"""The port's observability modules held against the JAX package's on the
same inputs (made from numpy seeds): exposition text byte for byte,
parsed scrapes and snapshots, JSON event lines, span parents, goodput
ledgers under injected clocks, the fleet rollup rows, time-series
queries, fault plans and the profiler trigger's lifecycle. Also: the
default profiler start/stop write a trace on the CPU, device memory
reads ``[]`` without a card, and no new module imports jax.
"""

import json
import math
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu_torch import observability as pobs
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.common import faults as pfaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the modules this slice adds to the port
NEW_MODULES = (
    "analytics_zoo_tpu_torch.common.faults",
    "analytics_zoo_tpu_torch.observability.tracing",
    "analytics_zoo_tpu_torch.observability.export",
    "analytics_zoo_tpu_torch.observability.goodput",
    "analytics_zoo_tpu_torch.observability.device",
    "analytics_zoo_tpu_torch.observability.profiler",
    "analytics_zoo_tpu_torch.observability.timeseries",
    "analytics_zoo_tpu_torch.observability.collector",
    "analytics_zoo_tpu_torch.serving.status",
)

#: event fields read off a clock: set aside when lines are compared
TIME_FIELDS = ("ts", "dur_s", "at_s", "age_s")


@pytest.fixture(autouse=True)
def port_context():
    pctx.reset_zoo_context()
    yield
    pctx.reset_zoo_context()


def _both(fn):
    """``fn(obs)`` on the JAX package's observability and the port's."""
    return fn(jobs), fn(pobs)


def _fill(obs, seed):
    """One seeded observation sequence into a fresh registry: labeled
    counters, gauges, weighted histograms (incl. extremes), summaries
    and a label value that needs escaping."""
    rng = np.random.default_rng(seed)
    reg = obs.MetricsRegistry()
    for kind in ("a", "b", 'quote"d\\n'):
        reg.counter("zoo_test_total", "a counter",
                    labels={"kind": kind}).inc(int(rng.integers(0, 50)))
    reg.counter("zoo_plain_total").inc(3.5)
    g = reg.gauge("zoo_test_depth", "a gauge")
    g.set(float(rng.normal()))
    g.add(2.0)
    h = reg.histogram("zoo_test_seconds", "a histogram")
    for v in rng.lognormal(-5, 2, 200):
        h.observe(float(v))
    h.observe(0.25, n=7)
    h.observe(1e-12)
    h.observe(1e9)
    s = reg.summary("zoo_test_quantiles_seconds", "a summary")
    for v in rng.exponential(0.01, int(rng.integers(100, 400))):
        s.observe(float(v))
    reg.summary("zoo_empty_quantiles_seconds", "never observed")
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_snapshot_and_quantiles_match_jax(seed):
    jreg, preg = _both(lambda obs: _fill(obs, seed))
    jtext = jobs.render_prometheus(jreg)
    ptext = pobs.render_prometheus(preg)
    assert ptext == jtext
    jparsed, pparsed = jobs.parse_prometheus(jtext), pobs.parse_prometheus(
        ptext)
    assert repr(pparsed) == repr(jparsed)     # NaN-aware equality
    for compact in (False, True):
        assert repr(pobs.dump(preg, compact=compact)) == \
            repr(jobs.dump(jreg, compact=compact))
    jsum = next(m for m in jreg.metrics()
                if m.name == "zoo_test_quantiles_seconds")
    psum = next(m for m in preg.metrics()
                if m.name == "zoo_test_quantiles_seconds")
    for q in (0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert psum.quantile(q) == jsum.quantile(q)


def test_parse_prometheus_rejects_garbage_like_jax():
    for obs in (jobs, pobs):
        with pytest.raises(ValueError):
            obs.parse_prometheus("zoo_x_total{bad 1\n")


@pytest.mark.parametrize("max_bytes,keep", [(0, 3), (200, 2), (500, 1)])
def test_json_sink_rotation_gives_the_same_lines(tmp_path, max_bytes, keep):
    rng = np.random.default_rng(max_bytes)
    events = [{"ts": float(i), "kind": "tick", "seq": i,
               "v": float(rng.normal())} for i in range(60)]
    out = {}
    for name, obs in (("jax", jobs), ("port", pobs)):
        d = tmp_path / name
        sink = obs.JsonEventSink(str(d / "e.jsonl"), max_bytes=max_bytes,
                                 keep=keep)
        for e in events:
            sink.write(e)
        sink.close()
        sink.write({"ts": 99.0, "kind": "after-close"})   # dropped
        segments = sorted(os.listdir(d))
        chain = [open(d / seg).read() for seg in segments]
        out[name] = (segments, chain, obs.read_events(str(d / "e.jsonl")),
                     obs.read_events(str(d / "e.jsonl"), kind="tick"))
    assert out["port"] == out["jax"]


def test_concurrent_writers_give_the_same_lines(tmp_path):
    """Eight threads emit events and spans through each package's
    registry into its sink: every line parses, and with the time fields
    set aside both logs hold the same lines."""
    n_threads, n_events = 8, 100

    def run(obs, path):
        sink = obs.JsonEventSink(path)
        reg = obs.MetricsRegistry()
        reg.add_event_sink(sink)

        def worker(tid):
            for i in range(n_events):
                if i % 2:
                    reg.emit("unit.tick", thread=tid, i=i)
                else:
                    with obs.span("unit.work", registry=reg, thread=tid):
                        pass

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        sink.close()
        lines = []
        for e in obs.read_events(path):
            assert isinstance(e["ts"], float)
            lines.append(json.dumps({k: v for k, v in e.items()
                                     if k not in TIME_FIELDS},
                                    sort_keys=True))
        snap = reg.snapshot()
        return sorted(lines), snap['zoo_span_seconds{span="unit.work"}'][
            "count"]

    jl, jn = run(jobs, str(tmp_path / "j.jsonl"))
    pl, pn = run(pobs, str(tmp_path / "p.jsonl"))
    assert len(pl) == n_threads * n_events
    assert pl == jl and pn == jn == n_threads * n_events // 2


def test_span_nesting_and_parents_match_jax():
    def run(obs):
        reg = obs.MetricsRegistry()
        events = []

        class ListSink:
            def write(self, e):
                events.append({k: v for k, v in e.items()
                               if k not in TIME_FIELDS})

        reg.add_event_sink(ListSink())
        seen = [obs.current_span()]
        with obs.span("outer", registry=reg, records=3):
            seen.append(obs.current_span())
            with obs.span("inner", registry=reg):
                seen.append(obs.current_span())
                with obs.span("probe", registry=reg) as sp:
                    sp.discard()
            with obs.span("inner", registry=reg):
                pass
        seen.append(obs.current_span())
        counts = {k: v["count"] for k, v in reg.snapshot().items()
                  if k.startswith("zoo_span_seconds")}
        return events, seen, counts

    jev, jseen, jcounts = run(jobs)
    pev, pseen, pcounts = run(pobs)
    assert (pev, pseen, pcounts) == (jev, jseen, jcounts)
    assert [e["parent"] for e in pev] == ["outer", "outer", None]
    assert pcounts == {'zoo_span_seconds{span="inner"}': 2,
                       'zoo_span_seconds{span="outer"}': 1}
    tid = [None, None]

    def other(i, obs):     # nesting is per thread
        tid[i] = obs.current_span()

    for i, obs in enumerate((jobs, pobs)):
        with obs.span("main", registry=obs.MetricsRegistry()):
            t = threading.Thread(target=other, args=(i, obs))
            t.start()
            t.join()
    assert tid == [None, None]
    for tr in (pobs.new_trace_id(), pobs.new_trace_id()):
        assert len(tr) == 16 and set(tr) <= set("0123456789abcdef")


@pytest.mark.parametrize("role", ["serve", "train"])
def test_goodput_ledger_matches_jax_under_injected_clocks(role):
    rng = np.random.default_rng(7)
    cats = (pobs.SERVE_CATEGORIES if role == "serve"
            else pobs.TRAIN_CATEGORIES)
    assert cats == (jobs.SERVE_CATEGORIES if role == "serve"
                    else jobs.TRAIN_CATEGORIES)
    steps = [(str(rng.choice(cats)), float(rng.exponential(0.01)))
             for _ in range(200)]
    steps.insert(50, ("idle", -0.5))         # a clock step back clamps

    def run(obs):
        reg = obs.MetricsRegistry()
        led = obs.GoodputLedger(role, registry=reg, clock=lambda: 0.0)
        before = (led.note(cats[0], now=10.0), led.snapshot(),
                  obs.goodput_snapshot(reg))
        led.open(now=10.0)
        now = 10.0
        got = []
        for cat, dt in steps:
            now += dt
            got.append(led.note(cat, now=now))
        with pytest.raises(ValueError):
            led.note("no-such-category", now=now)
        return (before, got, led.seconds(), led.wall(),
                led.goodput_seconds(), led.badput_seconds(), led.ratio(),
                led.snapshot(), obs.goodput_snapshot(reg),
                obs.render_prometheus(reg))

    assert repr(run(pobs)) == repr(run(jobs))
    with pytest.raises(ValueError):
        pobs.GoodputLedger("neither")


def _scrapes(obs, seeds=(3, 4, 5)):
    """``(base, health, status, families)`` rows of a few replicas'
    scrapes, each a seeded registry rendered and parsed."""
    rows = []
    for i, seed in enumerate(seeds):
        reg = _fill(obs, seed)
        rows.append((f"http://r{i}", {"status": "ok"}, {},
                     obs.parse_prometheus(obs.render_prometheus(reg))))
    return rows


def test_fleet_and_endpoint_rows_match_jax():
    jrows, prows = _scrapes(jobs), _scrapes(pobs)
    assert repr(pobs.fleet_rows(prows)) == repr(jobs.fleet_rows(jrows))
    for jr, pr in zip(jrows, prows):
        assert repr(pobs.endpoint_rows(pr[3])) == \
            repr(jobs.endpoint_rows(jr[3]))
        name = "zoo_test_quantiles_seconds"
        assert pobs.summary_points(pr[3], name) == \
            jobs.summary_points(jr[3], name)
    for arg in ("9464", "host:1234", "http://h:1/metrics", "https://h/"):
        assert pobs.base_url(arg) == jobs.base_url(arg)


@pytest.mark.parametrize("budget", [8, 64])
def test_rehydrate_digest_matches_jax(budget):
    rng = np.random.default_rng(budget)
    qs = {"0.5": 0.01, "0.95": 0.03, "0.99": 0.08}
    count = float(rng.integers(10, 1000))
    jd = jobs.rehydrate_digest(qs, count, budget=budget)
    pd = pobs.rehydrate_digest(qs, count, budget=budget)
    assert pd.count == jd.count
    for q in np.linspace(0, 1, 21):
        assert pd.quantile(float(q)) == jd.quantile(float(q))


def test_time_series_store_queries_match_jax():
    """The same registry snapshots through each package's sampler and
    store give the same rates, averages, slopes and windowed quantiles."""
    rng = np.random.default_rng(9)
    obs_seq = [(float(rng.exponential(0.02)), int(rng.integers(0, 5)))
               for _ in range(30)]

    def run(obs):
        reg = obs.MetricsRegistry()
        c = reg.counter("zoo_req_total")
        g = reg.gauge("zoo_depth")
        s = reg.summary("zoo_lat_quantiles_seconds")
        store = obs.TimeSeriesStore(retention_s=60.0, sample_interval_s=1.0)
        sampler = obs.RegistrySampler(reg, store=store, clock=lambda: 0.0)
        for t, (lat, n) in enumerate(obs_seq):
            c.inc(n)
            g.set(n)
            s.observe(lat)
            sampler.sample_once(now=100.0 + t)
        now = 100.0 + len(obs_seq) - 1
        return (store.keys(), store.rate("zoo_req_total", 10.0, now),
                store.avg("zoo_depth", 10.0, now),
                store.slope("zoo_depth", 10.0, now),
                store.max("zoo_depth", 5.0, now),
                store.quantile("zoo_lat_quantiles_seconds", 0.99, 10.0, now),
                store.latest("zoo_req_total"), store.capacity)

    assert repr(run(pobs)) == repr(run(jobs))
    rb = pobs.RingBuffer(3)
    for i in range(5):
        rb.append(float(i), i)
    assert rb.items() == [(2.0, 2), (3.0, 3), (4.0, 4)]
    assert pobs.timeseries.family_of('a{b="c"}') == "a"


def test_fault_plans_fire_as_jax_does():
    def run(faults):
        plan = faults.FaultPlan(seed=5)
        plan.add("s.a", "error", at=(1, 3)).add("s.b", "latency", p=0.3,
                                                 delay_s=0.0)
        plan.add("s.c", "partial_write", at=(0,), fraction=0.25)
        return plan

    jp, pp = run(jfaults), run(pfaults)
    for i in range(40):
        for p in (jp, pp):
            for site in ("s.a", "s.b", "s.c"):
                p.on_call(site)
    assert pp.fired == jp.fired and pp.calls("s.b") == 40
    with pytest.raises(RuntimeError, match="zoo.faults.enabled"):
        with pfaults.activate(pp):
            pass
    pctx.init_zoo_context(conf={"zoo.faults.enabled": True})
    plan = pfaults.FaultPlan().add("x", "error", at=(0,)).add(
        "x", "disconnect", at=(1,))
    with pfaults.activate(plan):
        with pytest.raises(pfaults.FaultError):
            pfaults.inject("x")
        with pytest.raises(ConnectionError):
            pfaults.inject("x")
        assert pfaults.inject("x") is None
    assert pfaults.active_plan() is None


def test_context_defaults_for_the_new_keys_match_jax():
    keys = ("zoo.faults.enabled", "zoo.telemetry.sample_interval_s",
            "zoo.telemetry.retention_s", "zoo.telemetry.device_memory",
            "zoo.goodput.enabled", "zoo.profiler.dir", "zoo.profiler.keep",
            "zoo.profiler.duration_s", "zoo.profiler.steps")
    for k in keys:
        assert pctx.DEFAULT_CONF[k] == jctx.DEFAULT_CONF[k], k
        assert type(pctx.DEFAULT_CONF[k]) is type(jctx.DEFAULT_CONF[k]), k
    ctx = pctx.init_zoo_context(profiler_keep=5)
    assert ctx.get("zoo.profiler.keep") == 5


def _lifecycle(obs, faults_mod, tmp_path, init_ctx):
    """One scripted run of a trigger under injected start/stop and clock:
    arm, refused re-arm, step-bounded stop, retention, a failing start,
    an injected ``profiler.capture`` fault, and the alert hook."""
    calls = []
    clock = [0.0]
    fail = [False]

    def start(d):
        if fail[0]:
            raise OSError("trace dir unwritable")
        calls.append(("start", os.path.relpath(d, tmp_path)))

    def stop():
        calls.append(("stop",))

    reg = obs.MetricsRegistry()
    events = []

    class ListSink:
        def write(self, e):
            events.append({k: (os.path.relpath(v, tmp_path)
                               if k == "dir" else v)
                           for k, v in e.items() if k not in TIME_FIELDS})

    reg.add_event_sink(ListSink())
    trig = obs.ProfilerTrigger(str(tmp_path / "caps"), registry=reg, keep=2,
                               duration_s=0.0, steps=2, start_fn=start,
                               stop_fn=stop, clock=lambda: clock[0])
    seen = []
    for _ in range(4):
        d = trig.arm("http", reason="test")
        seen.append(os.path.relpath(d, tmp_path))
        clock[0] += 1.5
        seen.append(trig.arm("manual"))          # in flight: refused
        seen.append(trig.in_flight()["age_s"])
        trig.step()
        seen.append(trig.in_flight() is not None)
        trig.step()                              # budget spent: stops
        seen.append(trig.in_flight())
    seen.append(sorted(os.listdir(tmp_path / "caps")))
    fail[0] = True
    seen.append(trig.arm("bogus"))
    fail[0] = False
    init_ctx(conf={"zoo.faults.enabled": True})
    plan = faults_mod.FaultPlan().add("profiler.capture", "error", at=(0,))
    with faults_mod.activate(plan):
        seen.append(trig.arm("alert"))
    trig.on_alert({"state": "pending", "alert": "x"})
    trig.on_alert({"state": "firing", "alert": "e2e burn"})
    seen.append(os.path.relpath(trig.in_flight()["dir"], tmp_path))
    seen.append(trig.stop() is not None)
    seen.append(trig.stop())
    trig.close()
    counters = {k: v["value"] for k, v in reg.snapshot().items()
                if k.startswith("zoo_profile")}
    return calls, events, seen, counters, plan.fired


def test_profiler_trigger_lifecycle_matches_jax(tmp_path):
    j = _lifecycle(jobs, jfaults, tmp_path / "j", jctx.init_zoo_context)
    p = _lifecycle(pobs, pfaults, tmp_path / "p", pctx.init_zoo_context)
    assert repr(p) == repr(j)
    calls, events, seen, counters, fired = p
    assert counters['zoo_profile_captures_total{trigger="http"}'] == 4
    assert counters['zoo_profile_capture_failures_total'] == 2
    assert seen[20] == ["capture-0003-http", "capture-0004-http"]


def test_default_profiler_start_stop_write_a_trace_on_the_cpu(tmp_path):
    reg = pobs.MetricsRegistry()
    trig = pobs.ProfilerTrigger(str(tmp_path), registry=reg, keep=3,
                                duration_s=0.0, steps=0)
    d = trig.arm("http")
    assert d is not None
    other = pobs.ProfilerTrigger(str(tmp_path / "b"), registry=reg,
                                 duration_s=0.0)
    assert other.arm("manual") is None       # one capture a process
    x = torch.randn(64, 64)
    for _ in range(3):
        x = torch.tanh(x @ x)
    assert trig.stop() == d
    with open(os.path.join(d, pobs.profiler.TRACE_FILE)) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]
    snap = reg.snapshot()
    assert snap['zoo_profile_captures_total{trigger="http"}']["value"] == 1
    assert snap["zoo_profile_capture_failures_total"]["value"] == 1
    assert other.arm("manual") is not None   # free again after the stop
    other.stop()


def test_device_memory_is_empty_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    reg = pobs.MetricsRegistry()
    assert pobs.device_memory_stats() == []
    assert pobs.sample_device_memory(reg) == []
    assert not [m for m in reg.metrics() if m.name == "zoo_device_hbm_bytes"]
    sampler = pobs.DeviceMemorySampler(reg, interval_s=0.001).start()
    sampler.close()
    assert not reg.metrics()


def test_scrape_server_endpoints_without_a_server():
    """A bare ScrapeServer: /metrics is the JAX text for the same
    registry, /healthz and /statusz carry the JAX keys, POST /profilez
    without a profiler and unknown paths give 404."""
    import urllib.error
    import urllib.request

    jreg, preg = _both(lambda obs: _fill(obs, 11))
    srvs = [jobs.ScrapeServer(jreg), pobs.ScrapeServer(preg)]
    try:
        got = []
        for srv in srvs:
            base = f"http://{srv.host}:{srv.port}"
            with urllib.request.urlopen(srv.url, timeout=10) as r:
                text = r.read().decode()
            with urllib.request.urlopen(base + "/statusz", timeout=10) as r:
                status = json.loads(r.read())
            codes = []
            for method, path in (("GET", "/nope"), ("POST", "/profilez"),
                                 ("POST", "/metrics")):
                req = urllib.request.Request(base + path, method=method,
                                             data=b"" if method == "POST"
                                             else None)
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(req, timeout=10)
                codes.append(e.value.code)
            got.append((text, sorted(status), sorted(status["jit"]),
                        sorted(status["performance"]), codes))
        assert got[1] == got[0]
        assert got[1][4] == [404, 404, 404]
    finally:
        for srv in srvs:
            srv.close()


def test_new_modules_import_no_jax():
    """Each new module alone, in a fresh interpreter, leaves jax and the
    JAX package out of ``sys.modules``; the status CLI answers --help."""
    code = (
        "import importlib, sys\n"
        f"for name in {NEW_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'analytics_zoo_tpu' or "
        "n.startswith('analytics_zoo_tpu.'))\n"
        "assert not bad, bad\n"
        "from analytics_zoo_tpu_torch.serving import status\n"
        "try:\n"
        "    status.main(['--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")
    assert "--slo-p99-ms" in proc.stdout


def test_fleet_rows_merge_weights_by_traffic():
    """A replica with ten times the traffic dominates the merged p50, as
    the count-weighted rehydration intends (not a percentile average)."""
    rows = []
    for i, (n, scale) in enumerate(((1000, 0.001), (100, 1.0))):
        reg = pobs.MetricsRegistry()
        s = reg.summary("zoo_serving_e2e_quantiles_seconds")
        for v in np.full(n, scale):
            s.observe(float(v))
        rows.append((f"r{i}", {}, {}, pobs.parse_prometheus(
            pobs.render_prometheus(reg))))
    (name, count, p50, _p95, p99), = pobs.fleet_rows(rows)[0]
    assert count == 1100 and math.isclose(p50, 1.0, rel_tol=0.05)
    assert p99 > 100.0


def test_scrape_while_observing_keeps_the_exposition_whole():
    """Eight producer threads hammer a histogram, a summary and a counter
    of the port's registry (a short switch interval) while its
    ScrapeServer renders: every scrape parses, the buckets are monotone,
    the +Inf bucket equals the count, and p50 <= p95 <= p99."""
    import urllib.request

    reg = pobs.MetricsRegistry()
    h = reg.histogram("zoo_load_seconds", "under fire")
    s = reg.summary("zoo_load_quantiles_seconds", "under fire")
    c = reg.counter("zoo_load_total")
    srv = pobs.ScrapeServer(reg, port=0)
    stop = threading.Event()
    interval = sys.getswitchinterval()

    def producer(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            v = float(rng.random())
            h.observe(v)
            s.observe(v)
            c.inc()

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(8)]
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for _ in range(20):
            with urllib.request.urlopen(srv.url, timeout=10) as resp:
                parsed = pobs.parse_prometheus(resp.read().decode())
            samples = parsed["zoo_load_seconds"]["samples"]
            buckets = [v for name, _, v in samples if name.endswith("_bucket")]
            count = next(v for name, _, v in samples
                         if name.endswith("_count"))
            assert buckets == sorted(buckets) and buckets[-1] == count
            qs = {lab["quantile"]: v for _, lab, v in
                  parsed["zoo_load_quantiles_seconds"]["samples"]
                  if "quantile" in lab}
            if qs and all(v == v for v in qs.values()):
                assert qs["0.5"] <= qs["0.95"] <= qs["0.99"]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
        srv.close()
    assert not any(t.is_alive() for t in threads)
    assert c.value == h.stats()[1] == s.count
