"""The status CLI — the port of ``scripts/cluster-serving-status``:
scrape running Cluster Serving instances' observability endpoints and
pretty-print them.

    python -m analytics_zoo_tpu_torch.serving.status [endpoint ...]
        [--slo-p99-ms [FAMILY=]MS ...] [--json]

(default endpoint: 127.0.0.1:9464; an endpoint is ``host:port``, a bare
port or a URL). It reads the three endpoints ``serve_metrics(port)``
mounts:

  /healthz   liveness: status, uptime, serve-loop state
  /statusz   operator page: stream depth, last-flush age, device info,
             the goodput ``performance`` block
  /metrics   Prometheus exposition, rendered as a compact table with
             p50/p95/p99 pulled out of the quantile summaries

Several endpoints (a replica fleet) roll up: each endpoint's health
prints on its own line, and the quantile summaries merge into ONE
fleet-wide p50/p95/p99 table through ``QuantileDigest.merge`` (each
replica's scraped quantile points rehydrated into a digest weighted by
its sample count); counters sum across replicas.

``--slo-p99-ms`` holds a p99 SLO against the scraped summaries: a bare
``MS`` applies to the end-to-end family; ``FAMILY=MS`` targets one family
by its short name (``queue_wait`` / ``dispatch`` / ``e2e``) or its full
metric name. Repeatable. A threshold whose family has no samples counts
as a breach (an SLO check that silently passes when the metric vanishes
is not an SLO check). ``--json`` emits one JSON object mirroring the
tables, under the same exit-status contract.

The semantics, output and JSON are the JAX package's script's; this copy
runs where jax is not installed (it imports only the port).

Exit status: 0 healthy, 1 unreachable or degraded, 2 p99 SLO breach.
"""

import argparse
import json
import sys
import urllib.error
import urllib.request

from ..observability import (base_url, endpoint_rows, fleet_rows,
                             parse_prometheus)

DEFAULT = "127.0.0.1:9464"

#: short names accepted by --slo-p99-ms FAMILY=MS
SLO_FAMILIES = {short: f"zoo_serving_{short}_quantiles_seconds"
                for short in ("queue_wait", "dispatch", "e2e")}


def _parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.serving.status",
        description="Scrape and pretty-print a Cluster Serving "
                    "observability endpoint.")
    ap.add_argument("endpoints", nargs="*", default=[DEFAULT],
                    metavar="endpoint",
                    help="host:port, bare port, or URL; several roll up "
                         f"into a fleet view (default {DEFAULT})")
    ap.add_argument("--slo-p99-ms", action="append", default=[],
                    metavar="[FAMILY=]MS",
                    help="p99 threshold in ms; bare MS = end-to-end, "
                         "FAMILY one of %s or a full family name; "
                         "repeatable; breach exits 2"
                         % "/".join(sorted(SLO_FAMILIES)))
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON object instead of the human "
                         "tables (same exit-status contract)")
    return ap.parse_args(argv)


def _parse_slos(specs):
    """``{family_name: threshold_ms}`` from the repeated flag values."""
    slos = {}
    for spec in specs:
        fam, _, ms = spec.rpartition("=")
        fam = fam or "e2e"
        try:
            threshold = float(ms)
        except ValueError:
            raise SystemExit(
                f"cluster-serving-status: bad --slo-p99-ms value {spec!r} "
                f"(expected [FAMILY=]MS)")
        slos[SLO_FAMILIES.get(fam, fam)] = threshold
    return slos


def _get(url: str, timeout: float = 10.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8")


def _fmt_age(s):
    return "never" if s is None else f"{s:.1f}s ago"


def _scrape_endpoint(base):
    """``(health, status, families)`` for one endpoint; raises on an
    unreachable / non-observability target."""
    health = json.loads(_get(base + "/healthz"))
    status = json.loads(_get(base + "/statusz"))
    families = parse_prometheus(_get(base + "/metrics"))
    return health, status, families


def _human_bytes(n):
    """``1536 -> "1.5KiB"`` — the operator CLIs' size formatter."""
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0


def _print_endpoint(base, health, status):
    srv = status.get("serving", {})
    print(f"== {base} : {health.get('status', '?')} "
          f"(up {health.get('uptime_s', 0.0):.1f}s) ==")
    if srv:
        print(f"serve loop   : {'running' if srv.get('running') else 'STOPPED'}"
              f" | stream depth {srv.get('stream_depth')}"
              f" | served {srv.get('served')} in {srv.get('batches')} batches"
              f" | last flush {_fmt_age(srv.get('last_flush_age_s'))}")
    ov = srv.get("overload")
    if ov:
        # the degradation line: is this replica shedding, spilling to its
        # DLQ, or running a backed-off batch target right now?
        wm = ov.get("shed_watermark") or 0
        parts = [
            f"depth {ov.get('stream_depth')}"
            + (f"/wm {wm}" if wm else " (shedding off)"),
            f"shed {ov.get('shed_depth_total', 0):.0f} depth"
            f" + {ov.get('shed_deadline_total', 0):.0f} deadline",
            f"batch target {ov.get('batch_size_target')}"
            + ("" if ov.get("adaptive_batch") else " (fixed)"),
        ]
        if "dlq_records" in ov:
            parts.append(f"dlq {ov['dlq_records']:.0f} rec"
                         f" / {_human_bytes(ov.get('dlq_bytes', 0))}")
        pb = ov.get("publish_breaker")
        if pb and pb != "closed":
            parts.append(f"publish breaker {pb.upper()}")
        print("degradation  : " + " | ".join(parts))
    sc = srv.get("scaling")
    if sc:
        # the autoscaler line: identity, backlog, in-flight pending
        # entries, and the busy-dispatch fraction since the last scrape
        util = sc.get("utilization")
        goodput = sc.get("goodput")
        print(f"scaling      : {sc.get('consumer', '?')}"
              + (f" in group {sc['group']}" if sc.get("group")
                 else " (single-consumer)")
              + f" | depth {sc.get('stream_depth')}"
              + f" | pending {sc.get('pending_entries')}"
              + (f" | util {util * 100.0:.0f}%" if util is not None
                 else "")
              + (f" | goodput {goodput * 100.0:.0f}%"
                 if goodput is not None else "")
              + f" | batch target {sc.get('batch_size_target')}")
    mdl = srv.get("models")
    if mdl:
        # the multiplexing view: one row per model lane — batch target,
        # compiled-bucket hit-rate, and the lane's dispatch-breaker
        # state (an open breaker = that model is fast-failing while the
        # others keep serving)
        print(f"models       : {'model':<16} {'weight':>6} {'target':>6} "
              f"{'bkt-hit':>8} {'breaker':>9} {'records':>9}")
        for name in sorted(mdl):
            b = mdl[name]
            print(f"               {name:<16} {b.get('weight', 1):>6g} "
                  f"{str(b.get('batch_target', '?')):>6} "
                  f"{_fmt_hit(b.get('bucket_hit_rate')):>8} "
                  f"{b.get('breaker', '?'):>9} "
                  f"{b.get('records', 0):>9.0f}")
    perf = status.get("performance")
    if perf and perf.get("ratio") is not None:
        # the attribution line: where this replica's wall clock went
        bad = perf.get("badput_s") or {}
        worst = sorted(((v, k) for k, v in bad.items() if v > 0),
                       reverse=True)[:3]
        print(f"performance  : goodput {perf['ratio'] * 100.0:.0f}%"
              + (" | badput " + ", ".join(
                  f"{k} {v:.1f}s" for v, k in worst) if worst else ""))
    dev = status.get("device", {})
    jit = status.get("jit", {})
    print(f"device       : {dev.get('platform', '?')}"
          f" x{dev.get('device_count', '?')}"
          f" | jit compiles {jit.get('compile_total', 0):.0f}"
          f" (retraces {jit.get('retrace_total', 0):.0f})")


def _fmt_hit(hit):
    return "—" if hit is None else f"{hit * 100.0:.0f}%"


def _print_fleet_degradation(scraped):
    """One fleet-wide degradation line: summed shed totals and DLQ
    depth/bytes, plus the per-replica batch-target spread — the
    30-second answer to "is the fleet shedding and where is the spilled
    work"."""
    blocks = [s.get("serving", {}).get("overload")
              for _b, _h, s, _f in scraped]
    blocks = [b for b in blocks if b]
    if not blocks:
        return
    shed_depth = sum(b.get("shed_depth_total", 0) for b in blocks)
    shed_deadline = sum(b.get("shed_deadline_total", 0) for b in blocks)
    dlq_records = sum(b.get("dlq_records", 0) for b in blocks)
    dlq_bytes = sum(b.get("dlq_bytes", 0) for b in blocks)
    targets = [b.get("batch_size_target") for b in blocks
               if b.get("batch_size_target") is not None]
    line = (f"degradation  : shed {shed_depth:.0f} depth"
            f" + {shed_deadline:.0f} deadline"
            f" | dlq {dlq_records:.0f} rec / {_human_bytes(dlq_bytes)}")
    if targets:
        line += (f" | batch target {min(targets)}"
                 if min(targets) == max(targets)
                 else f" | batch target {min(targets)}–{max(targets)}")
    open_breakers = sum(b.get("publish_breaker") not in (None, "closed")
                        for b in blocks)
    if open_breakers:
        line += f" | {open_breakers} replica(s) publish breaker not closed"
    print(line)


def _print_fleet_models(scraped):
    """The fleet multiplexing rollup: one row per model NAME across
    replicas — records summed, bucket hit-rate weighted by each
    replica's dispatch traffic (records), batch-target spread, and the
    WORST dispatch-breaker state across replicas (one replica's open
    lane is a fleet-level signal even when its peers are healthy)."""
    severity = {"closed": 0, "half_open": 1, "open": 2}
    agg = {}
    for _base, _h, status, _f in scraped:
        for name, b in (status.get("serving", {}).get("models")
                        or {}).items():
            a = agg.setdefault(name, {"records": 0.0, "hit_w": 0.0,
                                      "hit_n": 0.0, "targets": [],
                                      "breaker": "closed"})
            recs = float(b.get("records", 0))
            a["records"] += recs
            hit = b.get("bucket_hit_rate")
            if hit is not None:
                w = max(recs, 1.0)
                a["hit_w"] += hit * w
                a["hit_n"] += w
            if b.get("batch_target") is not None:
                a["targets"].append(b["batch_target"])
            st = b.get("breaker", "closed")
            if severity.get(st, 0) > severity.get(a["breaker"], 0):
                a["breaker"] = st
    if not agg:
        return
    print(f"{'model':<16} {'target':>8} {'bkt-hit':>8} {'breaker':>9} "
          f"{'records':>10}")
    for name in sorted(agg):
        a = agg[name]
        hit = a["hit_w"] / a["hit_n"] if a["hit_n"] else None
        targets = a["targets"]
        spread = ("?" if not targets
                  else str(targets[0]) if min(targets) == max(targets)
                  else f"{min(targets)}–{max(targets)}")
        print(f"{name:<16} {spread:>8} {_fmt_hit(hit):>8} "
              f"{a['breaker']:>9} {a['records']:>10.0f}")


def _print_fleet_scaling(scraped):
    """The fleet scaling table — one row per replica with a utilization
    column (busy-dispatch fraction between scrapes), plus a fleet mean:
    the signal an autoscaler compares against its target band."""
    rows = []
    for base, _h, status, _f in scraped:
        sc = status.get("serving", {}).get("scaling")
        if sc:
            rows.append((base, sc))
    if not rows:
        return
    print(f"{'replica':<28} {'depth':>6} {'pending':>8} "
          f"{'util':>6} {'batch':>6} {'goodput':>8}")
    utils = []
    goods = []
    for base, sc in rows:
        util = sc.get("utilization")
        if util is not None:
            utils.append(float(util))
        goodput = sc.get("goodput")
        if goodput is not None:
            goods.append(float(goodput))
        print(f"{base.replace('http://', ''):<28} "
              f"{str(sc.get('stream_depth')):>6} "
              f"{str(sc.get('pending_entries')):>8} "
              f"{(f'{util * 100.0:.0f}%' if util is not None else '?'):>6} "
              f"{str(sc.get('batch_size_target')):>6} "
              f"{(f'{goodput * 100.0:.0f}%' if goodput is not None else '?'):>8}")
    if utils or goods:
        print(f"{'fleet mean':<28} {'':>6} {'':>8} "
              + (f"{sum(utils) / len(utils) * 100.0:>5.0f}%"
                 if utils else f"{'?':>6}")
              + f" {'':>6} "
              + (f"{sum(goods) / len(goods) * 100.0:>7.0f}%"
                 if goods else f"{'?':>8}"))


def main(argv=None) -> int:
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    slos = _parse_slos(args.slo_p99_ms)
    bases = [base_url(e) for e in (args.endpoints or [DEFAULT])]
    scraped = []
    unreachable = []
    for base in bases:
        try:
            scraped.append((base,) + _scrape_endpoint(base))
        except (urllib.error.URLError, OSError, ValueError) as e:
            # ValueError covers non-JSON/garbage bodies (wrong service on
            # the port) — same exit-1 contract as a connection failure
            print(f"cluster-serving-status: {base} unreachable or not an "
                  f"observability endpoint ({e})", file=sys.stderr)
            unreachable.append(base)
    if not scraped:
        if args.json:
            print(json.dumps({"endpoints": {}, "fleet": False,
                              "unreachable": unreachable,
                              "quantiles": [], "metrics": {},
                              "breaches": [], "exit": 1}, indent=2))
        return 1

    human = not args.json
    if human:
        for base, health, status, _families in scraped:
            _print_endpoint(base, health, status)

    fleet = len(bases) > 1
    if fleet:
        quantile_rows, scalar_rows = fleet_rows(scraped)
        if human:
            print(f"\nfleet roll-up across {len(scraped)} replica(s) "
                  f"(QuantileDigest.merge; counters summed):")
            _print_fleet_degradation(scraped)
            _print_fleet_models(scraped)
            _print_fleet_scaling(scraped)
    else:
        quantile_rows, scalar_rows = endpoint_rows(scraped[0][3])

    breaches = []
    if quantile_rows and human:
        print("\nfleet-wide latency quantiles (ms):" if fleet
              else "\nlatency quantiles (ms):")
        print(f"  {'family':<44} {'count':>8} {'p50':>9} {'p95':>9} "
              f"{'p99':>9}")
    for name, count, p50, p95, p99 in quantile_rows:
        flag = ""
        threshold = slos.get(name)
        if threshold is not None and p99 == p99 and p99 > threshold:
            flag = f"  << p99 SLO BREACH (> {threshold:g} ms)"
            breaches.append(f"{name}: p99 {p99:.3f} ms > {threshold:g}")
        if human:
            print(f"  {name:<44} {count:>8.0f} {p50:>9.3f} {p95:>9.3f} "
                  f"{p99:>9.3f}{flag}")
    # a threshold whose family produced no row (absent or zero samples)
    # is a breach: missing data must not read as a passing SLO
    seen = {name for name, *_ in quantile_rows}
    for fam, threshold in sorted(slos.items()):
        if fam not in seen:
            breaches.append(f"{fam}: no samples (threshold {threshold:g} ms)")
    if scalar_rows and human:
        print("\nmetrics:")
        for name, v in scalar_rows:
            print(f"  {name:<60} {v:g}")
    if breaches:
        print("\ncluster-serving-status: p99 SLO breach: "
              + "; ".join(breaches), file=sys.stderr)
    code = (2 if breaches
            else 1 if unreachable or any(h.get("status") != "ok"
                                         for _b, h, _s, _f in scraped)
            else 0)
    if args.json:
        breach_names = {b.split(":", 1)[0] for b in breaches}
        doc = {
            "endpoints": {base: {"health": health, "status": status}
                          for base, health, status, _f in scraped},
            "fleet": fleet,
            "unreachable": unreachable,
            "quantiles": [
                {"family": name, "count": count, "p50_ms": p50,
                 "p95_ms": p95, "p99_ms": p99,
                 "slo_breach": name in breach_names}
                for name, count, p50, p95, p99 in quantile_rows],
            "metrics": dict(scalar_rows),
            "breaches": breaches,
            "exit": code,
        }
        print(json.dumps(doc, indent=2, default=str))
    return code


if __name__ == "__main__":
    sys.exit(main())
