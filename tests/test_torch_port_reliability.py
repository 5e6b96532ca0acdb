"""The port's training reliability layer held to the JAX package's: the
anomaly sentinels and gradient clipping in the step (``common/anomaly.py``,
``TrainingLoop.guarded_step``), skip-then-rollback recovery, and the fit's
goodput ledger. Each chaos scenario of ``tests/test_training_chaos.py``
runs here through BOTH packages, from the same weights, under the same
``train.grads`` fault plan (each package's own ``common.faults``), and the
flagged steps, counters, events, skipped sets, the rollback's
``restore_step``, the optimizer count after a skip and the post-fit
parameters are compared.

Tolerances, each with its reason:
* the port against JAX: post-fit parameters 1e-5 absolute / relative and
  epoch losses 1e-5 relative — the same f32 arithmetic in other summation
  orders (the JAX side sums over conftest's 8-device CPU mesh);
* the port against itself (a recovered run against a poison-free control,
  sentinel off against ``recover`` with nothing flagged): the same bits;
* ``off`` against ``warn``, and a never-engaging clip against no clip:
  1e-6 relative, as the JAX test holds them (the guarded step computes
  the norm; the update is the same).
Batch 32 (a multiple of the JAX side's 8 devices); shuffle off, so batch
i of an epoch is rows ``[32 i, 32 i + 32)``.
"""

import math
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import anomaly as janomaly
from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.common import faults as jfaults
from analytics_zoo_tpu.common import triggers as jtriggers
from analytics_zoo_tpu import observability as jobs
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras import training as jtraining
from analytics_zoo_tpu_torch.common import anomaly as panomaly
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.common import faults as pfaults
from analytics_zoo_tpu_torch.common import triggers as ptriggers
from analytics_zoo_tpu_torch import observability as pobs
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as pl
from analytics_zoo_tpu_torch.pipeline.api.keras import training as ptraining
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import \
    Sequential as PSequential
from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
    _bias_correction, step_scalars)

BATCH = 32
RTOL = ATOL = 1e-5

ANOM = ('zoo_train_anomaly_total{kind="nan_loss"}',
        'zoo_train_anomaly_total{kind="nan_grad"}',
        'zoo_train_anomaly_total{kind="spike"}',
        "zoo_train_skipped_steps_total", "zoo_train_rollback_total")

JAX = types.SimpleNamespace(
    name="jax", ctx=jctx, faults=jfaults, obs=jobs, triggers=jtriggers,
    TrainingDiverged=jtraining.TrainingDiverged)
PORT = types.SimpleNamespace(
    name="port", ctx=pctx, faults=pfaults, obs=pobs, triggers=ptriggers,
    TrainingDiverged=ptraining.TrainingDiverged)
BOTH = (JAX, PORT)


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    pobs.reset_default_registry()
    yield
    pctx.reset_zoo_context()
    jctx.reset_zoo_context()
    jeng.set_policy()


def _init(**conf):
    for pkg in BOTH:
        pkg.ctx.init_zoo_context(**conf)


def _data(n=256, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, 1)).astype(np.float32)
    return x, (x @ w).astype(np.float32)


def _without_batches(x, y, batch_indices):
    keep = np.ones(len(x), bool)
    for b in batch_indices:
        keep[b * BATCH:(b + 1) * BATCH] = False
    return x[keep], y[keep]


def _model(pkg, lr=0.05, d=8):
    """The chaos tests' ``Dense(8, relu) -> Dense(1)`` under Adam, from the
    same weights in both packages (drawn by the JAX package)."""
    jm = JSequential([jl.Dense(8, activation="relu", input_shape=(d,),
                               name="d0"), jl.Dense(1, name="d1")])
    jm.init_weights(rng=jax.random.key(5))
    if pkg is JAX:
        m = jm
    else:
        m = PSequential([pl.Dense(8, activation="relu", input_shape=(d,),
                                  name="d0"), pl.Dense(1, name="d1")],
                        device="cpu")
        m.load_jax_params(jax.tree.map(np.asarray, jm.params))
    m.compile(optimizer="adam", loss="mse", lr=lr)
    return m


def _params(pkg, m):
    if pkg is JAX:
        return {"/".join(str(k.key) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_flatten_with_path(
                    m.params)[0]}
    return {n.replace(".", "/"): p.detach().numpy().copy()
            for n, p in m.named_parameters()}


def _count(pkg, m):
    if pkg is JAX:
        return int(m.opt_state[0].count)
    return int(m.opt_state["count"])


def _counters(pkg, *names):
    snap = pkg.obs.default_registry().snapshot()
    out = {}
    for n in names:
        e = snap.get(n, {})
        out[n] = e.get("value", e.get("count", 0))
    return out


def _deltas(pkg, before, *names):
    after = _counters(pkg, *names)
    return {n: after[n] - before[n] for n in names}


def _assert_close_params(a, b, rtol=RTOL, atol=ATOL):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _fit_with_plan(pkg, m, plan_specs, seed, **fit_kw):
    plan = pkg.faults.FaultPlan(seed=seed)
    for site, kind, kw in plan_specs:
        plan.add(site, kind, **kw)
    with pkg.faults.activate(plan):
        h = m.fit(*fit_kw.pop("xy"), **fit_kw)
    return h, plan


def _events(pkg, tmp_path, fn):
    path = str(tmp_path / f"{pkg.name}-events.jsonl")
    sink = pkg.obs.JsonEventSink(path)
    pkg.obs.default_registry().add_event_sink(sink)
    try:
        out = fn()
    finally:
        pkg.obs.default_registry().remove_event_sink(sink)
        sink.close()
    return out, [e for e in pkg.obs.read_events(path)
                 if e["kind"] in ("train.anomaly", "train.rollback")]


def _strip(ev):
    return {k: v for k, v in ev.items()
            if k not in ("ts", "time", "t", "seq", "pid", "host")}


# ---------------------------------------------------------------------------
# detection: counters/events reconcile exactly against the plan
# ---------------------------------------------------------------------------

def test_recover_counts_each_kind_exactly_and_contains_them(tmp_path):
    """One nan_loss, one nan_grad, one spike: each kind counted once, all
    three updates discarded, the same events and parameters as JAX, and
    the optimizer count three behind the steps."""
    _init(faults_enabled=True, train_sentinel="recover")
    x, y = _data()
    specs = [("train.grads", "nan_loss", dict(at=(1,))),
             ("train.grads", "nan_grad", dict(at=(3,))),
             ("train.grads", "spike", dict(at=(7,), scale=1e6))]
    out = {}
    for pkg in BOTH:
        before = _counters(pkg, *ANOM)
        m = _model(pkg)
        (h, plan), evs = _events(pkg, tmp_path, lambda: _fit_with_plan(
            pkg, m, specs, 3, xy=(x, y), batch_size=BATCH, nb_epoch=1,
            shuffle=False))
        assert [(s, k) for s, k, _ in plan.fired] == [
            ("train.grads", "nan_loss"), ("train.grads", "nan_grad"),
            ("train.grads", "spike")]
        d = _deltas(pkg, before, *ANOM)
        assert d == {ANOM[0]: 1, ANOM[1]: 1, ANOM[2]: 1, ANOM[3]: 3,
                     ANOM[4]: 0}, (pkg.name, d)
        assert math.isfinite(h["loss"][0])
        p = _params(pkg, m)
        assert all(np.all(np.isfinite(v)) for v in p.values())
        assert [e["kinds"] for e in evs] == ["nan_loss", "nan_grad",
                                             "spike"]
        assert all(e["action"] == "skip" for e in evs)
        assert [e["iteration"] for e in evs] == [1, 3, 7]
        out[pkg.name] = (h, p, _count(pkg, m), [_strip(e) for e in evs])
    np.testing.assert_allclose(out["port"][0]["loss"], out["jax"][0]["loss"],
                               rtol=RTOL)
    _assert_close_params(out["port"][1], out["jax"][1])
    assert out["port"][2] == out["jax"][2] == 8 - 3
    assert out["port"][3] == out["jax"][3]


def test_warn_mode_detects_but_applies_updates():
    """``warn``: counted, logged, applied — a NaN loss with clean
    gradients shows as a NaN epoch mean; nothing skipped; as in JAX."""
    _init(faults_enabled=True, train_sentinel="warn")
    x, y = _data()
    out = {}
    for pkg in BOTH:
        before = _counters(pkg, *ANOM)
        m = _model(pkg)
        h, plan = _fit_with_plan(
            pkg, m, [("train.grads", "nan_loss", dict(at=(2,)))], 5,
            xy=(x, y), batch_size=BATCH, nb_epoch=1, shuffle=False)
        assert [(s, k) for s, k, _ in plan.fired] == [("train.grads",
                                                       "nan_loss")]
        d = _deltas(pkg, before, *ANOM)
        assert d[ANOM[0]] == 1 and d[ANOM[3]] == 0
        assert math.isnan(h["loss"][0])
        p = _params(pkg, m)
        assert all(np.all(np.isfinite(v)) for v in p.values())
        out[pkg.name] = (p, _count(pkg, m))
    _assert_close_params(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1] == 8


# ---------------------------------------------------------------------------
# skip-mode bit-identity vs a poison-free control
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan_steps", [1, 4])
def test_skip_mode_matches_control_bit_for_bit(scan_steps):
    """A recovered run's losses, parameters and optimizer state are the
    poison-free control's bits (the port against itself), and its
    parameters and count are the JAX recovered run's."""
    _init(faults_enabled=True, train_sentinel="recover",
          train_scan_steps=scan_steps)
    x, y = _data()
    specs = [("train.grads", "nan_loss", dict(at=(2,))),
             ("train.grads", "spike", dict(at=(6,), scale=1e5))]
    got = {}
    for pkg in BOTH:
        m = _model(pkg)
        h, plan = _fit_with_plan(pkg, m, specs, 7, xy=(x, y),
                                 batch_size=BATCH, nb_epoch=1,
                                 shuffle=False)
        assert len(plan.fired) == 2
        got[pkg.name] = (m, h)
    m_t, h_t = got["port"]
    xc, yc = _without_batches(x, y, (2, 6))
    m_c = _model(PORT)
    h_c = m_c.fit(xc, yc, batch_size=BATCH, nb_epoch=1, shuffle=False)
    assert h_t["loss"] == h_c["loss"]
    _assert_same_bits(_params(PORT, m_t), _params(PORT, m_c))
    for a, b in zip(m_t.opt_state["state"][0]["mu"]
                    + m_t.opt_state["state"][0]["nu"],
                    m_c.opt_state["state"][0]["mu"]
                    + m_c.opt_state["state"][0]["nu"]):
        assert torch.equal(a, b)
    assert m_t.opt_state["count"] == m_c.opt_state["count"] == 6
    _assert_close_params(_params(PORT, m_t), _params(JAX, got["jax"][0]))
    assert _count(JAX, got["jax"][0]) == 6
    np.testing.assert_allclose(h_t["loss"], got["jax"][1]["loss"],
                               rtol=RTOL)


def test_sentinel_off_and_warn_match_numerically():
    x, y = _data()
    _init(train_sentinel="off")
    m_off = _model(PORT)
    assert m_off._loop._sentinel_config().active is False
    h_off = m_off.fit(x, y, batch_size=BATCH, nb_epoch=2, shuffle=False)
    _init(train_sentinel="warn")
    m_warn = _model(PORT)
    assert m_warn._loop._sentinel_config().sentinel is True
    h_warn = m_warn.fit(x, y, batch_size=BATCH, nb_epoch=2, shuffle=False)
    np.testing.assert_allclose(h_off["loss"], h_warn["loss"], rtol=1e-6)
    _assert_close_params(_params(PORT, m_off), _params(PORT, m_warn),
                         rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("scan_steps", [1, 4])
def test_recover_with_empty_plan_is_sentinel_off_bit_for_bit(scan_steps):
    """The guarded step discards by a select against pre-step copies and
    poisons by a multiply by 1: with nothing flagged, ``recover`` (with
    the fault input compiled in) gives the plain step's bits."""
    x, y = _data()
    _init(train_scan_steps=scan_steps)
    m_off = _model(PORT)
    h_off = m_off.fit(x, y, batch_size=BATCH, nb_epoch=2, shuffle=False)
    _init(train_scan_steps=scan_steps, train_sentinel="recover",
          faults_enabled=True)
    m_rec = _model(PORT)
    with pfaults.activate(pfaults.FaultPlan(seed=1)):
        h_rec = m_rec.fit(x, y, batch_size=BATCH, nb_epoch=2, shuffle=False)
    assert h_off["loss"] == h_rec["loss"]
    _assert_same_bits(_params(PORT, m_off), _params(PORT, m_rec))
    assert m_off.opt_state["count"] == m_rec.opt_state["count"] == 16


# ---------------------------------------------------------------------------
# rollback escalation and the TrainingDiverged budget
# ---------------------------------------------------------------------------

def test_rollback_restores_last_good_and_skips_window_on_replay(tmp_path):
    """Past max_skips_per_epoch both packages reload ckpt-8 and replay
    epoch 2 without batches 2-4: the same counters and rollback event
    (restore_step 8), the port's replay equal to its poison-free control
    bit for bit, and its parameters the JAX run's."""
    _init(faults_enabled=True, train_sentinel="recover",
          train_max_skips_per_epoch=2)
    x, y = _data()
    m_c = _model(PORT)
    m_c.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)
    xc, yc = _without_batches(x, y, (2, 3, 4))
    h_c = m_c.fit(xc, yc, batch_size=BATCH, nb_epoch=1, shuffle=False)
    out = {}
    for pkg in BOTH:
        m = _model(pkg)
        m.set_checkpoint(str(tmp_path / pkg.name))
        m.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)
        before = _counters(pkg, *ANOM)
        (h, plan), evs = _events(pkg, tmp_path, lambda: _fit_with_plan(
            pkg, m, [("train.grads", "nan_loss", dict(at=(2, 3, 4)))], 11,
            xy=(x, y), batch_size=BATCH, nb_epoch=1, shuffle=False))
        assert len(plan.fired) == 3
        d = _deltas(pkg, before, *ANOM)
        assert d == {ANOM[0]: 3, ANOM[1]: 0, ANOM[2]: 0, ANOM[3]: 6,
                     ANOM[4]: 1}, (pkg.name, d)
        assert m.finished_epochs == 2
        rb = [e for e in evs if e["kind"] == "train.rollback"]
        assert len(rb) == 1 and rb[0]["restore_step"] == 8
        assert rb[0]["skipped_iters"] == 3
        out[pkg.name] = (m, h, [_strip(e) for e in evs])
    m, h, evs = out["port"]
    assert h["loss"] == h_c["loss"]
    _assert_same_bits(_params(PORT, m), _params(PORT, m_c))
    _assert_close_params(_params(PORT, m), _params(JAX, out["jax"][0]))
    assert _count(PORT, m) == _count(JAX, out["jax"][0]) == 8 + 5
    assert evs == out["jax"][2]


def test_rollback_regresses_past_in_memory_progress(tmp_path):
    """With the newest snapshot older than the published progress, the
    rollback regresses to it and the (epoch, ordinal) skip set lands on
    the same windows: the port equals its poison-free control bit for
    bit, and the JAX run at tolerance."""
    _init(faults_enabled=True, train_sentinel="recover",
          train_max_skips_per_epoch=2)
    x, y = _data()
    m_c = _model(PORT)
    h_c12 = m_c.fit(x, y, batch_size=BATCH, nb_epoch=2, shuffle=False)
    xc, yc = _without_batches(x, y, (2, 3, 4))
    h_c3 = m_c.fit(xc, yc, batch_size=BATCH, nb_epoch=1, shuffle=False)
    out = {}
    for pkg in BOTH:
        class _Never(pkg.triggers.Trigger):
            def __call__(self, state):
                return False

        m = _model(pkg)
        m.set_checkpoint(str(tmp_path / pkg.name))
        m.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)
        m.set_checkpoint(str(tmp_path / pkg.name), trigger=_Never())
        before = _counters(pkg, *ANOM)
        h, plan = _fit_with_plan(
            pkg, m, [("train.grads", "nan_loss", dict(at=(10, 11, 12)))],
            23, xy=(x, y), batch_size=BATCH, nb_epoch=2, shuffle=False)
        assert len(plan.fired) == 3
        assert _deltas(pkg, before, *ANOM)[ANOM[4]] == 1
        assert m.finished_epochs == 3 and len(h["loss"]) == 2
        out[pkg.name] = (m, h)
    m, h = out["port"]
    assert h["loss"][0] == h_c12["loss"][1]
    assert h["loss"][1] == h_c3["loss"][0]
    _assert_same_bits(_params(PORT, m), _params(PORT, m_c))
    _assert_close_params(_params(PORT, m), _params(JAX, out["jax"][0]))
    np.testing.assert_allclose(h["loss"], out["jax"][1]["loss"], rtol=RTOL)


class _CallsAtAnomaly:
    """An event sink that notes, at each ``train.anomaly`` event, the
    flagged iteration and how many ``train.grads`` site calls (steps
    dispatched) the plan had seen when the host observed it."""

    def __init__(self, plan):
        self.plan = plan
        self.seen = []

    def write(self, event):
        if event["kind"] == "train.anomaly":
            self.seen.append((event["iteration"],
                              self.plan.calls("train.grads")))


@pytest.mark.parametrize("scan_steps", [1, 2])
def test_escalation_reads_flags_at_the_jax_lag(scan_steps):
    """The skip budget (1) runs out at the second dispatch of an epoch of
    24 steps: both packages observe each dispatch's flags four dispatches
    late, so they escalate at the same iteration, after the same number
    of ``train.grads`` site calls (six dispatches), with no host read per
    step — eager (one step a dispatch) and on the multi-step program."""
    _init(faults_enabled=True, train_sentinel="recover",
          train_max_skips_per_epoch=1, train_scan_steps=scan_steps)
    x, y = _data(n=24 * BATCH)
    poisoned = (0, scan_steps)      # the first step of dispatches 0 and 1
    out = {}
    for pkg in BOTH:
        m = _model(pkg)
        plan = pkg.faults.FaultPlan(seed=7).add(
            "train.grads", "nan_loss", at=poisoned)
        sink = _CallsAtAnomaly(plan)
        pkg.obs.default_registry().add_event_sink(sink)
        try:
            with pkg.faults.activate(plan):
                with pytest.raises(pkg.TrainingDiverged,
                                   match="no checkpoint"):
                    m.fit(x, y, batch_size=BATCH, nb_epoch=1,
                          shuffle=False)
        finally:
            pkg.obs.default_registry().remove_event_sink(sink)
        out[pkg.name] = (sink.seen, plan.calls("train.grads"))
    lag = ptraining._SentinelMonitor.LAG
    assert lag == jtraining._SentinelMonitor.LAG == 4
    want = [(0, (lag + 1) * scan_steps),
            (scan_steps, (lag + 2) * scan_steps)]
    assert out["port"] == out["jax"] == (want, (lag + 2) * scan_steps)


def test_rollback_budget_exhaustion_raises_training_diverged(tmp_path):
    _init(faults_enabled=True, train_sentinel="recover",
          train_max_skips_per_epoch=1, train_max_rollbacks=2)
    x, y = _data()
    names = ("zoo_train_rollback_total",
             'zoo_retry_budget_exhausted_total{budget="train.rollback"}')
    for pkg in BOTH:
        m = _model(pkg)
        m.set_checkpoint(str(tmp_path / pkg.name))
        m.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)
        before = _counters(pkg, *names)
        plan = pkg.faults.FaultPlan(seed=13).add(
            "train.grads", "nan_grad", at=tuple(range(64)))
        with pkg.faults.activate(plan):
            with pytest.raises(pkg.TrainingDiverged, match="rollback budget"):
                m.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)
        assert _deltas(pkg, before, *names) == {names[0]: 2, names[1]: 1}
        assert all(np.all(np.isfinite(v))
                   for v in _params(pkg, m).values())


def test_escalation_without_checkpoint_raises_training_diverged():
    _init(faults_enabled=True, train_sentinel="recover",
          train_max_skips_per_epoch=1)
    x, y = _data()
    for pkg in BOTH:
        m = _model(pkg)
        plan = pkg.faults.FaultPlan(seed=17).add(
            "train.grads", "nan_loss", at=tuple(range(64)))
        with pkg.faults.activate(plan):
            with pytest.raises(pkg.TrainingDiverged, match="no checkpoint"):
                m.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)


# ---------------------------------------------------------------------------
# zoo.train.grad_clip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan_steps", [1, 4])
def test_grad_clip_engages_and_counts(scan_steps):
    """A tiny clip norm engages on every step (counted exactly, the
    parameters the JAX clipped run's); a huge one never engages and
    leaves the trajectory unchanged."""
    x, y = _data()
    key = "zoo_train_grad_clip_engaged_total"
    _init(train_grad_clip=1e-4, train_scan_steps=scan_steps)
    clipped = {}
    for pkg in BOTH:
        before = _counters(pkg, key)
        m = _model(pkg)
        assert m._loop._sentinel_config().grad_clip == 1e-4
        m.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)
        assert _deltas(pkg, before, key)[key] == 8
        clipped[pkg.name] = _params(pkg, m)
    _assert_close_params(clipped["port"], clipped["jax"])

    _init(train_grad_clip=1e9, train_scan_steps=scan_steps)
    before = _counters(PORT, key)
    m_hi = _model(PORT)
    h_hi = m_hi.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)
    assert _deltas(PORT, before, key)[key] == 0
    _init(train_grad_clip=0.0, train_scan_steps=scan_steps)
    m_off = _model(PORT)
    h_off = m_off.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)
    np.testing.assert_allclose(h_hi["loss"], h_off["loss"], rtol=1e-6)
    _assert_close_params(_params(PORT, m_hi), _params(PORT, m_off),
                         rtol=1e-6, atol=1e-7)


def test_grad_clip_interplay_with_spike_sentinel():
    """The spike sentinel watches the PRE-clip norm: a spike is detected
    and skipped with clipping active, in both packages alike."""
    _init(faults_enabled=True, train_sentinel="recover",
          train_grad_clip=1e9)
    x, y = _data()
    for pkg in BOTH:
        m = _model(pkg)
        before = _counters(pkg, *ANOM)
        h, plan = _fit_with_plan(
            pkg, m, [("train.grads", "spike", dict(at=(7,), scale=1e6))],
            19, xy=(x, y), batch_size=BATCH, nb_epoch=1, shuffle=False)
        assert len(plan.fired) == 1
        d = _deltas(pkg, before, *ANOM)
        assert d[ANOM[2]] == 1 and d[ANOM[3]] == 1


# ---------------------------------------------------------------------------
# config validation
# ---------------------------------------------------------------------------

def test_bad_sentinel_mode_rejected():
    _init(train_sentinel="aggressive")
    x, y = _data(n=64)
    for pkg in BOTH:
        m = _model(pkg)
        with pytest.raises(ValueError, match="zoo.train.sentinel") as e:
            m.fit(x, y, batch_size=BATCH, nb_epoch=1)
        assert "off|warn|recover" in str(e.value)


def test_sentinel_knobs_not_validated_when_off():
    x, y = _data(n=64)
    pctx.init_zoo_context(conf={"zoo.train.spike_factor": 0.5,
                                "zoo.train.max_rollbacks": 0})
    _model(PORT).fit(x, y, batch_size=BATCH, nb_epoch=1)
    msgs = {}
    for conf, match in (({"zoo.train.spike_factor": 0.5,
                          "zoo.train.sentinel": "warn"}, "spike_factor"),
                        ({"zoo.train.max_skips_per_epoch": -1,
                          "zoo.train.sentinel": "recover"},
                         "max_skips_per_epoch")):
        for pkg in BOTH:
            pkg.ctx.init_zoo_context(conf=conf)
            with pytest.raises(ValueError, match=match) as e:
                _model(pkg).fit(x, y, batch_size=BATCH, nb_epoch=1)
            msgs[pkg.name] = str(e.value)
        assert msgs["port"] == msgs["jax"]


def test_spike_check_waits_for_a_nonzero_baseline():
    """The JAX test's sequence through both ``check`` functions: the
    same flags and EWMA state at every step."""
    def run(mod, scalar):
        state = mod.init_state()
        flags = []
        seq = ([(0.0, 0.0)] * (mod.WARMUP_STEPS + 2) + [(0.3, 1.0)] * 4
               + [(0.3, 100.0)])
        for loss, norm in seq:
            f, state = mod.check(scalar(loss), scalar(norm), state, 10.0)
            flags.append((int(f), float(state[0]), float(state[1])))
        return flags

    got = run(panomaly, lambda v: torch.tensor(v, dtype=torch.float32))
    want = run(janomaly, lambda v: jax.numpy.asarray(v, jax.numpy.float32))
    assert got == want
    assert [f for f, _, _ in got[:-1]] == [0] * (len(got) - 1)
    assert got[-1][0] == panomaly.SPIKE


# ---------------------------------------------------------------------------
# the on-device pieces against JAX
# ---------------------------------------------------------------------------

def test_anomaly_constants_and_pieces_match_jax():
    for name in ("NAN_LOSS", "NAN_GRAD", "SPIKE", "ANOMALY_MASK",
                 "GRAD_CLIPPED", "KIND_BITS", "FAULT_CODES", "EWMA_ALPHA",
                 "WARMUP_STEPS", "EWMA_FLOOR"):
        assert getattr(panomaly, name) == getattr(janomaly, name), name
    rng = np.random.default_rng(4)
    grads = [rng.normal(size=s).astype(np.float32)
             for s in ((3, 5), (7,), (2, 2, 2))]
    pt = [torch.from_numpy(g.copy()) for g in grads]
    jt = [jax.numpy.asarray(g) for g in grads]
    np.testing.assert_allclose(float(panomaly.global_norm(pt)),
                               float(janomaly.global_norm(jt)), rtol=1e-6)
    norm = panomaly.global_norm(pt)
    engaged = panomaly.clip_by_global_norm(pt, norm, 1.0)
    jclipped, jengaged = janomaly.clip_by_global_norm(
        jt, janomaly.global_norm(jt), 1.0)
    assert bool(engaged) == bool(jengaged) is True
    for a, b in zip(pt, jclipped):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # a non-finite norm clips nothing
    inf = torch.tensor(float("inf"))
    again = [torch.from_numpy(g.copy()) for g in grads]
    assert not bool(panomaly.clip_by_global_norm(again, inf, 1.0))
    for a, g in zip(again, grads):
        np.testing.assert_array_equal(a.numpy(), g)
    # inject_grads: code 0 keeps every bit; each code poisons as JAX does
    loss = torch.tensor(0.25)
    cases = ((0, 0.0), (1, 0.0), (2, 0.0), (3, 1e3))
    jloss = jax.numpy.asarray(0.25)
    jcases = jax.numpy.asarray(np.float32(cases))
    for i, (code, scale) in enumerate(cases):
        pg = [torch.from_numpy(g.copy()) for g in grads]
        pl_ = panomaly.inject_grads(loss, pg, torch.tensor(float(code)),
                                    torch.tensor(float(scale)))
        jl_, jg = janomaly.inject_grads(jloss, jt, jcases[i, 0],
                                        jcases[i, 1])
        np.testing.assert_array_equal(pl_.numpy(), np.asarray(jl_))
        for a, b in zip(pg, jg):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert panomaly.kinds_of(7) == janomaly.kinds_of(7)


def test_count_and_scalars_after_a_skip():
    """Two discarded steps in a captured-path fit (scan 4): the count the
    port keeps is optax's, and the per-step values of the next update
    are those of that count — not of the steps dispatched."""
    _init(faults_enabled=True, train_sentinel="recover",
          train_scan_steps=4)
    x, y = _data()
    specs = [("train.grads", "nan_grad", dict(at=(1, 5)))]
    got = {}
    for pkg in BOTH:
        m = _model(pkg)
        _fit_with_plan(pkg, m, specs, 29, xy=(x, y), batch_size=BATCH,
                       nb_epoch=1, shuffle=False)
        got[pkg.name] = m
    count = _count(JAX, got["jax"])
    assert _count(PORT, got["port"]) == count == 6
    # the steps after the skips read the rows of the counts they have:
    # the next update's per-step values are update number 6's
    row = step_scalars(got["port"]._loop.optimizer, count)[0]
    np.testing.assert_array_equal(
        row[:2], np.float32([_bias_correction(0.9, 7),
                             _bias_correction(0.999, 7)]))
    _assert_close_params(_params(PORT, got["port"]),
                         _params(JAX, got["jax"]))
    # and a clean epoch after it continues both counts alike
    for pkg in BOTH:
        got[pkg.name].fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)
    assert _count(PORT, got["port"]) == _count(JAX, got["jax"]) == 14
    _assert_close_params(_params(PORT, got["port"]),
                         _params(JAX, got["jax"]))


def test_device_cache_turned_off_under_an_active_sentinel(caplog):
    _init(train_sentinel="warn", train_device_cache=True,
          train_fuse_epochs=2)
    x, y = _data(n=64)
    m = _model(PORT)
    import logging
    with caplog.at_level(logging.WARNING, logger="analytics_zoo_tpu_torch"):
        m.fit(x, y, batch_size=BATCH, nb_epoch=2, shuffle=False)
    assert any("zoo.train.device_cache disabled for this fit" in r.message
               for r in caplog.records)
    assert m._loop._data is None and m.finished_epochs == 2


# ---------------------------------------------------------------------------
# goodput (tests/test_goodput.py:186-270)
# ---------------------------------------------------------------------------

def _family_totals(*names):
    snap = pobs.default_registry().snapshot(compact=True)
    out = {}
    for n in names:
        for key, entry in snap.items():
            if key == n or key.startswith(n + "{"):
                out[key] = entry.get("value", entry.get("count", 0.0))
        out.setdefault(n, 0.0)
    return out


def test_chaos_fit_goodput_reconciles_to_wall_time(tmp_path):
    """Three poisoned steps (one rollback and replay skips), a save
    killed mid-write (one restart) and manifest latency (a checkpoint
    stall): the ledger attributes every second exactly once, every
    category is charged, and the exported families moved by the
    ledger."""
    _init(faults_enabled=True, train_sentinel="recover",
          train_max_skips_per_epoch=2)
    x, y = _data()
    m = _model(PORT)
    m.set_checkpoint(str(tmp_path / "ckpt"))
    m.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)
    fams = ("zoo_goodput_seconds_total", "zoo_badput_seconds_total",
            "zoo_train_rollback_total")
    before = _family_totals(*fams)
    plan = (pfaults.FaultPlan(seed=11)
            .add("train.grads", "nan_loss", at=(2, 3, 4))
            .add("ckpt.write", "error", at=(0,))
            .add("ckpt.manifest", "latency", delay_s=0.02,
                 at=(0, 1, 2, 3, 4, 5)))
    with pfaults.activate(plan):
        m.fit(x, y, batch_size=BATCH, nb_epoch=2, shuffle=False)
    after = _family_totals(*fams)
    assert len(plan.fired_at("train.grads")) == 3
    assert len(plan.fired_at("ckpt.write")) == 1
    assert after["zoo_train_rollback_total"] \
        - before["zoo_train_rollback_total"] == 1
    led = m._loop._goodput
    sec = led.seconds()
    assert led.goodput_seconds() + sum(led.badput_seconds().values()) \
        == pytest.approx(led.wall(), rel=1e-12)
    assert sum(sec.values()) == pytest.approx(led.wall(), rel=1e-12)
    for cat in ("device_step", "data_wait", "ckpt_stall",
                "rollback_replay", "restart", "anomaly_skip", "idle"):
        assert sec[cat] > 0.0, f"category {cat} never charged"
    assert after["zoo_goodput_seconds_total"] \
        - before["zoo_goodput_seconds_total"] \
        == pytest.approx(sec["device_step"], rel=1e-9)
    for cat, s in led.badput_seconds().items():
        k = f'zoo_badput_seconds_total{{category="{cat}"}}'
        assert after.get(k, 0.0) - before.get(k, 0.0) \
            == pytest.approx(s, rel=1e-9, abs=1e-12), cat


def test_goodput_disabled_leaves_no_ledger():
    pctx.init_zoo_context(goodput_enabled=False)
    x, y = _data(n=64)
    m = _model(PORT)
    m.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)
    assert m._loop._goodput is None


def test_reliability_modules_import_no_jax():
    """Every module this layer added imports torch, never jax or the JAX
    package (checked in a fresh interpreter)."""
    mods = ("analytics_zoo_tpu_torch.common.anomaly",
            "analytics_zoo_tpu_torch.common.triggers",
            "analytics_zoo_tpu_torch.utils.checkpoint",
            "analytics_zoo_tpu_torch.utils.ckpt_cli",
            "analytics_zoo_tpu_torch.observability.compile",
            "analytics_zoo_tpu_torch.pipeline.api.keras.training",
            "analytics_zoo_tpu_torch.pipeline.inference.inference_model")
    code = ("import sys; import " + ", ".join(mods) + "; "
            "sys.exit(int(any(m == 'jax' or m.startswith('jax.') or "
            "m == 'analytics_zoo_tpu' or "
            "m.startswith('analytics_zoo_tpu.') for m in sys.modules)))")
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0


# ---------------------------------------------------------------------------
# compile accounting (observability/compile.py)
# ---------------------------------------------------------------------------

def test_compile_accounting_counts_like_instrument_jit():
    """Two shapes through the JAX package's ``instrument_jit`` and two K
    of one port program (its CUDA-graph captures) count alike: two
    compiles, one retrace, a ``jit.compile`` event each and one
    ``jit.retrace``, under the same names."""
    from analytics_zoo_tpu.observability import instrument_jit
    from analytics_zoo_tpu_torch.observability.compile import (
        CompileTracker, record_compile)
    got = {}
    for pkg in BOTH:
        reg = pkg.obs.MetricsRegistry()
        log = []

        class Sink:
            def write(self, event):
                log.append(event["kind"])

        reg.add_event_sink(Sink())
        if pkg is JAX:
            fn = instrument_jit(lambda a: a * 2, name="train.scan_chunk",
                                registry=reg)
            fn(np.zeros(4, np.float32))
            fn(np.zeros(2, np.float32))
            fn(np.zeros(4, np.float32))
        else:
            tracker = CompileTracker("train.scan_chunk", reg)
            tracker.record(4, 0.5)
            tracker.record(2, 0.25)
        snap = reg.snapshot()
        got[pkg.name] = (
            snap["zoo_jit_compile_total"]["value"],
            snap['zoo_jit_retrace_total{fn="train.scan_chunk"}']["value"],
            snap['zoo_jit_compile_seconds{fn="train.scan_chunk"}']["count"],
            log)
    assert got["port"] == got["jax"] == (
        2, 1, 2, ["jit.compile", "jit.compile", "jit.retrace"])
    reg = pobs.MetricsRegistry()
    record_compile("flash_attention_fwd", 3.0, "lib.so", registry=reg)
    snap = reg.snapshot()
    assert snap["zoo_jit_compile_total"]["value"] == 1
    assert 'zoo_jit_retrace_total{fn="flash_attention_fwd"}' not in snap


def test_a_kernel_library_build_counts_as_a_compile(tmp_path, monkeypatch):
    """``CudaLibrary.build`` (nvcc faked) records one compile under the
    library's name; a library already built records none."""
    from analytics_zoo_tpu_torch.ops import cuda_build
    (tmp_path / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")

    def fake_run(cmd, **kw):
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")
    monkeypatch.setattr(cuda_build.subprocess, "run", fake_run)
    lib = cuda_build.CudaLibrary("fake_kernels", ["k.cu"], lambda l: None,
                                 src_dir=tmp_path)
    key = "zoo_jit_compile_total"
    before = _counters(PORT, key)[key]
    lib.build()
    lib.build()
    snap = pobs.default_registry().snapshot()
    assert snap[key]["value"] - before == 1
    assert snap['zoo_jit_compile_seconds{fn="fake_kernels"}']["count"] == 1
