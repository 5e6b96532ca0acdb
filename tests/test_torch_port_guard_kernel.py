"""G1 and G2, the guarded step's kernels (``ops/guard.py``,
``csrc/guard.cu``), on the CPU: their plain versions are the torch ops
they replace, bit for bit, in every sentinel mode, with and without
clipping and per-step values, on good steps and on each kind of bad one
(the guarded step through them is held to the JAX guarded step by
``tests/test_torch_port_reliability.py``). The kernels themselves are held to these plain versions on the card in
``tests/test_torch_port_cuda.py``."""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import anomaly
from analytics_zoo_tpu_torch.ops import guard as gk

TABLE = torch.arange(12, dtype=torch.float32).reshape(4, 3) / 7.0


def _today(loss, gnorm, ewma, obs, count, base, table, sentinel,
           spike_factor, grad_clip, recover, grads):
    """The guarded step's scalar chain, clip and count as the torch ops
    wrote them before G2 (``TrainingLoop.guarded_step``)."""
    if sentinel:
        flags, (e, o) = anomaly.check(loss, gnorm, (ewma, obs),
                                      spike_factor)
        ewma.copy_(e)
        obs.copy_(o)
    else:
        flags = torch.zeros((), dtype=torch.int32)
    if grad_clip > 0:
        engaged = anomaly.clip_by_global_norm(grads, gnorm, grad_clip)
        flags = flags | engaged.to(torch.int32) * anomaly.GRAD_CLIPPED
    row = (None if table is None
           else table.index_select(0, (count - base).view(1))[0])
    if recover:
        bad = (flags & anomaly.ANOMALY_MASK) > 0
        count.add_((~bad).to(torch.int64))
    else:
        bad = torch.zeros((), dtype=torch.bool)
        count.add_(1)
    return flags, bad, row


def _state(ewma, obs, count):
    return (torch.tensor(ewma, dtype=torch.float32),
            torch.tensor(obs, dtype=torch.float32),
            torch.tensor(count, dtype=torch.int64))


CASES = {
    "good": (0.7, 1.3, 1.1, 7.0),
    "first": (0.7, 1.3, 0.0, 0.0),
    "nan_loss": (float("nan"), 1.3, 1.1, 7.0),
    "inf_loss": (float("inf"), 1.3, 1.1, 7.0),
    "nan_grad": (0.7, float("nan"), 1.1, 7.0),
    "inf_grad": (0.7, float("inf"), 1.1, 7.0),
    "spike": (0.7, 50.0, 1.1, 7.0),
    "spike_before_warmup": (0.7, 50.0, 1.1, 3.0),
    "spike_on_a_zero_baseline": (0.7, 50.0, 0.0, 9.0),
    "clip_engaged": (0.7, 3.0, 2.9, 7.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode,grad_clip", [("recover", 0.0),
                                            ("recover", 2.0),
                                            ("warn", 0.0), ("warn", 2.0),
                                            ("off", 2.0)])
@pytest.mark.parametrize("with_table", [False, True])
def test_g2_plain_version_is_the_torch_chain_bit_for_bit(case, mode,
                                                         grad_clip,
                                                         with_table):
    loss_v, gnorm_v, ewma_v, obs_v = CASES[case]
    sentinel, recover = mode != "off", mode == "recover"
    table = TABLE if with_table else None
    rng = np.random.default_rng(3)
    grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in ((4, 3), (5,))]
    grads_want = [g.clone() for g in grads]
    want_state = _state(ewma_v, obs_v, 6)
    got_state = _state(ewma_v, obs_v, 6)
    base = torch.tensor(5, dtype=torch.int64)
    loss = torch.tensor(loss_v)
    gnorm = torch.tensor(gnorm_v)
    wf, wb, wr = _today(loss, gnorm, *want_state, base, table, sentinel,
                        10.0, grad_clip, recover, grads_want)
    flags_out = torch.full((), -1, dtype=torch.int32)
    gf, gb, gr, scale = gk.guard_check(
        loss, gnorm, *got_state, base, table, sentinel=sentinel,
        spike_factor=10.0, grad_clip=grad_clip, recover=recover,
        flags_out=flags_out)
    assert int(gf) == int(wf) == int(flags_out)
    assert bool(gb) == bool(wb)
    for got, want in zip(got_state, want_state):
        assert torch.equal(got, want), (got, want)
    if with_table:
        assert torch.equal(gr, wr)
    else:
        assert gr is None
    if grad_clip > 0:
        anomaly._scale(grads, scale)
        for g, w in zip(grads, grads_want):
            assert torch.equal(g, w)
    else:
        assert scale is None


@pytest.mark.parametrize("n", [1, 2, 12, 33, 128, 129])
def test_g2_given_the_per_tensor_norms_is_the_global_norm_chain(n):
    """``guard_check`` given the per-tensor norms (``gnorm`` None) gives
    what it gives with ``anomaly.global_norm``'s norm of them, bit for bit:
    the flags, the clip scale and the new EWMA state (a first step's EWMA
    value is the norm itself)."""
    rng = np.random.default_rng(n)
    grads = [torch.from_numpy(rng.standard_normal(1 + i % 5).astype(
        np.float32) * (1 + i % 3)) for i in range(n)]
    outs = []
    for gnorm, norms in ((anomaly.global_norm(grads), None),
                         (None, anomaly.tensor_norms(grads))):
        state = _state(0.0, 0.0, 0)
        flags, bad, _, scale = gk.guard_check(
            torch.tensor(0.7), gnorm, *state, torch.tensor(0), None,
            sentinel=True, spike_factor=10.0, grad_clip=1.5, recover=True,
            norms=norms)
        outs.append((int(flags), bool(bad), scale, *state))
    assert outs[0][:2] == outs[1][:2]
    for want, got in zip(outs[0][2:], outs[1][2:]):
        assert torch.equal(want, got), (want, got)
    assert torch.equal(outs[1][3], anomaly.global_norm(grads))


def test_g2_flags_by_case():
    """The flag words of the cases, in recover mode with clipping."""
    want = {"good": 0, "first": 0, "nan_loss": 1, "inf_loss": 1,
            "nan_grad": 2, "inf_grad": 2, "spike": 4 | 8,
            "spike_before_warmup": 8, "spike_on_a_zero_baseline": 8,
            "clip_engaged": 8}
    for case, (loss_v, gnorm_v, ewma_v, obs_v) in CASES.items():
        flags, bad, _, _ = gk.guard_check(
            torch.tensor(loss_v), torch.tensor(gnorm_v),
            *_state(ewma_v, obs_v, 0), torch.tensor(0), None,
            sentinel=True, spike_factor=10.0, grad_clip=2.0, recover=True)
        assert int(flags) == want[case], case
        assert bool(bad) == bool(want[case] & anomaly.ANOMALY_MASK), case


@pytest.mark.parametrize("bad", [False, True])
def test_g1_plain_version_is_the_per_tensor_select(bad):
    rng = np.random.default_rng(5)
    dtypes = (torch.float32, torch.bfloat16, torch.int64, torch.float32)
    state = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             .to(dt) for s, dt in zip(((7, 3), (11,), (2, 2), ()), dtypes)]
    prev = [t.clone() for t in state]
    for t in state:
        t.add_(1)
    want = [torch.where(torch.tensor(bad), p, t) for t, p in zip(state, prev)]
    assert gk.guard_commit(state, prev, torch.tensor(bad)) is None
    for got, w in zip(state, want):
        assert got.dtype == w.dtype and torch.equal(got, w)


def test_wrappers_refuse_mismatched_inputs():
    with pytest.raises(ValueError, match="differ in length"):
        gk.guard_commit([torch.zeros(2)], [], torch.tensor(True))


def test_commit_table_takes_dense_spans_in_any_order():
    """G1 copies each tensor's span of memory: contiguous tensors, a
    ``channels_last`` weight and a transposed matrix are dense; a strided
    slice is not (the table refuses it, before any device is asked)."""
    assert gk._dense(torch.zeros(4, 5))
    assert gk._dense(torch.zeros(8, 3, 5, 5).to(
        memory_format=torch.channels_last))
    assert gk._dense(torch.zeros(6, 9).t())
    assert gk._dense(torch.zeros(()))
    assert not gk._dense(torch.zeros(6, 9)[:, ::2])
    with pytest.raises(ValueError, match="dense"):
        gk.commit_table([torch.zeros(6, 9)[:, ::2]],
                        [torch.zeros(6, 9)[:, ::2]])
