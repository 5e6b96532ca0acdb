"""Sequence parallelism: ring and Ulysses attention (``parallel/
ring_attention.py``), their routing from ``MultiHeadSelfAttention``
(``zoo.seq.mode``, ``zoo.seq.strict``) and from the training loop
(``keras/seq_pipe.py``: ``zoo.train.seq_attention``), held to full
attention and to the JAX package's ring and Ulysses on the same mesh
(``tests/test_parallel.py``, ``tests/test_seq_pipe.py``).

The torch side runs as 4 gloo ranks on the CPU (one process group for the
file; ``file://`` store under ``tmp_path``); the workers import this
module, which imports no ``jax`` at the top.

Tolerances: attention outputs 2e-4 relative, 2e-5 absolute against full
attention (the JAX tests': streaming softmax against one softmax), 1e-5 /
1e-6 against JAX's ring and Ulysses (the same block order in f32); fits
1e-4 / 1e-5 (the JAX test's).
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.ops.attention import dot_product_attention
from analytics_zoo_tpu_torch.parallel import mesh as pmesh
from analytics_zoo_tpu_torch.parallel import ring_attention as pra
from analytics_zoo_tpu_torch.parallel.launch import run_ranks

WORLD = 4
TOL = dict(rtol=2e-4, atol=2e-5)
T, H = 16, 8


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None])


def _context(seq=4, data=1, **conf):
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf={"zoo.mesh.seq": seq, "zoo.mesh.data": data,
                                **conf})
    return pmesh.global_mesh()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _attention_cases():
    mesh = _context()
    out = {}
    q, k, v = (_t(a) for a in _qkv((2, 2, 16, 8), 0))
    for causal in (False, True):
        out[f"ring_{causal}"] = (
            pra.ring_self_attention(q, k, v, mesh=mesh,
                                    causal=causal).numpy(),
            dot_product_attention(q, k, v, causal=causal).numpy())
    q, k, v = (_t(a) for a in _qkv((2, 2, 16, 8), 1))
    mask = _mask([11, 16], 16)
    for causal in (False, True):
        out[f"ring_mask_{causal}"] = (
            pra.ring_self_attention(q, k, v, mesh=mesh, causal=causal,
                                    mask=_t(mask)).numpy(),
            dot_product_attention(q, k, v, causal=causal,
                                  mask=_t(mask).float()[:, None, None, :])
            .numpy())
    q, k, v = (_t(a) for a in _qkv((2, 4, 16, 8), 2))
    mask = _mask([13, 16], 16)
    for causal in (False, True):
        for m in (None, _t(mask)):
            out[f"uly_{causal}_{m is not None}"] = (
                pra.ulysses_self_attention(q, k, v, mesh=mesh,
                                           causal=causal, mask=m).numpy(),
                dot_product_attention(
                    q, k, v, causal=causal,
                    mask=None if m is None
                    else m.float()[:, None, None, :]).numpy())
    # the ring's gradient: the full attention's
    q, k, v = (_t(a).requires_grad_() for a in _qkv((2, 2, 16, 8), 3))
    do = _t(_qkv((2, 2, 16, 8), 4)[0])
    (pra.ring_self_attention(q, k, v, mesh=mesh, causal=True) * do).sum() \
        .backward()
    ring_g = [a.grad.clone().numpy() for a in (q, k, v)]
    for a in (q, k, v):
        a.grad = None
    (dot_product_attention(q, k, v, causal=True) * do).sum().backward()
    out["ring_grad"] = (ring_g, [a.grad.numpy() for a in (q, k, v)])
    errors = {}
    for name, fn in (
            ("indivisible_heads", lambda: pra.ulysses_self_attention(
                *(torch.zeros(2, 3, 16, 8),) * 3, mesh=mesh)),
            ("ragged_seq", lambda: pra.ring_self_attention(
                *(torch.zeros(2, 2, 10, 8),) * 3, mesh=mesh)),
            ("no_generator", lambda: pra.ring_self_attention(
                q, k, v, mesh=mesh, dropout_rate=0.4))):
        try:
            fn()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


def _dropout_cases():
    """Rate 0 is the no-dropout path bit for bit; rate 0.4 the same bits
    from the same seed, different from no dropout; causal + mask + dropout
    at T=24 (T_local=6) finite and, without dropout, full attention's."""
    mesh = _context()
    out = {}

    def gen(seed):
        return torch.Generator().manual_seed(seed)
    for name, fn, shape in (("ring", pra.ring_self_attention, (2, 2, 16, 8)),
                            ("uly", pra.ulysses_self_attention,
                             (2, 4, 16, 8))):
        q, k, v = (_t(a) for a in _qkv(shape, 4))
        base = fn(q, k, v, mesh=mesh)
        zero = fn(q, k, v, mesh=mesh, dropout_rate=0.0, generator=gen(5))
        d1 = fn(q, k, v, mesh=mesh, dropout_rate=0.4, generator=gen(5))
        d2 = fn(q, k, v, mesh=mesh, dropout_rate=0.4, generator=gen(5))
        out[name] = (bool(torch.equal(base, zero)),
                     bool(torch.equal(d1, d2)),
                     bool(torch.allclose(d1, base)))
    q, k, v = (_t(a) for a in _qkv((2, 2, 24, 8), 8))
    mask = _t(_mask([17, 24], 24))
    ring = pra.ring_self_attention(q, k, v, mesh=mesh, causal=True,
                                   mask=mask)
    full = dot_product_attention(q, k, v, causal=True,
                                 mask=mask.float()[:, None, None, :])
    d = pra.ring_self_attention(q, k, v, mesh=mesh, causal=True, mask=mask,
                                dropout_rate=0.4, generator=gen(9))
    out["odd"] = (ring.numpy(), full.numpy(),
                  bool(torch.isfinite(d).all()),
                  bool(torch.allclose(d, ring)))
    return out


def _block(causal=True):
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
        TransformerBlock
    reset_uids()
    blk = TransformerBlock(8, 2, causal=causal)
    blk.build(generator=torch.Generator().manual_seed(0))
    return blk


def _layer_cases():
    """A TransformerBlock on a data 2 x seq 2 mesh routes through the
    ring (counted) and gives the one-device forward, masked or causal;
    zoo.seq.strict raises where a call cannot ride the mesh; the "off"
    scope routes nothing."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
        MultiHeadSelfAttention
    from analytics_zoo_tpu_torch.pipeline.api.keras.seq_pipe import \
        seq_attention_scope
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(8, 16, 8)).astype(np.float32))
    lengths = rng.integers(9, 17, size=8)
    mask4 = _t(_mask(lengths, 16).astype(np.float32))[:, None, None, :]
    out = {}
    calls = {"ring": 0, "uly": 0}
    orig = (pra.ring_self_attention, pra.ulysses_self_attention)

    def ring(*a, **kw):
        calls["ring"] += 1
        return orig[0](*a, **kw)

    def uly(*a, **kw):
        calls["uly"] += 1
        return orig[1](*a, **kw)
    pra.ring_self_attention, pra.ulysses_self_attention = ring, uly
    try:
        for name, causal, xin in (("causal", True, x),
                                  ("masked", False, [x, mask4])):
            pctx.reset_zoo_context()
            pctx.init_zoo_context()
            blk = _block(causal)
            want = blk(xin).detach()
            _context(seq=2, data=2)
            before = calls["ring"]
            got = blk(xin).detach()
            out[name] = (got.numpy(), want.numpy(), calls["ring"] - before,
                         lengths)
        _context(seq=2, data=2, **{"zoo.seq.mode": "ulysses"})
        before = calls["uly"]
        blk(x)
        out["ulysses_knob"] = calls["uly"] - before
        _context(seq=2, data=2, **{"zoo.seq.strict": True})
        attn = MultiHeadSelfAttention(8, 2, attn_drop=0.5)
        attn.build(generator=torch.Generator().manual_seed(0))
        errors = []
        for args in ((x,), ([x, torch.ones(8, 1, 16, 16)],)):
            try:
                attn(*args, training=True, generator=None)
                errors.append(None)
            except RuntimeError as e:
                errors.append(str(e))
        out["strict"] = errors
        _context(seq=2, data=2)
        before = calls["ring"]
        with seq_attention_scope("off"):
            y = MultiHeadSelfAttention(8, 2)
            y.build(generator=torch.Generator().manual_seed(0))
            y = y(x)
        out["off"] = (calls["ring"] - before,
                      bool(torch.isfinite(y).all()))
    finally:
        pra.ring_self_attention, pra.ulysses_self_attention = orig
    return out


def _blocks_model(n_block=4, head=4):
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        Lambda, Sequential, reset_uids)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense, TransformerBlock)
    reset_uids()
    layers = [TransformerBlock(H, 2, causal=True, hidden_drop=0.0,
                               attn_drop=0.0,
                               **({"input_shape": (T, H)} if i == 0 else {}))
              for i in range(n_block)]
    return Sequential(layers + [Lambda(lambda h: h[:, -1, :], name="last"),
                                Dense(head)], device="cpu")


def _fit_data(n=16, head=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, T, H)).astype(np.float32),
            rng.integers(0, head, n).astype(np.int32))


def _fit(conf, tree, seq=1, data=4):
    _context(seq=seq, data=data, **conf)
    m = _blocks_model().init_weights()
    m.load_jax_params(tree)
    m.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
    x, y = _fit_data()
    return m.fit(x, y, batch_size=16, nb_epoch=2, shuffle=False)["loss"]


def _loop_cases(tree):
    """``zoo.train.seq_attention``: ring and ulysses forced on seq 2 train
    as the plain step (the routes counted); it wins over ``zoo.seq.mode``;
    a mesh without seq and an unknown mode are refused."""
    out = {"plain": _fit({}, tree)}
    calls = {"ring_self_attention": 0, "ulysses_self_attention": 0}
    orig = {n: getattr(pra, n) for n in calls}

    def counting(name):
        def fn(*a, **kw):
            calls[name] += 1
            return orig[name](*a, **kw)
        return fn
    for n in calls:
        setattr(pra, n, counting(n))
    try:
        for mode in ("ring", "ulysses"):
            before = dict(calls)
            out[mode] = (_fit({"zoo.train.seq_attention": mode,
                               "zoo.seq.mode": "ring"}, tree, seq=2,
                              data=2),
                         {n: calls[n] - before[n] for n in calls})
    finally:
        for n, fn in orig.items():
            setattr(pra, n, fn)
    errors = []
    for conf, seq, data in (({"zoo.train.seq_attention": "ring"}, 1, 4),
                            ({"zoo.train.seq_attention": "spiral"}, 2, 2)):
        try:
            _fit(conf, tree, seq=seq, data=data)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def _torch_side(rank, world, tree):
    return {"attention": _attention_cases(), "dropout": _dropout_cases(),
            "layer": _layer_cases(), "loop": _loop_cases(tree)}


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_side():
    import jax
    import jax.numpy as jnp
    import optax

    from analytics_zoo_tpu.common.context import (init_zoo_context,
                                                  reset_zoo_context)
    from analytics_zoo_tpu.parallel import mesh as jmesh
    from analytics_zoo_tpu.parallel.ring_attention import (
        ring_self_attention, ulysses_self_attention)
    from analytics_zoo_tpu.pipeline.api.keras import Sequential
    from analytics_zoo_tpu.pipeline.api.keras.engine import (Lambda,
                                                             reset_uids)
    from analytics_zoo_tpu.pipeline.api.keras.layers import (
        Dense, TransformerBlock)
    reset_zoo_context()
    init_zoo_context()
    mesh = jmesh.create_mesh(data=1, seq=4, devices=jax.devices()[:4])
    out = {}
    q, k, v = (jnp.asarray(a) for a in _qkv((2, 2, 16, 8), 0))
    for causal in (False, True):
        out[f"ring_{causal}"] = np.asarray(ring_self_attention(
            q, k, v, mesh=mesh, causal=causal))
    q, k, v = (jnp.asarray(a) for a in _qkv((2, 4, 16, 8), 2))
    mask = jnp.asarray(_mask([13, 16], 16))
    for causal in (False, True):
        out[f"uly_{causal}"] = np.asarray(ulysses_self_attention(
            q, k, v, mesh=mesh, causal=causal, mask=mask))
    reset_uids()
    layers = [TransformerBlock(H, 2, causal=True, hidden_drop=0.0,
                               attn_drop=0.0,
                               **({"input_shape": (T, H)} if i == 0 else {}))
              for i in range(4)]
    m = Sequential(layers + [Lambda(lambda h: h[:, -1, :], name="last"),
                             Dense(4)])
    m.compile(optimizer=optax.adam(1e-2), loss="scce_with_logits")
    x, y = _fit_data()
    m.init_weights(sample_input=x[:8])
    tree = jax.tree.map(np.asarray, m.params)
    out["fit"] = m.fit(x, y, batch_size=16, nb_epoch=2,
                       shuffle=False)["loss"]
    reset_zoo_context()
    return tree, out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tree, want = _jax_side()
    store = tmp_path_factory.mktemp("gloo") / "store"
    return want, run_ranks(_torch_side, WORLD, str(store), args=(tree,))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_full_and_jax(results, causal):
    for r in results[1]:
        got, full = r["attention"][f"ring_{causal}"]
        np.testing.assert_allclose(got, full, **TOL)
        np.testing.assert_allclose(got, results[0][f"ring_{causal}"],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_masked_ring_attention_matches_full(results, causal):
    """The key-padding mask rotates with the blocks; real query rows
    agree (padding queries are garbage rows the model never reads)."""
    for r in results[1]:
        got, full = r["attention"][f"ring_mask_{causal}"]
        np.testing.assert_allclose(got[0, :, :11], full[0, :, :11], **TOL)
        np.testing.assert_allclose(got[1], full[1], **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_full_and_jax(results, causal):
    for r in results[1]:
        for masked in (False, True):
            got, full = r["attention"][f"uly_{causal}_{masked}"]
            np.testing.assert_allclose(got, full, **TOL)
        np.testing.assert_allclose(r["attention"][f"uly_{causal}_True"][0],
                                   results[0][f"uly_{causal}"], rtol=1e-5,
                                   atol=1e-6)


def test_ring_attention_gradient_matches_full(results):
    for r in results[1]:
        got, want = r["attention"]["ring_grad"]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **TOL)


def test_refusals(results):
    """Ulysses refuses heads the axis does not divide, the ring a
    sequence it does not divide, and dropout without a generator."""
    for r in results[1]:
        e = r["attention"]["errors"]
        assert "n_head" in e["indivisible_heads"]
        assert "not divisible" in e["ragged_seq"]
        assert "generator" in e["no_generator"]


@pytest.mark.parametrize("route", ["ring", "uly"])
def test_attention_dropout(results, route):
    for r in results[1]:
        same_at_zero, same_seed, unchanged = r["dropout"][route]
        assert same_at_zero and same_seed and not unchanged


def test_ring_combined_causal_mask_dropout_odd_tlocal(results):
    """T=24 over seq 4 (T_local=6): causal and masked, the real rows full
    attention's; with dropout finite and different."""
    for r in results[1]:
        ring, full, finite, unchanged = r["dropout"]["odd"]
        np.testing.assert_allclose(ring[0, :, :17], full[0, :, :17], **TOL)
        np.testing.assert_allclose(ring[1], full[1], **TOL)
        assert finite and not unchanged


@pytest.mark.parametrize("case", ["causal", "masked"])
def test_transformer_block_rides_the_seq_mesh(results, case):
    """On data 2 x seq 2 a TransformerBlock routes through the ring once
    and gives the one-device forward (masked: real rows)."""
    for r in results[1]:
        got, want, calls, lengths = r["layer"][case]
        assert calls == 1
        if case == "causal":
            np.testing.assert_allclose(got, want, **TOL)
        else:
            for b in range(8):
                np.testing.assert_allclose(got[b, :lengths[b]],
                                           want[b, :lengths[b]], **TOL)
        assert r["layer"]["ulysses_knob"] == 1


def test_seq_strict_mode_and_off_scope(results):
    for r in results[1]:
        assert all(e and "strict" in e for e in r["layer"]["strict"])
        assert r["layer"]["off"] == (0, True)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_forced_seq_attention_matches_plain_step(results, mode):
    """``zoo.train.seq_attention`` on seq 2 trains as the plain step and
    as the JAX fit; the forced mode wins over ``zoo.seq.mode=ring``."""
    for r in results[1]:
        losses, calls = r["loop"][mode]
        target = ("ring_self_attention" if mode == "ring"
                  else "ulysses_self_attention")
        assert calls[target] > 0
        if mode == "ulysses":
            assert calls["ring_self_attention"] == 0
        np.testing.assert_allclose(losses, r["loop"]["plain"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(losses, results[0]["fit"], rtol=1e-4,
                                   atol=1e-5)


def test_forced_seq_attention_refusals(results):
    for r in results[1]:
        no_seq, unknown = r["loop"]["errors"]
        assert "seq mesh axis" in no_seq
        assert "off|ring|ulysses" in unknown
