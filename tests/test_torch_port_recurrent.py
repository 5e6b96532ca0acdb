"""The port's recurrent layers held to the JAX package on numpy-seeded
inputs and transferred weights: ``SimpleRNN``, ``LSTM``, ``GRU`` and
``Bidirectional`` (every merge mode, ``go_backwards`` both ways, with and
without ``return_sequences``, f32 gradients, bf16 forwards, ``run`` from a
given carry) and a ``Sequential`` fit on them. The zoo models on these
layers are held to JAX in ``tests/test_torch_port_recurrent_models.py``.

Tolerances, each with its reason:
* f32 outputs 1e-5 (the same formulas, the sums in another order);
* f32 gradients 1e-4 of the largest value (the backward's sums over the
  time steps in another order);
* a training step's parameters 1e-4 absolute, its loss 1e-5 (Adam's
  normalised step on gradients that agree to rounding);
* bf16 2e-2 relative, and of the largest value where values are small
  (the compute dtype's rounding of the same f32 sums);
* the bf16 carry against an f32 run on pre-rounded operands: bit for
  bit (the same f32 ops, one rounding of the emitted states).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as pl

F32_OUT, F32_GRAD, STEP_PARAM, STEP_LOSS, BF16 = 1e-5, 1e-4, 1e-4, 1e-5, 2e-2


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    peng.reset_uids()
    jeng.reset_uids()
    yield
    pctx.reset_zoo_context()
    jctx.reset_zoo_context()
    peng.set_policy()
    jeng.set_policy()


def _set_bf16():
    jeng.set_policy(compute_dtype=jnp.bfloat16)
    peng.set_policy(compute_dtype=torch.bfloat16)


def _redraw(tree, rng, scale=0.5):
    """Every leaf of a JAX param tree redrawn from a numpy seed."""
    if isinstance(tree, dict):
        return {k: _redraw(v, rng, scale) for k, v in tree.items()}
    return (rng.normal(size=np.shape(tree)) * scale).astype(np.float32)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_close(got, want, tol, scaled=False, err_msg=""):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape, err_msg)
    atol = tol * max(1.0, float(np.abs(want).max())) if scaled else tol
    np.testing.assert_allclose(got, want, atol=atol, rtol=tol,
                               err_msg=err_msg)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

#: name: (builder taking the layers module, input shape)
CASES = {
    "simplernn_seq": (lambda L: L.SimpleRNN(4, return_sequences=True), 5),
    "simplernn_last_bwd": (lambda L: L.SimpleRNN(4, go_backwards=True), 5),
    "lstm_seq": (lambda L: L.LSTM(4, return_sequences=True), 5),
    "lstm_last": (lambda L: L.LSTM(4), 5),
    "lstm_seq_bwd": (lambda L: L.LSTM(4, return_sequences=True,
                                      go_backwards=True), 5),
    "lstm_last_bwd": (lambda L: L.LSTM(4, go_backwards=True), 5),
    "lstm_sigmoid_relu": (lambda L: L.LSTM(5, activation="relu",
                                           inner_activation="sigmoid",
                                           return_sequences=True), 3),
    "gru_seq": (lambda L: L.GRU(4, return_sequences=True), 5),
    "gru_last": (lambda L: L.GRU(4), 5),
    "gru_seq_bwd": (lambda L: L.GRU(4, return_sequences=True,
                                    go_backwards=True), 5),
    "gru_last_bwd": (lambda L: L.GRU(6, go_backwards=True), 5),
    "bidir_lstm_concat": (lambda L: L.Bidirectional(
        L.LSTM(4, return_sequences=True)), 5),
    "bidir_gru_sum": (lambda L: L.Bidirectional(
        L.GRU(4, return_sequences=True), merge_mode="sum"), 5),
    "bidir_lstm_mul_last": (lambda L: L.Bidirectional(
        L.LSTM(3), merge_mode="mul"), 5),
    "bidir_rnn_ave_bwd": (lambda L: L.Bidirectional(
        L.SimpleRNN(4, return_sequences=True, go_backwards=True),
        merge_mode="ave"), 5),
    "bidir_gru_concat_last_bwd": (lambda L: L.Bidirectional(
        L.GRU(3, go_backwards=True)), 5),
}
T = 7


def _pair(name):
    build, d = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    jlayer, player = build(jl), build(pl)
    tree = _redraw(jlayer.build(jax.random.key(0), (None, T, d)), rng)
    player.build((None, T, d), generator=torch.Generator())
    peng.load_param_tree(player, tree)
    x = rng.normal(size=(3, T, d)).astype(np.float32)
    return jlayer, player, tree, x


@pytest.mark.parametrize("name", sorted(CASES))
def test_recurrent_forward_f32_matches_jax(name):
    jlayer, player, tree, x = _pair(name)
    want = np.asarray(jax.jit(jlayer.call)(_jtree(tree), jnp.asarray(x)))
    got = player(torch.from_numpy(x)).detach()
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), want, F32_OUT)
    shape = player.compute_output_shape((None, T, x.shape[-1]))
    assert tuple(shape[1:]) == want.shape[1:]


@pytest.mark.parametrize("name", sorted(CASES))
def test_recurrent_gradients_f32_match_jax(name):
    jlayer, player, tree, x = _pair(name)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = player(xt)
    r = np.random.default_rng(7).normal(size=tuple(yt.shape)).astype(
        np.float32)
    (yt * torch.from_numpy(r)).sum().backward()

    def f(params, xx):
        return jnp.sum(jlayer.call(params, xx) * r)

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(_jtree(tree),
                                                  jnp.asarray(x))
    flat = peng.flatten_tree(jax.tree.map(np.asarray, gp))
    grads = {n.replace(".", "/"): p.grad for n, p in
             player.named_parameters()}
    assert sorted(grads) == sorted(flat)
    _assert_close(xt.grad.numpy(), gx, F32_GRAD, scaled=True)
    for n in flat:
        _assert_close(grads[n].numpy(), flat[n], F32_GRAD, scaled=True,
                      err_msg=n)


@pytest.mark.parametrize("name", sorted(CASES))
def test_recurrent_forward_bf16_matches_jax(name):
    """bf16 compute: the input projection f32 over bf16 operands, the
    carry f32 with ``U`` rounded to bf16, only the emitted states bf16."""
    jlayer, player, tree, x = _pair(name)
    _set_bf16()
    want = np.asarray(jax.jit(jlayer.call)(_jtree(tree), jnp.asarray(
        x).astype(jnp.bfloat16)).astype(jnp.float32))
    got = player(torch.from_numpy(x).to(torch.bfloat16)).detach()
    assert got.dtype == torch.bfloat16
    _assert_close(got.float().numpy(), want, BF16, scaled=True)


def test_bf16_carry_stays_f32_and_projection_unrounded():
    """Under the bf16 policy the final carry is f32 and the states are
    the f32 recurrence rounded once: against an f32 run of the same
    layer whose W, U and x are pre-rounded to bf16, the bf16 run's states
    are those f32 states rounded to bf16, bit for bit, and its carry is
    them unrounded."""
    rng = np.random.default_rng(3)
    layer = pl.LSTM(6, return_sequences=True)
    layer.build((None, T, 5), generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.normal(size=(2, T, 5)).astype(np.float32))
    with torch.no_grad():
        for p in (layer.W, layer.U):
            p.copy_(p.to(torch.bfloat16).float())
        ref_hs, (ref_h, ref_c) = layer.run(x.to(torch.bfloat16).float())
        _set_bf16()
        hs, (h, c) = layer.run(x)
    assert hs.dtype == torch.bfloat16
    assert h.dtype == c.dtype == torch.float32
    assert torch.equal(hs, ref_hs.to(torch.bfloat16))
    assert torch.equal(h, ref_h) and torch.equal(c, ref_c)


@pytest.mark.parametrize("cls", ["LSTM", "GRU", "SimpleRNN"])
def test_run_from_a_given_carry_matches_jax(cls):
    """``run(x, carry0)`` (how a Seq2seq decoder starts from bridged
    states): the states and the final carry."""
    rng = np.random.default_rng(11)
    jlayer, player = getattr(jl, cls)(4), getattr(pl, cls)(4)
    tree = _redraw(jlayer.build(jax.random.key(0), (None, T, 3)), rng)
    player.build((None, T, 3), generator=torch.Generator())
    peng.load_param_tree(player, tree)
    x = rng.normal(size=(2, T, 3)).astype(np.float32)
    h0 = rng.normal(size=(2, 4)).astype(np.float32)
    c0 = rng.normal(size=(2, 4)).astype(np.float32)
    carry = (h0, c0) if cls == "LSTM" else h0
    jhs, jcarry = jlayer.run(_jtree(tree), jnp.asarray(x),
                             jax.tree.map(jnp.asarray, carry))
    phs, pcarry = player.run(torch.from_numpy(x), jax.tree.map(
        torch.from_numpy, carry))
    _assert_close(phs.detach().numpy(), jhs, F32_OUT)
    for g, w in zip(jax.tree.leaves(jax.tree.map(
            lambda t: t.detach().numpy(), pcarry)), jax.tree.leaves(jcarry)):
        _assert_close(g, w, F32_OUT)


def test_bidirectional_backward_copy_is_named_and_flipped():
    inner = pl.GRU(4, go_backwards=True, name="enc")
    bi = pl.Bidirectional(inner)
    assert bi.fwd is inner and bi.bwd is not inner
    assert bi.bwd.name == "enc_bwd" and bi.bwd.go_backwards is False
    bi.build((None, T, 3), generator=torch.Generator())
    names = [n for n, _ in bi.named_parameters()]
    assert names == ["forward.W", "forward.U", "forward.b",
                     "backward.W", "backward.U", "backward.b"]
    assert bi.fwd.W is not bi.bwd.W
    with pytest.raises(ValueError, match="merge_mode"):
        pl.Bidirectional(pl.LSTM(2), merge_mode="max")


def test_recurrent_layers_stack_in_a_sequential_fit():
    """``GRU(return_sequences)`` into pooling (``test_architectures.py``'s
    GRU case) and an ``LSTM`` classifier: a Sequential of the port's
    layers fits as the JAX one does, from the same weights (Adam, two
    epochs of two steps, unshuffled)."""
    conf = {"zoo.seed": 0}
    jctx.init_zoo_context(conf=conf)
    pctx.init_zoo_context(conf=conf)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(32, 6, 3)).astype(np.float32)
    y = (x.mean(axis=(1, 2)) > 0).astype(np.float32)[:, None]

    def layers(L):
        return [L.GRU(8, return_sequences=True, input_shape=(6, 3)),
                L.LSTM(5, go_backwards=True), L.Dense(1,
                                                      activation="sigmoid")]

    jm = jeng.Sequential(layers(jl))
    jm.init_weights(rng=jax.random.key(3))
    tree = jax.tree.map(np.asarray, jm.params)
    pm = peng.Sequential(layers(pl), device="cpu")
    pm.load_jax_params(tree)
    jm.compile(optimizer="adam", loss="bce", lr=0.02)
    pm.compile(optimizer="adam", loss="bce", lr=0.02)
    want = jm.fit(x, y, batch_size=16, nb_epoch=2, shuffle=False)["loss"]
    got = pm.fit(x, y, batch_size=16, nb_epoch=2, shuffle=False)["loss"]
    np.testing.assert_allclose(got, want, atol=STEP_LOSS, rtol=0)
    jp = peng.flatten_tree(jax.tree.map(np.asarray, jm.params))
    pp = {n.replace(".", "/"): p.detach().numpy()
          for n, p in pm.named_parameters()}
    for n in jp:
        np.testing.assert_allclose(pp[n], jp[n], atol=STEP_PARAM, rtol=0,
                                   err_msg=n)
