"""``zoo.train.remat`` in the port held to the JAX package and to itself:
the mode spellings and their error, the remat'd fit of a small causal LM
against the JAX fit under the same mode and against the port's own fit
without remat (bit for bit, dropout on too: the recompute redraws the
forward's masks), remat composed with the fused LM-head loss and the
multi-step dispatch, the guarded step, the memory the backward keeps,
and the forward kernels' plain versions called again in the recompute,
as the JAX gradient's jaxpr holds their ``pallas_call`` twice.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do on the CPU. Tolerances against JAX are ``test_lm_fit_matches_jax``'s
(``tests/test_torch_port_lm.py``: f32 losses and parameters 1e-5
absolute, the same arithmetic in another order through Adam); the port
against itself is bit for bit, since the recompute runs the same ops on
the same inputs.
"""

import collections
import gc
import importlib
import os
import subprocess
import sys
import weakref

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JaxSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.api.keras.fused_loss import \
    resolve_fused_loss as j_resolve_fused_loss
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.ops import fused_cross_entropy as pfce
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import training as ptr
from analytics_zoo_tpu_torch.pipeline.api.keras.training import (
    remat, remat_mode, step_generator)
from test_torch_port_lm import (FIT_TOL, LM, _assert_params_close,
                                _assert_updates_close, _lm_data,
                                _np_params, _port_lm)

pfa = importlib.import_module(
    "analytics_zoo_tpu_torch.ops.pallas.flash_attention")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = [False, True, "dots", "full"]
PALLAS = {"zoo.pallas.attention": True, "zoo.pallas.cross_entropy": True,
          "zoo.train.fused_ce": True, "zoo.seed": 0}


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    yield
    pctx.reset_zoo_context()
    jctx.reset_zoo_context()


def _port_fit(conf, lm=None, nb_epoch=2):
    """A fresh small LM (the same seeded weights each call) fitted under
    ``conf``: ``(losses, step losses, params)``."""
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf=conf)
    m = Sequential_lm(lm)
    m.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
    x, y = _lm_data()
    losses = m.fit(x, y, batch_size=8, nb_epoch=nb_epoch)["loss"]
    return losses, np.concatenate(m._loop.step_losses), _np_params(m)


def Sequential_lm(lm=None):
    """``_port_lm`` with ``lm``'s overrides of the layer's arguments."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense, TransformerLayer)
    cfg = {**LM, **(lm or {})}
    m = Sequential([TransformerLayer(**cfg, input_shape=(cfg["seq_len"],)),
                    Dense(cfg["vocab"])], device="cpu")
    m.init_weights(torch.Generator().manual_seed(1))
    return m


def _assert_bits(a, b):
    for name in b:
        assert np.array_equal(np.asarray(a[name]).view(np.uint32),
                              np.asarray(b[name]).view(np.uint32)), name


# ---------------------------------------------------------------------------
# the mode spellings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,want", [
    (False, None), (True, "dots"), ("false", None), ("off", None),
    ("none", None), ("", None), ("True", "dots"), ("1", "dots"),
    ("dots", "dots"), ("DOTS_WITH_NO_BATCH_DIMS_SAVEABLE", "dots"),
    ("full", "full"), (" all ", "full"), ("nothing_saveable", "full")])
def test_remat_mode_spellings(value, want):
    assert remat_mode(value) == want


def test_remat_rejects_unknown_mode_with_the_jax_message():
    """``bogus`` raises the JAX loop's ``ValueError``, word for word."""
    x, y = _lm_data()
    conf = {**PALLAS, "zoo.train.remat": "bogus"}
    jctx.init_zoo_context(conf=conf)
    jm = JaxSequential([jl.TransformerLayer(**LM,
                                            input_shape=(LM["seq_len"],)),
                        jl.Dense(LM["vocab"])])
    jm.init_weights(rng=jax.random.key(3))
    jm.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
    with pytest.raises(ValueError) as want:
        jm.fit(x, y, batch_size=8, nb_epoch=1)
    pctx.init_zoo_context(conf=conf)
    m = _port_lm()
    m.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
    with pytest.raises(ValueError) as got:
        m.fit(x, y, batch_size=8, nb_epoch=1)
    assert str(got.value) == str(want.value)
    assert "zoo.train.remat must be false|true|dots|full" in str(got.value)


def test_remat_defaults_off_and_resolves_once_per_loop():
    pctx.init_zoo_context(conf=PALLAS)
    m = _port_lm()
    m.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
    assert m._loop._resolve_remat() is None
    assert m._loop.remat_mode is None
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf={**PALLAS, "zoo.train.remat": "full"})
    # resolved already: the loop keeps its mode
    assert m._loop._resolve_remat() is None
    m.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
    assert m._loop._resolve_remat() == "full"
    assert m._loop.remat_mode == "full"


# ---------------------------------------------------------------------------
# the fit: against the JAX fit and against the port's own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_remat_fit_matches_jax_and_its_own_unremat_fit(mode):
    """Same weights, batch order and flags as ``test_lm_fit_matches_jax``
    (f32), under ``zoo.train.remat = mode`` on both sides: the port's
    losses and parameters against the JAX fit's at that test's bounds,
    and against the port's fit without remat bit for bit."""
    tol = FIT_TOL["float32"]
    conf = {**PALLAS, "zoo.train.remat": mode}
    jctx.init_zoo_context(conf=conf)
    jm = JaxSequential([jl.TransformerLayer(**LM,
                                            input_shape=(LM["seq_len"],)),
                        jl.Dense(LM["vocab"])])
    jm.init_weights(rng=jax.random.key(3))
    tree = jax.tree.map(np.asarray, jm.params)
    p0 = peng.flatten_tree(tree)
    x, y = _lm_data()
    jm.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
    want = jm.fit(x, y, batch_size=8, nb_epoch=2)["loss"]
    jp = peng.flatten_tree(jax.tree.map(np.asarray, jm.params))

    runs = {}
    for key in ("off", "on"):
        pctx.reset_zoo_context()
        pctx.init_zoo_context(conf=conf if key == "on" else PALLAS)
        pm = _port_lm(tree=tree)
        pm.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
        runs[key] = (pm.fit(x, y, batch_size=8, nb_epoch=2)["loss"],
                     _np_params(pm))
        assert pm._loop.remat_mode == (remat_mode(mode) if key == "on"
                                       else None)
    got, pp = runs["on"]
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(runs["off"][0], np.float32))
    _assert_bits(pp, runs["off"][1])
    np.testing.assert_allclose(got, want, atol=tol["loss"], rtol=0)
    _assert_params_close(pp, jp, tol["param"])
    _assert_updates_close(pp, jp, p0, tol["update"])


@pytest.mark.parametrize("scan_steps", [1, 4])
@pytest.mark.parametrize("mode", ["dots", "full"])
def test_remat_redraws_the_forwards_dropout_masks(mode, scan_steps):
    """Hidden dropout 0.1 (the port alone: torch's and JAX's streams never
    agree): the remat'd fit gives the bits of the fit without remat, on
    the eager loop and on the multi-step program. A recompute drawing new
    masks would differentiate another forward than the loss's."""
    lm = {"hidden_drop": 0.1, "embedding_drop": 0.1}
    base = {**PALLAS, "zoo.train.scan_steps": scan_steps}
    off = _port_fit(base, lm)
    on = _port_fit({**base, "zoo.train.remat": mode}, lm)
    np.testing.assert_array_equal(on[1], off[1])
    _assert_bits(on[2], off[2])
    # the masks are live: the same fit with dropout 0 differs
    assert not np.array_equal(_port_fit(base)[1], off[1])


def test_remat_without_the_redraw_differentiates_another_forward(
        monkeypatch):
    """The guard above has teeth: with the redraw disabled the remat'd
    fit leaves the un-remat'd one."""
    import contextlib

    from analytics_zoo_tpu_torch.common import noise

    @contextlib.contextmanager
    def no_redraw(generator, stashed):
        yield
    lm = {"hidden_drop": 0.1}
    off = _port_fit(PALLAS, lm)
    monkeypatch.setattr(noise, "redraw", no_redraw)
    on = _port_fit({**PALLAS, "zoo.train.remat": "full"}, lm)
    assert not np.array_equal(on[1], off[1])


def test_remat_composes_with_fused_ce_and_scan_steps():
    """The JAX contract (``tests/test_fused_ce.py:426``): remat with the
    fused loss and ``scan_steps`` 4 gives the eager fit's losses (here
    bit for bit: on the CPU the program runs its steps as they are)."""
    eager = _port_fit(PALLAS, nb_epoch=3)
    fused = _port_fit({**PALLAS, "zoo.train.remat": True,
                       "zoo.train.scan_steps": 4}, nb_epoch=3)
    np.testing.assert_array_equal(fused[1], eager[1])
    _assert_bits(fused[2], eager[2])


@pytest.mark.parametrize("mode", ["dots", "full"])
def test_remat_under_the_guarded_step_with_clipping(mode):
    """``guarded_step`` (sentinel warn, global-norm clipping that
    engages) runs the remat'd forward too: the same bits as without."""
    guard = {**PALLAS, "zoo.train.sentinel": "warn",
             "zoo.train.grad_clip": 0.05}
    off = _port_fit(guard)
    on = _port_fit({**guard, "zoo.train.remat": mode})
    np.testing.assert_array_equal(on[1], off[1])
    _assert_bits(on[2], off[2])
    # clipping engaged: an unclipped fit differs
    assert not np.array_equal(_port_fit(PALLAS)[1], off[1])


# ---------------------------------------------------------------------------
# what the backward keeps, and what it runs again
# ---------------------------------------------------------------------------

class _Outputs(TorchDispatchMode):
    """Weak references to every tensor an op makes while active."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.refs.append(weakref.ref(t))
        return out


def _kept_bytes(mode):
    """One training forward and loss of the small LM (hidden 64, so the
    dense products are not the smallest tensors) under ``mode``: the
    bytes autograd packs for the backward (``saved_tensors_hooks``) and
    the bytes of the distinct storages the forward made that are still
    alive when it returns, the loss aside (what the backward keeps,
    selective checkpointing's cache of the ``dots`` products included,
    which no hook sees)."""
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf={**PALLAS, "zoo.train.remat": mode})
    m = Sequential_lm({"hidden_size": 64})
    m.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
    loop = m._loop
    x, y = (torch.from_numpy(a) for a in _lm_data())
    packed = []

    def pack(t):
        packed.append(t.untyped_storage().nbytes())
        return t

    fn = loop._loss_application()
    if loop._resolve_remat() is not None:
        fn = remat(fn, loop.remat_mode)
    mode_ = _Outputs()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with mode_:
            loss = fn(x, y, step_generator(0, 0))
    gc.collect()
    alive = {}
    for ref in mode_.refs:
        t = ref()
        if t is not None and t is not loss:
            st = t.untyped_storage()
            alive[st.data_ptr()] = st.nbytes()
    loss.backward()
    return sum(packed), sum(alive.values())


def test_saved_bytes_fall_from_false_to_dots_to_full():
    (hook_off, kept_off), (hook_dots, kept_dots), (hook_full, kept_full) = (
        _kept_bytes(m) for m in (False, "dots", "full"))
    assert kept_off > kept_dots > kept_full, (kept_off, kept_dots, kept_full)
    assert hook_off > hook_dots and hook_off > hook_full
    # full keeps nothing of the activations: its hooks see the
    # checkpoint's inputs at most
    assert kept_full < kept_dots / 4


def _jax_forward_kernel_calls(policy):
    """The forward kernels' ``pallas_call`` equations in the JAX
    gradient's jaxpr of the small LM's fused loss, by kernel, under
    ``jax.checkpoint(policy)`` (None: no remat)."""
    jctx.init_zoo_context(conf=PALLAS)
    jm = JaxSequential([jl.TransformerLayer(**LM,
                                            input_shape=(LM["seq_len"],)),
                        jl.Dense(LM["vocab"])])
    jm.init_weights(rng=jax.random.key(3))
    jm.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
    spec = j_resolve_fused_loss(jm, jm._loop.loss)
    x, y = _lm_data()

    def loss(p):
        return spec.apply_and_loss(jm, p, jm.net_state, x, y, rng=None)[0]

    fn = loss if policy is None else jax.checkpoint(loss, policy=policy)
    counts = collections.Counter()

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                info = eqn.params["jaxpr"].debug_info.func_src_info
                counts[info.split(" ")[0]] += 1
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                        walk(sub.jaxpr)
    walk(jax.make_jaxpr(jax.grad(fn))(jm.params).jaxpr)
    return counts


@pytest.mark.parametrize("mode,policy", [
    (False, None),
    ("dots", "dots_with_no_batch_dims_saveable"),
    ("full", "nothing_saveable")])
def test_forward_kernels_run_again_in_the_recompute(mode, policy,
                                                    monkeypatch):
    """One step of the small LM: K2's and K4's plain versions are called
    once a block (head) without remat and twice under ``dots`` and
    ``full``, as the JAX gradient holds ``_fwd_kernel`` and
    ``_ce_fwd_kernel`` once or twice under the same policy; the backward
    kernels once either way."""
    want = _jax_forward_kernel_calls(
        None if policy is None else getattr(jax.checkpoint_policies,
                                            policy))
    calls = collections.Counter()
    for module, name, key in (
            (pfa, "flash_attention_reference", "_fwd_kernel"),
            (pfce, "fused_ce_forward_reference", "_ce_fwd_kernel"),
            (pfa, "bwd_dq_reference", "_bwd_dq_kernel"),
            (pfa, "bwd_dkv_reference", "_bwd_dkv_kernel")):
        real = getattr(module, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(module, name, counted)
    pctx.init_zoo_context(conf={**PALLAS, "zoo.train.remat": mode})
    m = _port_lm()
    m.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
    loop = m._loop
    x, y = (torch.from_numpy(a) for a in _lm_data())
    loop._grads(x[:8], y[:8], step_generator(0, 0), loop._params())
    blocks = 2 if mode else 1
    assert calls["_fwd_kernel"] == LM["n_block"] * blocks
    assert calls["_ce_fwd_kernel"] == blocks
    for key in ("_fwd_kernel", "_ce_fwd_kernel", "_bwd_dq_kernel",
                "_bwd_dkv_kernel"):
        assert calls[key] == want[key], (key, dict(calls), dict(want))


def test_remat_leaves_no_kernel_output_in_the_dots_cache():
    """The ``dots`` policy keeps the outputs of ``aten.mm``/``addmm``
    only; the kernels' outputs come from ``empty`` allocations, which it
    recomputes."""
    from torch.utils.checkpoint import CheckpointPolicy
    keep = {op for op in (torch.ops.aten.mm.default,
                          torch.ops.aten.addmm.default,
                          torch.ops.aten.bmm.default,
                          torch.ops.aten.empty.memory_format,
                          torch.ops.aten.empty_like.default,
                          torch.ops.aten.zeros.default)
            if ptr._keep_dots(None, op) is CheckpointPolicy.MUST_SAVE}
    assert keep == {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def test_remat_wrapper_is_numerics_preserving_on_a_direct_call():
    """:func:`remat` around a forward and loss with dropout: the loss and
    the gradients of one call equal the plain call's bit for bit."""
    pctx.init_zoo_context(conf=PALLAS)
    m = Sequential_lm({"hidden_drop": 0.2})
    m.compile(optimizer="adam", loss="scce_with_logits", lr=1e-2)
    loop = m._loop
    x, y = (torch.from_numpy(a[:8]) for a in _lm_data())
    fn = loop._loss_application()
    results = []
    for wrap in (lambda f: f, lambda f: remat(f, "dots"),
                 lambda f: remat(f, "full")):
        params = loop._params()
        for p in params.values():
            p.grad = None
        loss = wrap(fn)(x, y, step_generator(0, 7))
        loss.backward()
        results.append((loss.detach(), {n: p.grad.clone()
                                        for n, p in params.items()}))
    for loss, grads in results[1:]:
        assert torch.equal(loss, results[0][0])
        for n, g in grads.items():
            assert torch.equal(g, results[0][1][n]), n


def test_remat_modules_import_no_jax():
    code = (
        "import sys\n"
        "import analytics_zoo_tpu_torch.pipeline.api.keras.training\n"
        "import analytics_zoo_tpu_torch.pipeline.api.keras.dispatch\n"
        "import analytics_zoo_tpu_torch.common.noise\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'analytics_zoo_tpu' or "
        "n.startswith('analytics_zoo_tpu.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
