"""C8, the static int8 conv, on the CPU: its wgmma routes' pieces held to
the JAX package and to its plain version.

* The weight repack (HWIO read as (K, F), transposed to (F, K)) and a
  plain implicit GEMM over it give ``static_int8_conv2d_reference``'s bits
  and the JAX ``Convolution2D.quantized_call``'s, at C in {3, 16, 48, 64},
  stride 2, dilation 2, XLA's asymmetric ``SAME`` pads and M and F edges
  that are not multiples of the tiles.
* The quantize pass's plain version is the JAX quantize, bit for bit.
* The route follows the shape (``conv_plan``), and the wrapper launches
  what the plan says, with the launch faked (no nvcc or card here).
* A static int8 model repacks its conv weights once, at install, into a
  buffer that no ``.npz``, checkpoint or param tree carries; each of those
  reads back bit for bit.

Every comparison is bit for bit: the int8 products are exact and the f32
epilogue runs in the JAX order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.models.common import zoo_model as jzoo
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.models.image.imageclassification import \
    ImageClassifier as PImageClassifier
from analytics_zoo_tpu_torch.ops.pallas import quantized as pq
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.convolution import (
    Convolution2D, same_pads)
from analytics_zoo_tpu_torch.pipeline.api.keras.training import _param_tree
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    peng.reset_uids()
    jeng.reset_uids()
    jctx.init_zoo_context(conf={"zoo.seed": 0})
    yield
    pctx.reset_zoo_context()
    jctx.reset_zoo_context()


#: (b, h, w, c, f, kh, kw, stride, dilation, border, relu); M = b * Ho *
#: Wo and F are not multiples of C8's tiles (128 pixels, 64 or 128
#: filters)
GEMM_CASES = [
    (2, 9, 9, 3, 5, 3, 3, 1, 1, "same", True),
    (2, 12, 12, 16, 24, 3, 3, 2, 1, "same", True),    # (0, 1) pads
    (1, 11, 12, 48, 7, 3, 2, 2, 2, "valid", False),
    (2, 8, 8, 64, 130, 3, 3, 1, 2, "same", True),     # atrous, F past 128
    (3, 13, 11, 16, 64, 7, 7, 2, 1, "same", False),   # 7x7/2: (2, 3) pads
    (1, 10, 10, 64, 64, 1, 1, 1, 1, "valid", True),
    (2, 7, 7, 48, 66, 3, 3, 1, 1, "same", True),
]


def _operands(case):
    b, h, w, c, f, kh, kw, s, d, border, relu = case
    rng = np.random.default_rng(b * h * w + c * f)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    W = rng.integers(-127, 128, size=(kh, kw, c, f)).astype(np.int8)
    ws = (rng.random(f) * 0.01 + 1e-3).astype(np.float32)
    bias = rng.normal(size=f).astype(np.float32)
    xs = np.float32(np.abs(x).max() / 127)
    x.reshape(-1)[:3] = np.array([0.5, -2.5, 3.5], np.float32) * xs  # ties
    pads = ([same_pads(n, k, s, d) for n, k in ((h, kh), (w, kw))]
            if border == "same" else [(0, 0), (0, 0)])
    return x, W, ws, bias, xs, pads


def _jax_want(case, x, W, ws, bias, xs):
    b, h, w, c, f, kh, kw, s, d, border, relu = case
    layer = jl.Convolution2D(f, kh, kw, subsample=(s, s), dilation=(d, d),
                             border_mode=border,
                             activation="relu" if relu else None)
    return np.asarray(layer.quantized_call(
        {"W": jnp.asarray(W), "w_scale": jnp.asarray(ws),
         "x_scale": jnp.asarray(xs), "b": jnp.asarray(bias)},
        jnp.asarray(x)))


def _kmajor_gemm(xq, wk, kh, kw, s, d, pads):
    """The plain implicit GEMM C8's wgmma routes run: im2col rows of the
    int8 input with k = (r * kw + s') * C + c, times the (F, K) repack,
    exact in int64."""
    (lh, hh), (lw, hw) = pads
    xp = F.pad(xq, (0, 0, lw, hw, lh, hh))
    cols = xp.unfold(1, (kh - 1) * d + 1, s).unfold(2, (kw - 1) * d + 1, s)
    cols = cols[..., ::d, ::d]                # (B, Ho, Wo, C, kh, kw)
    b, ho, wo = cols.shape[:3]
    a = cols.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, -1)
    acc = a.long() @ wk.long().t()
    return acc.to(torch.int32).reshape(b, ho, wo, -1)


@pytest.mark.parametrize("case", GEMM_CASES)
def test_repacked_plain_gemm_is_jax_quantized_call_bit_for_bit(case):
    b, h, w, c, f, kh, kw, s, d, border, relu = case
    x, W, ws, bias, xs, pads = _operands(case)
    want = _jax_want(case, x, W, ws, bias, xs)
    tx, txs, tW = torch.from_numpy(x), torch.tensor(xs), torch.from_numpy(W)
    tws, tb = torch.from_numpy(ws), torch.from_numpy(bias)
    ref = pq.static_int8_conv2d_reference(tx, txs, tW, tws, tb, relu,
                                          (s, s), (d, d), pads)
    np.testing.assert_array_equal(ref.numpy(), want)
    wk = pq.repack_conv_weight(tW)
    assert wk.shape == (f, kh * kw * c) and wk.is_contiguous()
    acc = _kmajor_gemm(pq.static_int8_quantize(tx, txs), wk, kh, kw, s, d,
                       pads)
    y = acc.float() * (txs * tws) + tb
    if relu:
        y = torch.relu(y)
    np.testing.assert_array_equal(y.numpy(), want)
    # the wrapper takes the repack and still runs the plain version here
    np.testing.assert_array_equal(pq.static_int8_conv2d(
        tx, txs, tW, tws, tb, relu, (s, s), (d, d), pads,
        w_kmajor=wk).numpy(), want)


def test_repack_is_the_hwio_weight_read_as_k_by_f_transposed():
    g = torch.Generator().manual_seed(3)
    W = torch.randint(-127, 128, (3, 2, 16, 5), generator=g,
                      dtype=torch.int8)
    wk = pq.repack_conv_weight(W)
    for r, s, c, f in [(0, 0, 0, 0), (2, 1, 15, 4), (1, 0, 7, 2)]:
        assert wk[f, (r * 2 + s) * 16 + c] == W[r, s, c, f]
    assert torch.equal(wk, pq.repack_conv_weight_reference(W))
    with pytest.raises(ValueError, match="int8 HWIO"):
        pq.repack_conv_weight(W.float())


def test_quantize_pass_plain_version_is_jax_quantize_bit_for_bit():
    """``static_int8_quantize`` on the CPU runs the quantize pass's plain
    version, ``quantize_static``; both give the JAX ``quantized_call``'s
    ``clip(round(x / x_scale), -127, 127)`` as int8, over half-way
    quotients (round half to even), the clip, zeros and an odd length."""
    rng = np.random.default_rng(7)
    xs = np.float32(0.0371)
    x = np.concatenate([
        rng.normal(size=1001).astype(np.float32) * 3,
        (np.arange(-130, 131, dtype=np.float32) + 0.5) * xs,
        np.array([0.0, -0.0, 1e6, -1e6, 127.5 * xs, -127.5 * xs],
                 np.float32)])
    want = np.asarray(jax.jit(lambda a, s: jnp.clip(
        jnp.round(a / s), -127, 127).astype(jnp.int8))(x, xs))
    got = pq.static_int8_quantize(torch.from_numpy(x), torch.tensor(xs))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        pq.quantize_static(torch.from_numpy(x), torch.tensor(xs)).numpy(),
        want)
    with pytest.raises(ValueError, match="one x_scale"):
        pq.static_int8_quantize(torch.from_numpy(x), torch.ones(2))


# ---------------------------------------------------------------------------
# the route by shape
# ---------------------------------------------------------------------------

#: VGG-16's convs at 112 pixels (c, f, hw) and the route each takes on 132
#: SMs at batch 32 and batch 1
VGG_ROUTES = [
    ((3, 64, 112), "c8_small_c", "c8_small_c"),
    ((64, 64, 112), "c8_wgmma", "c8_wgmma"),
    ((64, 128, 56), "c8_wgmma", "c8_split"),
    ((128, 128, 56), "c8_wgmma", "c8_split"),
    ((128, 256, 28), "c8_wgmma", "c8_split"),
    ((256, 256, 28), "c8_wgmma", "c8_split"),
    ((256, 512, 14), "c8_wgmma", "c8_split"),
    ((512, 512, 14), "c8_wgmma", "c8_split"),
    ((512, 512, 7), "c8_split", "c8_split"),
]


def _check_plan(plan, m, f, k, c, sms):
    route, tn, splits, per = plan
    steps = -(-k // (32 if route == "c8_small_c" else 128))
    assert (splits - 1) * per < steps <= splits * per
    if route == "c8_small_c":
        assert c % 16 != 0 and tn == 64
        if splits > 1:
            assert per >= 4
    else:
        assert c % 16 == 0 and tn == (64 if f <= 64 else 128)
        tiles = -(-m // 128) * -(-f // tn)
        assert (route == "c8_split") == (splits > 1)
        if splits > 1:
            assert per >= 2 and 2 * tiles <= sms
            assert splits <= -(-2 * sms // tiles)


@pytest.mark.parametrize("shape,b32,b1", VGG_ROUTES)
def test_vgg16_convs_take_their_routes(shape, b32, b1):
    c, f, hw = shape
    for batch, want in ((32, b32), (1, b1)):
        m, k = batch * hw * hw, 9 * c
        plan = pq.conv_plan(m, f, k, c, 132)
        assert plan[0] == want, (batch, shape, plan)
        _check_plan(plan, m, f, k, c, 132)


@pytest.mark.parametrize("c,route", [(3, "c8_small_c"), (4, "c8_small_c"),
                                     (24, "c8_small_c"), (16, "c8_wgmma"),
                                     (48, "c8_wgmma"), (64, "c8_wgmma"),
                                     (1024, "c8_wgmma")])
@pytest.mark.parametrize("m,f,sms", [(401408, 64, 132), (25088, 256, 132),
                                     (49, 512, 132), (3136, 100, 78),
                                     (196, 7, 132)])
def test_route_follows_the_channels_and_the_tiles(c, route, m, f, sms):
    """``c % 16 == 0`` (a tap's channels are whole 16-byte chunks) takes
    the wgmma routes, split where the tiles fill less than half the SMs;
    the rest the quantize-on-load kernel, split where its tiles fill
    fewer than 4 blocks an SM."""
    for kh in (1, 3, 7):
        k = kh * kh * c
        plan = pq.conv_plan(m, f, k, c, sms)
        want = route
        if route == "c8_wgmma" and plan[2] > 1:
            want = "c8_split"
        assert plan[0] == want and pq.conv_takes_kmajor(c) == (
            route != "c8_small_c")
        _check_plan(plan, m, f, k, c, sms)


@pytest.mark.parametrize("case,route", [
    ((32, 14, 14, 3, 64, 3, 1, 1, True), "c8_small_c"),
    ((32, 28, 28, 64, 64, 3, 1, 1, True), "c8_wgmma"),
    ((1, 7, 7, 512, 512, 3, 1, 1, True), "c8_split"),
    ((2, 12, 12, 16, 24, 3, 2, 2, True), "c8_wgmma"),
])
@pytest.mark.parametrize("given", [False, True])
def test_wrapper_launches_the_planned_route(monkeypatch, case, route,
                                            given):
    """The CUDA branch of ``static_int8_conv2d`` with the library and the
    launch faked: the C entry point gets the plan's route code, tile,
    splits and K steps a split, the int8 input and the (F, K) repack on
    the wgmma routes (the f32 input and the HWIO weight on
    ``c8_small_c``), a workspace of M * F int32 only when K is split; the
    launch is counted in all and under its route. The operands are CPU
    tensors, which the fake launch never reads."""
    b, h, w, c, f, k, s, d, same = case
    g = torch.Generator().manual_seed(1)
    x = torch.randn(b, h, w, c, generator=g)
    xs = torch.tensor(0.05)
    wq = torch.randint(-127, 128, (k, k, c, f), generator=g,
                       dtype=torch.int8)
    ws, bias = torch.rand(f, generator=g), torch.randn(f, generator=g)
    pads = [same_pads(n, k, s, d) for n in (h, w)]
    wk = pq.repack_conv_weight(wq) if given else None
    calls = []

    def fake_launch(fn, tensor, *args):
        assert fn == "int8_static_conv2d"
        calls.append(args)
        return 0
    monkeypatch.setattr(pq.LIBRARY_CONV, "entry", lambda name: name)
    monkeypatch.setattr(pq, "launch", fake_launch)
    monkeypatch.setattr(pq, "_sm_count", lambda index: 132)
    seen = {}
    real_ptr = torch.Tensor.data_ptr

    def data_ptr(t):
        seen[real_ptr(t)] = t
        return real_ptr(t)
    monkeypatch.setattr(torch.Tensor, "data_ptr", data_ptr)
    before = (pq.KERNEL_INT8_CONV.launches,
              {n: r.launches for n, r in pq.KERNEL_INT8_CONV_ROUTES.items()})
    prev = (pq.LAST_CONV_LAUNCH.route, pq.LAST_CONV_LAUNCH.splits)
    try:
        out = pq._launch_conv(x, xs, wq, ws, bias, True, (s, s), (d, d),
                              pads, wk)
        (args,) = calls
        ho, wo = out.shape[1:3]
        m = b * ho * wo
        plan = pq.conv_plan(m, f, k * k * c, c, 132)
        assert plan[0] == route
        assert list(args[-4:]) == [pq.CONV_ROUTES[route], *plan[1:]]
        src, wsrc = seen[args[0]], seen[args[2]]
        if route == "c8_small_c":
            assert src.dtype == torch.float32 and wsrc.shape == wq.shape
        else:
            assert torch.equal(src, pq.quantize_static(x, xs))
            assert torch.equal(wsrc, pq.repack_conv_weight_reference(wq))
        assert args[8] == (m * f if plan[2] > 1 else 0)
        assert (args[7] is None) == (plan[2] == 1)
        assert pq.KERNEL_INT8_CONV.launches == before[0] + 1
        assert {n: r.launches for n, r in
                pq.KERNEL_INT8_CONV_ROUTES.items()} == {
            n: v + (n == route) for n, v in before[1].items()}
        assert pq.LAST_CONV_LAUNCH.route == route
        assert pq.LAST_CONV_LAUNCH.splits == plan[2]
    finally:
        pq.LAST_CONV_LAUNCH.route, pq.LAST_CONV_LAUNCH.splits = prev


def test_cpu_tensors_never_reach_c8s_launch_machinery(monkeypatch):
    """C8's three wrappers run their plain versions for CPU tensors: no
    plan, SM count, library or launch is touched and nothing is
    counted."""
    def refuse(*args, **kwargs):
        raise AssertionError("launch machinery reached for a CPU tensor")
    for name in ("launch", "_sm_count", "_launch_conv"):
        monkeypatch.setattr(pq, name, refuse)
    monkeypatch.setattr(pq.LIBRARY_CONV, "entry", refuse)
    counters = [pq.KERNEL_INT8_CONV, pq.KERNEL_INT8_CONV_QUANTIZE,
                pq.KERNEL_INT8_CONV_REPACK,
                *pq.KERNEL_INT8_CONV_ROUTES.values()]
    before = [c.launches for c in counters]
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 6, 6, 16, generator=g)
    xs = torch.tensor(0.02)
    wq = torch.randint(-127, 128, (3, 3, 16, 8), generator=g,
                       dtype=torch.int8)
    wk = pq.repack_conv_weight(wq)
    pq.static_int8_quantize(x, xs)
    pq.static_int8_conv2d(x, xs, wq, torch.ones(8), w_kmajor=wk)
    pq.static_int8_conv2d(x, xs, wq, torch.ones(8))
    assert [c.launches for c in counters] == before


def test_wrapper_refuses_a_w_kmajor_that_is_not_the_repack():
    x = torch.zeros(1, 5, 5, 16)
    xs, W = torch.ones(()), torch.zeros(3, 3, 16, 4, dtype=torch.int8)
    ws = torch.ones(4)
    for bad in (torch.zeros(4, 143, dtype=torch.int8),
                torch.zeros(144, 4, dtype=torch.int8),
                torch.zeros(4, 144)):
        with pytest.raises(ValueError, match="w_kmajor"):
            pq.static_int8_conv2d(x, xs, W, ws, w_kmajor=bad)


# ---------------------------------------------------------------------------
# the repack at install, and the saved formats
# ---------------------------------------------------------------------------

def _simple_cnn(seed=0):
    """``simple-cnn`` (a 3-channel conv, c8_small_c's, then a 16-channel
    one, the wgmma routes') on seeded weights."""
    m = PImageClassifier("simple-cnn", num_classes=3, input_shape=(8, 8, 3),
                         dropout=0.0, device="cpu")
    m.init_weights(torch.Generator().manual_seed(seed))
    return m


def _data(n=16):
    rng = np.random.default_rng(11)
    return (rng.normal(size=(n, 8, 8, 3)).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _served_convs(im):
    """The served copy's convs by path, in order: the 3-channel one
    first."""
    return {n: m for n, m in im._model.named_modules()
            if isinstance(m, Convolution2D)}


def test_install_repacks_each_wgmma_conv_once_into_an_unsaved_buffer():
    m = _simple_cnn()
    x, _ = _data()
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    im = InferenceModel(device="cpu").from_keras(m, quantize="int8",
                                                 calibrate=x[:8])
    convs = _served_convs(im)
    assert len(convs) == 2
    for name, layer in convs.items():
        c = layer.W.shape[2]
        if pq.conv_takes_kmajor(c):
            assert torch.equal(layer.W_kmajor,
                               pq.repack_conv_weight_reference(layer.W))
            assert "W_kmajor" in dict(layer.named_buffers())
        else:
            assert not hasattr(layer, "W_kmajor")
    net = im._model
    for keys in (net.state_dict(), dict(net.named_parameters()),
                 peng.named_state(net)):
        assert not any("W_kmajor" in k for k in keys)
    # the caller's model is left as it was
    assert not any("W_kmajor" in n for n, _ in m.named_buffers())
    for n, p in m.named_parameters():
        assert torch.equal(p, before[n])
    # a predict reads the buffer, never writes or remakes it
    wk = {n: layer.W_kmajor.clone() for n, layer in convs.items()
          if hasattr(layer, "W_kmajor")}
    y = im.predict(x)
    assert y.shape == (16, 3)
    for n, t in wk.items():
        assert torch.equal(convs[n].W_kmajor, t)


def test_static_int8_npz_reads_back_bit_for_bit(tmp_path):
    """The model's ``.npz``, written before and after a static install,
    holds the same arrays and no repacked leaf; a static runtime loaded
    from it predicts the in-memory install's bits; the JAX package reads
    the same ``.npz`` leaf for leaf."""
    m = _simple_cnn()
    x, _ = _data()
    first = _npz(m.save(str(tmp_path / "a.npz")))
    im = InferenceModel(device="cpu").from_keras(m, quantize="int8",
                                                 calibrate=x[:8])
    path = m.save(str(tmp_path / "b.npz"))
    second = _npz(path)
    assert first.keys() == second.keys()
    for k in first:
        np.testing.assert_array_equal(first[k], second[k])
    n_leaves = len(list(m.model.named_parameters())) + len(
        peng.named_state(m.model))
    assert len([k for k in second if k[:2] in ("p_", "s_")]) == n_leaves
    loaded = InferenceModel(device="cpu").load(path, quantize="int8",
                                               calibrate=x[:8])
    (_, a1), (_, a2) = _served_convs(loaded).items()
    (_, b1), (_, b2) = _served_convs(im).items()
    assert not hasattr(a1, "W_kmajor") and not hasattr(b1, "W_kmajor")
    assert torch.equal(a2.W_kmajor, b2.W_kmajor)
    np.testing.assert_array_equal(loaded.predict(x), im.predict(x))
    jm = jzoo.load_model(path)
    want = {n: p.detach().numpy() for n, p in m.model.named_parameters()}
    got = peng.flatten_tree(jax.tree.map(np.asarray, jm.params))
    assert set(got) == {n.replace(".", "/") for n in want}
    for n, a in want.items():
        np.testing.assert_array_equal(got[n.replace(".", "/")], a)


def test_static_int8_checkpoint_reads_back_bit_for_bit(tmp_path):
    """A training run's snapshot restores into a fresh model of the same
    architecture as a static int8 runtime whose predictions are the bits
    of the trained model's own static install: the snapshot's trees match
    the architecture key for key (no repacked leaf), before and after an
    install."""
    m = _simple_cnn()
    x, y = _data()
    m.compile(optimizer="sgd", loss="scce", lr=0.01)
    m.set_checkpoint(str(tmp_path / "ckpt"))
    m.fit(x, y, batch_size=8, nb_epoch=1)
    want = InferenceModel(device="cpu").from_keras(
        m, quantize="int8", calibrate=x[:8]).predict(x)
    fresh = _simple_cnn(seed=1)
    im = InferenceModel(device="cpu").load_checkpoint(
        fresh, str(tmp_path / "ckpt"), quantize="int8", calibrate=x[:8])
    np.testing.assert_array_equal(im.predict(x), want)
    m.fit(x, y, batch_size=8, nb_epoch=1)    # a second snapshot, after it
    again = InferenceModel(device="cpu").load_checkpoint(
        _simple_cnn(seed=2), str(tmp_path / "ckpt"), quantize="int8",
        calibrate=x[:8])
    np.testing.assert_array_equal(
        again.predict(x), InferenceModel(device="cpu").from_keras(
            m, quantize="int8", calibrate=x[:8]).predict(x))


def test_static_int8_load_jax_params_round_trip_bit_for_bit():
    """The port's param tree, through the JAX classifier and back with
    ``load_jax_params``, gives a model whose static install has the same
    int8 weights, repack and prediction bits; the tree never holds the
    repack."""
    from analytics_zoo_tpu.models.image.imageclassification import \
        ImageClassifier as JImageClassifier
    m = _simple_cnn()
    x, _ = _data()
    im = InferenceModel(device="cpu").from_keras(m, quantize="int8",
                                                 calibrate=x[:8])
    tree = _param_tree({n: p.detach().numpy().copy()
                        for n, p in m.model.named_parameters()})
    jm = JImageClassifier("simple-cnn", num_classes=3, input_shape=(8, 8, 3),
                          dropout=0.0)
    jm.params = jax.tree.map(jnp.asarray, tree)
    back = _simple_cnn(seed=5)
    back.model.load_jax_params(jax.tree.map(np.asarray, jm.params))
    assert not any("W_kmajor" in k for k in peng.flatten_tree(tree))
    im2 = InferenceModel(device="cpu").from_keras(back, quantize="int8",
                                                  calibrate=x[:8])
    for (n1, l1), (n2, l2) in zip(_served_convs(im).items(),
                                  _served_convs(im2).items()):
        assert n1 == n2 and torch.equal(l1.W, l2.W)
        if hasattr(l1, "W_kmajor"):
            assert torch.equal(l1.W_kmajor, l2.W_kmajor)
    np.testing.assert_array_equal(im2.predict(x), im.predict(x))


def test_layer_quantized_call_hands_the_repack_to_c8(monkeypatch):
    """``Convolution2D.quantized_call`` passes the installed repack to C8
    as ``w_kmajor``; a layer without one passes None."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
        convolution
    m = _simple_cnn()
    x, _ = _data()
    im = InferenceModel(device="cpu").from_keras(m, quantize="int8",
                                                 calibrate=x[:8])
    got = []
    real = convolution.static_int8_conv2d

    def spy(*args, **kwargs):
        got.append(kwargs.get("w_kmajor"))
        return real(*args, **kwargs)
    monkeypatch.setattr(convolution, "static_int8_conv2d", spy)
    im.predict(x[:4])
    convs = list(_served_convs(im).values())
    assert len(got) == 2 and got[0] is None
    assert got[1] is convs[1].W_kmajor
