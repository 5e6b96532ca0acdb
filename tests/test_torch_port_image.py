"""The port's image path held to the JAX package: the classifier
topologies, ``new_head`` and ``new_graph``, ``ImageSet`` and the
transforms, the native resize, the static int8 conv's plain version and
``InferenceModel`` on a conv model (static and weight-only int8).

Tolerances: topology forwards 1e-4 of the largest output (f32 through up
to ~300 layers, the same sums in another order; BatchNorm state redrawn
so the inference normalisation is not the identity), ResNet-50's training
forward 5e-4 (batch statistics amplify those differences); transforms and the
native resize bit for bit (the same numpy and C++ code on the same
arrays); C8's plain version bit for bit (int8 products are exact, the
f32 epilogue in the JAX order); static int8 predictions 1e-4 (f32
pooling and softmax after exact convs), weight-only 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.feature import image as jimage
from analytics_zoo_tpu.models.image.imageclassification import \
    ImageClassifier as JImageClassifier
from analytics_zoo_tpu.native import image as jnative
from analytics_zoo_tpu.pipeline.api.keras import Model as JModel
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu.pipeline.inference import InferenceModel as JaxIM
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.feature import image as pimage
from analytics_zoo_tpu_torch.models.image.imageclassification import \
    ImageClassifier as PImageClassifier
from analytics_zoo_tpu_torch.native import _loader as ploader
from analytics_zoo_tpu_torch.native import image as pnative
from analytics_zoo_tpu_torch.ops.pallas import quantized as pq
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as pl
from analytics_zoo_tpu_torch.pipeline.api.keras.layers.convolution import \
    same_pads
from analytics_zoo_tpu_torch.pipeline.api.keras.training import _param_tree
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

#: the smallest square input each topology admits; 32 where ``same``
#: padding admits any size (so the stride-2 pads stay asymmetric: the 7x7
#: stems pad (2, 3) there)
TOPOLOGIES = {"alexnet": 67, "vgg-16": 32, "vgg-19": 32, "resnet-50": 32,
              "squeezenet": 29, "mobilenet": 32, "mobilenet-v2": 32,
              "densenet-161": 29, "inception-v3": 75, "inception-v1": 32,
              "simple-cnn": 4}


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    peng.reset_uids()
    jeng.reset_uids()
    jctx.init_zoo_context(conf={"zoo.seed": 0})
    yield
    pctx.reset_zoo_context()
    jctx.reset_zoo_context()


def _tree(t):
    return jax.tree.map(np.asarray, t)


def _classifier_pair(name, hw, classes=3, seed=0, batch=2, **kw):
    """The port's classifier on seeded weights with its BatchNorm state
    redrawn from a numpy seed, and the JAX classifier carrying the same
    trees (set directly: the JAX ``init_weights`` of the large topologies
    takes tens of seconds on the CPU, and its draws are replaced anyway)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, hw, hw, 3)).astype(np.float32)
    pm = PImageClassifier(name, num_classes=classes,
                          input_shape=(hw, hw, 3), dropout=0.0,
                          device="cpu", **kw)
    pm.init_weights(torch.Generator().manual_seed(seed))
    params = _param_tree({n: p.detach().numpy().copy()
                          for n, p in pm.model.named_parameters()})
    state = _param_tree({
        n: (rng.random(t.shape).astype(np.float32) * 0.5 + 0.5)
        for n, t in peng.named_state(pm.model).items()})
    peng.load_param_tree(pm.model, params, state)
    jm = JImageClassifier(name, num_classes=classes,
                          input_shape=(hw, hw, 3), dropout=0.0, **kw)
    jm.params = jax.tree.map(jnp.asarray, params)
    jm.net_state = jax.tree.map(jnp.asarray, state)
    return jm, pm, x


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_topology_forward_matches_jax(name):
    jm, pm, x = _classifier_pair(name, TOPOLOGIES[name])
    want, _ = jax.jit(lambda p, s, a: jm.model.apply(p, s, a))(
        jm.params, jm.net_state, jnp.asarray(x))
    want = np.asarray(want)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    assert [n.name for n in pm.model._topo] == [n.name for n in
                                                jm.model._topo]
    assert pm.get_config() == jm.get_config()


def test_resnet_training_forward_and_statistics_match_jax():
    """ResNet-50's training forward (batch statistics in every
    BatchNorm) and the 53 new moving statistics pairs against JAX (batch
    8: the last stage normalises over 8 values a channel, not a
    near-degenerate 2)."""
    jm, pm, x = _classifier_pair("resnet-50", 32, batch=8)
    want, new_state = jax.jit(lambda p, s, a: jm.model.apply(
        p, s, a, training=True))(jm.params, jm.net_state, jnp.asarray(x))
    with torch.no_grad(), peng.collect_state() as sink:
        got = pm(torch.from_numpy(x), training=True).numpy()
    # 5e-4 on the probabilities: each of the 53 normalisations over a
    # batch divides by a standard deviation of 8 values, which scales the
    # sums' last-bit differences up layer after layer
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=5e-4)
    peng.commit_state(sink)
    want_state = peng.flatten_tree(_tree(new_state))
    got_state = {k.replace(".", "/"): v.numpy()
                 for k, v in peng.named_state(pm.model).items()}
    assert sorted(got_state) == sorted(want_state)
    assert len(got_state) == 2 * 53
    for k in want_state:
        np.testing.assert_allclose(got_state[k], want_state[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_new_head_grafts_by_shape_as_jax():
    jm, pm, x = _classifier_pair("simple-cnn", 8, classes=3)
    jh = jm.new_head(5)
    ph = pm.new_head(5)
    # the backbone came across, the head kept its fresh init (its shape
    # changed), in both packages
    jtree, ptree = _tree(jh.params), {
        k.replace(".", "/"): v.detach().numpy()
        for k, v in ph.model.named_parameters()}
    for key, a in peng.flatten_tree(jtree).items():
        if key.startswith("head_dense"):
            assert a.shape[-1] == 5 and ptree[key].shape == a.shape
        else:
            np.testing.assert_array_equal(ptree[key], a, err_msg=key)
    assert ph.num_classes == 5 and ph.model_name == pm.model_name
    assert ph.model.backbone_conv1.W.data_ptr() != \
        pm.model.backbone_conv1.W.data_ptr()


def test_new_graph_cuts_at_the_pooled_features_as_jax():
    """``new_graph(["gap"])`` of Inception-v1: the same layers (shared
    weights), the pooled features JAX's sub-graph gives."""
    jm, pm, x = _classifier_pair("inception-v1", 32)
    jsub = jm.model.new_graph(["gap"])
    psub = pm.model.new_graph(["gap"])
    want, _ = jax.jit(lambda p, s, a: jsub.apply(p, s, a))(
        jm.params, jm.net_state, jnp.asarray(x))
    with torch.no_grad():
        got = psub(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1024)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    assert psub.gap is pm.model.gap
    assert psub.stem_conv7.W is pm.model.stem_conv7.W
    assert [n.name for n in psub._topo] == [n.name for n in jsub._topo]


# ---------------------------------------------------------------------------
# the data path
# ---------------------------------------------------------------------------

TRANSFORMS = {
    "resize": ("Resize", (9, 13), {}),
    "center_crop": ("CenterCrop", (8, 10), {}),
    "random_crop": ("RandomCrop", (8, 10), dict(seed=3)),
    "hflip": ("HFlip", (), dict(p=0.5, seed=4)),
    "brightness": ("Brightness", (), dict(seed=5)),
    "channel_order": ("ChannelOrder", (), {}),
    "channel_normalize": ("ChannelNormalize", ((120., 110., 100.),
                                               (50., 60., 70.)), {}),
    "mat_to_tensor": ("MatToTensor", (), dict(scale=1 / 255.)),
    "hue": ("Hue", (), dict(seed=6)),
    "saturation": ("Saturation", (), dict(seed=7)),
    "contrast": ("Contrast", (), dict(seed=8)),
    "color_jitter": ("ColorJitter", (), dict(seed=9)),
    "expand": ("Expand", (), dict(seed=10)),
    "filler": ("Filler", (0.1, 0.2, 0.5, 0.7), {}),
    "aspect_scale": ("AspectScale", (10,), {}),
    "channel_scaled": ("ChannelScaledNormalizer", (120., 110., 100., 0.5),
                       {}),
    "mirror": ("Mirror", (), {}),
    "fixed_crop": ("FixedCrop", (0.1, 0.1, 0.8, 0.9), {}),
    "random_resize": ("RandomResize", (8, 12), dict(seed=11)),
}


def _images(n=4, h=16, w=20, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=(n, h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_the_jax_copy(name):
    cls, args, kw = TRANSFORMS[name]
    batch = _images()
    want = getattr(jimage, cls)(*args, **kw)(batch)
    got = getattr(pimage, cls)(*args, **kw)(batch)
    want_l = want if isinstance(want, list) else [want]
    got_l = got if isinstance(got, list) else [got]
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_image_set_and_chain_match_the_jax_copy():
    batch = _images(6)
    labels = np.arange(6) % 2
    chain = [("Resize", (12, 12)), ("CenterCrop", (10, 10)),
             ("ChannelNormalize", ((120., 110., 100.), (50., 60., 70.)))]

    def run(mod):
        pre = None
        for cls, args in chain:
            t = getattr(mod, cls)(*args)
            pre = t if pre is None else pre >> t
        s = mod.ImageSet.from_arrays(batch, labels).transform(pre)
        return s.to_array(), s.labels, len(s)

    got, want = run(pimage), run(jimage)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == 6 and got[0].dtype == np.float32
    fs = pimage.ImageSet.from_arrays(batch, labels).to_feature_set(
        shuffle=False)
    assert len(fs) == 6


def test_native_resize_matches_the_jax_binding_and_builds_outside_native():
    """The port's binding builds ``native/zoo_image.cc`` into
    ``build/native/`` and gives the JAX binding's bits, uint8 and f32."""
    assert pnative.available()
    assert ploader.library_path("zoo_image", "zoo_image.cc").exists()
    for arr in (_images(3, 17, 23), np.random.default_rng(1).normal(
            size=(2, 11, 7, 3)).astype(np.float32)):
        for hw in ((9, 31), (40, 5)):
            np.testing.assert_array_equal(
                pnative.resize_bilinear(arr, *hw),
                jnative.resize_bilinear(arr, *hw))
    x = _images(2)
    np.testing.assert_array_equal(
        pnative.normalize(x, (1., 2., 3.), (4., 5., 6.)),
        jnative.normalize(x, (1., 2., 3.), (4., 5., 6.)))


# ---------------------------------------------------------------------------
# static int8 convs
# ---------------------------------------------------------------------------

C8_CASES = [  # h, w, c, f, kh, kw, stride, dilation, border, relu
    (9, 9, 3, 5, 3, 3, 1, 1, "same", True),
    (12, 12, 3, 6, 7, 7, 2, 1, "same", True),     # the stems' (2, 3)
    (11, 12, 4, 5, 3, 2, 2, 2, "valid", False),
    (8, 8, 4, 4, 3, 3, 1, 2, "same", True),       # AtrousConvolution2D
    (5, 5, 1, 1, 1, 1, 1, 1, "valid", False),
]


@pytest.mark.parametrize("case", C8_CASES)
def test_c8_plain_version_is_jax_quantized_call_bit_for_bit(case):
    h, w, c, f, kh, kw, s, d, border, relu = case
    rng = np.random.default_rng(h * w + f)
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    W = rng.integers(-127, 128, size=(kh, kw, c, f)).astype(np.int8)
    ws = (rng.random(f) * 0.01 + 1e-3).astype(np.float32)
    b = rng.normal(size=f).astype(np.float32)
    xs = np.float32(np.abs(x).max() / 127)
    layer = jl.Convolution2D(f, kh, kw, subsample=(s, s), dilation=(d, d),
                             border_mode=border,
                             activation="relu" if relu else None)
    want = np.asarray(layer.quantized_call(
        {"W": jnp.asarray(W), "w_scale": jnp.asarray(ws),
         "x_scale": jnp.asarray(xs), "b": jnp.asarray(b)}, jnp.asarray(x)))
    pads = ([same_pads(n, k, s, d) for n, k in ((h, kh), (w, kw))]
            if border == "same" else [(0, 0), (0, 0)])
    got = pq.static_int8_conv2d_reference(
        torch.from_numpy(x), torch.tensor(xs), torch.from_numpy(W),
        torch.from_numpy(ws), torch.from_numpy(b), relu, (s, s), (d, d),
        pads).numpy()
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(pq.static_int8_conv2d(
        torch.from_numpy(x), torch.tensor(xs), torch.from_numpy(W),
        torch.from_numpy(ws), torch.from_numpy(b), relu, (s, s), (d, d),
        pads).numpy(), want)


def test_c8_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 5, 5, 3)
    xs, W, ws = torch.ones(()), torch.zeros(3, 3, 3, 4, dtype=torch.int8), \
        torch.ones(4)
    with pytest.raises(ValueError, match="shape mismatch"):
        pq.static_int8_conv2d(x, xs, W[:, :, :2], ws)
    with pytest.raises(TypeError, match="int8 w_q"):
        pq.static_int8_conv2d(x, xs, W.float(), ws)
    with pytest.raises(TypeError, match="float x"):
        pq.static_int8_conv2d(x.to(torch.int8), xs, W, ws)
    with pytest.raises(ValueError, match="shape mismatch"):
        pq.static_int8_conv2d(x, xs, W, ws, bias=torch.zeros(3))


def _conv_graph(mod, device=None):
    inp = mod.Input((10, 10, 3)) if device is None else peng.Input(
        (10, 10, 3))
    layers = jl if mod is jl else pl
    h = layers.Convolution2D(8, 3, 3, activation="relu", border_mode="same",
                             subsample=(2, 2), name="c1")(inp)
    h = layers.BatchNormalization(name="bn")(h)
    h = layers.AtrousConvolution2D(8, 3, 3, atrous_rate=(2, 2),
                                   border_mode="same", name="c2")(h)
    h = layers.ShareConvolution2D(6, 3, 3, pad_h=1, pad_w=1,
                                  name="c3")(h)
    h = layers.GlobalAveragePooling2D(name="gap")(h)
    out = layers.Dense(4, activation="softmax", name="fc")(h)
    if device is None:
        return JModel(input=inp, output=out)
    return peng.Model(inp, out, device=device)


def _conv_pair():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(16, 10, 10, 3)).astype(np.float32)
    jm = _conv_graph(jl)
    jm.init_weights(sample_input=x[:2])
    jm.net_state = jax.tree.map(
        lambda a: jnp.asarray(rng.random(a.shape).astype(np.float32) + 0.5),
        jm.net_state)
    pm = _conv_graph(None, device="cpu")
    pm.load_jax_params(_tree(jm.params), _tree(jm.net_state))
    return jm, pm, x


def test_static_int8_conv_model_matches_jax_predict():
    """Calibration records the convs JAX records (``Convolution2D`` and
    ``AtrousConvolution2D``, not ``ShareConvolution2D``, whose own
    ``call`` keeps it float) with the same scales and int8 weights, and the
    static predict (C8's plain version on the CPU) gives JAX's."""
    jm, pm, x = _conv_pair()
    jax_im = JaxIM().from_keras(jm, quantize="int8", calibrate=x[:8])
    im = InferenceModel(device="cpu").from_keras(pm, quantize="int8",
                                                 calibrate=x[:8])
    assert set(im._act_scales) == set(jax_im._act_scales) \
        == {"c1", "c2", "fc"}
    for name, (scale, shape) in jax_im._act_scales.items():
        assert im._act_scales[name][1] == shape
        np.testing.assert_allclose(im._act_scales[name][0], scale,
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(
            getattr(im._model, name).W.numpy(),
            np.asarray(jax_im._params[name]["W"]))
    np.testing.assert_allclose(im.predict(x), np.asarray(jax_im.predict(x)),
                               atol=1e-4, rtol=0)
    # the moving statistics stay f32 state, untouched
    np.testing.assert_array_equal(im._model.bn.moving_var.numpy(),
                                  np.asarray(jm.net_state["bn"]["moving_var"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_only_conv_model_matches_jax_predict(dtype):
    """Weight-only int8 dequantizes every float leaf of at least 512
    entries (the conv kernels here) at load with the JAX formula; the
    moving statistics stay f32 state in either runtime dtype."""
    jm, pm, x = _conv_pair()
    want = np.asarray(JaxIM().from_keras(jm, dtype=dtype,
                                         quantize="int8").predict(x))
    im = InferenceModel(device="cpu").from_keras(pm, dtype=dtype,
                                                 quantize="int8")
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(im.predict(x), want, atol=tol, rtol=0)
    assert im._model.bn.moving_mean.dtype == torch.float32
    bf = InferenceModel(device="cpu").from_keras(pm, dtype=dtype)
    assert bf._model.bn.moving_var.dtype == torch.float32
    np.testing.assert_allclose(
        bf.predict(x), np.asarray(JaxIM().from_keras(jm, dtype=dtype)
                                  .predict(x)), atol=tol, rtol=0)


def test_image_classifier_int8_suffix_serves_weight_only():
    jm, pm, x = _classifier_pair("simple-cnn-int8", 8)
    assert pm.quantize == jm.quantize == "int8"
    im = pm.as_inference_model()
    assert im._quantize == "int8" and im.device.type == "cpu"
    want = np.asarray(jm.as_inference_model().predict(x))
    np.testing.assert_allclose(im.predict(x), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("module", [
    "analytics_zoo_tpu_torch.pipeline.api.keras.layers.convolution",
    "analytics_zoo_tpu_torch.pipeline.api.keras.layers.pooling",
    "analytics_zoo_tpu_torch.feature.image",
    "analytics_zoo_tpu_torch.native.image",
    "analytics_zoo_tpu_torch.models.image",
])
def test_image_modules_import_no_jax(module):
    """Importing the module and running a small classifier's training
    step and static int8 predict leaves jax and the JAX package out of
    ``sys.modules``."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, importlib, numpy as np\n"
        f"importlib.import_module({module!r})\n"
        "from analytics_zoo_tpu_torch.models.image import ImageClassifier\n"
        "from analytics_zoo_tpu_torch.pipeline.inference import "
        "InferenceModel\n"
        "m = ImageClassifier('simple-cnn', 3, (8, 8, 3), device='cpu')\n"
        "m.init_weights().compile(optimizer='sgd', loss='scce')\n"
        "x = np.ones((8, 8, 8, 3), np.float32)\n"
        "m.fit(x, np.zeros(8, np.int32), batch_size=8, nb_epoch=1)\n"
        "InferenceModel(device='cpu').from_keras(m, quantize='int8', "
        "calibrate=x).predict(x)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'analytics_zoo_tpu' or "
        "n.startswith('analytics_zoo_tpu.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = repo
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
