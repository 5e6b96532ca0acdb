"""The port's SavedModel import against the JAX package's.

The SavedModel directories are written by the installed TensorFlow (the
``tests/test_saved_model.py`` exports), so those cases skip where it is
missing; both packages load the same directory and the same seeded inputs.
The tensor bundle and SavedModel writers of ``chip_smoke.py`` (the card
has no TensorFlow) are held here too: without TensorFlow, both packages'
``read_tensor_bundle`` read their output to the arrays written; with it,
TensorFlow's own checkpoint reader does.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.pipeline.api import saved_model as jsm
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.net import Net as JNet
from analytics_zoo_tpu.utils.tensor_bundle import \
    read_tensor_bundle as jax_read_bundle
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.pipeline.api import saved_model as psm
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import \
    Sequential as PSequential
from analytics_zoo_tpu_torch.pipeline.api.net import Net as PNet
from analytics_zoo_tpu_torch.utils.tensor_bundle import read_tensor_bundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def port_context():
    pctx.reset_zoo_context()
    yield
    pctx.reset_zoo_context()


def _export(path, use_resource, seed):
    """The JAX test's TF1-style SavedModel export (x → dense(relu) →
    dense → softmax), written by TensorFlow."""
    pytest.importorskip("tensorflow")
    from test_saved_model import _export_mlp
    return _export_mlp(path, use_resource=use_resource, seed=seed)


def _head_weights(rng, dims=(24, 16, 8, 5)):
    out = {}
    for j, (i, o) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"fc{6 + j}/kernel"] = (rng.normal(size=(i, o))
                                    / np.sqrt(i)).astype(np.float32)
        out[f"fc{6 + j}/bias"] = rng.normal(size=(o,)).astype(np.float32)
    return out


def _head_math(weights, x):
    h = x
    for j in range(3):
        h = h @ weights[f"fc{6 + j}/kernel"] + weights[f"fc{6 + j}/bias"]
        h = np.maximum(h, 0) if j < 2 else h
    e = np.exp(h - h.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("use_resource", [False, True],
                         ids=["ref_vars", "resource_vars"])
def test_saved_model_matches_jax(tmp_path, use_resource):
    xs, want = _export(tmp_path / "sm", use_resource, seed=0)
    pnet = psm.load_saved_model(str(tmp_path / "sm"), device="cpu")
    jnet = jsm.load_saved_model(str(tmp_path / "sm"))
    assert pnet.feed_names == jnet.feed_names == ["x"]
    assert pnet.output_names == jnet.output_names
    got = pnet(torch.from_numpy(xs)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.call(jnet.build(None),
                                                         xs)),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    assert sorted(pnet._tree_keys.values()) == sorted(jnet.build(None))
    assert len(list(pnet.parameters())) == 4


def test_net_load_tf_detects_saved_model_dir(tmp_path):
    xs, want = _export(tmp_path / "sm", False, seed=1)
    pnet, jnet = PNet.load_tf(str(tmp_path / "sm"), device="cpu"), \
        JNet.load_tf(str(tmp_path / "sm"))
    got = pnet(torch.from_numpy(xs)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.call(jnet.build(None),
                                                         xs)),
                               rtol=2e-5, atol=2e-6)


def test_saved_model_fine_tunes_like_jax(tmp_path):
    """Six epochs of Adam on the same shuffled batches from the JAX
    network's weights: the same losses, the same moved variables and the
    same evaluate."""
    _export(tmp_path / "sm", True, seed=2)
    jctx.init_zoo_context(conf={"zoo.seed": 0})
    pctx.init_zoo_context(conf={"zoo.seed": 0})
    rng = np.random.default_rng(3)
    w = rng.normal(size=(6, 4))
    x = rng.normal(size=(256, 6)).astype(np.float32)
    y = (x @ w).argmax(1).astype(np.int32)
    jm = JSequential([jsm.load_saved_model(str(tmp_path / "sm"))])
    pm = PSequential([psm.load_saved_model(str(tmp_path / "sm"),
                                           device="cpu")], device="cpu")
    jm.init_weights(sample_input=x[:2])
    pm.init_weights(sample_input=x[:2])
    tree = jax.tree.map(np.asarray, jm.params)
    pm.load_jax_params(tree)
    for m in (jm, pm):
        m.compile(optimizer="adam", loss="scce", lr=5e-3)
    got = pm.fit(x, y, batch_size=32, nb_epoch=6)["loss"]
    want = jm.fit(x, y, batch_size=32, nb_epoch=6)["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert got[-1] < got[0]
    jp = peng.flatten_tree(jax.tree.map(np.asarray, jm.params))
    pp = {"/".join(peng.tree_key(pm, n)): p.detach().numpy()
          for n, p in pm.named_parameters()}
    assert sorted(jp) == sorted(pp)
    for k in jp:
        assert not np.allclose(pp[k], peng.flatten_tree(tree)[k])
        np.testing.assert_allclose(pp[k], jp[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    pe = pm.evaluate(x, y, batch_size=64)
    je = jm.evaluate(x, y, batch_size=64)
    np.testing.assert_allclose(pe["loss"], float(je["loss"]), rtol=1e-4)


def test_bundle_reader_matches_jax_on_a_tf_checkpoint(tmp_path):
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    vals = {
        "f32": np.random.default_rng(0).normal(size=(3, 5)).astype(
            np.float32),
        "f64": np.arange(6, dtype=np.float64).reshape(2, 3),
        "i32": np.arange(7, dtype=np.int32),
        "i64": np.array([[-1, 2], [3, -4]], np.int64),
        "scalar": np.float32(3.5),
    }
    g = tf1.Graph()
    with g.as_default():
        for k, v in vals.items():
            tf1.get_variable(k, initializer=v, use_resource=False)
        saver = tf1.train.Saver()
        with tf1.Session(graph=g) as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, str(tmp_path / "ckpt"), write_meta_graph=False)
    got = read_tensor_bundle(str(tmp_path / "ckpt"))
    want = jax_read_bundle(str(tmp_path / "ckpt"))
    assert sorted(got) == sorted(want) == sorted(vals)
    for k in vals:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], np.asarray(vals[k]))


def test_missing_signature_refused_like_jax(tmp_path):
    _export(tmp_path / "sm", False, seed=4)
    sm = str(tmp_path / "sm")
    with pytest.raises(ValueError) as jerr:
        jsm.load_saved_model(sm, signature="nope")
    with pytest.raises(ValueError) as perr:
        psm.load_saved_model(sm, signature="nope", device="cpu")
    assert str(perr.value) == str(jerr.value)
    assert "not found; available" in str(perr.value)
    net = psm.load_saved_model(sm, signature="nope", inputs=["x"],
                               outputs=["probs"], device="cpu")
    assert net.output_names == ["probs"]


def test_missing_directory_and_tags_refused_like_jax(tmp_path):
    for fn in (psm.load_saved_model, jsm.load_saved_model):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path / "nowhere"))
    sm = str(tmp_path / "sm")
    chip_smoke.write_saved_model(sm, _head_weights(
        np.random.default_rng(5)))
    with pytest.raises(ValueError) as jerr:
        jsm.load_saved_model(sm, tags=["train"])
    with pytest.raises(ValueError) as perr:
        psm.load_saved_model(sm, tags=["train"], device="cpu")
    assert str(perr.value) == str(jerr.value)


def test_crc32c_known_values():
    """The smoke's chunked bundle CRC against the port's byte-wise one
    (the check value first), a bitwise reference and the JAX package's,
    on both sides of a chunk's length."""
    from analytics_zoo_tpu.utils import tensorboard as jtb
    from analytics_zoo_tpu_torch.utils import tensorboard as ptb
    assert ptb._crc32c(b"") == 0
    assert ptb._crc32c(b"123456789") == 0xE3069283
    for n in (0, 9, 4095, 4096, 3 * 4096 + 17, 5 * 4096):
        data = np.random.default_rng(n).integers(0, 256, n,
                                                 dtype=np.uint8).tobytes()
        crc = 0xFFFFFFFF            # bitwise reference
        for byte in data:
            crc ^= byte
            for _ in range(8):
                crc = (crc >> 1) ^ (0x82F63B78 & -(crc & 1))
        assert ptb._crc32c(data) == crc ^ 0xFFFFFFFF
        assert chip_smoke.bundle_crc(np.frombuffer(data, np.uint8)) \
            == ptb._masked_crc(data) == jtb._masked_crc(data), n


def test_smoke_bundle_reads_the_same_in_both_packages(tmp_path):
    """No TensorFlow: the smoke's bundle writer's output read by both
    packages' ``read_tensor_bundle`` gives the arrays written."""
    rng = np.random.default_rng(7)
    arrays = {"fc6/kernel": rng.normal(size=(40, 30)).astype(np.float32),
              "fc6/bias": rng.normal(size=(30,)).astype(np.float32),
              "step": np.asarray(7, np.int64),
              "ids": np.arange(9, dtype=np.int32).reshape(3, 3),
              "empty": np.zeros((0, 4), np.float32)}
    prefix = str(tmp_path / "variables")
    chip_smoke.write_tensor_bundle(prefix, arrays)
    got, want = read_tensor_bundle(prefix), jax_read_bundle(prefix)
    assert sorted(got) == sorted(want) == sorted(arrays)
    for k, a in arrays.items():
        assert got[k].dtype == want[k].dtype == a.dtype
        # both readers give a 0-d tensor as shape (1,) (fault y)
        assert got[k].shape == want[k].shape == (a.shape or (1,))
        np.testing.assert_array_equal(got[k], a)
        np.testing.assert_array_equal(want[k], a)


def test_smoke_saved_model_serves_like_jax(tmp_path):
    """The smoke's SavedModel of VGG-16's classifier head (at small
    widths): both packages load it, serve the same probabilities as the
    head's math, and train its six variables."""
    weights = _head_weights(np.random.default_rng(8))
    sm = str(tmp_path / "sm")
    chip_smoke.write_saved_model(sm, weights)
    pnet = psm.load_saved_model(sm, device="cpu")
    jnet = jsm.load_saved_model(sm)
    assert pnet.feed_names == jnet.feed_names == ["features"]
    assert pnet.output_names == jnet.output_names == ["probs"]
    assert sorted(pnet._tree_keys.values()) == sorted(jnet.build(None)) \
        == sorted(weights)
    x = np.maximum(np.random.default_rng(9).normal(size=(6, 24)), 0) \
        .astype(np.float32)
    got = pnet(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.call(jnet.build(None),
                                                         x)),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, _head_math(weights, x), rtol=2e-5,
                               atol=2e-6)


def test_smoke_writers_read_back_by_tensorflow(tmp_path):
    """TensorFlow's own readers take the smoke's files: the bundle by its
    checkpoint reader (entry checksums verified), the SavedModel by
    ``tf.compat.v1.saved_model.load``, which serves the head's math."""
    tf = pytest.importorskip("tensorflow")
    tf1 = tf.compat.v1
    rng = np.random.default_rng(10)
    weights = _head_weights(rng, dims=(1100, 16, 8, 5))
    sm = str(tmp_path / "sm")
    chip_smoke.write_saved_model(sm, weights)
    reader = tf.train.load_checkpoint(os.path.join(sm, "variables",
                                                   "variables"))
    for k, a in weights.items():
        np.testing.assert_array_equal(reader.get_tensor(k), a)
    x = np.maximum(rng.normal(size=(4, 1100)), 0).astype(np.float32)
    g = tf1.Graph()
    with g.as_default(), tf1.Session(graph=g) as sess:
        meta = tf1.saved_model.load(sess, ["serve"], sm)
        sig = meta.signature_def["serving_default"]
        want = sess.run(sig.outputs["probs"].name,
                        {sig.inputs["features"].name: x})
    np.testing.assert_allclose(want, _head_math(weights, x), rtol=1e-5,
                               atol=1e-6)
    got = psm.load_saved_model(sm, device="cpu")(
        torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_smoke_vgg_graphdef_matches_the_module_and_jax(tmp_path):
    """The smoke's frozen NHWC GraphDef of a (narrow) VGG module: both
    packages' TFNet give the module's NCHW logits, and TorchNet's import
    of the module gives them too."""
    module = chip_smoke.vgg16_module(
        seed=1, widths=(4, "M", 8, 8, "M", 8, "M"), hw=16, fc=12,
        classes=5)
    pb = str(tmp_path / "vgg.pb")
    with open(pb, "wb") as f:
        f.write(chip_smoke.vgg16_graphdef(module))
    x = np.random.default_rng(11).normal(size=(3, 16, 16, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        want = module(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    pnet, jnet = PNet.load_tf(pb, device="cpu"), JNet.load_tf(pb)
    got = pnet(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jnet.call(jnet.build(None), x)),
                               want, rtol=1e-4, atol=1e-5)
    imported = PNet.load_torch(module, (3, 16, 16), device="cpu")
    np.testing.assert_allclose(imported.predict(x), want, rtol=1e-4,
                               atol=1e-5)


def test_saved_model_module_imports_no_jax():
    code = (
        "import sys\n"
        "import analytics_zoo_tpu_torch.pipeline.api.saved_model\n"
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
