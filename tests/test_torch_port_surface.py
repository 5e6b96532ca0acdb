"""The port's public surface against the JAX package's: every layer
class's output-shape rule (fault u: ``MultiHeadSelfAttention`` had none,
so a ``Sequential`` or graph ``Model`` holding it could not be built),
and the public top-level names of every module (fault v: the package
``__init__``s lacked the JAX package's re-exports).

The shape sweep builds each layer class of both packages at the input
shapes the JAX layer tests use and compares the port's rule with the JAX
layer's ``jax.eval_shape`` inference, one case per class. The name walk
reads each JAX module's top-level definitions and re-exports from its
source and asks the port's module for each, minus the stated lists below.
"""

import ast
import importlib
import inspect
import os

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.pipeline.api.keras import Input as JInput
from analytics_zoo_tpu.pipeline.api.keras import Model as JModel
from analytics_zoo_tpu.pipeline.api.keras import Sequential as JSequential
from analytics_zoo_tpu.pipeline.api.keras import layers as jl
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.pipeline.api.keras import Input as PInput
from analytics_zoo_tpu_torch.pipeline.api.keras import Model as PModel
from analytics_zoo_tpu_torch.pipeline.api.keras import \
    Sequential as PSequential
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras import layers as pl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def port_context():
    pctx.reset_zoo_context()
    yield
    pctx.reset_zoo_context()


# ---------------------------------------------------------------------------
# fault u: every layer's output-shape rule
# ---------------------------------------------------------------------------

IMG = (None, 9, 11, 3)          # tests/test_golden_layers.py's conv input
SEQ = (None, 15, 4)             # its Conv1D input
VOL = (None, 6, 8, 10, 3)
VEC = (None, 6)
ATT = (None, 16, 32)            # tests/test_torch_port_layers.py's B, T, H
MASK = (None, 1, 1, 16)

#: ``class name: (args(layers module) -> (args, kwargs), input shape)``
SHAPE_CASES = {
    "Activation": (lambda L: (("relu",), {}), VEC),
    "AddConstant": (lambda L: ((2.0,), {}), VEC),
    "AtrousConvolution1D": (lambda L: ((6, 3), {"atrous_rate": 2}), SEQ),
    "AtrousConvolution2D": (lambda L: ((5, 3, 3), {"atrous_rate": (2, 2)}),
                            IMG),
    "AveragePooling1D": (lambda L: ((), {"pool_length": 2}), SEQ),
    "AveragePooling2D": (lambda L: ((), {"border_mode": "same"}), IMG),
    "AveragePooling3D": (lambda L: ((), {}), VOL),
    "BatchNormalization": (lambda L: ((), {}), IMG),
    "Bidirectional": (lambda L: ((L.LSTM(6, return_sequences=True),), {}),
                      SEQ),
    "BinaryThreshold": (lambda L: ((), {}), VEC),
    "CAdd": (lambda L: (((6,),), {}), VEC),
    "CMul": (lambda L: (((6,),), {}), VEC),
    "ConvLSTM2D": (lambda L: ((4, 3), {"return_sequences": True}),
                   (None, 3, 8, 8, 2)),
    "ConvLSTM3D": (lambda L: ((4, 3), {}), (None, 3, 5, 5, 5, 2)),
    "Convolution1D": (lambda L: ((6, 3), {"border_mode": "same",
                                          "subsample_length": 2}), SEQ),
    "Convolution2D": (lambda L: ((5, 3, 3), {"subsample": (2, 2)}), IMG),
    "Convolution3D": (lambda L: ((4, 3, 3, 3), {}), VOL),
    "Cropping1D": (lambda L: ((), {}), SEQ),
    "Cropping2D": (lambda L: ((((1, 2), (2, 1)),), {}), IMG),
    "Cropping3D": (lambda L: ((), {}), VOL),
    "Deconvolution2D": (lambda L: ((4, 3, 3), {"subsample": (2, 2)}), IMG),
    "Dense": (lambda L: ((5,), {}), SEQ),
    "DepthwiseConvolution2D": (lambda L: ((3, 3), {"depth_multiplier": 2}),
                               IMG),
    "Dropout": (lambda L: ((0.5,), {}), VEC),
    "ELU": (lambda L: ((), {}), VEC),
    "Embedding": (lambda L: ((30, 8), {}), (None, 7)),
    "Exp": (lambda L: ((), {}), VEC),
    "Expand": (lambda L: (((3, 6),), {}), (None, 1, 6)),
    "ExpandDim": (lambda L: ((1,), {}), VEC),
    "Flatten": (lambda L: ((), {}), IMG),
    "GPipe": (lambda L: ((lambda: L.Dense(6), 2), {}), VEC),
    "GaussianDropout": (lambda L: ((0.3,), {}), VEC),
    "GaussianNoise": (lambda L: ((0.5,), {}), VEC),
    "GaussianSampler": (lambda L: ((), {}), [VEC, VEC]),
    "GlobalAveragePooling1D": (lambda L: ((), {}), SEQ),
    "GlobalAveragePooling2D": (lambda L: ((), {}), IMG),
    "GlobalAveragePooling3D": (lambda L: ((), {}), VOL),
    "GlobalMaxPooling1D": (lambda L: ((), {}), SEQ),
    "GlobalMaxPooling2D": (lambda L: ((), {}), IMG),
    "GlobalMaxPooling3D": (lambda L: ((), {}), VOL),
    "GRU": (lambda L: ((6,), {}), SEQ),
    "HardShrink": (lambda L: ((), {}), VEC),
    "HardTanh": (lambda L: ((), {}), VEC),
    "Highway": (lambda L: ((), {}), VEC),
    "InputLayer": (lambda L: (((6,),), {}), VEC),
    "KMaxPooling": (lambda L: ((3,), {}), SEQ),
    "L2Normalize": (lambda L: ((), {}), VEC),
    "Lambda": (lambda L: ((None,), {}), VEC),
    "LayerNorm": (lambda L: ((), {}), ATT),
    "LeakyReLU": (lambda L: ((), {}), VEC),
    "LocallyConnected1D": (lambda L: ((5, 3), {}), SEQ),
    "LocallyConnected2D": (lambda L: ((4, 3, 3), {}), IMG),
    "Log": (lambda L: ((), {}), VEC),
    "LRN2D": (lambda L: ((), {}), IMG),
    "LSTM": (lambda L: ((6,), {"return_sequences": True}), SEQ),
    "Masking": (lambda L: ((), {}), SEQ),
    "Max": (lambda L: ((1,), {}), SEQ),
    "MaxoutDense": (lambda L: ((5,), {}), VEC),
    "MaxPooling1D": (lambda L: ((), {"pool_length": 3, "stride": 2}), SEQ),
    "MaxPooling2D": (lambda L: ((), {}), IMG),
    "MaxPooling3D": (lambda L: ((), {}), VOL),
    "Merge": (lambda L: ((), {"mode": "concat"}), [SEQ, SEQ]),
    "Mul": (lambda L: ((), {}), VEC),
    "MulConstant": (lambda L: ((3.0,), {}), VEC),
    "MultiHeadSelfAttention": (lambda L: ((32, 4), {}), ATT),
    "MultiHeadSelfAttention[mask]": (lambda L: ((32, 4), {}), [ATT, MASK]),
    "Narrow": (lambda L: ((1, 1, 2), {}), SEQ),
    "Negative": (lambda L: ((), {}), VEC),
    "Permute": (lambda L: (((2, 1),), {}), SEQ),
    "Pipeline": (lambda L: (([[L.Dense(8)], [L.Dense(3)]],), {}), VEC),
    "Power": (lambda L: ((2.0,), {}), VEC),
    "PReLU": (lambda L: ((), {}), VEC),
    "RepeatVector": (lambda L: ((3,), {}), VEC),
    "Reshape": (lambda L: (((3, 2),), {}), VEC),
    "ResizeBilinear": (lambda L: ((5, 7), {}), IMG),
    "RReLU": (lambda L: ((), {}), VEC),
    "Scale": (lambda L: (((6,),), {}), VEC),
    "Select": (lambda L: ((1, 3), {}), SEQ),
    "SeparableConvolution1D": (lambda L: ((6, 3), {}), SEQ),
    "SeparableConvolution2D": (lambda L: ((5, 3, 3), {}), IMG),
    "ShardedEmbedding": (lambda L: ((30, 8), {}), (None, 7)),
    "ShareConvolution2D": (lambda L: ((5, 3, 3), {"pad_h": 1, "pad_w": 1}),
                           IMG),
    "SimpleRNN": (lambda L: ((6,), {}), SEQ),
    "Softmax": (lambda L: ((), {}), VEC),
    "SoftShrink": (lambda L: ((), {}), VEC),
    "SparseDense": (lambda L: ((5,), {}), VEC),
    "SparseEmbedding": (lambda L: ((30, 8), {}), (None, 30)),
    "SparseMoE": (lambda L: ((4, 8), {"top_k": 2}), (None, 5, 6)),
    "SpatialDropout1D": (lambda L: ((), {}), SEQ),
    "SpatialDropout2D": (lambda L: ((), {}), IMG),
    "SpatialDropout3D": (lambda L: ((), {}), VOL),
    "Sqrt": (lambda L: ((), {}), VEC),
    "Square": (lambda L: ((), {}), VEC),
    "Squeeze": (lambda L: ((1,), {}), (None, 1, 6)),
    "SReLU": (lambda L: ((), {}), VEC),
    "Threshold": (lambda L: ((), {}), VEC),
    "ThresholdedReLU": (lambda L: ((), {}), VEC),
    "TimeDistributed": (lambda L: ((L.Dense(5),), {}), SEQ),
    "TransformerBlock": (lambda L: ((32, 4), {}), ATT),
    "TransformerBlock[mask]": (lambda L: ((32, 4), {}), [ATT, MASK]),
    "TransformerLayer": (lambda L: ((50, 16), {"n_block": 1,
                                               "hidden_size": 32,
                                               "n_head": 4}), (None, 16)),
    "UpSampling1D": (lambda L: ((), {}), SEQ),
    "UpSampling2D": (lambda L: ((), {}), IMG),
    "UpSampling3D": (lambda L: ((), {}), VOL),
    "WithinChannelLRN": (lambda L: ((), {}), IMG),
    "WordEmbedding": (lambda L: ((np.random.default_rng(0).normal(
        size=(30, 8)).astype(np.float32),), {}), (None, 7)),
    "ZeroPadding1D": (lambda L: ((), {}), SEQ),
    "ZeroPadding2D": (lambda L: ((), {}), IMG),
    "ZeroPadding3D": (lambda L: ((), {}), VOL),
}

#: layer classes without a case, each with its reason
NO_SHAPE_CASE = {
    # the JAX BERT cannot stand first in a Sequential either: it takes four
    # inputs (ids, token types, positions, mask) and returns two outputs
    "BERT",
}


def _make(layers, case):
    args, kwargs = SHAPE_CASES[case][0](layers)
    if case == "Lambda":
        args = (lambda x: x[..., :3] * 2,)
    return getattr(layers, case.split("[")[0])(*args, **kwargs)


def _shape(s):
    return [_shape(x) for x in s] if isinstance(s, list) else tuple(s)


@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_output_shape_rule_matches_jax(case):
    shape = SHAPE_CASES[case][1]
    jlayer = _make(jl, case)
    params = jlayer.build(jax.random.key(0), shape)
    want = jlayer.output_shape_for(params, jlayer.initial_state(shape),
                                   shape)
    player = _make(pl, case)
    player.build(shape, generator=torch.Generator().manual_seed(0))
    assert _shape(player.compute_output_shape(shape)) == _shape(want)


def test_every_layer_class_has_a_shape_case():
    classes = {name for name in pl.__all__
               if inspect.isclass(getattr(pl, name))
               and issubclass(getattr(pl, name), peng.Layer)}
    cased = {case.split("[")[0] for case in SHAPE_CASES}
    assert classes - cased == NO_SHAPE_CASE
    assert cased <= classes


@pytest.mark.parametrize("container", ["sequential", "model"])
def test_mhsa_stacks_like_jax(container):
    """Fault u: MultiHeadSelfAttention first in a Sequential and in a graph
    Model (then Dense(3)) builds, predicts (2, 8, 3), and matches the JAX
    network after weight transfer."""
    x = np.random.default_rng(1).normal(size=(2, 8, 32)).astype(np.float32)
    if container == "sequential":
        jm = JSequential([jl.MultiHeadSelfAttention(32, 4, input_shape=(8, 32)),
                          jl.Dense(3)])
        pm = PSequential([pl.MultiHeadSelfAttention(32, 4,
                                                    input_shape=(8, 32)),
                          pl.Dense(3)], device="cpu")
    else:
        ji, pi = JInput(shape=(8, 32)), PInput(shape=(8, 32))
        jm = JModel(ji, jl.Dense(3)(jl.MultiHeadSelfAttention(32, 4)(ji)))
        pm = PModel(pi, pl.Dense(3)(pl.MultiHeadSelfAttention(32, 4)(pi)),
                    device="cpu")
    assert pm.compute_output_shape((None, 8, 32)) == (None, 8, 3)
    jm.init_weights()
    pm.load_jax_params(jax.tree.map(np.asarray, jm.params))
    got = pm.predict(x)
    want = np.asarray(jm.predict(x))
    assert got.shape == want.shape == (2, 8, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shuffle,drop_last", [(False, False),
                                               (True, True)])
def test_iter_batches_matches_jax(shuffle, drop_last):
    from analytics_zoo_tpu.pipeline.api.keras import training as jtr
    from analytics_zoo_tpu_torch.pipeline.api.keras import training as ptr
    x = [np.arange(22, dtype=np.float32).reshape(11, 2),
         np.arange(11, dtype=np.int32)]
    y = np.arange(11, dtype=np.float32) * 10
    kw = dict(shuffle=shuffle, seed=4, drop_last=drop_last)
    got = list(ptr.iter_batches(x, y, 4, **kw))
    want = list(jtr.iter_batches(x, y, 4, **kw))
    assert len(got) == len(want) == (2 if drop_last else 3)
    for (gx, gy), (wx, wy) in zip(got, want):
        for a, b in zip(gx, wx):
            np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(gy, np.asarray(wy))


def test_shape_message_names_both_containers_and_the_probe():
    class NoRule(peng.Layer):
        def call(self, x, *, training=False, generator=None):
            return x

    with pytest.raises(NotImplementedError) as err:
        PSequential([NoRule(input_shape=(3,))], device="cpu").init_weights()
    assert "Sequential or a graph Model" in str(err.value)
    assert "probe_output_shape" in str(err.value)


# ---------------------------------------------------------------------------
# fault v: every public top-level name of the JAX package
# ---------------------------------------------------------------------------

#: JAX modules no slice has ported yet, and the queue item that brings
#: each (ROADMAP.md queue 1); each later slice removes its entries
WAITING_MODULES = {
    "analysis": "item 11",
    "models.caffe": "item 10f",
    "pipeline.api.onnx": "item 10f",
    "pipeline.api.keras2": "item 10g",
    "tfpark.estimator": "item 10g",
    "tfpark.gan_estimator": "item 10g",
    "tfpark.model": "item 10g",
    "tfpark.tf_dataset": "item 10g",
    # a shard_map shim over JAX versions: nothing to port
    "parallel.compat": "none",
}

#: JAX-only names with no torch counterpart: the jit machinery (the
#: CUDA-graph capture counts and ``compiled_flops`` on the call stand in
#: for it) and the TPU tiling (Pallas block and VMEM selectors, the TPU
#: peak table); each kernel's own launch plan replaces the selectors
JAX_ONLY = {
    "observability": {"instrument_jit"},
    "observability.compile": {"InstrumentedJit", "instrument_jit"},
    "pipeline.api.keras.training": {"CompiledSpec"},
    "utils.profiling": {"jit_flops", "PEAK_FLOPS_BF16"},
    "ops.pallas.common": {"LANES", "SUBLANES", "VMEM_BYTES_DEFAULT",
                          "VMEM_USABLE_FRACTION", "attention_vmem_bytes",
                          "ce_bwd_vmem_bytes", "ce_vmem_bytes",
                          "embed_gather_vmem_bytes", "kernel_vmem_bytes",
                          "round_up", "vmem_budget_bytes",
                          "vmem_usable_bytes"},
    "ops.pallas.flash_attention": {"select_attention_blocks"},
    "ops.pallas.cross_entropy": {"select_ce_blocks"},
}


def _waiting(rel):
    return any(rel == w or rel.startswith(w + ".") for w in WAITING_MODULES)


def _jax_modules():
    """``(relative module name, path)`` of every public JAX module."""
    root = os.path.join(REPO, "analytics_zoo_tpu")
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in sorted(filenames):
            if not f.endswith(".py"):
                continue
            parts = os.path.relpath(os.path.join(dirpath, f),
                                    root)[:-3].split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            if any(p.startswith("_") for p in parts):
                continue
            out.append((".".join(parts), os.path.join(dirpath, f)))
    return out


def _is_logger(value):
    return (isinstance(value, ast.Call)
            and isinstance(value.func, ast.Attribute)
            and value.func.attr == "getLogger")


def _public_names(rel, path):
    """The public top-level names of a JAX module's source: its defs,
    classes and assignments (module loggers aside), and, in a package
    ``__init__``, its relative re-exports (from a waiting module aside)."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign) and not _is_logger(node.value):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif (path.endswith("__init__.py") and isinstance(node, ast.ImportFrom)
              and node.level):
            src = ".".join(p for p in (rel, node.module) if p) \
                if node.level == 1 else node.module or ""
            if node.module and _waiting(src):
                continue
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _missing():
    out = {}
    for rel, path in _jax_modules():
        if _waiting(rel):
            continue
        port = "analytics_zoo_tpu_torch" + ("." + rel if rel else "")
        mod = importlib.import_module(port)
        miss = {n for n in _public_names(rel, path) if not hasattr(mod, n)}
        if miss:
            out[rel] = miss
    return out


def test_port_has_every_public_name_of_the_jax_package():
    """Fault v: every public top-level name of every JAX module resolves
    on the port's module of the same path, outside the stated lists."""
    missing = _missing()
    unexpected = {rel: sorted(names - JAX_ONLY.get(rel, set()))
                  for rel, names in missing.items()}
    assert {r: n for r, n in unexpected.items() if n} == {}


def test_stated_lists_are_still_needed():
    """Each JAX-only name is still missing from the port and each waiting
    module still unported, so a slice that ports one must take it off."""
    missing = _missing()
    stale = {rel: sorted(names - missing.get(rel, set()))
             for rel, names in JAX_ONLY.items()}
    assert {r: n for r, n in stale.items() if n} == {}
    for rel in WAITING_MODULES:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"analytics_zoo_tpu_torch.{rel}")


def test_package_reexports_leave_the_cli_imports_torch_free():
    """The root and ``common`` re-exports resolve on first use, so the
    host-only status CLI still imports without torch."""
    import subprocess
    import sys
    code = ("import sys\n"
            "import analytics_zoo_tpu_torch as a, "
            "analytics_zoo_tpu_torch.common as c\n"
            "import analytics_zoo_tpu_torch.serving.status\n"
            "assert 'torch' not in sys.modules\n"
            "assert 'init_zoo_context' in dir(c)\n"
            "assert callable(a.init_zoo_context) and callable(c.RetryPolicy)\n"
            "assert c.get_zoo_context is a.get_zoo_context\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
