"""The port's device mesh (``parallel/mesh.py``, ``parallel/
collectives.py``, ``common/context.py``'s bring-up) and its data and
tensor parallelism in the training loop, held to the JAX package.

The torch side runs as 4 gloo ranks on the CPU: one process group for the
whole file (a module-scoped fixture; a ``file://`` store under
``tmp_path``, no port bound), in which every case runs in turn; the
workers import this module, which imports no ``jax`` at the top. The JAX
side runs in the test process on ``create_mesh(devices=jax.devices()[:4])``
of conftest's 8-device host mesh. Both start from the same weights (the
JAX model's, transferred) and the same numpy batches (``shuffle=False``).

Tolerances: f32 losses, predictions and parameters 1e-5 relative (1e-6
absolute): the same arithmetic, the collectives summing in another order
than XLA's ``psum``. The transformer case trains with SGD: the key
projection's bias has a gradient of zero in exact arithmetic (softmax is
shift-invariant), so its computed gradient is rounding noise, which
Adam's normalisation would turn into full-size steps that no two
summation orders share.
"""

import logging

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.parallel import collectives as pcol
from analytics_zoo_tpu_torch.parallel import mesh as pmesh
from analytics_zoo_tpu_torch.parallel.launch import run_ranks

WORLD = 4
RTOL, ATOL = 1e-5, 1e-6
V, T, H = 60, 8, 16


def _data(n=256, d=8, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, classes)).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int32)


def _ids(n=128, seed=11):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (n, T)).astype(np.int32)
    return ids, (ids.sum(1) % 4).astype(np.int32)


def _ncf_data(seed=0):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(1, 50, 256), rng.integers(1, 40, 256)],
                 axis=1).astype(np.int32)
    return x, rng.integers(0, 3, 256).astype(np.int32)


NCF_ARGS = dict(user_embed=8, item_embed=8, hidden_layers=(16, 8), mf_embed=8)

# case -> (mesh axes, what it fits)
CASES = {
    "dp": ({"data": 4}, "mlp"),
    "bn": ({"data": 4}, "bn"),
    "tp": ({"data": 2, "model": 2}, "mlp"),
    "fallback": ({"data": 2, "model": 2}, "mlp3"),
    "megatron": ({"data": 2, "model": 2}, "transformer"),
    "ncf": ({"data": 2, "model": 2}, "ncf"),
}


# ---------------------------------------------------------------------------
# the torch side (runs in the gloo workers)
# ---------------------------------------------------------------------------

def _port_model(kind):
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        Lambda, Sequential, reset_uids)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        BatchNormalization, Dense, TransformerLayer)
    reset_uids()
    if kind == "bn":
        # no bias before the normalisation: its gradient is rounding
        # noise (the batch mean absorbs it), which Adam would turn into
        # full-size steps that no two summation orders share
        return Sequential([Dense(32, bias=False, input_shape=(8,)),
                           BatchNormalization(),
                           Dense(4, activation="softmax")], device="cpu")
    if kind == "mlp":
        return Sequential([Dense(32, activation="relu", input_shape=(8,)),
                           Dense(4, activation="softmax")], device="cpu")
    if kind == "mlp3":
        return Sequential([Dense(32, activation="relu", input_shape=(8,)),
                           Dense(3, activation="softmax")], device="cpu")
    if kind == "transformer":
        return Sequential([
            TransformerLayer(vocab=V, seq_len=T, n_block=2, hidden_size=H,
                             n_head=2, hidden_drop=0.0, attn_drop=0.0,
                             embedding_drop=0.0, input_shape=(T,)),
            Lambda(lambda h: h[:, -1, :], name="last_tok"),
            Dense(4, activation="softmax")], device="cpu")
    return NeuralCF(50, 40, 3, **NCF_ARGS, device="cpu")


def _fit_data(kind):
    if kind == "mlp3":
        rng = np.random.default_rng(7)
        x = rng.normal(size=(256, 8)).astype(np.float32)
        return x, np.argmax(x @ rng.normal(size=(8, 3)),
                            axis=1).astype(np.int32)
    return {"mlp": _data, "bn": _data, "transformer": _ids,
            "ncf": _ncf_data}[kind]()


def _fit_port(axes, kind, tree, log_records):
    from analytics_zoo_tpu_torch.pipeline.api.keras.training import \
        tree_module
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf={f"zoo.mesh.{k}": v for k, v in axes.items()})
    model = _port_model(kind).init_weights()
    model.load_jax_params(tree)
    if kind == "transformer":
        model.compile(optimizer="sgd", loss="scce", lr=0.1)
    else:
        model.compile(optimizer="adam", loss="scce", lr=0.01)
    x, y = _fit_data(kind)
    bs = 32 if kind == "transformer" else 64
    hist = model.fit(x, y, batch_size=bs, nb_epoch=2, shuffle=False)
    pred = model.predict(x, batch_size=bs)
    local = {n: tuple(p.shape)
             for n, p in tree_module(model).named_parameters()}
    full = {n: pmesh.full_tensor(p).detach().numpy()
            for n, p in tree_module(model).named_parameters()}
    return {"loss": hist["loss"], "pred": pred, "local": local,
            "full": full, "warnings": list(log_records)}


def _context_case():
    pctx.reset_zoo_context()
    ctx = pctx.init_zoo_context(conf={"zoo.mesh.model": 2})
    mesh = ctx.mesh
    group = mesh.group("model")
    t = torch.full((2,), float(torch.distributed.get_rank()))
    return {"shape": dict(mesh.shape), "meta": pmesh.mesh_metadata(mesh),
            "format": pmesh.format_mesh(pmesh.mesh_metadata(mesh)),
            "coords": mesh.coords, "model_ranks": group.ranks,
            "sum": pcol.all_reduce(t, group).tolist(),
            "gather": pcol.all_gather(t, mesh.group("data"), 0).tolist(),
            "shift": pcol.ring_shift(t, group).tolist(),
            "a2a": pcol.all_to_all(torch.arange(4.0) + 10 * torch.distributed
                                   .get_rank(), group, 0, 0).tolist(),
            "process": (ctx.process_index, ctx.process_count)}


def _torch_side(rank, world, trees):
    class Catch(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.records = []

        def emit(self, record):
            self.records.append(record.getMessage())
    catch = Catch()
    logging.getLogger("analytics_zoo_tpu_torch.mesh").addHandler(catch)
    out = {"context": _context_case()}
    for name, (axes, kind) in CASES.items():
        catch.records = []
        out[name] = _fit_port(axes, kind, trees[name], catch.records)
    return out


# ---------------------------------------------------------------------------
# the JAX side (the test process)
# ---------------------------------------------------------------------------

def _jax_model(kind):
    from analytics_zoo_tpu.models.recommendation import NeuralCF
    from analytics_zoo_tpu.pipeline.api.keras import Sequential
    from analytics_zoo_tpu.pipeline.api.keras.engine import Lambda
    from analytics_zoo_tpu.pipeline.api.keras.layers import (
        BatchNormalization, Dense, TransformerLayer)
    if kind == "bn":
        return Sequential([Dense(32, bias=False, input_shape=(8,)),
                           BatchNormalization(),
                           Dense(4, activation="softmax")])
    if kind == "mlp":
        return Sequential([Dense(32, activation="relu", input_shape=(8,)),
                           Dense(4, activation="softmax")])
    if kind == "mlp3":
        return Sequential([Dense(32, activation="relu", input_shape=(8,)),
                           Dense(3, activation="softmax")])
    if kind == "transformer":
        return Sequential([
            TransformerLayer(vocab=V, seq_len=T, n_block=2, hidden_size=H,
                             n_head=2, hidden_drop=0.0, attn_drop=0.0,
                             embedding_drop=0.0, input_shape=(T,)),
            Lambda(lambda h: h[:, -1, :], name="last_tok"),
            Dense(4, activation="softmax")])
    return NeuralCF(50, 40, 3, **NCF_ARGS)


def _fit_jax(axes, kind):
    import jax
    import optax

    from analytics_zoo_tpu.common.context import (init_zoo_context,
                                                  reset_zoo_context)
    from analytics_zoo_tpu.parallel import mesh as jmesh
    from analytics_zoo_tpu.pipeline.api.keras.engine import reset_uids
    reset_zoo_context()
    init_zoo_context()
    n = int(np.prod(list(axes.values())))
    jmesh.set_global_mesh(jmesh.create_mesh(devices=jax.devices()[:n],
                                            **axes))
    reset_uids()
    model = _jax_model(kind)
    model.compile(optimizer=optax.sgd(0.1) if kind == "transformer"
                  else optax.adam(0.01), loss="scce")
    x, y = _fit_data(kind)
    model.init_weights(sample_input=x[:8])
    tree = jax.tree.map(np.asarray, model.params)
    bs = 32 if kind == "transformer" else 64
    hist = model.fit(x, y, batch_size=bs, nb_epoch=2, shuffle=False)
    pred = np.asarray(model.predict(x, batch_size=bs))
    after = {"/".join(str(getattr(k, "key", k)) for k in path):
             np.asarray(leaf) for path, leaf in
             jax.tree_util.tree_flatten_with_path(model.params)[0]}
    reset_zoo_context()
    return tree, {"loss": hist["loss"], "pred": pred, "params": after}


def _bring_up(rank, world, store):
    """The context's own bring-up (``zoo.distributed.*``): the rank leaves
    the launcher's group and joins the one the context makes, the mesh
    laid over it from ``zoo.mesh.*``."""
    torch.distributed.destroy_process_group()
    pctx.reset_zoo_context()
    ctx = pctx.init_zoo_context(conf={
        "zoo.distributed.coordinator": f"file://{store}",
        "zoo.distributed.num_processes": world,
        "zoo.distributed.process_id": rank, "zoo.mesh.model": 2})
    t = torch.ones(1) * (rank + 1)
    return {"mesh": dict(ctx.mesh.shape), "world": ctx.process_count,
            "sum": pcol.all_reduce(t, ctx.mesh.group("model")).item(),
            "global": pmesh.global_mesh() is ctx.mesh}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    jax_side = {name: _fit_jax(axes, kind)
                for name, (axes, kind) in CASES.items()}
    tmp = tmp_path_factory.mktemp("gloo")
    ranks = run_ranks(_torch_side, WORLD, str(tmp / "store"),
                      args=({n: t for n, (t, _) in jax_side.items()},))
    bring_up = run_ranks(_bring_up, 2, str(tmp / "launcher"),
                         args=(str(tmp / "context"),))
    return {n: r for n, (_, r) in jax_side.items()}, ranks, bring_up


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_on_the_mesh_matches_jax(results, case):
    """DP over 4 ranks (also with a BatchNormalization, whose training
    statistics are the global batch's), TP (data 2 x model 2) with Dense
    column splits,
    the divisibility fallback, Megatron TP of a TransformerLayer stack and
    NCF's column-split tables: every rank's losses, predictions and
    gathered parameters are the JAX fit's on the same mesh."""
    want, ranks = results[0][case], results[1]
    for r in ranks:
        got = r[case]
        _close(got["loss"], want["loss"])
        _close(got["pred"], want["pred"])
        for name, arr in got["full"].items():
            _close(arr, want["params"][name.replace(".", "/")])


def test_tp_params_actually_sharded(results):
    """Under model=2 every rank holds half of the first Dense kernel's
    columns, and of the Megatron blocks' qkv and fc (JAX
    ``test_tp_params_actually_sharded``)."""
    for r in results[1]:
        assert r["tp"]["local"]["dense_0.W"] == (8, 16)
        assert r["dp"]["local"]["dense_0.W"] == (8, 32)
        local = r["megatron"]["local"]
        assert local["transformerlayer_0.block0.attn.qkv.W"] == (H, 3 * H // 2)
        assert local["transformerlayer_0.block0.attn.proj.W"] == (H // 2, H)
        assert local["transformerlayer_0.block0.fc.W"] == (H, 2 * H)
        assert local["transformerlayer_0.wte"] == (V, H // 2)
        assert any(shape[-1] == 4 for n, shape in r["ncf"]["local"].items()
                   if "embed" in n.lower())


def test_tp_divisibility_fallback_warns_once(results):
    """Dense(3) under model=2: its leaves replicate with one warning line
    that counts them and names the first (JAX ``param_shardings``)."""
    for r in results[1]:
        warned = [w for w in r["fallback"]["warnings"]
                  if "replicated instead of model-sharded" in w]
        assert len(warned) == 1 and warned[0].startswith("2 param")
        assert r["fallback"]["local"]["dense_1.W"] == (32, 3)
        assert r["fallback"]["local"]["dense_0.W"] == (8, 16)


def test_context_brings_up_the_mesh_over_the_ranks(results):
    """``zoo.mesh.model=2`` over 4 ranks: data absorbs the rest; the axis
    order is JAX's (model innermost); the collectives over each axis."""
    for rank, r in enumerate(results[1]):
        c = r["context"]
        assert c["shape"] == {"data": 2, "pipe": 1, "seq": 1, "expert": 1,
                              "model": 2}
        assert c["meta"] == {"axes": c["shape"], "devices": 4}
        assert c["format"] == "{data:2, model:2}"
        assert c["coords"]["data"] == rank // 2
        assert c["coords"]["model"] == rank % 2
        pair = (rank // 2 * 2, rank // 2 * 2 + 1)
        assert c["model_ranks"] == pair
        assert c["sum"] == [float(sum(pair))] * 2
        assert c["gather"] == [float(rank % 2)] * 2 + [float(rank % 2 + 2)] * 2
        assert c["shift"] == [float(pair[1] if rank == pair[0]
                                    else pair[0])] * 2
        mine = rank % 2
        assert c["a2a"] == [10 * pair[0] + 2 * mine, 10 * pair[0] + 2 * mine
                            + 1, 10 * pair[1] + 2 * mine,
                            10 * pair[1] + 2 * mine + 1]
        assert c["process"] == (rank, 4)


# ---------------------------------------------------------------------------
# one process: the helpers and the bring-up's absence
# ---------------------------------------------------------------------------

def test_context_joins_the_coordinator_and_lays_the_mesh(results):
    """``zoo.distributed.coordinator`` (a ``file://`` store here), the
    process count and id: ``init_zoo_context`` joins the process group
    and sets the global mesh over it (JAX ``_maybe_init_distributed``)."""
    for r in results[2]:
        assert r["mesh"]["model"] == 2 and r["mesh"]["data"] == 1
        assert r["world"] == 2 and r["global"]
        assert r["sum"] == 3.0


def test_one_process_mesh_changes_nothing():
    """No coordinator and one process: no process group, a one-rank mesh
    (``mesh_metadata`` the one-device block checkpoints write), every
    collective the identity."""
    pctx.reset_zoo_context()
    ctx = pctx.init_zoo_context()
    assert ctx.mesh is None and ctx.process_count == 1
    mesh = pmesh.global_mesh()
    assert mesh.size == 1
    from analytics_zoo_tpu_torch.utils.checkpoint import MESH_ONE_DEVICE
    assert pmesh.mesh_metadata(mesh) == MESH_ONE_DEVICE
    assert pmesh.format_mesh(pmesh.mesh_metadata(mesh)) == "{}"
    t = torch.arange(4.0)
    for fn in (lambda: pcol.all_reduce(t, mesh.group("data")),
               lambda: pcol.all_gather(t, mesh.group("model"), 0),
               lambda: pcol.ring_shift(t, mesh.group("seq"))):
        assert torch.equal(fn(), t)


def test_create_mesh_validates_like_jax():
    import jax

    from analytics_zoo_tpu.parallel import mesh as jmesh
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.create_mesh(model=3, ranks=range(4))
    with pytest.raises(ValueError, match="!= device count"):
        pmesh.create_mesh(data=3, ranks=range(4))
    with pytest.raises(ValueError, match="not divisible"):
        jmesh.create_mesh(model=3, devices=jax.devices()[:4])


def test_zero_sharding_for_and_batch_specs_match_jax():
    """``zero_sharding_for`` takes the first whole dimension the data axis
    divides (JAX ``test_zero_sharding_helper_picks_free_divisible_dim``),
    on a mesh given as axis sizes."""
    import jax
    from jax.sharding import PartitionSpec as P

    from analytics_zoo_tpu.parallel import mesh as jmesh

    class Sizes:
        shape = {"data": 4, "model": 2}
    jm = jmesh.create_mesh(data=4, model=2, devices=jax.devices()[:8])
    cases = [((), (8, 6)), ((None, "model"), (6, 8)),
             (("model", None), (8, 12)), ((), (3, 5))]
    for spec, shape in cases:
        want = jmesh.zero_sharding_for(
            jax.sharding.NamedSharding(jm, P(*spec)), shape, jm).spec
        got = pmesh.zero_sharding_for(spec, shape, Sizes)
        assert tuple(got or ()) == tuple(want) + (None,) * (
            len(tuple(got or ())) - len(tuple(want))), (spec, shape)
    assert pmesh.batch_sharding() == ("data",)
    assert pmesh.stacked_batch_sharding() == (None, "data")
    assert pmesh.replicated_sharding() == ()


@pytest.mark.parametrize("spec", [(None, "model"), ("model", None),
                                  (None, ("model", 3))])
def test_local_slices_put_back_whole(spec):
    """``local_slice`` on every rank of a 2-rank model axis, concatenated
    as ``gather_full`` does, is the whole array; a blocked dimension keeps
    each of its 3 blocks' slices together."""
    class Fake:
        shape = {"data": 1, "pipe": 1, "seq": 1, "expert": 1, "model": 2}

        def __init__(self, i):
            self.i = i

        def axis_index(self, ax):
            return self.i
    full = torch.arange(6 * 12.0).reshape(6, 12)
    parts = [pmesh.local_slice(full, spec, Fake(i)) for i in range(2)]
    dim = [i for i, e in enumerate(spec) if e is not None][0]
    blocks = spec[dim][1] if isinstance(spec[dim], tuple) else 1
    whole = torch.cat([torch.cat([p.chunk(blocks, dim)[b] for p in parts],
                                 dim) for b in range(blocks)], dim)
    assert torch.equal(whole, full)
    if blocks == 3:
        # rank 0's block is the first half of each of q, k and v
        assert torch.equal(parts[0][:, :2], full[:, :2])
        assert torch.equal(parts[0][:, 2:4], full[:, 4:6])


@pytest.mark.parametrize("cards,local,want", [
    (0, None, "gloo"), (0, 4, "gloo"), (8, None, "nccl"), (8, 8, "nccl"),
    (8, 4, "nccl"), (1, 2, "gloo"), (1, None, "nccl"), (4, 16, "gloo")])
def test_backend_from_ranks_per_host(cards, local, want):
    """``_maybe_init_distributed``'s backend: NCCL whenever this host's
    ranks (``LOCAL_WORLD_SIZE``) each have a card, whatever the world size
    (2 hosts x 8 cards is NCCL); gloo on the CPU and where this host's
    ranks share a card, with the reason."""
    backend, why = pctx._backend(cards, local)
    assert backend == want
    if backend == "gloo":
        assert why
