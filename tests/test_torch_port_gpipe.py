"""Pipeline parallelism: the GPipe schedule (``parallel/pipeline.py``),
the ``GPipe`` and ``Pipeline`` layers (``layers/gpipe.py``) and the
training loop's stage cut (``keras/seq_pipe.py``: ``zoo.train.
pipe_stages``), held to sequential stage application, to plain data
parallelism and to the JAX package's fits on the same meshes
(``tests/test_pipeline_parallel.py``, ``tests/test_seq_pipe.py``).

The torch side runs as 4 gloo ranks on the CPU (one process group for the
file; ``file://`` store under ``tmp_path``); the workers import this
module, which imports no ``jax`` at the top.

Tolerances: forwards 2e-4 relative, 2e-5 absolute against the sequential
stages (the JAX tests'); fits 1e-5 on losses against the JAX fit on the
same mesh and against plain DP (collective order), 1e-4 / 1e-5 on
predictions after the Adam steps.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.parallel import mesh as pmesh
from analytics_zoo_tpu_torch.parallel.launch import run_ranks

WORLD = 4
TOL = dict(rtol=2e-4, atol=2e-5)
T, H = 16, 8


def _data(n=256, d=8, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, classes)).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.int32)


def _context(**axes):
    pctx.reset_zoo_context()
    conf = {f"zoo.mesh.{k}": v for k, v in axes.items() if k != "conf"}
    conf.update(axes.get("conf", {}))
    pctx.init_zoo_context(conf=conf)
    return pmesh.global_mesh()


def _torch_layers():
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        Lambda, Sequential, reset_uids)
    return layers, Sequential, Lambda, reset_uids


def _pp_net(stages=4):
    layers, Sequential, _, reset_uids = _torch_layers()
    reset_uids()
    return Sequential([
        layers.Dense(16, activation="relu", input_shape=(8,)),
        layers.GPipe(lambda: layers.Dense(16, activation="tanh"),
                     num_stages=stages, name="pipe"),
        layers.Dense(4, activation="softmax")], device="cpu")


def _sequential(layer, x):
    """The stages one after another on the whole stacked parameters."""
    h = x
    for s in range(layer.num_stages):
        h = torch.tanh(h @ pmesh.full_tensor(layer.stage.W)[s]
                       + pmesh.full_tensor(layer.stage.b)[s])
    return h


def _layer_cases():
    layers, Sequential, _, reset_uids = _torch_layers()
    out = {}
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, 8)).astype(np.float32))
    for name, stages, kw in (("pipe4", 4, {}), ("grouped", 8, {}),
                             ("micro8", 4, {"n_microbatches": 8}),
                             ("remat", 4, {"remat": True})):
        mesh = _context(pipe=4)
        reset_uids()
        layer = layers.GPipe(lambda: layers.Dense(8, activation="tanh"),
                             num_stages=stages, **kw)
        m = Sequential([layer], device="cpu")
        m.build((None, 8), generator=torch.Generator().manual_seed(0))
        m.built = True
        pmesh.place_params(m, mesh)
        xg = x.clone().requires_grad_()
        y = m(xg)
        y.square().sum().backward()
        want_x = x.clone().requires_grad_()
        want = _sequential(layer, want_x)
        want.square().sum().backward()
        out[name] = (y.detach().numpy(), want.detach().numpy(),
                     xg.grad.numpy(), want_x.grad.numpy(),
                     tuple(layer.stage.W.shape))
    # a batch the microbatches do not divide: sequential, one warning
    _context(pipe=4)
    reset_uids()
    layer = layers.GPipe(lambda: layers.Dense(8, activation="tanh"), 4)
    m = Sequential([layer], device="cpu")
    m.build((None, 8), generator=torch.Generator().manual_seed(0))
    m.built = True
    pmesh.place_params(m, pmesh.global_mesh())
    out["ragged"] = (m(x[:6]).detach().numpy(),
                     _sequential(layer, x[:6]).detach().numpy(),
                     layer._warned_fallback)
    # stages the pipe axis does not divide
    reset_uids()
    bad = layers.GPipe(lambda: layers.Dense(8), 3)
    mb = Sequential([bad], device="cpu")
    mb.build((None, 8), generator=torch.Generator().manual_seed(0))
    try:
        bad(x)
        out["guard"] = None
    except ValueError as e:
        out["guard"] = str(e)
    return out


def _fit(net, axes, tree, x, y, epochs=3, bs=64):
    _context(**axes)
    m = net().init_weights()
    if tree is not None:
        m.load_jax_params(tree)
    m.compile(optimizer="adam", loss="scce", lr=0.01)
    h = m.fit(x, y, batch_size=bs, nb_epoch=epochs, shuffle=False)
    return {"loss": h["loss"], "pred": m.predict(x, batch_size=bs),
            "local": {n: tuple(p.shape) for n, p in m.named_parameters()}}


def _hetero_net():
    layers, Sequential, _, reset_uids = _torch_layers()
    reset_uids()
    return Sequential([
        layers.Dense(16, activation="relu", input_shape=(8,)),
        layers.Pipeline([[layers.Dense(12, activation="tanh")],
                         [layers.Dense(6, activation="relu"),
                          layers.Dense(16)]], name="pl"),
        layers.Dense(4, activation="softmax")], device="cpu")


def _real_net():
    layers, Sequential, Lambda, reset_uids = _torch_layers()
    reset_uids()
    return Sequential([
        layers.Embedding(50, 8, input_shape=(T,)),
        layers.GPipe(lambda: layers.TransformerBlock(8, 2, causal=True),
                     num_stages=2, name="blocks"),
        Lambda(lambda h: h[:, -1, :], name="last"),
        layers.Dense(4, activation="softmax")], device="cpu")


def _blocks_model(head=4):
    layers, Sequential, Lambda, reset_uids = _torch_layers()
    reset_uids()
    blocks = [layers.TransformerBlock(
        H, 2, causal=True, **({"input_shape": (T, H)} if i == 0 else {}))
        for i in range(4)]
    return Sequential(blocks + [Lambda(lambda h: h[:, -1, :], name="last"),
                                layers.Dense(head)], device="cpu")


def _stage_cut(conf, axes, head=4, loss="scce_with_logits"):
    _context(conf=conf, **axes)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, T, H)).astype(np.float32)
    y = rng.integers(0, head, 16).astype(np.int32)
    m = _blocks_model(head).init_weights(torch.Generator().manual_seed(1))
    m.compile(optimizer="adam", loss=loss, lr=1e-2)
    return m.fit(x, y, batch_size=16, nb_epoch=2, shuffle=False)["loss"]


NOISE_B, NOISE_W = 16, 8


def _noise_case(device="cpu", remat=False, pipe=4):
    """``gpipe_apply`` over ``pipe`` ranks, one stage a rank, with a stage
    that draws a keep mask from its generator (a CPU one split a tick, or
    a device one drawn in program order) and records every draw: the
    output, the input's and the rank's weight's gradients, and the masks
    the forward drew (gathered over the axis) and any the backward drew
    again."""
    from analytics_zoo_tpu_torch.parallel import collectives as pcol
    from analytics_zoo_tpu_torch.parallel.pipeline import gpipe_apply
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.gpipe import \
        _remat
    mesh = _context(pipe=pipe)
    ax = mesh.group("pipe")
    x, w, c = _noise_inputs(pipe)
    x = torch.from_numpy(x).to(device).requires_grad_()
    local = {"W": torch.from_numpy(w[ax.index:ax.index + 1]).to(
        device).requires_grad_()}
    gen = (torch.Generator(device=device).manual_seed(3) if device != "cpu"
           else torch.Generator().manual_seed(3))
    drawn = []

    def stage(p, h, g):
        keep = (torch.rand(h.shape, generator=g, device=h.device)
                < 0.5).to(h.dtype)
        drawn.append(keep.detach())
        return torch.tanh(h @ p["W"]) * keep * 2.0

    n_micro = pipe
    y = gpipe_apply(_remat(stage) if remat else stage, local, x, mesh=mesh,
                    n_micro=n_micro, generator=gen)
    ticks = n_micro + pipe - 1
    fwd = torch.stack(drawn[:ticks])
    (y * torch.from_numpy(c).to(device)).sum().backward()
    again = drawn[ticks:]
    return {"y": y.detach().cpu().numpy(),
            "gx": x.grad.cpu().numpy(),
            "gw": local["W"].grad[0].cpu().numpy(),
            "masks": pcol.all_gather(fwd[None], ax, 0).cpu().numpy(),
            "redrawn": (torch.stack(again[::-1]).cpu().numpy() if again
                        else None), "fwd": fwd.cpu().numpy()}


def _noise_inputs(pipe):
    rng = np.random.default_rng(4)
    return (rng.normal(size=(NOISE_B, NOISE_W)).astype(np.float32),
            (rng.normal(size=(pipe, NOISE_W, NOISE_W)) / 3).astype(
                np.float32),
            rng.normal(size=(NOISE_B, NOISE_W)).astype(np.float32))


def _noise_ranks(rank, world, device, remat):
    return _noise_case(device, remat, pipe=world)


def _check_noise(ranks, pipe):
    """Every rank's output and gradients are those of the stages applied
    one after another with the masks the forward drew (rank ``s``'s mask
    for microbatch ``i`` drawn at tick ``i + s``), and a recompute drew
    the forward's masks again."""
    x, w, c = (torch.from_numpy(a) for a in _noise_inputs(pipe))
    x.requires_grad_()
    w.requires_grad_()
    masks = torch.from_numpy(ranks[0]["masks"])
    mb = NOISE_B // pipe
    ys = []
    for i in range(pipe):
        h = x[i * mb:(i + 1) * mb]
        for s in range(pipe):
            h = torch.tanh(h @ w[s]) * masks[s, i + s] * 2.0
        ys.append(h)
    y = torch.cat(ys)
    (y * c).sum().backward()
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["y"], y.detach().numpy(), **TOL)
        np.testing.assert_allclose(r["gx"], x.grad.numpy(), **TOL)
        np.testing.assert_allclose(r["gw"], w.grad[rank].numpy(), **TOL)
        if r["redrawn"] is not None:
            np.testing.assert_array_equal(r["redrawn"], r["fwd"])


def _torch_side(rank, world, tree, hetero_tree):
    out = {"layer": _layer_cases()}
    out["noise"] = {remat: _noise_case(remat=remat)
                    for remat in (False, True)}
    x, y = _data()
    for name, axes in (("dp", {"data": 4}), ("pp4", {"pipe": 4}),
                       ("pp2", {"data": 2, "pipe": 2})):
        out[name] = _fit(_pp_net, axes, tree, x, y)
    for name, axes in (("hetero_dp", {"data": 4}),
                       ("hetero_pp", {"data": 2, "pipe": 2})):
        out[name] = _fit(_hetero_net, axes, hetero_tree, x, y)
    try:
        _context(pipe=4)
        _hetero_net().init_weights()(torch.zeros(8, 8))
        out["hetero_guard"] = None
    except ValueError as e:
        out["hetero_guard"] = str(e)
    ids = np.random.default_rng(2).integers(0, 50, (64, T)).astype(np.int32)
    yy = (ids.sum(1) % 4).astype(np.int32)
    for name, axes in (("real_dp", {"data": 4}),
                       ("real_pp", {"data": 2, "pipe": 2})):
        _context(**axes)
        m = _real_net().init_weights(torch.Generator().manual_seed(5))
        m.compile(optimizer="sgd", loss="scce", lr=0.1)
        out[name] = m.fit(ids, yy, batch_size=32, nb_epoch=2,
                          shuffle=False)["loss"]
    out["cut_plain"] = _stage_cut({}, {"data": 4})
    for name, axes in (("cut_pp2", {"data": 2, "pipe": 2}),
                       ("cut_pp4", {"pipe": 4}),
                       ("cut_seq", {"data": 4})):
        out[name] = _stage_cut({"zoo.train.pipe_stages": 4}, axes)
    out["cut_fused"] = (
        _stage_cut({"zoo.train.fused_ce": True}, {"data": 4}, head=1024),
        _stage_cut({"zoo.train.fused_ce": True,
                    "zoo.train.pipe_stages": 4}, {"data": 2, "pipe": 2},
                   head=1024))
    errors = []
    for conf in ({"zoo.train.pipe_stages": 3}, {"zoo.train.pipe_stages": 4}):
        try:
            axes = {"pipe": 4} if conf["zoo.train.pipe_stages"] == 3 else {}
            if not axes:
                # a graph Model, not a Sequential
                from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
                    Input, Model)
                from analytics_zoo_tpu_torch.pipeline.api.keras.layers \
                    import Dense
                from analytics_zoo_tpu_torch.pipeline.api.keras.seq_pipe \
                    import resolve_pipe_spec
                _context(conf=conf, data=4)
                inp = Input((8,))
                resolve_pipe_spec(Model(inp, Dense(4)(inp), device="cpu"))
            else:
                _stage_cut(conf, axes)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["cut_errors"] = errors
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_fits():
    import jax
    import optax

    from analytics_zoo_tpu.common.context import (init_zoo_context,
                                                  reset_zoo_context)
    from analytics_zoo_tpu.parallel import mesh as jmesh
    from analytics_zoo_tpu.pipeline.api.keras import Sequential
    from analytics_zoo_tpu.pipeline.api.keras.engine import reset_uids
    from analytics_zoo_tpu.pipeline.api.keras.layers import (Dense, GPipe,
                                                             Pipeline)
    x, y = _data()
    nets = {
        "pp": lambda: Sequential([
            Dense(16, activation="relu", input_shape=(8,)),
            GPipe(lambda: Dense(16, activation="tanh"), num_stages=4,
                  name="pipe"),
            Dense(4, activation="softmax")]),
        "hetero": lambda: Sequential([
            Dense(16, activation="relu", input_shape=(8,)),
            Pipeline([[Dense(12, activation="tanh")],
                      [Dense(6, activation="relu"), Dense(16)]], name="pl"),
            Dense(4, activation="softmax")])}
    out = {}
    for name, axes in (("pp", {"data": 2, "pipe": 2}),
                       ("hetero", {"data": 2, "pipe": 2})):
        reset_zoo_context()
        init_zoo_context()
        jmesh.set_global_mesh(jmesh.create_mesh(devices=jax.devices()[:4],
                                                **axes))
        reset_uids()
        m = nets[name]()
        m.compile(optimizer=optax.adam(0.01), loss="scce")
        m.init_weights(sample_input=x[:8])
        tree = jax.tree.map(np.asarray, m.params)
        h = m.fit(x, y, batch_size=64, nb_epoch=3, shuffle=False)
        out[name] = (tree, {"loss": h["loss"],
                            "pred": np.asarray(m.predict(x, batch_size=64))})
    reset_zoo_context()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    want = _jax_fits()
    store = tmp_path_factory.mktemp("gloo") / "store"
    ranks = run_ranks(_torch_side, WORLD, str(store),
                      args=(want["pp"][0], want["hetero"][0]))
    return {k: v[1] for k, v in want.items()}, ranks


@pytest.mark.parametrize("case", ["pipe4", "grouped", "micro8", "remat"])
def test_gpipe_forward_and_grad_match_sequential_stages(results, case):
    """On pipe 4: 4 stages a rank each, 8 stages two a rank, 8
    microbatches, and the remat'd schedule — the forward and the input's
    gradient the stages' one after another; each rank holds its stages'
    rows only."""
    for r in results[1]:
        y, want, gx, gwant, shape = r["layer"][case]
        np.testing.assert_allclose(y, want, **TOL)
        np.testing.assert_allclose(gx, gwant, **TOL)
        assert shape[0] == (2 if case == "grouped" else 1)


@pytest.mark.parametrize("remat", [False, True])
def test_gpipe_stage_noise_gradients_use_the_forward_masks(results, remat):
    """A stage that draws dropout-like noise on pipe 4 (CPU generator,
    split a tick): the output and every gradient are those of the masks
    the forward drew — the schedule keeps each tick's graph, and a
    rematerialised stage draws its forward's masks again."""
    _check_noise([r["noise"][remat] for r in results[1]], WORLD)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_gpipe_stage_noise_on_a_device_generator(tmp_path, remat):
    """The same on the card: two gloo ranks sharing it, each stage's
    noise drawn from one device generator in program order — the
    gradients are those of the forward's masks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ranks = run_ranks(_noise_ranks, 2, str(tmp_path / "store"),
                      args=("cuda", remat), device="cuda")
    _check_noise(ranks, 2)


def test_gpipe_guards_and_sequential_fallback(results):
    for r in results[1]:
        y, want, warned = r["layer"]["ragged"]
        np.testing.assert_allclose(y, want, **TOL)
        assert warned
        assert "multiple of the pipe axis" in r["layer"]["guard"]


@pytest.mark.parametrize("mesh", ["pp4", "pp2"])
def test_dp_vs_pp_numerical_equality(results, mesh):
    """pipe 4 and data 2 x pipe 2 train as plain DP; data 2 x pipe 2 as the
    JAX fit on the same mesh; the stage weights split over pipe."""
    for r in results[1]:
        np.testing.assert_allclose(r[mesh]["loss"], r["dp"]["loss"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r[mesh]["pred"], r["dp"]["pred"],
                                   rtol=1e-4, atol=1e-5)
        assert r[mesh]["local"]["pipe.W"][0] == (1 if mesh == "pp4" else 2)
    want = results[0]["pp"]
    for r in results[1]:
        np.testing.assert_allclose(r["pp2"]["loss"], want["loss"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["pp2"]["pred"], want["pred"],
                                   rtol=1e-4, atol=1e-5)


def test_hetero_pipeline_trains_dp_vs_pp_equal_and_as_jax(results):
    """Heterogeneous stages (packed into one (S, L) stack, the JAX layout)
    on data 2 x pipe 2: plain DP's and the JAX fit's; a stage count other
    than the pipe axis is refused."""
    want = results[0]["hetero"]
    for r in results[1]:
        np.testing.assert_allclose(r["hetero_pp"]["loss"],
                                   r["hetero_dp"]["loss"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["hetero_pp"]["loss"], want["loss"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["hetero_pp"]["pred"], want["pred"],
                                   rtol=1e-4, atol=1e-5)
        assert r["hetero_pp"]["local"]["pl.stack"][0] == 1
        assert "exactly one stage" in r["hetero_guard"]


def test_real_model_with_embedding_front_and_head_pipelines(results):
    """Embedding → GPipe(TransformerBlock) → head on data 2 x pipe 2: the
    plain DP fit's losses."""
    for r in results[1]:
        np.testing.assert_allclose(r["real_pp"], r["real_dp"], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("mesh", ["cut_pp2", "cut_pp4", "cut_seq"])
def test_pipe_stages_matches_plain_step(results, mesh):
    """``zoo.train.pipe_stages=4`` cuts the TransformerBlock run into the
    GPipe schedule on data 2 x pipe 2 and on pipe 4, and runs it
    sequentially without a pipe axis: the plain step's losses."""
    for r in results[1]:
        np.testing.assert_allclose(r[mesh], r["cut_plain"], rtol=1e-5,
                                   atol=1e-6)


def test_pipe_stages_composes_with_fused_ce_head(results):
    for r in results[1]:
        plain, cut = r["cut_fused"]
        np.testing.assert_allclose(cut, plain, rtol=1e-5, atol=1e-6)


def test_pipe_stages_validation(results):
    for r in results[1]:
        mismatch, not_sequential = r["cut_errors"]
        assert "stage count must equal" in mismatch
        assert "needs a Sequential" in not_sequential
