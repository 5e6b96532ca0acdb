"""The port's CUDA kernels on a GPU, held against their plain PyTorch
versions. Skipped where no CUDA device exists. This file imports neither
jax nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

TF32 is off for both matmul and cuDNN, so the plain versions compute in
full f32. Forward tolerances: f32 1e-4 (other summation order over up to
260 keys), bf16 2e-2 (probabilities rounded to bf16 relative to a running
max in the kernel, to the final max in the plain version). Backward
tolerances, relative to the largest gradient of the case: f32 1e-4 (other
summation order), bf16 2e-2 (P and dS are rounded to bf16 at the same
points in both versions, but a value that the two f32 sums leave on
either side of a rounding boundary moves by one bf16 step, 2^-8).
The embedding kernels are held bit for bit: K1 against ``rows[inv]``, SA
against its plain version on the CPU (position-order sums) and itself.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                    reset_zoo_context)
from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
    KERNEL, KERNEL_BWD_DKV, KERNEL_BWD_DQ, flash_attention,
    flash_attention_bwd_reference, flash_attention_reference)
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
from analytics_zoo_tpu_torch.tfpark.bert_classifier import (
    BERTClassifier, make_bert_inputs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_zoo_context()
    yield torch.device("cuda")
    reset_zoo_context()


def _inputs(b, h, tq, tk, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, generator=g).to("cuda", dtype)
               for t in (tq, tk, tk))
    lens = torch.randint(tk // 3, tk + 1, (b,), generator=g)
    mask = (torch.arange(tk)[None, :] < lens[:, None]).float().cuda()
    mask[0] = 0.0                                   # one empty batch row
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal,tq,tk", [(False, 130, 130),
                                          (True, 130, 130),
                                          (True, 200, 70),
                                          (False, 33, 260)])
def test_kernel_matches_plain_version(cuda, dtype, atol, d, causal, tq, tk):
    q, k, v, mask = _inputs(2, 3, tq, tk, d, dtype, seed=d + tq)
    before = KERNEL.launches
    out, lse = flash_attention(q, k, v, mask=mask, causal=causal,
                               want_lse=True)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    ref, ref_lse = flash_attention_reference(q, k, v, mask, causal,
                                             want_lse=True)
    assert out.dtype == dtype and torch.all(out[0] == 0)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=atol, rtol=0)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(fin, torch.isfinite(lse))
    np.testing.assert_allclose(lse[fin].cpu().numpy(),
                               ref_lse[fin].cpu().numpy(), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                        q, q)
    q48 = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q48, q48, q48)


@pytest.mark.cuda
def test_bert_serving_goes_through_the_kernel(cuda):
    init_zoo_context(conf={"zoo.pallas.attention": True})
    cfg = dict(vocab=99, hidden_size=64, n_block=2, n_head=2, seq_len=96,
               intermediate_size=128)
    model = BERTClassifier(3, **cfg, device="cpu").init_weights()
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 99, (6, 96)).astype(np.int32)
    ids[:, 70:] = 0
    x = make_bert_inputs(ids, attention_mask=(ids != 0))
    want = InferenceModel(device="cpu").from_keras(model).predict(x)
    im = InferenceModel(device=cuda).from_keras(model)
    before = KERNEL.launches
    got = im.predict(x)
    assert KERNEL.launches == before + cfg["n_block"]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal,tq,tk", [(False, 130, 130),
                                          (True, 130, 130),
                                          (True, 200, 70),
                                          (False, 33, 260)])
def test_backward_kernels_match_plain_version(cuda, dtype, rtol, d, causal,
                                              tq, tk):
    """K3a and K3b against the plain backward on the same forward output
    and lse; batch row 0 sees no key, so its grads are exactly zero."""
    q, k, v, mask = _inputs(2, 3, tq, tk, d, dtype, seed=d + tk)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(d)
                     ).to("cuda", dtype)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = (KERNEL.launches, KERNEL_BWD_DQ.launches,
              KERNEL_BWD_DKV.launches)
    out, lse = flash_attention(q, k, v, mask=mask, causal=causal,
                               want_lse=True)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (KERNEL.launches, KERNEL_BWD_DQ.launches,
            KERNEL_BWD_DKV.launches) == tuple(n + 1 for n in before)
    want = flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(),
                                         mask, out.detach(), lse, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.all(g[0] == 0), f"{name}: empty batch row not zero"
        assert torch.isfinite(g).all(), name
        scale = max(w.float().abs().max().item(), 1e-6)
        err = (g.float() - w.float()).abs().max().item()
        assert err <= rtol * scale, f"{name}: {err} > {rtol} * {scale}"


@pytest.mark.cuda
def test_flash_output_has_a_grad_fn_on_cuda(cuda):
    """The output of the kernel carries autograd's node when its inputs
    require grad, so gradients reach q, k and v (and the qkv weights)."""
    q, k, v, mask = _inputs(1, 2, 64, 64, 64, torch.bfloat16, seed=1)
    q.requires_grad_()
    out = flash_attention(q, k, v, mask=mask)
    assert out.grad_fn is not None
    out.float().sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    with torch.no_grad():
        assert flash_attention(q, k, v, mask=mask).grad_fn is None


@pytest.mark.cuda
def test_bert_training_step_on_cuda_matches_cpu(cuda):
    """One SGD step of a small BERTClassifier through the kernels on the
    card against the same step on the CPU (plain versions), in f32."""
    init_zoo_context(conf={"zoo.pallas.attention": True})
    cfg = dict(vocab=99, hidden_size=64, n_block=2, n_head=2, seq_len=96,
               intermediate_size=128, hidden_drop=0.0, attn_drop=0.0)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 99, (8, 96)).astype(np.int32)
    ids[:, 70:] = 0
    y = rng.integers(0, 3, 8).astype(np.int32)
    x = make_bert_inputs(ids, attention_mask=(ids != 0))
    params = {}
    for dev in ("cpu", "cuda"):
        model = BERTClassifier(3, **cfg, device=dev).init_weights()
        model.compile(optimizer="sgd", loss="scce", lr=0.1)
        before = (KERNEL_BWD_DQ.launches, KERNEL_BWD_DKV.launches)
        model.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)
        if dev == "cuda":
            assert (KERNEL_BWD_DQ.launches, KERNEL_BWD_DKV.launches) == (
                before[0] + cfg["n_block"], before[1] + cfg["n_block"])
        params[dev] = {n: p.detach().cpu().numpy()
                       for n, p in model.named_parameters()}
    # f32 with TF32 off: only summation orders (and the atomic order of
    # the embedding gradient) differ, scaled by lr 0.1
    for name, want in params["cpu"].items():
        np.testing.assert_allclose(params["cuda"][name], want, atol=1e-5,
                                   rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# fused LM-head cross-entropy: K4, K5a, K5b
# ---------------------------------------------------------------------------
#
# Against the plain versions on the same inputs. f32: lse and the label
# logit 1e-4, gradients 1e-4 of the case's largest (summation order only).
# bf16: the logits round to bf16 at the same points in both, but an f32
# product that the two summation orders leave on either side of a rounding
# boundary moves that logit by one bf16 step (2^-8 relative), so lse 2e-2,
# the label logit one step of its magnitude, gradients 2e-2 of the largest.

CE_TOL = {torch.float32: dict(lse=1e-4, ll_rel=1e-5, grad=1e-4),
          torch.bfloat16: dict(lse=2e-2, ll_rel=2.0 ** -7, grad=2e-2)}


def _ce_inputs(n, hidden, v, dtype, seed, bias=True):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(n, hidden, generator=g).to("cuda", dtype)
    w = (torch.randn(hidden, v, generator=g) * hidden ** -0.5).to("cuda",
                                                                  dtype)
    b = (torch.randn(v, generator=g) * 0.5).cuda() if bias else None
    labels = torch.randint(0, v, (n,), generator=g, dtype=torch.int32)
    labels[::3] = -1                                   # masked rows
    return h, w, b, labels.cuda()


def _ce_counts():
    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import (
        KERNEL_CE_BWD_DH, KERNEL_CE_BWD_DW, KERNEL_CE_FWD)
    return (KERNEL_CE_FWD.launches, KERNEL_CE_BWD_DH.launches,
            KERNEL_CE_BWD_DW.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [64, 100, 512, 768, 1280, 2048])
@pytest.mark.parametrize("n,v,bias", [(70, 130, True), (200, 1000, False),
                                      (33, 8, True)])
def test_ce_kernels_match_plain_versions(cuda, dtype, hidden, n, v, bias):
    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import (
        fused_ce_backward, fused_ce_backward_reference, fused_ce_forward,
        fused_ce_forward_reference)
    tol = CE_TOL[dtype]
    h, w, b, labels = _ce_inputs(n, hidden, v, dtype, seed=n + hidden,
                                 bias=bias)
    labels[1] = v + 3                                  # over-range: no hit
    before = _ce_counts()
    lse, ll = fused_ce_forward(h, w, b, labels)
    torch.cuda.synchronize()
    ref_lse, ref_ll = fused_ce_forward_reference(h, w, b, labels)
    assert (lse - ref_lse).abs().max().item() <= tol["lse"]
    assert ll[1].item() == 0.0 and torch.all(ll[::3] == 0)
    ll_err = (ll - ref_ll).abs() / ref_ll.abs().clamp_min(1.0)
    assert ll_err.max().item() <= tol["ll_rel"]

    labels[1] = 0
    scale = torch.where(labels >= 0, 1.0 / n, 0.0).float()
    dh, dw, db = fused_ce_backward(h, w, b, labels, ref_lse, scale)
    torch.cuda.synchronize()
    assert _ce_counts() == tuple(c + 1 for c in before)
    want = fused_ce_backward_reference(h, w, b, labels, ref_lse, scale)
    assert dh.dtype == dtype and dw.dtype == torch.float32
    assert torch.all(dh[::3] == 0), "masked rows' dh not exactly 0"
    for name, got, ref in (("dh", dh, want[0]), ("dw", dw, want[1]),
                           ("db", db, want[2])):
        if ref is None:
            assert got is None
            continue
        assert torch.isfinite(got).all(), name
        top = ref.float().abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol["grad"] * top, f"{name}: {err} > {tol} x {top}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_over_range_rows_poison_dh_rows_and_all_of_dw(cuda, dtype):
    from analytics_zoo_tpu_torch.ops.fused_cross_entropy import \
        fused_sparse_cross_entropy
    h, w, b, labels = _ce_inputs(100, 128, 300, dtype, seed=4)
    labels[[5, 50, 99]] = torch.tensor([300, 301, 10 ** 6],
                                       dtype=torch.int32, device=cuda)
    h.requires_grad_()
    w32 = w.float().requires_grad_()
    loss = fused_sparse_cross_entropy(labels, h, w32, b)
    loss.backward()
    assert torch.isnan(loss)
    bad = torch.zeros(100, dtype=torch.bool, device=cuda)
    bad[[5, 50, 99]] = True
    assert torch.isnan(h.grad[bad]).all()
    assert torch.isfinite(h.grad[~bad]).all()
    assert torch.isnan(w32.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ce_backward_is_bit_identical_over_runs(cuda, dtype):
    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import (
        fused_ce_backward, fused_ce_forward)
    h, w, b, labels = _ce_inputs(1000, 256, 777, dtype, seed=9)
    lse, _ = fused_ce_forward(h, w, b, labels)
    scale = torch.full((1000,), 1e-3, device=cuda)
    first = fused_ce_backward(h, w, b, labels, lse, scale)
    second = fused_ce_backward(h, w, b, labels, lse, scale)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_ce_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """A non-contiguous operand is refused. Any hidden width is taken:
    H = 96 and 1088 (padded to 128 and 1152, the latter in two slices)
    launch the kernel and match the plain version."""
    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import (
        fused_ce_forward, fused_ce_forward_reference)
    labels = torch.zeros(4, dtype=torch.int32, device=cuda)
    for hidden in (96, 1088):
        h = torch.randn(4, hidden, device=cuda)
        w = torch.randn(hidden, 10, device=cuda) * hidden ** -0.5
        before = _ce_counts()[0]
        lse, _ = fused_ce_forward(h, w, None, labels)
        torch.cuda.synchronize()
        assert _ce_counts()[0] == before + 1
        ref, _ = fused_ce_forward_reference(h, w, None, labels)
        assert (lse - ref).abs().max().item() <= CE_TOL[torch.float32]["lse"]
    w = torch.zeros(10, 64, device=cuda).T
    with pytest.raises(ValueError, match="contiguous"):
        fused_ce_forward(torch.zeros(4, 64, device=cuda), w, None, labels)


@pytest.mark.cuda
def test_lm_training_step_on_cuda_matches_cpu(cuda):
    """One SGD step of a small causal LM (fused CE through K4/K5a/K5b,
    attention through K2/K3a/K3b) on the card against the same step on the
    CPU (plain versions), in f32."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense, TransformerLayer)
    init_zoo_context(conf={"zoo.pallas.attention": True,
                           "zoo.train.fused_ce": True})
    cfg = dict(vocab=130, seq_len=64, n_block=2, hidden_size=64, n_head=2,
               hidden_drop=0.0, attn_drop=0.0, embedding_drop=0.0)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 130, (8, 64)).astype(np.int32)
    y = ((7 * x + 13) % 130).astype(np.int32)
    params = {}
    for dev in ("cpu", "cuda"):
        model = Sequential([TransformerLayer(**cfg, input_shape=(64,)),
                            Dense(130)], device=dev)
        model.init_weights(torch.Generator().manual_seed(2))
        model.compile(optimizer="sgd", loss="scce_with_logits", lr=0.1)
        before = _ce_counts()
        model.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)
        if dev == "cuda":
            assert _ce_counts() == tuple(c + 1 for c in before)
        params[dev] = {n: p.detach().cpu().numpy()
                       for n, p in model.named_parameters()}
    for name, want in params["cpu"].items():
        np.testing.assert_allclose(params["cuda"][name], want, atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_with_hidden_100_fits_through_the_ce_kernels(cuda, dtype):
    """A Sequential LM whose head input width (100) is no multiple of 64
    fits on the card with the fused CE engaged (auto, V = 1024): one
    launch of each of K4/K5a/K5b per step; in f32 its losses match the
    same fit on the CPU (plain versions) within 1e-4."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import engine
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense, TransformerLayer)
    init_zoo_context()
    engine.set_policy(compute_dtype=dtype)
    cfg = dict(vocab=1024, seq_len=16, n_block=1, hidden_size=100, n_head=4,
               hidden_drop=0.0, attn_drop=0.0, embedding_drop=0.0)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1024, (16, 16)).astype(np.int32)
    y = ((7 * x + 13) % 1024).astype(np.int32)
    losses = {}
    try:
        for dev in ("cpu", "cuda"):
            model = Sequential([TransformerLayer(**cfg, input_shape=(16,)),
                                Dense(1024)], device=dev)
            model.init_weights(torch.Generator().manual_seed(2))
            model.compile(optimizer="adam", loss="scce_with_logits", lr=1e-3)
            before = _ce_counts()
            losses[dev] = model.fit(x, y, batch_size=8, nb_epoch=2)["loss"]
            if dev == "cuda":
                assert _ce_counts() == tuple(c + 4 for c in before)
    finally:
        engine.set_policy()
    assert all(np.isfinite(losses["cuda"]))
    if dtype == torch.float32:
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=1e-4,
                                   rtol=0)


# --- K1 (embed_expand) and SA (dedup_scatter_add): bit for bit ---

def _embed_counts():
    from analytics_zoo_tpu_torch.ops.pallas.embedding import (
        KERNEL_EMBED_EXPAND, KERNEL_SCATTER_ADD)
    return KERNEL_EMBED_EXPAND.launches, KERNEL_SCATTER_ADD.launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [20, 21, 64, 128])
def test_embed_expand_kernel_is_rows_at_inv(cuda, dtype, d):
    """K1 against rows[inv], bit for bit, at a ragged N (1001 ids over 300
    unique rows; D = 21 bf16 rows take 2-byte copies, D = 20 bf16 8-byte,
    f32 16-byte)."""
    from analytics_zoo_tpu_torch.ops.pallas.embedding import embed_expand
    g = torch.Generator().manual_seed(d)
    rows = torch.randn(300, d, generator=g).to(cuda, dtype)
    inv = torch.randint(0, 300, (1001,), generator=g,
                        dtype=torch.int32).to(cuda)
    before = _embed_counts()[0]
    out = embed_expand(rows, inv)
    torch.cuda.synchronize()
    assert _embed_counts()[0] == before + 1
    assert out.dtype == dtype and out.shape == (1001, d)
    assert torch.equal(out.view(torch.int16), rows[inv.long()].view(
        torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [20, 128])
def test_dedup_scatter_add_kernel_matches_cpu_bit_for_bit(cuda, dtype, d):
    """SA against its plain version on the CPU (index_add_ in position
    order), bit for bit, and the same bits over two runs; heavy repeats
    and empty slots."""
    from analytics_zoo_tpu_torch.ops.pallas.embedding import (
        dedup_scatter_add, dedup_scatter_add_reference)
    gen = torch.Generator().manual_seed(d + 1)
    g = (torch.randn(4096, d, generator=gen)
         * 10.0 ** torch.randint(-3, 3, (4096, 1), generator=gen)).to(dtype)
    inv = torch.randint(0, 97, (4096,), generator=gen, dtype=torch.int32)
    want = dedup_scatter_add_reference(g, inv, 128)
    before = _embed_counts()[1]
    runs = [dedup_scatter_add(g.to(cuda), inv.to(cuda), 128)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert _embed_counts()[1] == before + 2
    for got in runs:
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
    assert torch.all(runs[0][97:] == 0)


@pytest.mark.cuda
def test_sharded_embedding_graph_step_on_cuda_matches_cpu(cuda):
    """One SGD step of a NeuralCF-shaped graph on ShardedEmbedding tables
    on the card (K1 and SA, four launches each) against the same step on
    the CPU (plain versions): parameters within 1e-6."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (Input,
                                                                   Model)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense, Merge, Select, ShardedEmbedding)
    init_zoo_context()
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(1, 64, 256), rng.integers(1, 128, 256)],
                 1).astype(np.int32)
    y = (x.sum(1) % 5).astype(np.int32)
    params = {}
    for dev in ("cpu", "cuda"):
        inp = Input(shape=(2,))
        user, item = Select(1, 0)(inp), Select(1, 1)(inp)
        h = Merge(mode="concat")([ShardedEmbedding(64, 8)(user),
                                  ShardedEmbedding(128, 8)(item)])
        mf = Merge(mode="mul")([ShardedEmbedding(64, 8)(user),
                                ShardedEmbedding(128, 8)(item)])
        h = Merge(mode="concat")([Dense(16, activation="relu")(h), mf])
        model = Model(inp, Dense(5, activation="softmax")(h), device=dev)
        model.init_weights(torch.Generator().manual_seed(1))
        model.compile(optimizer="sgd", loss="scce", lr=0.1)
        before = _embed_counts()
        model.fit(x, y, batch_size=256, nb_epoch=1, shuffle=False)
        if dev == "cuda":
            assert _embed_counts() == tuple(c + 4 for c in before)
        params[dev] = {n: p.detach().cpu().numpy()
                       for n, p in model.named_parameters()}
    for name, want in params["cpu"].items():
        np.testing.assert_allclose(params["cuda"][name], want, atol=1e-6,
                                   rtol=0, err_msg=name)


def _bf16_step(v: float) -> float:
    """One bf16 step (unit in the last place) at magnitude ``v``."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _int8_operands(m, k, n, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=gen).to(dtype)
    w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    s = torch.rand(n, generator=gen) * 0.09 + 0.01
    return x, w, s


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (32, 4096, 4096),
                                   (2, 256, 48), (17, 100, 10),
                                   (32, 768, 2), (33, 130, 130),
                                   (300, 768, 2304), (257, 96, 50),
                                   (129, 3072, 768)])
def test_int8_matmul_kernel_matches_plain_version(cuda, dtype, m, k, n):
    """K6 against its plain version on the card (TF32 off): f32 within
    1e-4 of the case's largest value (summation order only); bf16 within
    one bf16 step at the case's largest value (the two f32 sums may round
    to neighbouring bf16 values). Then the same bits on a second run."""
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_MATMUL, int8_matmul, int8_matmul_reference)
    x, w, s = (t.to(cuda) for t in _int8_operands(m, k, n, dtype, m + k))
    before = KERNEL_INT8_MATMUL.launches
    got = int8_matmul(x, w, s)
    again = int8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert KERNEL_INT8_MATMUL.launches == before + 2
    want = int8_matmul_reference(x, w, s)
    assert got.dtype == dtype and got.shape == (m, n)
    top = want.float().abs().max().item()
    tol = 1e-4 * top if dtype == torch.float32 else _bf16_step(top)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       again.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))


@pytest.mark.cuda
def test_int8_matmul_refuses_what_the_kernel_does_not_take(cuda):
    from analytics_zoo_tpu_torch.ops.pallas.quantized import int8_matmul
    x = torch.zeros(4, 8, device=cuda)
    w = torch.zeros(8, 3, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="shape mismatch"):
        int8_matmul(x, w, torch.zeros(4, device=cuda))
    with pytest.raises(TypeError, match="int8"):
        int8_matmul(x, w.float(), torch.zeros(3, device=cuda))
    with pytest.raises(ValueError, match="devices"):
        int8_matmul(x, w, torch.zeros(3))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 64, 8), (32, 4096, 8),
                                   (1, 100, 10), (32, 768, 2),
                                   (40, 24, 16)])
def test_int8_product_pads_for_int_mm_exactly(cuda, m, k, n):
    """``torch._int_mm`` on the card wants M > 16 and K, N multiples of
    8; the padded product is the CPU's int32 product bit for bit."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import \
        int8_product
    gen = torch.Generator().manual_seed(m * k + n)
    xq = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    got = int8_product(xq.to(cuda), wq.to(cuda))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), xq.int() @ wq.int())


@pytest.mark.cuda
def test_weight_only_dense_raises_without_the_kernel_library(cuda,
                                                             monkeypatch):
    """A weight-only int8 Dense on the card runs K6 or raises: with the
    kernel's library missing it does not fall back to a float product."""
    from analytics_zoo_tpu_torch.ops import cuda_build
    from analytics_zoo_tpu_torch.ops.pallas import quantized
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    init_zoo_context()
    model = Sequential([Dense(32, input_shape=(64,))],
                       device="cpu").init_weights()
    im = InferenceModel(device=cuda).from_keras(model, quantize="int8")
    x = np.ones((4, 64), np.float32)
    before = quantized.KERNEL_INT8_MATMUL.launches
    im.predict(x)
    assert quantized.KERNEL_INT8_MATMUL.launches == before + 1
    monkeypatch.setattr(quantized, "LIBRARY", cuda_build.CudaLibrary(
        "missing", ["no_such_source.cu"], quantized._bind))
    with pytest.raises((RuntimeError, OSError)):
        im.predict(x)
    assert quantized.KERNEL_INT8_MATMUL.launches == before + 1
