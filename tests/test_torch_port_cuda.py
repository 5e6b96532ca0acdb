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
against its plain version on the CPU (position-order sums) and itself,
both standalone and through the dedup'd lookup's forward sort.
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
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal,tq,tk", [(False, 200, 200),
                                          (True, 200, 200),
                                          (False, 4100, 4100),
                                          (True, 4100, 4100),
                                          (True, 70, 200),
                                          (True, 200, 70)])
def test_forward_kernel_at_tile_edges(cuda, dtype, atol, d, causal, tq, tk):
    """K2 over ragged tiles (T = 200, 4100), causal Tq < Tk and Tq > Tk, the
    tile-edge mask of ``_tile_edge_mask`` (row 2 sees only the first key
    tile, row 3 none of keys 64..127): within the tolerances above, exact
    zeros and an infinite lse on every row that sees no key, the same
    output without the lse, and the same bits on a second call."""
    q, k, v, mask = _inputs(4, 3, tq, tk, d, dtype, seed=d + tq + tk)
    mask = _tile_edge_mask(mask)
    before = KERNEL.launches
    out, lse = flash_attention(q, k, v, mask=mask, causal=causal,
                               want_lse=True)
    plain = flash_attention(q, k, v, mask=mask, causal=causal)
    again = flash_attention(q, k, v, mask=mask, causal=causal)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 3
    ref, ref_lse = flash_attention_reference(q, k, v, mask, causal,
                                             want_lse=True)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=atol, rtol=0)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(fin, torch.isfinite(lse))
    assert torch.all(out[~fin] == 0), "a row that sees no key is not zero"
    np.testing.assert_allclose(lse[fin].cpu().numpy(),
                               ref_lse[fin].cpu().numpy(), atol=1e-4, rtol=0)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(plain.view(bits), out.view(bits))
    assert torch.equal(again.view(bits), out.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["q", "k", "v"])
def test_forward_wrapper_refuses_a_misaligned_operand(cuda, name):
    """The bf16 forward reads q, k and v through TMA, whose tensor maps take
    only 16-byte aligned bases: a view two bytes in is refused before any
    launch, and never handed to another route."""
    ops = {key: torch.zeros(1, 2, 8, 64, device=cuda, dtype=torch.bfloat16)
           for key in ("q", "k", "v")}
    flat = torch.zeros(ops[name].numel() + 1, device=cuda,
                       dtype=torch.bfloat16)
    ops[name] = flat[1:].view(ops[name].shape)
    before = KERNEL.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        flash_attention(ops["q"], ops["k"], ops["v"])
    assert KERNEL.launches == before


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


def _tile_edge_mask(mask):
    """Batch rows 2 and 3 of a key-padding mask at the kernels' 64-key tile
    edges: row 2 keeps only the first key tile, row 3 hides its second key
    tile (keys 64..127) entirely and keeps every other key."""
    mask[2] = 0.0
    mask[2, :64] = 1.0
    mask[3] = 1.0
    mask[3, 64:128] = 0.0
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal,tq,tk", [(False, 130, 130),
                                          (True, 130, 130),
                                          (True, 200, 70),
                                          (False, 33, 260),
                                          (False, 200, 200),
                                          (True, 70, 200),
                                          (True, 4100, 4100)])
def test_backward_kernels_match_plain_version(cuda, dtype, rtol, d, causal,
                                              tq, tk):
    """K3a and K3b against the plain backward on the same forward output
    and lse, over ragged tiles (T = 200, 4100), both causal cross lengths
    and every head dim. Batch row 0 sees no key, so its grads are exactly
    zero; row 2 sees only the first key tile and row 3 none of the second
    (``_tile_edge_mask``), so dk and dv of the hidden keys are exactly
    zero. The same bits again on a second run."""
    q, k, v, mask = _inputs(4, 3, tq, tk, d, dtype, seed=d + tk)
    mask = _tile_edge_mask(mask)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(d)
                     ).to("cuda", dtype)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = (KERNEL.launches, KERNEL_BWD_DQ.launches,
              KERNEL_BWD_DKV.launches)
    out, lse = flash_attention(q, k, v, mask=mask, causal=causal,
                               want_lse=True)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    again = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (KERNEL.launches, KERNEL_BWD_DQ.launches,
            KERNEL_BWD_DKV.launches) == (before[0] + 1, before[1] + 2,
                                         before[2] + 2)
    want = flash_attention_bwd_reference(q.detach(), k.detach(), v.detach(),
                                         mask, out.detach(), lse, do, causal)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.all(g[0] == 0), f"{name}: empty batch row not zero"
        assert torch.isfinite(g).all(), name
        scale = max(w.float().abs().max().item(), 1e-6)
        err = (g.float() - w.float()).abs().max().item()
        assert err <= rtol * scale, f"{name}: {err} > {rtol} * {scale}"
        assert torch.equal(g.view(bits), g2.view(bits)), f"{name}: bits"
    for name, g in (("dk", got[1]), ("dv", got[2])):
        assert torch.all(g[2, :, 64:] == 0), f"{name}: keys past tile 0"
        assert torch.all(g[3, :, 64:128] == 0), f"{name}: hidden key tile"


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
def test_k2_as_a_fresh_threads_first_cuda_work_matches_the_main_thread(
        cuda):
    """Fault m's guard on the card: a thread whose first CUDA work is K2's
    wrapper, on bf16 tensors made in the main thread, launches it and
    gives the main thread's bits."""
    import threading
    q, k, v, _ = _inputs(2, 12, 512, 512, 64, torch.bfloat16, seed=5)
    want = flash_attention(q, k, v)
    torch.cuda.synchronize()
    got, errors = [], []

    def first_work():
        try:
            out = flash_attention(q, k, v)
            torch.cuda.synchronize()
            got.append(out)
        except Exception as e:      # surfaced in the main thread below
            errors.append(e)
    before = KERNEL.launches
    t = threading.Thread(target=first_work)
    t.start()
    t.join()
    assert not errors, errors
    assert KERNEL.launches == before + 1
    assert torch.equal(got[0].view(torch.int16), want.view(torch.int16))


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


def _ce_dh_case(v, bias, dh_dtype, special, hidden=512, n=4100, seed=5):
    """One case of the CE kernels' wgmma routes: h (n, hidden), w (hidden,
    v) bf16,
    labels with every third row masked; ``bias100`` puts a bias of 100 on
    column 3, ``over_range`` gives three rows labels past V (NaN scale)."""
    h, w, b, labels = _ce_inputs(n, hidden, v, torch.bfloat16, seed,
                                 bias=bias)
    bad = torch.zeros(n, dtype=torch.bool, device="cuda")
    if special == "bias100":
        b[3] = 100.0
    if special == "over_range":
        bad[[7, 2000, n - 1]] = True
        labels[bad] = torch.tensor([v, v + 1, 10 ** 6], dtype=torch.int32,
                                   device="cuda")
    scale = torch.where(labels >= 0, 1.0 / n, 0.0).float()
    scale = torch.where(labels >= v, float("nan"), scale)
    return h, w, b, labels, scale, bad


@pytest.mark.cuda
@pytest.mark.parametrize("v", [8192, 8000])
@pytest.mark.parametrize("dh_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias,special", [(True, ""), (False, ""),
                                          (True, "bias100"),
                                          (True, "over_range"),
                                          (False, "over_range")])
def test_ce_dh_wgmma_route_matches_plain_version(cuda, v, dh_dtype, bias,
                                                 special):
    """K5a on its wgmma route (N = 4100, H = 512, bf16, the ragged V = 8000
    too) against its plain version at CE_TOL: masked rows exactly 0,
    over-range labels poison exactly their dh rows, a bias of 100 holds
    the tolerance, dh in bf16 and f32, the same bits twice."""
    from analytics_zoo_tpu_torch.ops.pallas import cross_entropy as ce
    h, w, b, labels, scale, bad = _ce_dh_case(v, bias, dh_dtype, special)
    lse, _ = ce.fused_ce_forward(h, w, b, labels)
    before = ce.KERNEL_CE_BWD_DH_ROUTES["wgmma"].launches
    runs = [ce.fused_ce_backward_dh(h, w, b, labels, lse, scale, dh_dtype)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert ce.KERNEL_CE_BWD_DH_ROUTES["wgmma"].launches == before + 2
    assert ce.LAST_DH_LAUNCH.route == "wgmma"
    dh = runs[0]
    assert dh.dtype == dh_dtype and dh.shape == h.shape
    assert torch.equal(runs[0].view(torch.uint8), runs[1].view(torch.uint8))
    want = ce.fused_ce_backward_reference(h, w, b, labels, lse, scale,
                                          dh_dtype)[0]
    assert torch.all(dh[labels < 0] == 0)
    assert torch.equal(torch.isnan(dh).any(dim=1), bad)
    ok = ~bad
    assert torch.isfinite(dh[ok]).all()
    top = want[ok].float().abs().max().item()
    err = (dh[ok].float() - want[ok].float()).abs().max().item()
    assert err <= CE_TOL[torch.bfloat16]["grad"] * top, (err, top)


def _misaligned_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts 2 bytes past a 16-byte
    boundary (TMA cannot address it)."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0 and out.is_contiguous()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [64, 320, 512])
@pytest.mark.parametrize("v", [8192, 8000])
@pytest.mark.parametrize("bias,special", [(True, ""), (False, ""),
                                          (True, "bias100"),
                                          (True, "over_range")])
def test_ce_fwd_dw_wgmma_routes_match_plain_versions(cuda, hidden, v, bias,
                                                     special):
    """K4 and K5b on their wgmma routes (N = 4100: a ragged last row
    block; H = 64, 320 and 512; the ragged V = 8000 too) against their
    plain versions at CE_TOL: lse, the label logit (0 on masked and
    over-range rows), dW and db, the same bits twice; over-range labels
    poison exactly their rows of dh and every element of dW and db, and
    masked rows' dh stays exactly 0."""
    from analytics_zoo_tpu_torch.ops.pallas import cross_entropy as ce
    tol = CE_TOL[torch.bfloat16]
    h, w, b, labels, scale, bad = _ce_dh_case(v, bias, torch.bfloat16,
                                              special, hidden=hidden,
                                              seed=hidden + v)
    before = (ce.KERNEL_CE_FWD_ROUTES["wgmma"].launches,
              ce.KERNEL_CE_BWD_DW_ROUTES["wgmma"].launches)
    fwd = [ce.fused_ce_forward(h, w, b, labels) for _ in range(2)]
    dws = [ce.fused_ce_backward_dw(h, w, b, labels, fwd[0][0], scale)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert (ce.KERNEL_CE_FWD_ROUTES["wgmma"].launches,
            ce.KERNEL_CE_BWD_DW_ROUTES["wgmma"].launches) == \
        tuple(c + 2 for c in before)
    assert ce.LAST_FWD_LAUNCH.route == ce.LAST_DW_LAUNCH.route == "wgmma"
    for a, c in zip(fwd[0] + dws[0], fwd[1] + dws[1]):
        assert (a is None and c is None) or torch.equal(
            a.view(torch.int32), c.view(torch.int32))
    lse, ll = fwd[0]
    ref_lse, ref_ll = ce.fused_ce_forward_reference(h, w, b, labels)
    assert (lse - ref_lse).abs().max().item() <= tol["lse"]
    assert torch.all(ll[labels < 0] == 0) and torch.all(ll[bad] == 0)
    ll_err = (ll - ref_ll).abs() / ref_ll.abs().clamp_min(1.0)
    assert ll_err.max().item() <= tol["ll_rel"]
    dw, db = dws[0]
    assert dw.shape == w.shape and (db is None) == (not bias)
    ref = ce.fused_ce_backward_reference(h, w, b, labels, lse, scale)
    if special == "over_range":
        dh = ce.fused_ce_backward_dh(h, w, b, labels, lse, scale)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(dh).any(dim=1), bad)
        assert torch.all(dh[labels < 0] == 0)
        assert torch.isnan(dw).all() and torch.isnan(db).all()
        return
    for name, got, want in (("dw", dw, ref[1]), ("db", db, ref[2])):
        if want is None:
            continue
        assert torch.isfinite(got).all(), name
        top = want.abs().max().item()
        err = (got - want).abs().max().item()
        assert err <= tol["grad"] * top, (name, err, top)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fwd", "dh", "dw"])
@pytest.mark.parametrize("dtype,hidden,v,shape,route", [
    (torch.bfloat16, 512, 8192, "", "wgmma"),
    (torch.bfloat16, 100, 1000, "", "wgmma"),
    (torch.bfloat16, 320, 8, "", "wgmma"),
    (torch.bfloat16, 512, 130, "", "mma"),
    (torch.bfloat16, 576, 1000, "", "mma"),
    (torch.bfloat16, 1024, 8192, "", "mma"),
    (torch.bfloat16, 512, 1000, "misaligned_w", "mma"),
    (torch.float32, 512, 8192, "", "fma")])
def test_ce_dh_route_by_shape(cuda, kernel, dtype, hidden, v, shape, route):
    """Each CE kernel's C entry point (K4 fwd, K5a dh, K5b dw) reports the
    kernel it took, counted under that route: wgmma in bf16 where TMA can
    address the operands (padded H <= 512, V % 8 == 0, 16-byte aligned h
    and w: the LM shape), mma.sync at V = 130, at H = 576 and 1024, and on
    a misaligned w, FMAs in f32; each within CE_TOL of its plain
    version."""
    from analytics_zoo_tpu_torch.ops.pallas import cross_entropy as ce
    h, w, b, labels = _ce_inputs(300, hidden, v, dtype, seed=hidden + v)
    if shape == "misaligned_w":
        w = _misaligned_copy(w)
    lse, _ = ce.fused_ce_forward_reference(h, w, b, labels)
    scale = torch.where(labels >= 0, 1.0 / 300, 0.0).float()
    counters, last, run = {
        "fwd": (ce.KERNEL_CE_FWD_ROUTES, ce.LAST_FWD_LAUNCH,
                lambda: ce.fused_ce_forward(h, w, b, labels)),
        "dh": (ce.KERNEL_CE_BWD_DH_ROUTES, ce.LAST_DH_LAUNCH,
               lambda: (ce.fused_ce_backward_dh(h, w, b, labels, lse,
                                                scale),)),
        "dw": (ce.KERNEL_CE_BWD_DW_ROUTES, ce.LAST_DW_LAUNCH,
               lambda: ce.fused_ce_backward_dw(h, w, b, labels, lse, scale)),
    }[kernel]
    before = {k: c.launches for k, c in counters.items()}
    got = run()
    torch.cuda.synchronize()
    assert last.route == route
    assert {k: c.launches for k, c in counters.items()} == \
        {k: n + (k == route) for k, n in before.items()}
    tol = CE_TOL[dtype]
    if kernel == "fwd":
        ref_lse, ref_ll = ce.fused_ce_forward_reference(h, w, b, labels)
        assert (got[0] - ref_lse).abs().max().item() <= tol["lse"]
        ll_err = (got[1] - ref_ll).abs() / ref_ll.abs().clamp_min(1.0)
        assert ll_err.max().item() <= tol["ll_rel"]
        return
    ref = ce.fused_ce_backward_reference(h, w, b, labels, lse, scale)
    want = ref[:1] if kernel == "dh" else ref[1:]
    for a, c in zip(got, want):
        top = c.float().abs().max().item()
        err = (a.float() - c.float()).abs().max().item()
        assert err <= tol["grad"] * top, (err, top)


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
def test_embed_expand_zero_rows_for_out_of_range_ids(cuda, dtype, d,
                                                     monkeypatch):
    """K1 through the lean launch path (no ``torch.cuda.Stream`` built:
    ``current_stream`` is made to raise): rows[inv] bit for bit where an
    id is in [0, capacity), a row of zeros where it is not, with int32
    and int64 ids alike."""
    from analytics_zoo_tpu_torch.ops.pallas.embedding import embed_expand

    def no_stream(*args, **kwargs):
        raise AssertionError("a torch.cuda.Stream was built")
    monkeypatch.setattr(torch.cuda, "current_stream", no_stream)
    g = torch.Generator().manual_seed(d + 7)
    rows = torch.randn(300, d, generator=g).to(cuda, dtype)
    inv = torch.randint(-20, 320, (1001,), generator=g, dtype=torch.int32)
    valid = (inv >= 0) & (inv < 300)
    want = torch.where(valid[:, None], rows.cpu()[inv.clamp(0, 299).long()],
                       torch.zeros((), dtype=dtype))
    for ids in (inv, inv.long()):
        before = _embed_counts()[0]
        out = embed_expand(rows, ids.to(cuda))
        torch.cuda.synchronize()
        assert _embed_counts()[0] == before + 1
        assert torch.equal(out.cpu().view(torch.int16),
                           want.view(torch.int16))


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


def _sa_case(case, n, d, dtype, seed):
    """Ids of one SA case on the card and a seeded cotangent: ``ncf``
    draws 3n/4 distinct values with repeats, ``all_equal`` repeats one id,
    ``empty`` has no ids (n = 0)."""
    gen = torch.Generator().manual_seed(seed)
    if case == "empty":
        n = 0
    hi = 1 if case == "all_equal" else max(3 * n // 4, 1)
    ids = torch.randint(0, hi, (n,), generator=gen, dtype=torch.int32) * 7
    g = (torch.randn(n, d, generator=gen)
         * 10.0 ** torch.randint(-3, 3, (n, 1), generator=gen)).to(dtype)
    return ids.cuda(), g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 20, 128, 130])
@pytest.mark.parametrize("case", ["ncf", "all_equal", "empty"])
@pytest.mark.parametrize("sorted_by", ["forward", "standalone"])
def test_dedup_scatter_add_through_the_forward_sort(cuda, dtype, d, case,
                                                    sorted_by):
    """SA on the positions sorted by the dedup'd lookup's forward
    (``order``/``sorted_slot`` from its unique), and standalone (the op
    sorts ``inv`` itself): bit for bit the CPU's position-order sum, the
    same bits twice, zeros in the slots past the unique count (the
    capacity exceeds it), one launch counted per call."""
    from analytics_zoo_tpu_torch.ops.pallas.embedding import (
        dedup_scatter_add, dedup_scatter_add_reference)
    from analytics_zoo_tpu_torch.ops.sharded_embedding import (
        _dedup_sort, dedup_capacity)
    ids, g = _sa_case(case, 3000, d, dtype, seed=d)
    cap = max(dedup_capacity(ids.shape[0], 10 ** 6), 8)
    _, inv, order, slot = _dedup_sort(ids, cap, fill=10 ** 6)
    kw = (dict(order=order, sorted_slot=slot) if sorted_by == "forward"
          else {})
    before = _embed_counts()[1]
    runs = [dedup_scatter_add(g.to(cuda), inv, cap, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert _embed_counts()[1] == before + 2
    want = dedup_scatter_add_reference(g, inv.cpu(), cap)
    n_unique = int(torch.unique(inv).numel())
    assert cap > n_unique
    for got in runs:
        assert got.shape == (cap, d) and got.dtype == torch.float32
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))
    assert torch.all(runs[0][n_unique:] == 0)


@pytest.mark.cuda
def test_dedup_scatter_add_with_the_forward_sort_is_one_kernel(cuda):
    """Given the forward's sort, SA launches one device kernel and nothing
    else (no sort, no search, no cast); standalone it sorts first. The
    kernels are read from a CUDA graph of one call (``device_kernels``),
    not from ``torch.profiler``, whose CUPTI records can come back
    empty."""
    from analytics_zoo_tpu_torch.ops.graph_kernels import device_kernels
    from analytics_zoo_tpu_torch.ops.pallas.embedding import \
        dedup_scatter_add
    from analytics_zoo_tpu_torch.ops.sharded_embedding import _dedup_sort
    ids, g = _sa_case("ncf", 8192, 20, torch.float32, seed=3)
    _, inv, order, slot = _dedup_sort(ids, 8192, fill=10 ** 6)
    g = g.to(cuda)
    one = device_kernels(lambda: dedup_scatter_add(
        g, inv, 8192, order=order, sorted_slot=slot))
    assert len(one) == 1 and "segment_sum_sorted" in one[0], one
    alone = device_kernels(lambda: dedup_scatter_add(g, inv, 8192))
    assert len(alone) > 1 and "segment_sum_sorted" in alone[-1], alone


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (32, 4096, 4096),
                                   (17, 100, 10), (32, 768, 2),
                                   (33, 130, 130), (300, 768, 2304),
                                   (129, 3072, 768)])
def test_int8_matmul_dequantize_first_matches_plain_version(cuda, dtype, m,
                                                            k, n):
    """K6's dequantize-first mode (each weight q * s formed in x's dtype
    before the product, as the JAX weight-only predict does) against its
    plain version: the tolerances above, then the same bits twice."""
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_MATMUL, int8_matmul, int8_matmul_reference)
    x, w, s = (t.to(cuda) for t in _int8_operands(m, k, n, dtype, m + n))
    before = KERNEL_INT8_MATMUL.launches
    got = int8_matmul(x, w, s, dequantize_first=True)
    again = int8_matmul(x, w, s, dequantize_first=True)
    torch.cuda.synchronize()
    assert KERNEL_INT8_MATMUL.launches == before + 2
    want = int8_matmul_reference(x, w, s, dequantize_first=True)
    assert got.dtype == dtype and got.shape == (m, n)
    top = want.float().abs().max().item()
    tol = 1e-4 * top if dtype == torch.float32 else _bf16_step(top)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), again.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("m,k,n,route", [(1024, 768, 2304, "wgmma"),
                                         (129, 3072, 768, "wgmma"),
                                         (300, 768, 2304, "wgmma"),
                                         (64, 128, 130, "mma"),
                                         (64, 100, 128, "mma")])
def test_int8_matmul_tile_routes(cuda, first, m, k, n, route):
    """K6's bf16 tile path for M > 32: shapes whose x and w rows TMA can
    address (K % 8 == 0, N % 16 == 0) take the wgmma kernel, the others
    the mma.sync one, in both modes; each within one bf16 step of its
    plain version at the case's largest value, the same bits twice, and
    counted under its route."""
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_MATMUL, KERNEL_INT8_ROUTES, int8_matmul,
        int8_matmul_reference)
    x, w, s = (t.to(cuda) for t in _int8_operands(m, k, n, torch.bfloat16,
                                                  m + k + n))
    before = {name: c.launches for name, c in KERNEL_INT8_ROUTES.items()}
    total = KERNEL_INT8_MATMUL.launches
    got = int8_matmul(x, w, s, first)
    again = int8_matmul(x, w, s, first)
    torch.cuda.synchronize()
    assert KERNEL_INT8_MATMUL.launches == total + 2
    assert {name: c.launches - before[name]
            for name, c in KERNEL_INT8_ROUTES.items()} == {
        name: 2 if name == route else 0 for name in KERNEL_INT8_ROUTES}
    want = int8_matmul_reference(x, w, s, first)
    top = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _bf16_step(top), (err, _bf16_step(top))
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` starting one element past a 16-byte
    boundary (a view into a larger buffer)."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


#: (K, N, misaligned, one K slice): the int8 head at K = N = 4096, BERT's
#: pooler and Dense(2) head, a ragged one, an odd K with N % 16 != 0 (byte
#: loads), x and w views that start off a 16-byte boundary (all split K);
#: then shapes the kernel runs in one K slice and so finishes itself
#: (epilogue and store in the block, no reduce kernel): K <= 64, and a K
#: of 256 over N wide enough (547 panels) that its panels alone fill the
#: card
SKINNY_SHAPES = [(4096, 4096, False, False), (768, 768, False, False),
                 (768, 2, False, False), (100, 10, False, False),
                 (4097, 130, False, False), (768, 768, True, False),
                 (64, 768, False, True), (48, 130, False, True),
                 (256, 70000, False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 17, 31, 32])
@pytest.mark.parametrize("k,n,misaligned,one_slice", SKINNY_SHAPES)
def test_int8_matmul_skinny_route(cuda, dtype, first, m, k, n, misaligned,
                                  one_slice):
    """K6's skinny route (M <= 32: split-K blocks, a second kernel adding
    the slices in order; or one K slice, the block finishing the output
    itself) in both modes, without and with the fused bias/ReLU epilogue:
    within the file's tolerance of its plain version (f32 1e-4, bf16 one
    step, at the case's largest value before or after the epilogue), the
    same bits on a second call, counted as ``skinny`` with the K slices
    the entry point reports, and the fused epilogue the same bits as the
    unfused kernel's output followed by the bias add and ReLU as torch
    ops."""
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_ROUTES, LAST_LAUNCH, int8_matmul, int8_matmul_reference)
    x, w, s = (t.to(cuda) for t in _int8_operands(m, k, n, dtype,
                                                  m * 7 + k + n))
    b = (torch.randn(n, generator=torch.Generator().manual_seed(n)) * 4.0
         ).to(cuda)
    if misaligned:
        x, w = _misaligned(x), _misaligned(w)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    plain = int8_matmul_reference(x, w, s, first)
    for bias, relu in ((None, False), (b, False), (None, True), (b, True)):
        before = KERNEL_INT8_ROUTES["skinny"].launches
        got = int8_matmul(x, w, s, first, bias=bias, relu=relu)
        assert LAST_LAUNCH.route == "skinny"
        assert (LAST_LAUNCH.splits == 1) == one_slice, LAST_LAUNCH.splits
        again = int8_matmul(x, w, s, first, bias=bias, relu=relu)
        unfused = int8_matmul(x, w, s, first)
        torch.cuda.synchronize()
        assert KERNEL_INT8_ROUTES["skinny"].launches == before + 3
        want = int8_matmul_reference(x, w, s, first, bias=bias, relu=relu)
        assert got.dtype == dtype and got.shape == (m, n)
        top = max(want.float().abs().max().item(),
                  plain.float().abs().max().item())
        tol = 1e-4 * top if dtype == torch.float32 else _bf16_step(top)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, (bias is not None, relu, err, tol)
        assert torch.equal(got.view(bits), again.view(bits))
        if bias is not None:
            unfused = unfused + bias.to(dtype)
        if relu:
            unfused = torch.relu(unfused)
        assert torch.equal(got.view(bits), unfused.view(bits)), \
            (bias is not None, relu)


@pytest.mark.cuda
@pytest.mark.parametrize("m,route", [(32, "skinny"), (33, "fma")])
def test_int8_matmul_epilogue_off_the_skinny_route(cuda, m, route):
    """Past the skinny route the wrapper adds the bias and applies the
    ReLU as torch ops after the kernel: the same bits as doing so by hand,
    and the same numbers as the skinny kernel's fused epilogue."""
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_ROUTES, int8_matmul, int8_matmul_reference)
    x, w, s = (t.to(cuda) for t in _int8_operands(m, 256, 96,
                                                  torch.float32, m))
    b = torch.linspace(-3.0, 3.0, 96, device=cuda)
    before = KERNEL_INT8_ROUTES[route].launches
    got = int8_matmul(x, w, s, True, bias=b, relu=True)
    plain = int8_matmul(x, w, s, True)
    torch.cuda.synchronize()
    assert KERNEL_INT8_ROUTES[route].launches == before + 2
    assert torch.equal(got.view(torch.int32),
                       torch.relu(plain + b).view(torch.int32))
    want = int8_matmul_reference(x, w, s, True, bias=b, relu=True)
    top = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * top


@pytest.mark.cuda
def test_weight_only_relu_head_fuses_its_epilogue_on_cuda(cuda):
    """A weight-only int8 Sequential of Dense(relu) layers on the card:
    every hidden layer's bias and ReLU ride K6's skinny kernel, and the
    predict matches the same model on the CPU (plain versions)."""
    from analytics_zoo_tpu_torch.ops.pallas import quantized
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    init_zoo_context()
    model = Sequential([Dense(256, activation="relu", input_shape=(64,)),
                        Dense(256, activation="relu"),
                        Dense(8, activation="softmax")],
                       device="cpu").init_weights()
    x = np.random.default_rng(3).normal(size=(5, 64)).astype(np.float32)
    want = InferenceModel(device="cpu").from_keras(
        model, quantize="int8").predict(x)
    im = InferenceModel(device=cuda).from_keras(model, quantize="int8")
    before = quantized.KERNEL_INT8_ROUTES["skinny"].launches
    got = im.predict(x)
    assert quantized.KERNEL_INT8_ROUTES["skinny"].launches == before + 3
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


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
                                   (40, 24, 16), (17, 64, 128),
                                   (33, 100, 4096), (40, 8, 64),
                                   (1, 120, 256)])
def test_int8_product_pads_for_int_mm_exactly(cuda, m, k, n):
    """``torch._int_mm`` on the card wants M > 16 and K, N multiples of
    8, and cuBLASLt refuses K under 128 at up to 40 rows once N reaches
    64; the padded product is the CPU's int32 product bit for bit."""
    from analytics_zoo_tpu_torch.ops.pallas.quantized import int8_product
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


# ---------------------------------------------------------------------------
# fault l on the card, and the fused training dispatch (CUDA graphs)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ce_rows_take_a_transposed_w_and_a_sliced_hidden_on_cuda(
        cuda, dtype):
    """Fault l: a tied head's ``emb.T`` and a column slice of ``hidden``
    reach the kernels as dense copies (one launch each of K4, K5a and
    K5b) and give the plain route's loss rows and gradients at CE_TOL,
    each gradient in its caller's layout."""
    from analytics_zoo_tpu_torch.ops.fused_cross_entropy import \
        fused_cross_entropy_rows
    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import \
        fused_ce_forward_reference
    g = torch.Generator().manual_seed(8)
    n, hidden, v = 300, 128, 8192
    wide = torch.randn(n, hidden + 16, generator=g).to(cuda, dtype)
    emb = (torch.randn(v, hidden, generator=g) * hidden ** -0.5).to(cuda,
                                                                    dtype)
    b = (torch.randn(v, generator=g) * 0.5).cuda()
    labels = torch.randint(0, v, (n,), generator=g, dtype=torch.int32)
    labels[::3] = -1
    labels = labels.cuda()
    tol = CE_TOL[dtype]

    def run(use_pallas):
        ts = [t.detach().clone().requires_grad_() for t in (wide, emb, b)]
        rows = fused_cross_entropy_rows(ts[0][:, 8:8 + hidden], ts[1].T,
                                        ts[2], labels,
                                        use_pallas=use_pallas)
        grads = torch.autograd.grad(rows.sum(), ts)
        for t, gr in zip(ts, grads):
            assert gr.shape == t.shape and gr.dtype == t.dtype
        return rows.detach(), grads
    before = _ce_counts()
    got, g_got = run(True)
    torch.cuda.synchronize()
    assert _ce_counts() == tuple(c + 1 for c in before)
    want, g_want = run(False)
    _, ll = fused_ce_forward_reference(wide[:, 8:8 + hidden].contiguous(),
                                       emb.T.contiguous(), b, labels)
    err = (got - want).abs().max().item()
    assert err <= tol["lse"] + tol["ll_rel"] * ll.abs().max().item(), err
    for a, c in zip(g_got, g_want):
        top = c.float().abs().max().item()
        assert (a.float() - c.float()).abs().max().item() <= \
            tol["grad"] * top


def _sharded_ncf(users=300, items=500, embed=16, classes=5):
    """NeuralCF's graph on ShardedEmbedding tables (K1 and SA on every
    table)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (Input,
                                                                   Model)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense, Merge, Select, ShardedEmbedding)
    inp = Input(shape=(2,))
    user, item = Select(1, 0)(inp), Select(1, 1)(inp)
    h = Merge(mode="concat")([ShardedEmbedding(users + 1, embed)(user),
                              ShardedEmbedding(items + 1, embed)(item)])
    h = Dense(32, activation="relu")(h)
    mf = Merge(mode="mul")([ShardedEmbedding(users + 1, embed)(user),
                            ShardedEmbedding(items + 1, embed)(item)])
    h = Merge(mode="concat")([h, mf])
    return Model(inp, Dense(classes, activation="softmax")(h),
                 device="cuda")


def _feature_set_order(monkeypatch):
    from analytics_zoo_tpu_torch.pipeline.api.keras import dispatch
    monkeypatch.setattr(
        dispatch, "device_permutation", lambda n, seed, device:
        torch.from_numpy(np.random.default_rng(seed).permutation(n)).to(
            device))


def _ncf_fit(conf, nb_epochs=(1, 2)):
    """A seeded sharded NCF fitted over ``nb_epochs`` fits of one
    FeatureSet (960 ratings, batch 64: 15 steps an epoch): the epoch and
    step losses, the parameters, and K1's and SA's launches in the last
    fit."""
    from analytics_zoo_tpu_torch.feature import FeatureSet
    from analytics_zoo_tpu_torch.ops.pallas.embedding import (
        KERNEL_EMBED_EXPAND, KERNEL_SCATTER_ADD)
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    reset_zoo_context()
    init_zoo_context(conf={"zoo.seed": 0, **conf})
    reset_uids()
    rng = np.random.default_rng(2)
    x = np.stack([rng.integers(1, 301, 960), rng.integers(1, 501, 960)],
                 axis=1).astype(np.int32)
    fs = FeatureSet.array(x, ((x[:, 0] + x[:, 1]) % 5).astype(np.int32),
                          seed=0)
    net = _sharded_ncf().init_weights(torch.Generator().manual_seed(1))
    net.compile(optimizer="adam", loss="scce", lr=0.01)
    losses, steps = [], []
    for n in nb_epochs:
        for c in (KERNEL_EMBED_EXPAND, KERNEL_SCATTER_ADD):
            c.reset()
        losses += net.fit(fs, batch_size=64, nb_epoch=n)["loss"]
        steps += [torch.from_numpy(s) for s in net._loop.step_losses]
    torch.cuda.synchronize()
    return (losses, torch.stack(steps),
            {k: p.detach().clone() for k, p in net.named_parameters()},
            (KERNEL_EMBED_EXPAND.launches, KERNEL_SCATTER_ADD.launches))


@pytest.mark.cuda
@pytest.mark.parametrize("conf", [
    {"zoo.train.scan_steps": 4},
    {"zoo.train.device_cache": True, "zoo.train.scan_steps": 4,
     "zoo.train.fuse_epochs": 2},
], ids=["scan4", "cache_scan4_fuse2"])
def test_captured_ncf_fit_gives_the_eager_fits_bits(cuda, conf,
                                                    monkeypatch):
    """A sharded NCF fitted 1 + 2 epochs as replays of captured K-step
    graphs (chunks of 4, 4, 4 and a short 3) against the eager fit in the
    same batch order: the same step losses, epoch losses and parameters,
    bit for bit; K1 and SA launch 4 a step in the second fit, counted at
    every replay (the graphs were captured in the first)."""
    _feature_set_order(monkeypatch)
    eager = _ncf_fit({})
    keyed = _ncf_fit(conf)
    assert keyed[0] == eager[0]
    assert torch.equal(keyed[1], eager[1])
    for k in eager[2]:
        assert torch.equal(keyed[2][k], eager[2][k]), k
    assert keyed[3] == eager[3] == (4 * 2 * 15, 4 * 2 * 15)


def _dropout_fit(conf, drop=0.5, lr=0.0):
    """A Dense-Dropout-Dense net on 64 copies of one row, batch 8, two
    epochs of sgd: with ``lr`` 0 every step loss differs only by its
    dropout masks."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        Sequential, reset_uids)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (Dense,
                                                                   Dropout)
    reset_zoo_context()
    init_zoo_context(conf={"zoo.seed": 3, **conf})
    reset_uids()
    net = Sequential([Dense(64, activation="relu", input_shape=(8,)),
                      Dropout(drop), Dense(3, activation="softmax")],
                     device="cuda").init_weights(
                         torch.Generator().manual_seed(0))
    net.compile(optimizer="sgd", loss="scce", lr=lr)
    x = np.repeat(np.linspace(-1, 1, 8, dtype=np.float32)[None], 64, 0)
    y = np.ones(64, np.int32)
    net.fit(x, y, batch_size=8, nb_epoch=2, shuffle=False)
    torch.cuda.synchronize()
    return (np.concatenate(net._loop.step_losses),
            [p.detach().clone() for p in net.parameters()])


@pytest.mark.cuda
def test_replays_draw_new_dropout_masks_the_eager_steps_masks(cuda):
    """Dropout inside a captured 4-step graph: every step of every replay
    draws a new mask (16 distinct step losses from one repeated row and
    unchanging weights), and each is the mask the eager step draws at
    that iteration (the same step losses, bit for bit); with dropout 0
    and a moving lr the captured fit is the eager fit's bits."""
    keyed, _ = _dropout_fit({"zoo.train.scan_steps": 4})
    assert len(set(keyed.tolist())) == len(keyed) == 16
    eager, _ = _dropout_fit({})
    np.testing.assert_array_equal(keyed, eager)
    a = _dropout_fit({"zoo.train.scan_steps": 4}, drop=0.0, lr=0.1)
    b = _dropout_fit({}, drop=0.0, lr=0.1)
    np.testing.assert_array_equal(a[0], b[0])
    assert all(torch.equal(p, q) for p, q in zip(a[1], b[1]))


@pytest.mark.cuda
def test_a_step_that_syncs_inside_capture_raises(cuda):
    """A loss that reads a device value on the host cannot be captured:
    the keyed fit raises (no eager fallback). Run in a fresh process, so
    an aborted capture cannot touch the other tests."""
    import os
    import subprocess
    import sys
    code = """
import numpy as np, torch
from analytics_zoo_tpu_torch.common.context import init_zoo_context
from analytics_zoo_tpu_torch.pipeline.api.keras import objectives
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
init_zoo_context(conf={"zoo.train.scan_steps": 2})
def syncing(y, p):
    loss = objectives.get_loss("scce")(y, p)
    return loss * float(loss.item() > -1.0)
net = Sequential([Dense(3, activation="softmax", input_shape=(4,))],
                 device="cuda").init_weights()
net.compile(optimizer="sgd", loss=syncing)
try:
    net.fit(np.ones((16, 4), np.float32), np.zeros(16, np.int32),
            batch_size=4, nb_epoch=1)
except RuntimeError as e:
    assert "cannot be captured" in str(e), e
    print("raised")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "raised", out.stdout


@pytest.mark.cuda
def test_device_memory_stats_read_the_allocator(cuda):
    """``device_memory_stats`` on the card: one ``gpu:<i>`` row a device,
    ``in_use`` the allocator's current bytes (a 64 MiB tensor shows),
    ``peak`` at least that, ``limit`` the card's total; the gauges land
    in the registry."""
    from analytics_zoo_tpu_torch.observability import (
        MetricsRegistry, device_memory_stats, sample_device_memory)
    before = device_memory_stats()
    x = torch.empty(16 << 20, dtype=torch.float32, device="cuda")
    rows = device_memory_stats()
    assert [r["device"] for r in rows] == [
        f"gpu:{i}" for i in range(torch.cuda.device_count())]
    row = rows[torch.cuda.current_device()]
    assert row["in_use"] == torch.cuda.memory_allocated()
    assert row["in_use"] >= (before[0]["in_use"] if before else 0) + (64 << 20)
    assert row["peak"] >= row["in_use"]
    assert row["limit"] == torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory
    reg = MetricsRegistry()
    sample_device_memory(reg)
    snap = reg.snapshot()
    key = f'zoo_device_hbm_bytes{{device="{row["device"]}",kind="limit"}}'
    assert snap[key]["value"] == row["limit"]
    del x


class _HeldAdapter:
    """A served record is a ``(512,)`` int32 token row, pad id 0; the
    model takes BERT's four inputs. ``hold`` makes the first dispatch wait
    until released (the replica then holds its read entries in flight);
    ``dispatches`` counts the batches launched."""

    def __init__(self, im, hold=False):
        import threading
        self.im = im
        self.dispatches = 0
        self.entered = threading.Event()
        self.release = threading.Event()
        if not hold:
            self.release.set()

    def inputs(self, ids):
        return make_bert_inputs(ids, attention_mask=(ids != 0))

    def predict_async(self, ids, block=True):
        self.entered.set()
        assert self.release.wait(timeout=120), "dispatch never released"
        collect = self.im.predict_async(self.inputs(ids), block=block)
        self.dispatches += collect is not None
        return collect


@pytest.mark.cuda
def test_fleet_over_resp_reclaims_a_killed_replicas_batch(cuda):
    """Two replicas of a 2-block BERT at full width (bf16, K2 in every
    block) on one stream over ``RedisBackend`` and a local
    ``chip_smoke.MiniResp``. The victim reads a batch alone and is killed
    with it in flight; the survivor reclaims it: every record answered
    once (the broker's result-write count), 8 reclaimed from the victim,
    the PEL empty, K2 launched 2 a dispatch, and the reclaimed batch's
    answers the bits of the same batch read fresh."""
    import threading

    import chip_smoke
    from analytics_zoo_tpu_torch.observability import MetricsRegistry
    from analytics_zoo_tpu_torch.serving import (ClusterServing, InputQueue,
                                                 OutputQueue, RedisBackend)

    init_zoo_context(conf={"zoo.pallas.attention": True,
                           "zoo.compute.dtype": "bfloat16", "zoo.seed": 0})
    model = BERTClassifier(2, n_block=2, device="cuda").init_weights()
    vocab = model.get_config()["vocab"]
    ims = [InferenceModel(concurrent_num=2, device="cuda").from_keras(
        model, dtype="bfloat16") for _ in range(2)]
    rng = np.random.default_rng(0)
    ids = rng.integers(1, vocab, (32, 512)).astype(np.int32)
    lens = rng.integers(64, 513, 32)
    ids[np.arange(512)[None, :] >= lens[:, None]] = 0
    broker = chip_smoke.MiniResp()
    threading.Thread(target=broker.serve_forever, daemon=True).start()
    victim_model = _HeldAdapter(ims[0], hold=True)
    survivor_model = _HeldAdapter(ims[1])
    regs = [MetricsRegistry(), MetricsRegistry()]
    common = dict(batch_size=8, claim_sweep_s=0.05, heartbeat_s=0.05)
    try:
        q = InputQueue(RedisBackend(port=broker.port))
        for i in range(32):
            q.enqueue(f"r-{i}", ids[i])
        probe = RedisBackend(port=broker.port)
        KERNEL.reset()
        victim = ClusterServing(victim_model,
                                backend=RedisBackend(port=broker.port),
                                registry=regs[0], consumer_name="victim",
                                claim_idle_ms=60000, **common).start()
        assert victim_model.entered.wait(120)
        window = probe.xpending("tensor_stream", "serving")
        survivor = ClusterServing(survivor_model,
                                  backend=RedisBackend(port=broker.port),
                                  registry=regs[1], consumer_name="survivor",
                                  claim_idle_ms=500, **common).start()
        victim.kill(join=False)
        victim_model.release.set()
        victim.kill()
        out = OutputQueue(RedisBackend(port=broker.port))
        got = np.stack([out.query(f"r-{i}", timeout=300)
                        for i in range(32)])
        survivor.stop()
        launches = KERNEL.launches
        pel = probe.pending_len("tensor_stream", "serving")
        writes = dict(zip(*[iter(probe._r.command("ZOOWRITES"))] * 2))
    finally:
        broker.close()
    snap = regs[1].snapshot()
    assert window == {"victim": 8}
    assert snap['zoo_serving_reclaimed_total{from="victim"}'][
        "value"] == 8
    assert snap["zoo_serving_records_total"]["value"] == 32
    assert snap["zoo_serving_acks_total"]["value"] == 32 and pel == 0
    assert victim.served == 0
    assert {k: v for k, v in writes.items()
            if k.startswith(b"result:")} == {
        f"result:r-{i}".encode(): b"1" for i in range(32)}
    dispatches = victim_model.dispatches + survivor_model.dispatches
    assert launches == 2 * dispatches and survivor_model.dispatches >= 4
    assert np.isfinite(got).all() and got.shape == (32, 2)
    # the victim's batch was its first read: records 0..7, in order
    fresh = ims[1].predict(survivor_model.inputs(ids[:8]))
    assert np.array_equal(got[:8].view(np.uint32),
                          np.asarray(fresh, np.float32).view(np.uint32))


# ---------------------------------------------------------------------------
# slice 15: the guarded step under capture, checkpoints of CUDA tensors
# ---------------------------------------------------------------------------

#: BERT at two blocks (narrow, seq 128) on the captured path's shapes
GUARD_CFG = dict(num_classes=2, vocab=300, hidden_size=128, n_block=2,
                 n_head=2, seq_len=128, intermediate_size=256,
                 hidden_drop=0.0, attn_drop=0.0)


def _guard_fit(conf, plan_at=None, sentinel=True):
    """One epoch of 8 steps of batch 8 on the 2-block BERT, AdamW, with
    ``conf``; ``recover`` with an empty ``train.grads`` plan (or a
    ``nan_grad`` at ``plan_at``) when ``sentinel``. Returns (params,
    count, step losses)."""
    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    reset_zoo_context()
    extra = ({"zoo.train.sentinel": "recover", "zoo.faults.enabled": True}
             if sentinel else {})
    init_zoo_context(conf={"zoo.seed": 0, "zoo.pallas.attention": True,
                           **extra, **conf})
    reset_uids()
    model = BERTClassifier(**GUARD_CFG, device="cuda").init_weights(
        torch.Generator().manual_seed(0))
    model.compile(optimizer="adamw", loss="scce", lr=1e-3)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, GUARD_CFG["vocab"], (64, 128)).astype(np.int32)
    ids[:, 100:] = 0
    x = make_bert_inputs(ids, attention_mask=(ids != 0))
    y = rng.integers(0, 2, 64).astype(np.int32)
    plan = faults.FaultPlan(seed=0)
    if plan_at is not None:
        plan.add("train.grads", "nan_grad", at=(plan_at,))
    if sentinel:
        with faults.activate(plan):
            model.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)
    else:
        model.fit(x, y, batch_size=8, nb_epoch=1, shuffle=False)
    torch.cuda.synchronize()
    return ({n: p.detach().clone() for n, p in model.named_parameters()},
            model.opt_state["count"],
            np.concatenate(model._loop.step_losses))


@pytest.mark.cuda
def test_guarded_captured_step_keeps_the_bits_and_skips_inside_a_chunk(
        cuda):
    """``recover`` with nothing flagged, captured 4 steps a replay: the
    captured sentinel-off fit's bits. A ``nan_grad`` at call 5 (inside
    the second chunk) is discarded inside the replay: the count ends one
    below the 8 steps, the params stay finite and are the eager guarded
    fit's bits (the later steps read the rows of the counts they have)."""
    off = _guard_fit({"zoo.train.scan_steps": 4}, sentinel=False)
    empty = _guard_fit({"zoo.train.scan_steps": 4})
    assert off[1] == empty[1] == 8
    np.testing.assert_array_equal(off[2], empty[2])
    for name in off[0]:
        assert torch.equal(off[0][name], empty[0][name]), name
    skipped = _guard_fit({"zoo.train.scan_steps": 4}, plan_at=5)
    eager = _guard_fit({}, plan_at=5)
    assert skipped[1] == eager[1] == 7
    for name in skipped[0]:
        assert bool(torch.isfinite(skipped[0][name]).all()), name
        assert torch.equal(skipped[0][name], eager[0][name]), name
    np.testing.assert_array_equal(skipped[2], eager[2])


@pytest.mark.cuda
def test_checkpoint_round_trip_of_cuda_tensors_is_bit_for_bit(cuda,
                                                              tmp_path):
    """CUDA leaves (f32, int64, an empty one) through the pinned batched
    snapshot, the async writer and a verified restore: the same bits."""
    from analytics_zoo_tpu_torch.observability import MetricsRegistry
    from analytics_zoo_tpu_torch.utils.checkpoint import CheckpointManager
    g = torch.Generator(device="cuda").manual_seed(3)
    tree = {"w": torch.randn(1000, 37, device="cuda", generator=g),
            "b": {"c": torch.arange(7, device="cuda"),
                  "e": torch.zeros(0, 3, device="cuda")},
            "s": torch.tensor(2.5, device="cuda")}
    want = tree["w"].cpu().numpy().copy()
    mgr = CheckpointManager(str(tmp_path), registry=MetricsRegistry())
    mgr.save(5, {"t": tree})
    tree["w"].add_(1.0)              # the snapshot was taken at save()
    mgr.close()
    template = {"w": np.zeros((1000, 37), np.float32),
                "b": {"c": np.zeros(7, np.int64),
                      "e": np.zeros((0, 3), np.float32)},
                "s": np.zeros((), np.float32)}
    step, trees, _ = mgr.restore_latest({"t": template})
    assert step == 5 and mgr.verify(5)[0] == "ok"
    got = trees["t"]
    np.testing.assert_array_equal(got["w"], want)
    np.testing.assert_array_equal(got["b"]["c"], np.arange(7))
    assert got["b"]["e"].shape == (0, 3) and float(got["s"]) == 2.5


@pytest.mark.cuda
def test_load_checkpoint_onto_cuda(cuda, tmp_path):
    """A CPU-trained snapshot served on the GPU: the model's weights on
    the card after ``load_checkpoint``, and its answers within 1e-4 of
    the CPU model's (f32)."""
    init_zoo_context(conf={"zoo.seed": 0})
    cfg = dict(GUARD_CFG, seq_len=16)
    cpu = BERTClassifier(**cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(1))
    cpu.compile(optimizer="adamw", loss="scce", lr=1e-3)
    rng = np.random.default_rng(1)
    ids = rng.integers(1, cfg["vocab"], (16, 16)).astype(np.int32)
    x = make_bert_inputs(ids)
    y = rng.integers(0, 2, 16).astype(np.int32)
    cpu.set_checkpoint(str(tmp_path))
    cpu.fit(x, y, batch_size=8, nb_epoch=1)
    gpu = BERTClassifier(**cfg, device="cuda").init_weights(
        torch.Generator().manual_seed(2))
    im = InferenceModel(device="cuda").load_checkpoint(gpu, str(tmp_path))
    assert all(p.is_cuda for p in im._model.parameters())
    for (n, a), (_, b) in zip(cpu.named_parameters(),
                              gpu.named_parameters()):
        assert torch.equal(a, b.cpu()), n
    np.testing.assert_allclose(im.predict(x), cpu.predict(x), atol=1e-4)


# ---------------------------------------------------------------------------
# Q8: the static int8 dense layer
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bias,relu", [(False, False), (True, True),
                                       (True, False)])
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (7, 4096, 4096),
                                   (32, 4096, 4096), (1, 4096, 8),
                                   (32, 4096, 8), (4, 1000, 130),
                                   (16, 333, 17), (3, 64, 70),
                                   (2, 4100, 256), (8, 4096, 4096),
                                   (9, 4096, 4096), (16, 4096, 4096),
                                   (17, 4096, 4096), (24, 4096, 4096),
                                   (31, 4096, 4096), (31, 256, 130)])
def test_q8_is_its_plain_version_bit_for_bit(cuda, m, k, n, bias, relu):
    """Q8 against the static path's torch ops on the CPU (and on the card
    at the head's shapes): the same bits (the int32 sum is exact, the
    finish rounds as they do), and the same bits twice; one launch a call,
    on the route its plan names (``q8_dp4a`` at few rows or a K the
    tensor-core route refuses, ``q8_wgmma_xq`` past the crossover). Ragged K and N pad with zeros; x / x_scale lands on .5
    for a few entries."""
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_STATIC, LAST_STATIC_LAUNCH, static_int8_dense,
        static_int8_dense_reference, static_plan)
    g = torch.Generator().manual_seed(m * 7 + k + n)
    x = torch.randn(m, k, generator=g) * 3.0
    x[0, :3] = torch.tensor([0.125, -0.375, 6.4])
    xs = torch.tensor(0.05)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    s = torch.rand(n, generator=g) * 0.02 + 0.001
    b = torch.randn(n, generator=g) * 2.0 if bias else None
    dev = [t if t is None else t.to(cuda) for t in (x, xs, w, s, b)]
    before = KERNEL_INT8_STATIC.launches
    got = static_int8_dense(*dev, relu=relu)
    again = static_int8_dense(*dev, relu=relu)
    torch.cuda.synchronize()
    assert KERNEL_INT8_STATIC.launches == before + 2
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert LAST_STATIC_LAUNCH.route == static_plan(m, k, n, sms)[0]
    cpu = static_int8_dense_reference(x, xs, w, s, b, relu=relu)
    wants = [cpu, again.cpu()]
    if n in (8, 4096):
        # the plain version on the card too (the padded _int_mm; cuBLASLt
        # refuses some small padded shapes, such as K = 64 with N = 72)
        wants.append(static_int8_dense_reference(*dev, relu=relu).cpu())
    for want in wants:
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 25088, 4096), (32, 25088, 4096),
                                   (1, 4096, 1000), (32, 4096, 1000)])
def test_q8_vgg16_fc6_and_fc8_on_every_route(cuda, m, k, n, monkeypatch):
    """VGG-16's fc6 and fc8 at 1 and 32 rows, with the bias and ReLU, on
    every route (the plan forced to each in turn) and on the plan's: the
    plain version's bits on the card and on the CPU, the same bits twice,
    the route each call reports."""
    from analytics_zoo_tpu_torch.ops.pallas import quantized as pq
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        LAST_STATIC_LAUNCH, static_int8_dense, static_int8_dense_reference,
        static_plan)
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g) * 3.0
    xs = torch.tensor(0.05)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    s = torch.rand(n, generator=g) * 0.02 + 0.001
    b = torch.randn(n, generator=g) * 2.0
    dev = [t.to(cuda) for t in (x, xs, w, s, b)]
    want = static_int8_dense_reference(*dev, relu=True).cpu()
    assert torch.equal(want.view(torch.int32),
                       static_int8_dense_reference(x, xs, w, s, b, relu=True)
                       .view(torch.int32))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for plan in (static_plan(m, k, n, sms), pq._plan_dp4a(m, k, n, sms),
                 pq._plan_wgmma(m, k, n, sms)):
        with monkeypatch.context() as mp:
            mp.setattr(pq, "static_plan", lambda *a, plan=plan: plan)
            outs = [static_int8_dense(*dev, relu=True) for _ in range(2)]
        torch.cuda.synchronize()
        assert LAST_STATIC_LAUNCH.route == plan[0]
        for out in outs:
            assert torch.equal(out.cpu().view(torch.int32),
                               want.view(torch.int32)), plan


@pytest.mark.cuda
def test_q8_refuses_more_than_32_rows_and_reads_x_scale_on_the_device(cuda):
    """Above 32 rows the wrapper raises (``quantized_call`` sends those to
    the padded ``_int_mm``); a captured call replays what the ``x_scale``
    buffer holds at replay time."""
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        static_int8_dense, static_int8_dense_reference)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(33, 256, generator=g).to(cuda)
    w = torch.randint(-127, 128, (256, 64), generator=g,
                      dtype=torch.int8).to(cuda)
    s = torch.full((64,), 0.01, device=cuda)
    xs = torch.tensor(0.05, device=cuda)
    with pytest.raises(ValueError, match="at most 32"):
        static_int8_dense(x, xs, w, s)
    x1 = x[:1].contiguous()
    static_int8_dense(x1, xs, w, s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = static_int8_dense(x1, xs, w, s)
    xs.fill_(0.1)
    graph.replay()
    torch.cuda.synchronize()
    want = static_int8_dense_reference(x1.cpu(), xs.cpu(), w.cpu(), s.cpu())
    assert torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_static_int8_head_forward_launches_q8_on_every_layer(cuda):
    """A calibrated 3-layer head at batch 1 and 32 runs Q8 once a layer
    and agrees with its plain CPU route bit for bit but the softmax."""
    from analytics_zoo_tpu_torch.ops.pallas.quantized import \
        KERNEL_INT8_STATIC
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    init_zoo_context(conf={"zoo.seed": 0})
    net = Sequential([Dense(256, activation="relu", input_shape=(96,)),
                      Dense(130, activation="relu"),
                      Dense(8, activation="softmax")],
                     device="cpu").init_weights()
    x = np.random.default_rng(0).normal(size=(32, 96)).astype(np.float32)
    im = InferenceModel(device="cuda").from_keras(net, quantize="int8",
                                                  calibrate=x[:8])
    ref = InferenceModel(device="cpu").from_keras(net, quantize="int8",
                                                  calibrate=x[:8])
    for m in (1, 32):
        before = KERNEL_INT8_STATIC.launches
        got = im.predict(x[:m])
        torch.cuda.synchronize()
        assert KERNEL_INT8_STATIC.launches == before + 3
        np.testing.assert_allclose(got, ref.predict(x[:m]), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# slice 18: the 32k shape, remat on the card, RReLU under capture
# ---------------------------------------------------------------------------

#: the 32k LM's attention shape (bench.py:424-425: batch 1, 8 heads of
#: 64, T = 32768, causal); the plain versions form the (T, T) f32 score
#: matrix, so they run on a cut: the last rows (which see the most keys)
#: against every key for out, lse and dq, one head at full length for dk
#: and dv
LC_SHAPE = (1, 8, 32768, 64)
LC_ROWS = 1024


@pytest.mark.cuda
def test_attention_kernels_at_32k_match_plain_versions_on_a_cut(cuda):
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        bwd_dkv, bwd_dkv_reference, bwd_dq, bwd_dq_reference)
    g = torch.Generator().manual_seed(32)
    q, k, v, do = (torch.randn(*LC_SHAPE, generator=g).to("cuda",
                                                          torch.bfloat16)
                   for _ in range(4))
    out, lse = flash_attention(q, k, v, causal=True, want_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    dq = bwd_dq(q, k, v, None, lse, delta, do, True)
    dk, dv = bwd_dkv(q, k, v, None, lse, delta, do, True)
    rows = slice(LC_SHAPE[2] - LC_ROWS, LC_SHAPE[2])
    ref, ref_lse = flash_attention_reference(q[:, :, rows], k, v, None,
                                             True, want_lse=True)
    # |out| is about sqrt(e / T) here, so out is held relative to the
    # reference's largest value, as dq, dk and dv are
    top = ref.float().abs().max().item()
    assert (out[:, :, rows].float() - ref.float()).abs().max() <= 2e-2 * top
    np.testing.assert_allclose(lse[:, :, rows].cpu().numpy(),
                               ref_lse.cpu().numpy(), atol=1e-3, rtol=0)
    want = bwd_dq_reference(q[:, :, rows], k, v, None, lse[:, :, rows],
                            delta[:, :, rows], do[:, :, rows], True)
    top = want.float().abs().max().item()
    assert (dq[:, :, rows].float() - want.float()).abs().max() <= 2e-2 * top
    del ref, want
    h = slice(7, 8)
    wk, wv = bwd_dkv_reference(q[:, h], k[:, h], v[:, h], None, lse[:, h],
                               delta[:, h], do[:, h], True)
    for got, want in ((dk[:, h], wk), (dv[:, h], wv)):
        top = want.float().abs().max().item()
        assert torch.isfinite(got).all()
        assert (got.float() - want.float()).abs().max() <= 2e-2 * top


def _remat_lm(conf, remat):
    """A small causal LM (2 blocks, hidden 64, seq 64, dropout 0.1 on the
    embeddings and hidden states) on the card through its kernels, under
    ``zoo.train.remat = remat``, compiled; with its data ``(x, y)``."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        Sequential, reset_uids)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense, TransformerLayer)
    reset_zoo_context()
    init_zoo_context(conf={"zoo.seed": 3, "zoo.pallas.attention": True,
                           "zoo.pallas.cross_entropy": True,
                           "zoo.train.fused_ce": True,
                           "zoo.train.remat": remat, **conf})
    reset_uids()
    net = Sequential([TransformerLayer(vocab=256, seq_len=64, n_block=2,
                                       hidden_size=64, n_head=2,
                                       hidden_drop=0.1, embedding_drop=0.1,
                                       attn_drop=0.0, bidirectional=False,
                                       input_shape=(64,)),
                      Dense(256)], device="cuda").init_weights(
                          torch.Generator().manual_seed(0))
    net.compile(optimizer="adam", loss="scce_with_logits", lr=1e-3)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (32, 64)).astype(np.int32)
    return net, x, ((7 * x + 13) % 256).astype(np.int32)


def _remat_lm_fit(conf, remat):
    """:func:`_remat_lm` fitted 2 epochs: step losses, parameters, K2/K4
    launches."""
    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import \
        KERNEL_CE_FWD
    net, x, y = _remat_lm(conf, remat)
    k2, k4 = KERNEL.launches, KERNEL_CE_FWD.launches
    net.fit(x, y, batch_size=8, nb_epoch=2, shuffle=False)
    torch.cuda.synchronize()
    return (np.concatenate(net._loop.step_losses),
            [p.detach().clone() for p in net.parameters()],
            (KERNEL.launches - k2, KERNEL_CE_FWD.launches - k4))


@pytest.mark.cuda
@pytest.mark.parametrize("conf", [{}, {"zoo.train.scan_steps": 4}],
                         ids=["eager", "captured"])
@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_on_the_card_gives_the_unremated_fits_bits(cuda, conf, remat):
    """Dropout on: the remat'd fit's step losses and parameters are the
    fit without remat's bits, in eager steps and in steps captured 4 a
    graph (the recompute redraws the forward's masks from the twin of
    each step's generator), with K2 and K4 launched twice a block (head)
    a step; the masks are live (dropout 0 gives other losses)."""
    off = _remat_lm_fit(conf, False)
    on = _remat_lm_fit(conf, remat)
    np.testing.assert_array_equal(on[0], off[0])
    assert all(torch.equal(p, q) for p, q in zip(on[1], off[1]))
    # a captured fit also runs one warm-up step before its first capture
    steps = 2 * 32 // 8 + (1 if conf else 0)
    assert off[2] == (2 * steps, steps)
    assert on[2] == (2 * 2 * steps, 2 * steps)
    assert len(set(on[0].tolist())) == len(on[0])


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, "dots", "full"])
def test_remat_step_leaves_nothing_on_the_card(cuda, remat):
    """With dropout on, the memory allocated after each forward and
    backward (``TrainingLoop._grads``, where remat applies) whose loss and
    gradients are dropped is the same from step to step: no recompute
    cache, stashed generator state or saved tensor outlives its step. The
    first step may leave the libraries' workspaces behind."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.training import \
        _to_device
    net, x, y = _remat_lm({}, remat)
    loop, dev = net._loop, torch.device("cuda")
    xb, yb = _to_device(x[:8], dev), _to_device(y[:8], dev)
    params = loop._params()
    after = []
    for i in range(4):
        loss, grads = loop._grads(xb, yb, loop._noise(3, i, dev), params)
        assert torch.isfinite(loss)
        del loss, grads
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated())
    assert after[1:] == after[:1] * 3, after


@pytest.mark.cuda
def test_rrelu_draws_its_slopes_on_the_device_under_capture(cuda):
    """RReLU in a Sequential fitted 4 steps a captured graph: the slopes
    come from each step's device generator (the captured fit's step
    losses are the eager fit's bits), every step draws new ones (8
    distinct losses at lr 0 on one repeated row) and no CPU generator is
    split."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        Sequential, reset_uids)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (Dense,
                                                                   RReLU)

    def fit(conf):
        reset_zoo_context()
        init_zoo_context(conf={"zoo.seed": 3, **conf})
        reset_uids()
        net = Sequential([Dense(64, input_shape=(8,)), RReLU(),
                          Dense(3, activation="softmax")],
                         device="cuda").init_weights(
                             torch.Generator().manual_seed(0))
        net.compile(optimizer="sgd", loss="scce", lr=0.0)
        x = np.repeat(np.linspace(-1, 1, 8, dtype=np.float32)[None], 64, 0)
        net.fit(x, np.ones(64, np.int32), batch_size=16, nb_epoch=2,
                shuffle=False)
        torch.cuda.synchronize()
        return np.concatenate(net._loop.step_losses)
    keyed = fit({"zoo.train.scan_steps": 4})
    assert len(set(keyed.tolist())) == len(keyed) == 8
    np.testing.assert_array_equal(keyed, fit({}))


# ---------------------------------------------------------------------------
# slice 19: C8, the static int8 conv
# ---------------------------------------------------------------------------

#: (batch, h, w, c, f, k, stride, dilation, same): every conv shape of
#: VGG-16 at 112 pixels (batch 1; batch 32 at its first and last block),
#: the 7x7/2 stems of ResNet-50 and Inception-v1 (XLA's (2, 3) pads), a
#: dilated AtrousConvolution2D, an odd K (45) and a 1x1 projection; then
#: the wgmma routes at C in {16, 48, 64} with stride 2, dilation 2, XLA's
#: asymmetric pads, F past a tile (130), F not a multiple of 4 (7), a 7x7/2
#: on 16 channels and a many-tile 64-filter layer
C8_CASES = ([(1, 112, 112, 3, 64, 3, 1, 1, True),
             (1, 112, 112, 64, 64, 3, 1, 1, True),
             (1, 56, 56, 64, 128, 3, 1, 1, True),
             (1, 56, 56, 128, 128, 3, 1, 1, True),
             (1, 28, 28, 128, 256, 3, 1, 1, True),
             (1, 28, 28, 256, 256, 3, 1, 1, True),
             (1, 14, 14, 256, 512, 3, 1, 1, True),
             (1, 14, 14, 512, 512, 3, 1, 1, True),
             (1, 7, 7, 512, 512, 3, 1, 1, True),
             (32, 112, 112, 3, 64, 3, 1, 1, True),
             (32, 7, 7, 512, 512, 3, 1, 1, True),
             (2, 112, 112, 3, 64, 7, 2, 1, True),
             (3, 33, 31, 16, 24, 3, 1, 2, True),
             (2, 17, 13, 5, 7, 3, 2, 1, False),
             (4, 28, 28, 256, 512, 1, 2, 1, True),
             (2, 12, 12, 16, 24, 3, 2, 1, True),
             (1, 11, 12, 48, 7, 3, 2, 2, False),
             (2, 8, 8, 64, 130, 3, 1, 2, True),
             (3, 13, 11, 16, 64, 7, 2, 1, True),
             (32, 28, 28, 64, 64, 3, 1, 1, True),
             (2, 56, 56, 64, 200, 3, 1, 1, True)])


def _c8_operands(case, seed):
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.convolution \
        import same_pads
    b, h, w, c, f, k, s, d, same = case
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g) * 2.0
    x.view(-1)[:3] = torch.tensor([0.125, -0.375, 6.4])   # .5 quotients
    xs = torch.tensor(0.05)
    wq = torch.randint(-127, 128, (k, k, c, f), generator=g,
                       dtype=torch.int8)
    ws = torch.rand(f, generator=g) * 0.01 + 1e-3
    bias = torch.randn(f, generator=g)
    pads = ([same_pads(n, k, s, d) for n in (h, w)] if same
            else [(0, 0), (0, 0)])
    return x, xs, wq, ws, bias, (s, s), (d, d), pads


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("case", C8_CASES)
def test_c8_is_its_plain_version_bit_for_bit(cuda, case, relu):
    """C8 against its plain version (the exact float64 conv of the int8
    values, on the card; small shapes on the CPU too): the same bits, the
    same bits twice and with the weight repacked beforehand, one launch a
    call, on the route ``conv_plan`` names for the shape."""
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_CONV, KERNEL_INT8_CONV_ROUTES, LAST_CONV_LAUNCH,
        conv_plan, repack_conv_weight, static_int8_conv2d,
        static_int8_conv2d_reference)
    x, xs, wq, ws, bias, st, dil, pads = _c8_operands(case, sum(case[:6]))
    dev = [t.to(cuda) for t in (x, xs, wq, ws, bias)]
    before = KERNEL_INT8_CONV.launches
    got = static_int8_conv2d(*dev, relu, st, dil, pads)
    route = LAST_CONV_LAUNCH.route
    routed = KERNEL_INT8_CONV_ROUTES[route].launches
    again = static_int8_conv2d(*dev, relu, st, dil, pads,
                               w_kmajor=repack_conv_weight(dev[2]))
    torch.cuda.synchronize()
    assert KERNEL_INT8_CONV.launches == before + 2
    assert KERNEL_INT8_CONV_ROUTES[route].launches == routed + 1
    m = got.shape[0] * got.shape[1] * got.shape[2]
    assert route == conv_plan(m, case[4], case[5] ** 2 * case[3], case[3],
                              torch.cuda.get_device_properties(
                                  0).multi_processor_count)[0]
    wants = [again.cpu(),
             static_int8_conv2d_reference(*dev, relu, st, dil, pads).cpu()]
    if x.numel() * wq.shape[-1] < 2 ** 24:
        wants.append(static_int8_conv2d_reference(x, xs, wq, ws, bias, relu,
                                                  st, dil, pads))
    for want in wants:
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


@pytest.mark.cuda
def test_c8_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from analytics_zoo_tpu_torch.ops.pallas.quantized import \
        static_int8_conv2d
    x = torch.zeros(1, 5, 5, 3, device=cuda)
    xs = torch.ones((), device=cuda)
    w = torch.zeros(7, 7, 3, 4, dtype=torch.int8, device=cuda)
    s = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="no output"):
        static_int8_conv2d(x, xs, w, s)             # 7x7 valid on 5x5
    with pytest.raises(ValueError, match="different devices"):
        static_int8_conv2d(x, xs, w.cpu(), s)
    with pytest.raises(TypeError, match="int8 w_q"):
        static_int8_conv2d(x, xs, w.float(), s)


@pytest.mark.cuda
def test_static_int8_vgg16_forward_launches_c8_once_per_conv(cuda):
    """A calibrated static-int8 VGG-16 (at its smallest input, 32 pixels)
    runs C8 once for each of its 13 convs and Q8 once for each of its 3
    Dense layers in one ``_forward``, and agrees with the CPU runtime's
    plain route (exact convs and products; the softmax within 1e-6)."""
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_CONV, KERNEL_INT8_CONV_QUANTIZE, KERNEL_INT8_CONV_REPACK,
        KERNEL_INT8_CONV_ROUTES, KERNEL_INT8_STATIC)
    init_zoo_context(conf={"zoo.seed": 0})
    m = ImageClassifier("vgg-16", num_classes=8, input_shape=(32, 32, 3),
                        device="cpu").init_weights()
    x = np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(
        np.float32)
    im = InferenceModel(device="cuda").from_keras(m, quantize="int8",
                                                  calibrate=x[:2])
    ref = InferenceModel(device="cpu").from_keras(m, quantize="int8",
                                                  calibrate=x[:2])
    assert len(im._act_scales) == 16
    counters = [KERNEL_INT8_CONV, KERNEL_INT8_STATIC,
                KERNEL_INT8_CONV_QUANTIZE, KERNEL_INT8_CONV_REPACK,
                *KERNEL_INT8_CONV_ROUTES.values()]
    before = [c.launches for c in counters]
    with torch.no_grad():
        out = im._forward([torch.from_numpy(x).cuda()])
    torch.cuda.synchronize()
    conv, static, quantize, repack, small_c, wgmma, split = (
        c.launches - n for c, n in zip(counters, before))
    assert (conv, static) == (13, 3)
    # the 3-channel conv quantizes on load; the other 12 run the quantize
    # pass and the wgmma routes on the repack made at install
    assert (small_c, wgmma + split, quantize, repack) == (1, 12, 12, 0)
    np.testing.assert_allclose(out.cpu().numpy(), ref.predict(x), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(16, 0), (4096 * 64 + 5, 0),
                                      (1000, 3), (7, 1),
                                      (32 * 56 * 56 * 64, 0)])
def test_c8_quantize_pass_is_quantize_static_bit_for_bit(cuda, n, offset):
    """The quantize pass (16 elements a thread where x and the output lie
    on 16 bytes, one where not) is ``quantize_static``'s bits: half-way
    quotients, the clip, zeros, an odd length, an unaligned view."""
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_CONV_QUANTIZE, quantize_static, static_int8_quantize)
    g = torch.Generator().manual_seed(n)
    xs = torch.tensor(0.0371, device=cuda)
    base = (torch.randn(n + offset, generator=g) * 3).to(cuda)
    k = min(n, 261)
    base[offset:offset + k] = (torch.arange(k, device=cuda) - 130 + 0.5
                               ) * xs
    x = base[offset:]
    before = KERNEL_INT8_CONV_QUANTIZE.launches
    got = static_int8_quantize(x, xs)
    torch.cuda.synchronize()
    assert KERNEL_INT8_CONV_QUANTIZE.launches == before + 1
    assert got.dtype == torch.int8 and got.shape == x.shape
    assert torch.equal(got, quantize_static(x, xs))
    assert torch.equal(got.cpu(), quantize_static(x.cpu(), xs.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 3, 64, 64), (3, 3, 512, 512),
                                   (7, 7, 3, 64), (1, 1, 16, 7),
                                   (3, 3, 48, 130)])
def test_c8_repack_is_its_plain_version(cuda, shape):
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_CONV_REPACK, repack_conv_weight,
        repack_conv_weight_reference)
    g = torch.Generator().manual_seed(sum(shape))
    w = torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)
    before = KERNEL_INT8_CONV_REPACK.launches
    got = repack_conv_weight(w.to(cuda))
    torch.cuda.synchronize()
    assert KERNEL_INT8_CONV_REPACK.launches == before + 1
    assert torch.equal(got.cpu(), repack_conv_weight_reference(w))


@pytest.mark.cuda
def test_c8_cases_cover_every_route(cuda):
    from analytics_zoo_tpu_torch.ops.pallas.quantized import conv_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    routes = set()
    for b, h, w, c, f, k, s, d, same in C8_CASES:
        ho = -(-h // s) if same else (h - (k - 1) * d - 1) // s + 1
        wo = -(-w // s) if same else (w - (k - 1) * d - 1) // s + 1
        routes.add(conv_plan(b * ho * wo, f, k * k * c, c, sms)[0])
    assert routes == {"c8_small_c", "c8_wgmma", "c8_split"}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [32, 1])
def test_static_int8_vgg16_forward_is_the_plain_forwards_bits(
        cuda, batch, monkeypatch):
    """A static int8 VGG-16 forward on the card gives the bits of the same
    forward with every conv on ``static_int8_conv2d_reference`` (Q8 and
    the other layers as they are): C8's routes change no bit."""
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.ops.pallas.quantized import \
        static_int8_conv2d_reference
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
        convolution
    init_zoo_context(conf={"zoo.seed": 0})
    m = ImageClassifier("vgg-16", num_classes=8, input_shape=(32, 32, 3),
                        device="cpu").init_weights()
    x = np.random.default_rng(1).normal(size=(batch, 32, 32, 3)).astype(
        np.float32)
    im = InferenceModel(device="cuda").from_keras(m, quantize="int8",
                                                  calibrate=x[:2])
    xt = torch.from_numpy(x).cuda()
    with torch.no_grad():
        got = im._forward([xt])
        torch.cuda.synchronize()

        def plain(*args, w_kmajor=None, **kwargs):
            return static_int8_conv2d_reference(*args, **kwargs)
        monkeypatch.setattr(convolution, "static_int8_conv2d", plain)
        want = im._forward([xt])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# --------------------------------------------------------------------------
# the recurrent slice: RNNs and ConvLSTMs on the card, captured fits,
# TextClassifier's int8 paths
# --------------------------------------------------------------------------

RECURRENT_CASES = {
    "simplernn": (lambda L: L.SimpleRNN(16, return_sequences=True),
                  (4, 9, 8)),
    "lstm_bwd": (lambda L: L.LSTM(16, go_backwards=True), (4, 9, 8)),
    "gru": (lambda L: L.GRU(16, return_sequences=True), (4, 9, 8)),
    "bidir_lstm": (lambda L: L.Bidirectional(L.LSTM(8, return_sequences=True),
                                             merge_mode="ave"), (4, 9, 8)),
    "convlstm2d": (lambda L: L.ConvLSTM2D(4, 3, return_sequences=True),
                   (2, 3, 8, 8, 2)),
    "convlstm3d": (lambda L: L.ConvLSTM3D(3, 3), (2, 3, 4, 5, 5, 1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RECURRENT_CASES))
def test_recurrent_layer_on_cuda_matches_cpu(cuda, name):
    """The same layer and input on the card and on the CPU: outputs 1e-5,
    the input's and every weight's gradient 1e-4 of the largest value
    (cuBLAS/cuDNN sum in another order; TF32 off)."""
    import copy

    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    build, shape = RECURRENT_CASES[name]
    cpu = build(L)
    cpu.build((None,) + shape[1:], generator=torch.Generator().manual_seed(1))
    dev = copy.deepcopy(cpu).to(cuda)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(2))
    outs = []
    for layer, xx in ((cpu, x.clone()), (dev, x.to(cuda))):
        xx.requires_grad_(True)
        y = layer(xx)
        r = torch.linspace(-1, 1, y.numel()).reshape(y.shape).to(y.device)
        (y * r).sum().backward()
        outs.append([y.detach().cpu(), xx.grad.cpu()]
                    + [p.grad.cpu() for p in layer.parameters()])
    for i, (want, got) in enumerate(zip(*outs)):
        tol = 1e-5 if i == 0 else 1e-4 * max(1.0, float(want.abs().max()))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol,
                                   rtol=1e-4)


def _recurrent_fit(kind, conf):
    """A small model of the slice on the card, fitted two epochs of four
    steps from seeded weights: its step losses and parameters."""
    from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq
    from analytics_zoo_tpu_torch.models.textclassification import \
        TextClassifier
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (
        Sequential, reset_uids)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        ConvLSTM2D, Dense, GlobalAveragePooling2D)
    reset_zoo_context()
    init_zoo_context(conf={"zoo.seed": 3, **conf})
    reset_uids()
    rng = np.random.default_rng(0)
    if kind == "text_lstm":          # Dropout(0.2) live in every step
        m = TextClassifier(4, 16, 24, "lstm", 32, vocab_size=50,
                           device="cuda")
        x = rng.integers(1, 50, (64, 24)).astype(np.int32)
        y = (x[:, 0] % 4).astype(np.int32)
        loss = "scce"
    elif kind == "seq2seq_gru":
        m = Seq2seq("gru", 2, 16, 4, bridge="densenonlinear",
                    generator_dim=4, device="cuda")
        enc = rng.normal(size=(64, 6, 4)).astype(np.float32)
        x, y, loss = [enc, enc], enc, "mse"
    else:
        m = Sequential([ConvLSTM2D(4, 3, input_shape=(3, 8, 8, 1)),
                        GlobalAveragePooling2D(),
                        Dense(2, activation="softmax")], device="cuda")
        x = rng.normal(size=(64, 3, 8, 8, 1)).astype(np.float32)
        y = rng.integers(0, 2, 64).astype(np.int32)
        loss = "scce"
    m.init_weights(torch.Generator().manual_seed(0))
    m.compile(optimizer="adam", loss=loss, lr=1e-2)
    m.fit(x, y, batch_size=16, nb_epoch=2, shuffle=False)
    torch.cuda.synchronize()
    return (np.concatenate(m._loop.step_losses),
            [p.detach().clone() for p in m.parameters()])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["text_lstm", "seq2seq_gru", "convlstm2d"])
def test_captured_recurrent_fit_is_the_eager_fits_bits(cuda, kind):
    """The T-step loops inside ``zoo.train.scan_steps`` 4 CUDA graphs:
    the step losses and the parameters are the eager fit's bits (dropout
    masks included; cuDNN deterministic for the ConvLSTM)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager = _recurrent_fit(kind, {})
        keyed = _recurrent_fit(kind, {"zoo.train.scan_steps": 4})
    finally:
        torch.backends.cudnn.deterministic = prev
    assert len(eager[0]) == 8
    np.testing.assert_array_equal(keyed[0], eager[0])
    assert all(torch.equal(p, q) for p, q in zip(keyed[1], eager[1]))


#: TextClassifier's int8 forwards on the card: the weight-only forward
#: against the same forward on K6's plain version (on the card) and on the
#: CPU, on probabilities of about 0.01-0.05 (measured on the H100: 1.5e-7
#: and 3.1e-7 at most)
TEXT_INT8_PLAIN_TOL, TEXT_INT8_CPU_TOL = 1e-6, 3e-6


@pytest.mark.cuda
@pytest.mark.parametrize("encoder", ["cnn", "lstm"])
def test_text_classifier_int8_paths_launch_k6_and_q8(cuda, encoder,
                                                       monkeypatch):
    """A batch of 16 through a TextClassifier's weight-only int8 forward
    launches K6 on both Dense layers; through its static int8 forward, Q8
    on both. The weight-only forward is within ``TEXT_INT8_PLAIN_TOL`` of
    the same forward on K6's plain version and ``TEXT_INT8_CPU_TOL`` of the
    CPU's; the static forward is the bits of the same forward on Q8's
    plain version and within 1e-4 of the CPU's."""
    from analytics_zoo_tpu_torch.models.textclassification import \
        TextClassifier
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_MATMUL, KERNEL_INT8_STATIC, int8_matmul_reference,
        static_int8_dense_reference)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import core
    init_zoo_context(conf={"zoo.seed": 0})
    table = np.random.default_rng(1).normal(size=(100, 32)).astype(
        np.float32)
    m = TextClassifier(20, 32, 40, encoder, 64, embedding_weights=table,
                       device="cpu").init_weights()
    x = np.random.default_rng(2).integers(1, 100, (16, 40)).astype(np.int32)
    wo = InferenceModel(device="cuda").from_keras(m, quantize="int8")
    before = KERNEL_INT8_MATMUL.launches
    got = wo.predict(x)
    assert KERNEL_INT8_MATMUL.launches == before + 2
    want = InferenceModel(device="cpu").from_keras(
        m, quantize="int8").predict(x)
    np.testing.assert_allclose(got, want, atol=TEXT_INT8_CPU_TOL, rtol=0)
    st = InferenceModel(device="cuda").from_keras(m, quantize="int8",
                                                  calibrate=x)
    before = KERNEL_INT8_STATIC.launches
    sgot = st.predict(x)
    assert KERNEL_INT8_STATIC.launches == before + 2
    want = InferenceModel(device="cpu").from_keras(
        m, quantize="int8", calibrate=x).predict(x)
    np.testing.assert_allclose(sgot, want, atol=1e-4, rtol=0)
    monkeypatch.setattr(core, "int8_matmul", int8_matmul_reference)
    monkeypatch.setattr(core, "static_int8_dense",
                        static_int8_dense_reference)
    np.testing.assert_allclose(got, wo.predict(x), atol=TEXT_INT8_PLAIN_TOL,
                               rtol=0)
    np.testing.assert_array_equal(sgot.view(np.int32),
                                  st.predict(x).view(np.int32))


_GUARD_CASES = [(0.7, 1.3, 1.1, 7.0), (0.7, 1.3, 0.0, 0.0),
                (float("nan"), 1.3, 1.1, 7.0), (0.7, float("inf"), 1.1, 7.0),
                (0.7, 50.0, 1.1, 7.0), (0.7, 50.0, 1.1, 3.0),
                (0.7, 3.0, 2.9, 7.0), (1e-3, 1e-20, 1e-7, 9.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,grad_clip", [("recover", 0.0),
                                            ("recover", 2.0), ("warn", 0.5),
                                            ("off", 2.0)])
@pytest.mark.parametrize("loss_dtype", [torch.float32, torch.bfloat16])
def test_guard_check_kernel_is_its_plain_version_bit_for_bit(
        cuda, mode, grad_clip, loss_dtype):
    """G2 against the torch chain it replaces, on the card, for each kind
    of step: flags, bad, the row, the clip scale and the updated EWMA
    state and count."""
    from analytics_zoo_tpu_torch.ops import guard as gk
    table = (torch.arange(12, dtype=torch.float32, device="cuda")
             .reshape(4, 3) / 7.0)
    for loss_v, gnorm_v, ewma_v, obs_v in _GUARD_CASES:
        outs = []
        before = gk.KERNEL_CHECK.launches
        for run in (gk.guard_check_reference, gk.guard_check):
            state = [torch.tensor(v, dtype=dt, device="cuda") for v, dt in
                     ((ewma_v, torch.float32), (obs_v, torch.float32),
                      (6, torch.int64))]
            res = run(torch.tensor(loss_v, device="cuda").to(loss_dtype),
                      torch.tensor(gnorm_v, device="cuda"), *state,
                      torch.tensor(5, device="cuda"), table,
                      sentinel=mode != "off", spike_factor=10.0,
                      grad_clip=grad_clip, recover=mode == "recover")
            outs.append([t for t in list(res) + state if t is not None])
        # the reference launches nothing, the wrapper its kernel once
        assert gk.KERNEL_CHECK.launches == before + 1
        for want, got in zip(*outs):
            assert want.dtype == got.dtype
            assert torch.equal(want.view(-1).view(torch.uint8),
                               got.view(-1).view(torch.uint8)), (
                loss_v, gnorm_v, want, got)


def _g2_both(grads, loss_v=0.7, mode="recover", clip=1.5, keep=None):
    """G2 given ``grads`` and its plain version on the same gradients, each
    from a first step's state (the new EWMA value is the global norm
    itself): their outputs and states, and G2's launches. With ``keep``,
    ``(copies, state)``, the kernel's run is followed by the recover
    step's keep: G1 copying ``state`` into ``copies`` on G2's ``bad``."""
    from analytics_zoo_tpu_torch.ops import guard as gk
    outs = []
    before = gk.KERNEL_CHECK.launches
    for run in (gk.guard_check_reference, gk.guard_check):
        state = [torch.zeros((), device="cuda"),
                 torch.zeros((), device="cuda"),
                 torch.tensor(0, device="cuda")]
        res = run(torch.tensor(loss_v, device="cuda"), None, *state,
                  torch.tensor(0, device="cuda"), None,
                  sentinel=mode != "off", spike_factor=10.0,
                  grad_clip=clip, recover=mode == "recover", grads=grads)
        if keep is not None and run is gk.guard_check:
            gk.guard_commit(keep[0], keep[1], res[1])
        outs.append([t for t in list(res) + state if t is not None])
    torch.cuda.synchronize()
    return outs, gk.KERNEL_CHECK.launches - before


def _same_outputs(outs):
    return all(a.dtype == b.dtype and torch.equal(
        a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8))
        for a, b in zip(*outs))


def _ncf_grads(g, dtype=torch.float32):
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    net = NeuralCF(6040, 3706, 5, device="cpu").init_weights()
    return [torch.randn(p.shape, generator=g, device="cuda").to(dtype)
            for p in net.parameters()]


def _g2_case(name, g):
    """The gradient lists G2 is held to its plain version on: NCF's 12
    parameters, 200 tensors, several chunks, lengths off a multiple of 4,
    a misaligned view (``_foreach_norm``'s unaligned path), bf16, empty
    tensors, and 1100 tensors (their descriptors in a device table)."""
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    if name == "ncf":
        return _ncf_grads(g)
    if name == "ncf_bf16":
        return _ncf_grads(g, torch.bfloat16)
    if name == "200_tensors":
        return [r(1 + (i * 37) % 3001) * (1 + i % 5) for i in range(200)]
    if name == "several_chunks":
        return [r(5 * 65536 + 12), r(65536), r(3 * 65536 + 1)]
    if name == "lengths_off_4":
        return [r(n) for n in (1, 2, 3, 5, 6, 7, 4099, 65537, 131071)]
    if name == "misaligned_view":
        base = r(3 * 65536 + 9)
        return [base[1:], base[2:130], base[4:4 + 4096], r(8)]
    if name == "bf16_mixed":
        return [r(n).to(torch.bfloat16) for n in (8, 7, 65536 + 4, 3001)] + [
            r(3 * 65536 + 8)[1:].to(torch.bfloat16), r(12)]
    if name == "empty_tensors":
        return [r(0), r(5), r(0), r(65536 + 3), r(0)]
    if name == "1100_tensors":
        # past the descriptors G2 takes by value: the device table
        return [r(1 + i % 7) * (1 + i % 3) for i in range(1100)]
    raise KeyError(name)


_G2_CASES = ["ncf", "ncf_bf16", "200_tensors", "several_chunks",
             "lengths_off_4", "misaligned_view", "bf16_mixed",
             "empty_tensors", "1100_tensors"]


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_guard_check_takes_the_norm_of_the_norms_bit_for_bit(cuda, scale):
    """G2 given the step's gradients for every count of tensors from 0 to
    260: the global norm it takes (read back as the new EWMA value of a
    first step, which is the norm itself) is ``_foreach_norm`` then
    ``vector_norm``'s bits, on both sides of 128 norms (where
    ``vector_norm`` loads four floats a thread), one launch each."""
    g = torch.Generator(device="cuda").manual_seed(int(scale * 1000))
    wrong = []
    for n in range(0, 261):
        grads = [torch.randn(1 + (i * 7) % 13, generator=g, device="cuda")
                 * scale * (1 + i % 3) for i in range(n)]
        outs, launches = _g2_both(grads, clip=0.0)
        assert launches == 1
        if not _same_outputs(outs):
            wrong.append((n, outs[0][3].item(), outs[1][3].item()))
    assert not wrong, wrong


@pytest.mark.cuda
@pytest.mark.parametrize("case", _G2_CASES)
@pytest.mark.parametrize("mode,clip", [("recover", 1.5), ("warn", 0.0),
                                       ("off", 2.0)])
def test_g2_reads_the_gradients_with_the_chains_bits(cuda, case, mode, clip):
    """G2 on the gradients against ``tensor_norms`` -> ``norm_of_norms``
    -> ``guard_check_reference``, bit for bit: flags, bad, the clip scale
    and the new EWMA state and count, in one launch."""
    g = torch.Generator(device="cuda").manual_seed(len(case))
    grads = _g2_case(case, g)
    outs, launches = _g2_both(grads, mode=mode, clip=clip)
    assert launches == 1
    assert _same_outputs(outs), (case, outs)


@pytest.mark.cuda
@pytest.mark.parametrize("special", ["nan", "inf"])
@pytest.mark.parametrize("mode", ["recover", "warn"])
@pytest.mark.parametrize("aligned", [True, False])
def test_g2_flags_a_nan_or_inf_gradient_as_its_plain_version(
        cuda, special, mode, aligned):
    """A NaN or an inf in one gradient (on ``_foreach_norm``'s vectorised
    path and on its unaligned one): NAN_GRAD, ``bad`` in recover mode,
    the EWMA state kept — the plain version's bits."""
    g = torch.Generator(device="cuda").manual_seed(7)
    grads = _ncf_grads(g)
    if not aligned:
        grads[0] = torch.randn(70_001, generator=g, device="cuda")[1:]
    grads[0].view(-1)[1234] = float(special)
    outs, _ = _g2_both(grads, mode=mode)
    assert _same_outputs(outs)
    assert int(outs[1][0]) & 2 and bool(outs[1][1]) == (mode == "recover")


@pytest.mark.cuda
def test_g2_given_gradients_keeps_the_state_on_a_bad_step(cuda):
    """G2 reading the gradients in recover mode, then the keep (G1 on its
    ``bad``): a bad step (a NaN gradient) copies every state tensor into
    its pre-step copy; a good one writes none of them, over six steps in
    a row, good and bad in turn."""
    from analytics_zoo_tpu_torch.ops import guard as gk
    g = torch.Generator(device="cuda").manual_seed(3)
    state = [torch.randn(s, generator=g, device="cuda").to(dt) for s, dt in
             (((300_001,), torch.float32), ((3, 5), torch.bfloat16),
              ((9,), torch.int64))]
    for bad in (False, True, True, False, False, True):
        grads = _ncf_grads(g)
        if bad:
            grads[0].view(-1)[5] = float("nan")
        copies = [torch.zeros_like(t) for t in state]
        g1 = gk.KERNEL_COMMIT.launches
        outs, launches = _g2_both(grads, keep=(copies, state))
        assert gk.KERNEL_COMMIT.launches == g1 + 1
        assert launches == 1 and _same_outputs(outs)
        assert bool(outs[1][1]) == bad
        for c, t in zip(copies, state):
            assert torch.equal(c, t if bad else torch.zeros_like(t))


@pytest.mark.cuda
@pytest.mark.parametrize("with_keep", [False, True])
def test_g2_captured_step_replays_with_the_plain_bits(cuda, with_keep):
    """G2 captured in a CUDA graph with the loop's own tickets (reset by
    the kernel itself, so the graph holds no memset) and replayed twice
    on new gradient values: each replay gives the plain version's bits
    on the values it read, with the keep's G1 after it and without (a
    good step: the copies stay unwritten)."""
    from analytics_zoo_tpu_torch.ops import guard as gk
    g = torch.Generator(device="cuda").manual_seed(11)
    grads = _ncf_grads(g) + [torch.randn(1001, generator=g, device="cuda")]
    state = [torch.zeros((), device="cuda"), torch.zeros((), device="cuda"),
             torch.tensor(0, device="cuda")]
    loss = torch.tensor(0.7, device="cuda")
    base = torch.tensor(0, device="cuda")
    kept = [torch.randn(70_001, generator=g, device="cuda")]
    copies = [torch.zeros_like(t) for t in kept]
    keep = gk.commit_table(copies, kept) if with_keep else None
    tickets = torch.zeros(len(grads) + 1, dtype=torch.int32, device="cuda")

    def step():
        out = gk.guard_check(loss, None, *state, base, None, sentinel=True,
                             spike_factor=10.0, grad_clip=1.5,
                             recover=True, grads=grads, tickets=tickets)
        if keep is not None:
            gk.guard_commit(copies, kept, out[1], keep)
        return out
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        flags, bad, _, scale = step()
    for replay in range(2):
        for t in grads:
            t.copy_(torch.randn(t.shape, generator=g, device="cuda")
                    * (replay + 1))
        for t in state:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        got = [flags.clone(), bad.clone(), scale.clone()] + [
            t.clone() for t in state]
        want_state = [torch.zeros((), device="cuda"),
                      torch.zeros((), device="cuda"),
                      torch.tensor(0, device="cuda")]
        want = gk.guard_check_reference(
            loss, None, *want_state, base, None, sentinel=True,
            spike_factor=10.0, grad_clip=1.5, recover=True, grads=grads)
        want = [want[0], want[1], want[3]] + want_state
        assert _same_outputs([want, got]), (replay, want, got)
        assert not torch.any(tickets) and not torch.any(copies[0])


@pytest.mark.cuda
def test_g2_launches_of_two_loops_at_once_keep_their_own_tickets(cuda):
    """Two loops' G2 launches on two streams, each with its own tickets,
    overlapping over many rounds (one set of many tensors, one of few):
    every launch gives its plain version's bits, and both ticket sets
    end at zero."""
    from analytics_zoo_tpu_torch.ops import guard as gk
    g = torch.Generator(device="cuda").manual_seed(21)
    sets = [_ncf_grads(g),
            [torch.randn(1 + 37 * i, generator=g, device="cuda")
             for i in range(150)]]
    tickets = [torch.zeros(len(s) + 1, dtype=torch.int32, device="cuda")
               for s in sets]
    zero = torch.tensor(0, device="cuda")
    loss = torch.tensor(0.7, device="cuda")

    def scalars():
        return [torch.zeros((), device="cuda"),
                torch.zeros((), device="cuda"),
                torch.tensor(0, device="cuda")]
    want = []
    for grads in sets:
        st = scalars()
        res = gk.guard_check_reference(
            loss, None, *st, zero, None, sentinel=True, spike_factor=10.0,
            grad_clip=1.5, recover=True, grads=grads)
        want.append([t for t in list(res) + st if t is not None])
    streams = [torch.cuda.Stream() for _ in sets]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[] for _ in sets]
    for _ in range(50):
        for k, (grads, s) in enumerate(zip(sets, streams)):
            with torch.cuda.stream(s):
                st = scalars()
                res = gk.guard_check(
                    loss, None, *st, zero, None, sentinel=True,
                    spike_factor=10.0, grad_clip=1.5, recover=True,
                    grads=grads, tickets=tickets[k])
                got[k].append([t for t in list(res) + st if t is not None])
    torch.cuda.synchronize()
    for k in range(len(sets)):
        for out in got[k]:
            assert _same_outputs([want[k], out]), k
        assert not torch.any(tickets[k])


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [False, True])
def test_guard_commit_kernel_is_the_per_tensor_select(cuda, bad):
    """G1 against ``torch.where(bad, prev, t, out=t)`` a tensor, over
    tensors of several dtypes, odd sizes (a byte tail), one larger than a
    chunk and two dense in another dimension order, in one launch; the
    table is made once."""
    from analytics_zoo_tpu_torch.ops import guard as gk
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = ((7, 3), (100_003,), (2, 2), (), (5,))
    dtypes = (torch.float32, torch.bfloat16, torch.int64, torch.float32,
              torch.bool)
    state = [torch.randn(s, generator=g, device="cuda").to(dt)
             for s, dt in zip(shapes, dtypes)]
    # a channels_last conv weight and a transposed matrix: dense spans in
    # another dimension order, as a conv model's parameters lie
    state += [torch.randn(8, 3, 5, 5, generator=g, device="cuda").to(
                  memory_format=torch.channels_last),
              torch.randn(6, 9, generator=g, device="cuda").t()]
    prev = [t.clone() for t in state]
    for t in state:
        if t.dtype != torch.bool:
            t.add_(1)
    want = [t.clone() for t in state]
    gk.guard_commit_reference(want, prev, torch.tensor(bad, device="cuda"))
    before = gk.KERNEL_COMMIT.launches
    table = gk.guard_commit(state, prev, torch.tensor(bad, device="cuda"))
    assert gk.KERNEL_COMMIT.launches == before + 1
    assert gk.guard_commit(state, prev, torch.tensor(False, device="cuda"),
                           table) is table
    torch.cuda.synchronize()
    for got, w in zip(state, want):
        assert torch.equal(got, w)


@pytest.mark.cuda
def test_guard_check_keep_copies_the_state_for_a_bad_step_only(cuda):
    """The recover step's keep, G1 on G2's ``bad`` (the norm given, as on
    a mesh): a bad step copies every state tensor into its pre-step copy
    bit for bit; a good step writes none of them."""
    from analytics_zoo_tpu_torch.ops import guard as gk
    g = torch.Generator(device="cuda").manual_seed(1)
    state = [torch.randn(s, generator=g, device="cuda").to(dt) for s, dt in
             (((70_001,), torch.float32), ((3, 5), torch.bfloat16),
              ((9,), torch.int64))]
    for loss_v, bad in ((0.5, False), (float("nan"), True)):
        copies = [torch.zeros_like(t) for t in state]
        keep = gk.commit_table(copies, state)
        scalars = [torch.tensor(v, dtype=dt, device="cuda") for v, dt in
                   ((1.0, torch.float32), (7.0, torch.float32),
                    (0, torch.int64))]
        _, flag, _, _ = gk.guard_check(
            torch.tensor(loss_v, device="cuda"),
            torch.tensor(1.0, device="cuda"), *scalars,
            torch.tensor(0, device="cuda"), None, sentinel=True,
            spike_factor=10.0, grad_clip=0.0, recover=True)
        gk.guard_commit(copies, state, flag, keep)
        torch.cuda.synchronize()
        assert bool(flag) == bad
        for c, t in zip(copies, state):
            assert torch.equal(c, t if bad else torch.zeros_like(t))


# ---------------------------------------------------------------------------
# N1, the batched NMS keep-mask, and SSD's detection path
# ---------------------------------------------------------------------------

def _nms_rows(rows, k, seed):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(rows, k, 2, generator=g) * 0.7
    wh = torch.rand(rows, k, 2, generator=g) * 0.3 + 0.01
    boxes = torch.cat([xy, xy + wh], -1)
    if k >= 5:
        # an IoU of 0.5 exactly (kept at 0.5), and a duplicate (dropped)
        boxes[0, :5] = torch.tensor([[0.0, 0.0, 0.5, 1.0],
                                     [0.0, 0.0, 1.0, 1.0],
                                     [0.9, 0.0, 1.0, 0.05],
                                     [0.25, 0.25, 0.75, 0.75],
                                     [0.25, 0.25, 0.75, 0.75]])
    return boxes.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,threshold", [
    (672, 400, 0.45), (21, 400, 0.5), (3, 37, 0.3), (5, 1, 0.45),
    (2, 1024, 0.5), (7, 700, 0.45), (4, 1, 0.0), (6, 31, 0.45),
    (6, 32, 0.7), (6, 33, 0.3), (3, 1024, 0.45), (9, 64, 0.0)])
def test_n1_is_its_plain_version_bit_for_bit(cuda, rows, k, threshold):
    """N1 against the torch loop on the card, one launch for every row;
    at K = 700 and 1024 its shared memory is above the default 48 KB."""
    from analytics_zoo_tpu_torch.ops.nms import (KERNEL_NMS, nms_keep_mask,
                                                 nms_keep_mask_reference)
    boxes = _nms_rows(rows, k, seed=rows + k)
    before = KERNEL_NMS.launches
    got = nms_keep_mask(boxes, threshold)
    torch.cuda.synchronize()
    assert KERNEL_NMS.launches == before + 1
    assert torch.equal(got, nms_keep_mask_reference(boxes, threshold))
    if k >= 5 and threshold == 0.5:
        assert got[0, 1] and got[0, 3] and not got[0, 4]
    # batched leading dimensions are rows too
    assert torch.equal(nms_keep_mask(boxes.view(1, rows, k, 4), threshold),
                       got.view(1, rows, k))


def _boxes_at_the_threshold(t, k):
    """One row of ``k`` boxes whose IoUs with the first sit at and a few
    ulps around ``t``: box 0 is the unit square, box j a strip [0, 0, w_j,
    1] whose IoU with it is about w_j, for w_j on t's neighbours; the
    strips' IoUs with each other land on many other values."""
    t = np.float32(t)
    ws = [t]
    for d in (np.inf, -np.inf):
        v = t
        for _ in range(3):
            v = np.nextafter(v, np.float32(d))
            ws.append(v)
    rng = np.random.default_rng(int(t * 1000))
    ws += list(rng.uniform(0.2, 0.9, k).astype(np.float32))
    boxes = np.zeros((1, k, 4), np.float32)
    boxes[0, 0] = [0.0, 0.0, 1.0, 1.0]
    for j in range(1, k):
        wj = np.clip(ws[(j - 1) % len(ws)], 0, 1)
        boxes[0, j] = [0.0, 0.0, wj, 1.0]
    return boxes


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [0.0, 0.3, 0.45, 0.5, 0.7])
@pytest.mark.parametrize("k", [8, 33, 400])
def test_n1_decides_iou_at_the_threshold_as_the_division(cuda, threshold,
                                                          k):
    """Rows whose IoUs sit on the threshold and an ulp or a few either
    side of it, also under the later rows' own overlaps: N1's keep-mask
    is its plain version's bit for bit (the division-free test hands the
    pairs at the cut to the division)."""
    from analytics_zoo_tpu_torch.ops.nms import (nms_keep_mask,
                                                 nms_keep_mask_reference)
    boxes = torch.from_numpy(_boxes_at_the_threshold(threshold, k)).cuda()
    rows = torch.cat([boxes, boxes.flip(1)], 0)
    got = nms_keep_mask(rows, threshold)
    torch.cuda.synchronize()
    assert torch.equal(got, nms_keep_mask_reference(rows, threshold))


@pytest.mark.cuda
def test_n1_refuses_what_it_does_not_take(cuda):
    from analytics_zoo_tpu_torch.ops.nms import NMS_MAX_K, nms_keep_mask
    with pytest.raises(ValueError):
        nms_keep_mask(torch.zeros(2, NMS_MAX_K + 1, 4, device="cuda"))
    assert nms_keep_mask(torch.zeros(0, 3, 4, device="cuda")).shape == (0, 3)


@pytest.mark.cuda
def test_ssd_lite_detect_runs_n1_and_matches_the_cpu(cuda):
    """``ssd-lite``'s detect on the card (one N1 launch a batch) against
    the same detector on the CPU (N1's plain version): the same labels
    wherever the scores are apart, boxes within 1e-4."""
    from analytics_zoo_tpu_torch.models.image.objectdetection import \
        ObjectDetector
    from analytics_zoo_tpu_torch.ops.nms import KERNEL_NMS
    init_zoo_context()
    cpu = ObjectDetector("ssd-lite", num_classes=3, resolution=64,
                         device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    gpu = ObjectDetector("ssd-lite", num_classes=3, resolution=64,
                         device="cuda")
    gpu.init_weights(torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).normal(size=(4, 64, 64, 3)).astype(
        np.float32)
    before = KERNEL_NMS.launches
    got = gpu.detect(x, batch_size=2, conf_thresh=0.2)
    assert KERNEL_NMS.launches == before + 2
    want = cpu.detect(x, batch_size=2, conf_thresh=0.2)
    assert got.shape == want.shape == (4, 200, 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], atol=1e-4,
                               rtol=0)


@pytest.mark.cuda
def test_multibox_loss_captures_in_a_cuda_graph(cuda):
    """MultiBoxLoss reads nothing back to the host: a fit of ``ssd-lite``
    captured in CUDA graphs (``zoo.train.scan_steps``) gives the eager
    fit's step losses bit for bit."""
    from analytics_zoo_tpu_torch.models.image.objectdetection import \
        ObjectDetector
    torch.backends.cudnn.deterministic = True
    try:
        rng = np.random.default_rng(1)
        x = rng.normal(size=(32, 64, 64, 3)).astype(np.float32)
        gt = np.full((32, 2, 5), -1.0, np.float32)
        gt[:, 0] = [1, 0.2, 0.2, 0.6, 0.7]
        losses = []
        for conf in ({}, {"zoo.train.scan_steps": 4}):
            reset_zoo_context()
            init_zoo_context(conf=conf)
            det = ObjectDetector("ssd-lite", num_classes=2, resolution=64,
                                 device="cuda")
            det.init_weights(torch.Generator().manual_seed(0))
            det.compile(optimizer="adam", loss=det.multibox_loss(), lr=1e-3)
            det.fit(x, gt, batch_size=8, nb_epoch=2, shuffle=False)
            losses.append(np.concatenate(det._loop.step_losses))
        np.testing.assert_array_equal(losses[0], losses[1])
    finally:
        torch.backends.cudnn.deterministic = False
