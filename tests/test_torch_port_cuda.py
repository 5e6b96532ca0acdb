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
