#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds every CUDA kernel of the port from ``analytics_zoo_tpu_torch/
   csrc`` with ``nvcc`` (into ``build/``; one ``nvcc`` per source, all
   started together) and prints the build time.
2. Forward kernel phase: holds K2 (bf16: wgmma on TMA-fed tiles; f32:
   CUDA-core FMAs) against its plain PyTorch version at BERT-base
   attention shapes (B=8, H=12, T=512, D=64; f32 and bf16, key padding, a
   causal case, a t_q != t_kv case, a fully masked row) and
   times it beside the plain version, ``scaled_dot_product_attention``
   (timed here only, as a yardstick) and its roofline bound.
3. Backward kernel phase: holds K3a (dq) and K3b (dk/dv) against their
   plain versions at the same shapes (key padding, causal, t_q != t_kv
   both ways, a fully masked batch row whose gradients must be exactly 0)
   and against themselves: the same bits on a second run.
4. Serving phase: a full-width BERT-base ``BERTClassifier`` (random
   weights from a seed, bf16 policy, ``zoo.pallas.attention=true``) behind
   ``InferenceModel`` and ``ClusterServing(batch_size=32)`` on a
   ``LocalBackend`` answers 256 records of 512 tokens. Every answer is
   checked (finite, sums to 1, agrees with the port's oracle attention
   route), and the kernel launch counts prove the path went through the
   kernels.
5. Training phase: the JAX package's seq-512 fine-tune configuration
   (BERT-base, vocab 30522, bf16 compute with f32 params, AdamW lr 2e-5,
   batch 32) through ``compile``/``fit`` on 256 seeded records: one
   warm-up epoch, then one timed epoch of 8 steps. Checks a finite loss,
   moved parameters, 12 launches per step of each of K2, K3a and K3b,
   and one step's gradients against the oracle attention route.

6. CE kernel phase: holds K4, K5a and K5b (the fused LM-head
   cross-entropy) against their plain versions at N=4100, H=512, in f32
   and bf16: V=8192 and a ragged V=8000, no bias, labels of -1 on every
   third row (loss 0, dh rows exactly 0), three over-range labels (NaN in
   those rows and in dW) and one bias entry of 100 over a ragged row tile.
   Each case runs twice and K5b's dW/db must be the same bits; every
   kernel must report its wgmma route in bf16 and its FMA route in f32.
7. LM training phase: the JAX package's 4k long-context configuration
   (``bench.py:415-438``: ``Sequential([TransformerLayer(vocab=8192,
   seq_len=4096, n_block=4, hidden_size=512, n_head=8, causal),
   Dense(8192)])``, Adam lr 3e-4, ``scce_with_logits``, bf16 compute with
   f32 params, batch 16) through ``compile``/``fit`` on 32 sequences of
   ``y = (7x + 13) mod 8192`` with every flag at ``auto``: a warm-up of
   two epochs, then two timed epochs of two steps. Checks the loss gate,
   1 launch per step of K4/K5a/K5b (every one on its wgmma route) and 4
   of K2/K3a/K3b, one step's
   gradients against the full-logits oracle, and that the fused route's
   peak memory over that step is at least one bf16 logits tensor lower.
   Then prints the JAX bench's ``fused_ce_speedup`` (``bench.py:254-325``:
   one forward and backward of the fused loss against the full-logits
   objective at 32,768 rows, best of three; not gated).

8. CE hidden-width phase: K4/K5a/K5b against their plain versions at
   N=4100, V=8192, bf16, H = 100 (padded to 128), 1280 and 2048 (H staged
   in two slices), each timed.
9. Embedding kernel phase: K1 (the dedup'd expand) and SA (the dedup
   scatter-add) against their plain versions at the NCF path's shapes
   (the first batch's user and item ids, capacities 8192 and 4096, D=20)
   and at a DLRM-Terabyte width (D=128, N=2048x26 ids over a million
   rows, f32 and bf16): K1 bit for bit, SA bit for bit against the CPU's
   position-order sum and the same bits over two runs, both through the
   forward's sort (the engine's call: one device kernel) and standalone
   (it sorts first). Each is timed beside ``index_select`` /
   ``index_add_`` and its byte bound (SA's also beside the byte time of
   the int64 sorted positions and slots it reads in place of the ids).
10. NCF phase: the JAX package's NeuralCF bench configuration
   (``bench.py:50-52, 1279-1285``: ``NeuralCF(6040, 3706, 5)``, Adam lr
   1e-3, ``scce``, batch 8192, 1,000,000 MovieLens-1M-shaped ratings from
   numpy seed 0, ``FeatureSet.array(x, y, seed=0)``), then the same graph
   on ``ShardedEmbedding`` tables: a warm-up epoch and two timed epochs of
   122 steps each. Checks the loss gate (last epoch below the first and
   below ln 5), 4 launches per step of K1 and of SA on the sharded graph
   and none on the stock model, the device kernels of one forward and one
   backward of the sharded graph (``torch.profiler``: SA four times in
   the backward, no sort or search there), one step's gradients of the
   two from the same weights (1e-5 relative per leaf), the same dW bits
   over two
   backward passes, and ``recommend_for_user`` against a plain eager
   forward. Each configuration is fitted four times from the same start,
   in turns: the eager loop, the JAX bench's dispatch keys
   (``zoo.train.scan_steps=16``, ``device_cache=true``; ``fuse_epochs=2``
   for the two timed epochs, the bench's 12 cut), the keys again, the
   eager loop; each prints records/s, ms a step and the device's busy
   share over one more epoch under ``torch.profiler``; the keyed fits'
   K1 and SA count 4 a step under CUDA-graph replay. The keyed loop runs
   once more with the device permutation replaced by the FeatureSet's own
   order: its step losses against the eager loop's (the same bits, or
   within 1e-6 relative, printed which).

11. int8 kernel phase: K6 (the int8 weight-only dequant-matmul,
   ``csrc/quantized.cu``) against its plain version in f32 and bf16 at
   the head's batch-1, batch-8 and batch-32 shapes (K = N = 4096; at 32
   also with the dense layer's bias and ReLU fused into the skinny kernel,
   which must give the bits of the unfused kernel followed by the two
   torch ops), BERT-base's qkv and fc/out products (M = 32 x 512), BERT's
   Dense(2) head, a ragged (17, 100, 10) and a (300, 100, 130) whose rows
   TMA cannot address, each checked for the kernel it takes (skinny at
   M <= 32, fma in f32, wgmma in bf16 where K % 8 and N % 16 are 0, else
   mma), in both modes (dequantize-first, which ``dense`` runs, and the
   Pallas contract's scale-after): f32 within 1e-4 of the case's largest
   value, bf16 within one bf16 step there, the same bits over two runs;
   each timed in the first mode (wrapper, CUDA-graph device time, plain,
   ``torch.matmul`` on the dequantized weight, bound; with the route and
   the K slices the C entry point reported for the timed calls, checked
   against the route expected; the fused case with the unfused
   sequence's device time beside) with the second mode's device time
   beside. The static path's padded ``torch._int_mm`` bit for bit against
   the CPU's int32 product at M = 1 and 32.
12. int8 serving phase (config B): the serving phase's BERT-base, records
   and adapter on the weight-only int8 ``InferenceModel`` that
   ``ClusterServing._wrap_model`` builds for ``dtype="int8"``: every matmul
   weight int8 on the device, 50 K6 and 12 K2 launches per dispatch (48
   of the K6 ones, every product over the 32 x 512 tokens, on the wgmma
   tile kernel, the pooler and the Dense(2) head on the skinny one), the
   answers within 2e-2 of bf16 serving on the dequantized weights (and,
   printed beside, of bf16 serving on the weights the JAX predict forms,
   ``bf16(q) * bf16(s)``, which K6's dequantize-first mode forms too).
13. int8 head phase (config A): the JAX bench's weight-streaming scoring
   head (``bench.py:797-815``: 3 x Dense(4096, relu) + Dense(8, softmax),
   f32, one epoch of Adam 1e-4 on 256 seeded rows, batch 64) served fp32,
   weight-only int8 (K6 on all four layers, bias and ReLU fused into its
   skinny kernel) and static int8 calibrated on 8 rows (``_int_mm`` on all
   four): resident weight bytes (int8 at most 0.3 x fp32), each int8 mode
   within 1e-4 relative of its float counterpart, top-1 agreement and
   batch-1 device time by CUDA-graph replay (printed; weight-only also
   with the bias adds and ReLUs as torch ops of their own, as before the
   fusion, and the device kernels one batch-1 ``_forward`` launches each
   way, fewer with the fusion), and ``ClusterServing(model,
   dtype="int8")`` answering all 256 records with 4 K6 launches per
   dispatch, all on the skinny kernel.
14. Fault l phase: the fused LM-head cross-entropy on views (a column
   slice of a wider hidden array, a tied head's transposed embedding) at
   N=4100, H=512, V=8192, f32 and bf16: one launch each of K4/K5a/K5b,
   the loss rows and the three gradients against the plain route.
15. Captured BERT phase: BERT at two blocks of full width, seq 512, batch
   8, hidden dropout 0.1, four steps a captured graph: K2, K3a and K3b
   launch 2 a step under replay, every step of two replays draws a new
   dropout mask (sgd at lr 0 on one repeated record: 8 distinct step
   losses), the eager steps' masks; with dropout 0 and AdamW the captured
   fit's losses and parameters against the eager fit's.

Prints the card's name and power limit, one ``{"kernels": [...]}`` JSON
line (each kernel at its main path's shape, with its launches on that
path; the attention kernels also checked against their plain versions,
checked for the same gradient bits over two runs and timed at the LM
shape beside SDPA's causal forward and backward there, K1 and SA also at
the DLRM width), and last
``{"ok":
true, "device": {...}}``. Exits non-zero, printing no result, without a
CUDA device, outside the repository, or when any check fails.
"""

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

T_BATCH = 32          # ClusterServing and fit batch size: the kernels' B
N_RECORDS = 256
SEQ = 512
#: the JAX package's seq-512 fine-tune configuration (bench.py:193-236)
TRAIN_CFG = dict(num_classes=2, vocab=30522, hidden_size=768, n_block=12,
                 n_head=12, seq_len=SEQ, intermediate_size=3072,
                 attn_drop=0.0)
#: per-leaf bound on |g_flash - g_oracle| / |g_oracle| for one bf16 step:
#: the two attention routes round the probabilities at different points
#: (the oracle rounds normalized f32 weights to bf16; K2 rounds
#: exponentials relative to a running max and normalizes after the
#: product, K3a/K3b round P and dS), so each attention output differs by
#: up to a bf16 step (2^-8) and the differences compound through 12
#: blocks forward and back. A missing attention gradient would put the
#: qkv leaves near 100%.
GRAD_REL_TOL = 0.1


#: the JAX package's 4k long-context configuration (bench.py:415-438)
LM_VOCAB, LM_SEQ, LM_BATCH, LM_SEQS = 8192, 4096, 16, 32
LM_CFG = dict(vocab=LM_VOCAB, seq_len=LM_SEQ, n_block=4, hidden_size=512,
              n_head=8, hidden_drop=0.0, attn_drop=0.0, embedding_drop=0.0,
              bidirectional=False)
#: per-leaf bound on |g_fused - g_oracle| / |g_oracle| for one bf16 LM
#: step. Both routes round the logits to bf16 at the same points (Dense's
#: rounding) and run the same attention kernels; they differ in the
#: softmax gradient: the oracle takes it from an f32 log-softmax of the
#: upcast logits and rounds it to bf16 in autograd's cast, the fused route
#: re-forms p from its own f32 lse and rounds dl to bf16. Entries near a
#: rounding boundary move by one bf16 step (2^-8), so each leaf differs by
#: well under 1%; 2% leaves room for the four blocks the difference
#: crosses on its way back. A missing head gradient would read 100%.
LM_GRAD_REL_TOL = 0.02


#: the JAX package's NeuralCF bench configuration (bench.py:50-52,
#: 1279-1285): MovieLens-1M's shape
N_USERS, N_ITEMS, N_CLASSES = 6040, 3706, 5
N_EXAMPLES = 1_000_000
NCF_BATCH = 8192
#: one step's gradients, stock NeuralCF against its ShardedEmbedding
#: graph from the same weights: both gather the same f32 rows and sum the
#: repeated ids' cotangents in f32 (position order against the gather's
#: own backward), so they differ by summation order only
NCF_GRAD_REL_TOL = 1e-5
#: the JAX bench's dispatch keys (bench.py:53-54, 1258-1262), fuse_epochs
#: cut from its 12 to the phase's two timed epochs
NCF_KEYED_CONF = {"zoo.train.scan_steps": 16, "zoo.train.device_cache": True,
                  "zoo.train.fuse_epochs": 2}
#: the keyed loop's step losses against the eager loop's in the same batch
#: order: the same ops on the same values, so the same bits are expected;
#: this bounds any difference a captured kernel might still make
NCF_STEP_REL_TOL = 1e-6
#: DLRM-Terabyte's width: 26 sparse features of dimension 128, batch 2048
DLRM_D, DLRM_N, DLRM_V = 128, 2048 * 26, 1_000_000

#: config A, the JAX bench's weight-streaming scoring head
#: (bench.py:797-815): 3 x Dense(4096) + Dense(8), 256 seeded rows
HEAD_D, HEAD_CLASSES, HEAD_ROWS = 4096, 8, 256
#: K6's cases (M, K, N, fused bias + ReLU): the head at batch 1, 8 and
#: 32 and at 32 with the dense layer's epilogue fused, BERT-base's qkv and
#: fc/out products at 32 x 512 tokens, BERT's Dense(2) head, a ragged one,
#: and a tile-path shape TMA cannot address (K % 8, N % 16 not 0)
INT8_CASES = [(1, 4096, 4096, False), (8, 4096, 4096, False),
              (32, 4096, 4096, False), (32, 4096, 4096, True),
              (16384, 768, 2304, False), (16384, 3072, 768, False),
              (32, 768, 2, False), (17, 100, 10, False),
              (300, 100, 130, False)]
#: weight-only and static int8 against their float counterparts on the
#: same weights: the same products in another order (weight-only: scale
#: after the sum against a dequantized weight; static: the card's int32
#: product against the CPU's, the same f32 rescale), so the probabilities
#: differ by rounding only
INT8_REL_TOL = 1e-4


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20):
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed between two events, so the host's launch cost stays
    out of the timed region (``time_ms`` of a wrapper that runs for a few
    microseconds reads the host's launch rate instead)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, iters=5, warmup=1) / iters


def attention_bound(q, k, mask, causal, flops_per_pair_per_d=4,
                    n_q_sized=2, n_kv_sized=2, n_row_f32=0):
    """Least time for the function on these inputs: the larger of the
    operations it needs (``flops_per_pair_per_d`` x D flops per visible
    (query, key) pair, counted from this mask) over the dtype's peak, and
    the bytes it must move over HBM bandwidth: ``n_q_sized`` tensors the
    size of q and ``n_kv_sized`` the size of k read or written once, the
    mask (if any) read once and ``n_row_f32`` f32 (B, H, Tq) rows (lse,
    delta).
    The forward (K2) is 4 flops per pair per D and reads q and writes out,
    reads k and v."""
    import torch
    b, h, t_q, d = q.shape
    t_kv = k.shape[2]
    keep = (torch.ones(b, t_kv, dtype=torch.bool, device=q.device)
            if mask is None else mask >= 1.0)
    vis = keep[:, None, :].expand(b, t_q, t_kv)
    if causal:
        tri = torch.ones(t_q, t_kv, dtype=torch.bool,
                         device=q.device).tril(t_kv - t_q)
        vis = vis & tri
    pairs = int(vis.sum().item()) * h
    flops = float(flops_per_pair_per_d) * d * pairs
    nbytes = ((q.numel() * n_q_sized + k.numel() * n_kv_sized)
              * q.element_size() + (0 if mask is None else mask.numel() * 4)
              + n_row_f32 * b * h * t_q * 4)
    dtype = str(q.dtype).replace("torch.", "")
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_inputs(b, h, tq, tk, d, dtype, g, empty_row=False,
                     lens_from=None):
    """Seeded q, k, v, dO on the card and a key-padding mask: valid
    lengths uniform in 64..tk, or the padding of ``lens_from`` ids."""
    import torch
    q, k, v, do = (torch.randn(b, h, t, d, generator=g).to("cuda", dtype)
                   for t in (tq, tk, tk, tq))
    if lens_from is not None:
        mask = torch.from_numpy((lens_from != 0).astype("float32")).cuda()
    else:
        lens = torch.randint(64, tk + 1, (b,), generator=g)
        mask = (torch.arange(tk)[None, :] < lens[:, None]).float().cuda()
    if empty_row:
        mask[0] = 0.0
    return q, k, v, do, mask


def kernel_phase():
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        flash_attention, flash_attention_reference)

    g = torch.Generator().manual_seed(0)
    cases = [  # name, dtype, tol, tq, tk, causal, empty_row
        ("bert_f32_padded", torch.float32, 1e-4, 512, 512, False, False),
        ("bert_bf16_padded", torch.bfloat16, 2e-2, 512, 512, False, False),
        ("bf16_causal", torch.bfloat16, 2e-2, 512, 512, True, False),
        ("f32_tq384_tk512", torch.float32, 1e-4, 384, 512, False, False),
        ("bf16_causal_tq512_tk384", torch.bfloat16, 2e-2, 512, 384, True,
         False),
        ("f32_fully_masked_row", torch.float32, 1e-4, 512, 512, False, True),
    ]
    rows = []
    for name, dtype, tol, tq, tk, causal, empty in cases:
        q, k, v, _, mask = attention_inputs(8, 12, tq, tk, 64, dtype, g,
                                            empty)
        out, lse = flash_attention(q, k, v, mask=mask, causal=causal,
                                   want_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_reference(q, k, v, mask, causal,
                                                 want_lse=True)
        err = (out.float() - ref.float()).abs().max().item()
        fin = torch.isfinite(ref_lse)
        check(torch.equal(fin, torch.isfinite(lse)), f"{name}: lse inf set")
        lse_err = (lse[fin] - ref_lse[fin]).abs().max().item()
        check(err <= tol, f"{name}: max |kernel - plain| {err} > {tol}")
        check(lse_err <= 1e-3, f"{name}: lse error {lse_err}")
        if empty:
            check(bool(torch.all(out[0] == 0)), f"{name}: empty row not 0")
        if causal and tq > tk:
            check(bool(torch.all(out[:, :, :tq - tk] == 0)),
                  f"{name}: rows before the diagonal not 0")
        row = {"case": name, "shape": [8, 12, tq, tk, 64],
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "max_abs_err": err, "tol": tol, "lse_err": lse_err}
        if name.startswith("bert_"):
            attn = (mask >= 1.0)[:, None, None, :]
            row["ms"] = time_ms(lambda: flash_attention(q, k, v, mask=mask))
            row["plain_ms"] = time_ms(
                lambda: flash_attention_reference(q, k, v, mask))
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=attn))
            row["bound_ms"], row["bound_by"] = attention_bound(q, k, mask,
                                                               False)
        rows.append(row)
        print(f"kernel case {json.dumps(row)}")
    return rows


class BertAdapter:
    """A served record is a (T,) int32 token row with pad id 0; the model
    takes BERT's four inputs."""

    def __init__(self, im):
        from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
            make_bert_inputs
        self.im = im
        self.make = make_bert_inputs
        self.dispatches = 0

    def inputs(self, ids):
        return self.make(ids, attention_mask=(ids != 0))

    def predict_async(self, ids, block=True):
        collect = self.im.predict_async(self.inputs(ids), block=block)
        self.dispatches += collect is not None
        return collect


def serving_records(vocab):
    """The served BERT records: 256 rows of 512 token ids from numpy seed
    0, valid lengths uniform in 64..512, pad id 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    ids = rng.integers(1, vocab, (N_RECORDS, SEQ)).astype(np.int32)
    lens = rng.integers(64, SEQ + 1, N_RECORDS)
    ids[np.arange(SEQ)[None, :] >= lens[:, None]] = 0
    return ids


def serve(make_server, records, counters):
    """``make_server(backend)`` builds a ``ClusterServing`` on a fresh
    ``LocalBackend`` that holds ``records``, pre-enqueued; it answers them.
    Returns the answers, the wall time from server start to the last
    answer, and the stopped server. ``counters`` are set to 0 just before
    the start."""
    import numpy as np

    from analytics_zoo_tpu_torch.serving import (InputQueue, LocalBackend,
                                                 OutputQueue)
    backend = LocalBackend()
    server = make_server(backend)
    q = InputQueue(backend)
    for i, rec in enumerate(records):
        q.enqueue(f"rec-{i}", rec)
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    server.start()
    out = OutputQueue(backend)
    try:
        got = np.stack([out.query(f"rec-{i}", timeout=300)
                        for i in range(len(records))])
        wall = time.perf_counter() - t0
    finally:
        server.stop()
    return got, wall, server


def serving_phase():
    import numpy as np

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import KERNEL
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import ClusterServing
    from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
        BERTClassifier

    conf = {"zoo.pallas.attention": True, "zoo.compute.dtype": "bfloat16",
            "zoo.seed": 0}
    init_zoo_context(conf=conf)
    t0 = time.perf_counter()
    model = BERTClassifier(num_classes=2, device="cuda").init_weights()
    im = InferenceModel(concurrent_num=2, device="cuda").from_keras(
        model, dtype="bfloat16")
    cfg = model.get_config()
    del model                       # the runtime holds its bf16 copy
    n_block = cfg["n_block"]
    print(f"serving: BERT-base built in {time.perf_counter() - t0:.1f}s "
          f"({json.dumps(cfg)})")
    ids = serving_records(cfg["vocab"])
    adapter = BertAdapter(im)
    adapter.predict_async(ids[:T_BATCH])()          # warm-up, not counted
    adapter.dispatches = 0
    got, wall, server = serve(
        lambda backend: ClusterServing(adapter, backend=backend,
                                       batch_size=T_BATCH), ids, [KERNEL])
    launches = KERNEL.launches
    chunks = adapter.dispatches
    print(f"serving: {N_RECORDS} records in {wall:.3f}s = "
          f"{N_RECORDS / wall:.1f} records/s; {chunks} dispatches, "
          f"{launches} flash_attention_fwd launches")
    check(server.served == N_RECORDS, f"served {server.served}")
    check(got.shape == (N_RECORDS, 2), f"result shape {got.shape}")
    check(bool(np.isfinite(got).all()), "non-finite probabilities")
    sums = np.abs(got.sum(-1) - 1.0).max()
    check(sums <= 1e-2, f"probabilities sum off 1 by {sums}")
    check(launches == n_block * chunks and chunks > 0,
          f"{launches} kernel launches for {chunks} chunks of "
          f"{n_block} blocks")

    # the port's oracle attention route on the same records and batches
    init_zoo_context(conf={**conf, "zoo.pallas.attention": False})
    KERNEL.reset()
    want = np.concatenate([im.predict(adapter.inputs(ids[i:i + T_BATCH]))
                           for i in range(0, N_RECORDS, T_BATCH)])
    check(KERNEL.launches == 0, "the oracle route launched the kernel")
    diff = float(np.abs(got - want).max())
    print(f"serving: max |flash - oracle| probability {diff:.3e} "
          f"(bf16 tolerance 2e-2)")
    check(diff <= 2e-2, f"flash vs oracle route {diff}")
    return {"records_per_s": N_RECORDS / wall, "wall_s": wall,
            "dispatches": chunks, "launches": launches,
            "flash_vs_oracle": diff}


def bf16_step(v):
    """One bf16 step (unit in the last place) at magnitude ``v``."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def int8_bound(m, k, n, dtype, bias=False):
    """K6's least time: x read, the int8 weights and f32 scales (and the
    f32 bias) read, the output written once, against 2 M K N operations at
    the peak of x's dtype."""
    name = str(dtype).replace("torch.", "")
    es = 4 if name == "float32" else 2
    t_bytes = (m * k * es + k * n + n * 4 * (2 if bias else 1)
               + m * n * es) / PEAK_BYTES_PER_S
    t_ops = 2.0 * m * n * k / PEAK_FLOPS[name]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def cycling(fn, copies):
    """A zero-argument call of ``fn(j)`` that walks ``j`` over
    ``range(copies)`` call by call."""
    state = [0]

    def call():
        j = state[0] % copies
        state[0] += 1
        return fn(j)
    return call


def int8_kernel_phase():
    """K6 against its plain version at the shapes of the two int8 paths:
    the scoring head at batch 1, 8 and 32 (K = N = 4096; at 32 also with
    the dense layer's bias and ReLU fused into the skinny kernel),
    BERT-base's qkv and fc/out products at 32 x 512 tokens, BERT's Dense(2)
    head, and a ragged case; f32 and bf16; in both modes, dequantize-first
    (what ``dense``, hence both paths, runs: the row's numbers) and the
    Pallas contract's scale-after (checked and timed beside). The fused
    case must also give the bits of the unfused kernel followed by the
    bias add and ReLU as torch ops. Weight sets above 8 MB rotate over
    enough copies to exceed the 50 MB L2, so each timed call reads its
    weights from HBM, as a batch-1 predict through the 4-layer head does.
    Then the padded ``torch._int_mm`` of the static path, bit for bit
    against the CPU's int32 product."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_ROUTES, LAST_LAUNCH, int8_matmul, int8_matmul_reference)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.core import \
        int8_product
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n, epi in INT8_CASES:
            name = f"{str(dtype)[6:]}_{m}x{k}x{n}" + ("_bias_relu" if epi
                                                       else "")
            g = torch.Generator().manual_seed(m + k + n)
            x = torch.randn(m, k, generator=g).to("cuda", dtype)
            copies = math.ceil(64e6 / (k * n)) if k * n > 8e6 else 1
            ws = [torch.randint(-127, 128, (k, n), generator=g,
                                dtype=torch.int8).cuda()
                  for _ in range(copies)]
            sc = (torch.rand(n, generator=g) * 0.09 + 0.01).cuda()
            bias = (torch.randn(n, generator=g) * 4.0).cuda() if epi \
                else None
            bits = torch.int32 if dtype == torch.float32 else torch.int16
            errs = {}
            before = {r: c.launches for r, c in KERNEL_INT8_ROUTES.items()}
            for first in (True, False):
                out = int8_matmul(x, ws[0], sc, first, bias=bias, relu=epi)
                again = int8_matmul(x, ws[0], sc, first, bias=bias,
                                    relu=epi)
                torch.cuda.synchronize()
                ref = int8_matmul_reference(x, ws[0], sc, first, bias=bias,
                                            relu=epi)
                top = max(ref.float().abs().max().item(),
                          int8_matmul_reference(x, ws[0], sc, first)
                          .float().abs().max().item())
                tol = (1e-4 * top if dtype == torch.float32
                       else bf16_step(top))
                err = (out.float() - ref.float()).abs().max().item()
                same = torch.equal(out.view(bits), again.view(bits))
                mode = "dequantize-first" if first else "scale-after"
                check(err <= tol, f"K6 {name} {mode}: max |kernel - plain| "
                      f"{err} > {tol}")
                check(same, f"K6 {name} {mode}: two runs differ")
                if epi:
                    plain = int8_matmul(x, ws[0], sc, first)
                    unfused = torch.relu(plain + bias.to(dtype))
                    check(torch.equal(out.view(bits), unfused.view(bits)),
                          f"K6 {name} {mode}: the fused epilogue differs "
                          f"from the product + bias + ReLU as torch ops")
                errs[first] = (err, tol, same)
            err, tol, same = errs[True]
            routes = {r for r, c in KERNEL_INT8_ROUTES.items()
                      if c.launches != before[r]}
            want_route = (
                "skinny" if m <= 32 else "fma" if dtype == torch.float32
                else "wgmma" if k % 8 == 0 and n % 16 == 0 else "mma")
            check(routes == {want_route}, f"K6 {name}: routes {routes}, not "
                  f"{want_route}")
            deq = [w.to(dtype) * sc.to(dtype) for w in ws]
            bound_ms, bound_by = int8_bound(m, k, n, dtype, epi)

            def fused(j):
                return int8_matmul(x, ws[j], sc, True, bias=bias, relu=epi)
            ms = time_ms(cycling(fused, copies))
            # the route and K slices the entry point reported for the
            # timed calls (1 slice off the skinny route)
            check(LAST_LAUNCH.route == want_route, f"K6 {name}: timed on "
                  f"{LAST_LAUNCH.route}, not {want_route}")
            row = {
                "case": name, "m": m, "k": k, "n": n, "route": want_route,
                "splits": LAST_LAUNCH.splits,
                "dtype": str(dtype)[6:], "epilogue": "bias+relu" if epi
                else None, "max_abs_err": err, "tol": tol,
                "same_bits_two_runs": same, "weight_copies": copies,
                "max_abs_err_scale_after": errs[False][0],
                "ms": ms, "device_ms": graph_ms(cycling(fused, copies)),
                "device_ms_scale_after": graph_ms(cycling(
                    lambda j: int8_matmul(x, ws[j], sc, bias=bias,
                                          relu=epi), copies)),
                "plain_ms": time_ms(cycling(
                    lambda j: int8_matmul_reference(x, ws[j], sc, True,
                                                    bias=bias, relu=epi),
                    copies)),
                "library_ms": time_ms(cycling(
                    lambda j: torch.matmul(x, deq[j]), copies)),
                "library_device_ms": graph_ms(cycling(
                    lambda j: torch.matmul(x, deq[j]), copies)),
                "bound_ms": bound_ms, "bound_by": bound_by}
            if epi:
                # the same product with the bias add and ReLU as the two
                # torch ops they were before the fusion
                row["device_ms_unfused"] = graph_ms(cycling(
                    lambda j: torch.relu(int8_matmul(x, ws[j], sc, True)
                                         + bias.to(dtype)), copies))
            rows[name] = row
            print(f"int8 kernel case {json.dumps(row)}")
            del x, ws, deq, out, again, ref
    for m in (1, T_BATCH):
        g = torch.Generator().manual_seed(m)
        xq = torch.randint(-127, 128, (m, HEAD_D), generator=g,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (HEAD_D, HEAD_D), generator=g,
                           dtype=torch.int8)
        xc, wc = xq.cuda(), wq.cuda()
        got = int8_product(xc, wc)
        equal = torch.equal(got.cpu(), torch._int_mm(xq, wq))
        check(equal, f"padded _int_mm at M={m} differs from the CPU's")
        row = {"case": f"int_mm_{m}x{HEAD_D}x{HEAD_D}", "bit_equal": equal,
               "ms": time_ms(lambda: int8_product(xc, wc)),
               "device_ms": graph_ms(lambda: int8_product(xc, wc))}
        rows[row["case"]] = row
        print(f"int8 kernel case {json.dumps(row)}")
    return rows


def dequantized_copy(net, dtype=None):
    """A float copy of a weight-only int8 network: each int8 ``W`` becomes
    ``W.float() * w_scale`` (every other leaf already is what the runtime
    computes with) — the model the int8 path is held against. With
    ``dtype``, ``W.to(dtype) * w_scale.to(dtype)`` instead: the weights the
    JAX weight-only predict forms (``dequantize_int8``), which K6's
    dequantize-first mode forms too."""
    import copy

    import torch
    net = copy.deepcopy(net)
    for mod in net.modules():
        if "w_scale" in mod._buffers:
            w = mod._buffers.pop("W")
            s = mod._buffers.pop("w_scale")
            deq = (w.float() * s if dtype is None
                   else w.to(dtype) * s.to(dtype))
            mod.register_parameter("W", torch.nn.Parameter(
                deq, requires_grad=False))
    return net


def rel_err(a, b):
    """Largest elementwise |a - b| / |b| (|b| floored at 1e-6)."""
    import numpy as np
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))


def device_kernels(fn):
    """The names of the device kernels one call of ``fn`` launches (after a
    warm-up call), from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    check(names, "the profiler recorded no device kernel")
    return [name.split("(")[0][-60:] for name in names]


class unfused_epilogue:
    """Within the block, ``dense`` runs K6 without its fused epilogue: the
    product, then the bias add and the ReLU as torch ops of their own, the
    port's weight-only predict before the fusion (the same numbers)."""

    def __enter__(self):
        import torch

        from analytics_zoo_tpu_torch.pipeline.api.keras.layers import core
        self.core, self.fused = core, core.int8_matmul

        def unfused(x, w, s, first=False, bias=None, relu=False):
            y = self.fused(x, w, s, first)
            if bias is not None:
                y = y + bias.to(y.dtype)
            return torch.relu(y) if relu else y
        core.int8_matmul = unfused
        return self

    def __exit__(self, *exc):
        self.core.int8_matmul = self.fused
        return False


def int8_head_phase():
    """Config A: the JAX bench's weight-streaming scoring head
    (``bench.py:797-815``) trained one epoch, then served three ways."""
    import copy

    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.feature.feature_set import FeatureSet
    from analytics_zoo_tpu_torch.observability import MetricsRegistry
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_MATMUL, KERNEL_INT8_ROUTES)
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import ClusterServing

    init_zoo_context(conf={"zoo.compute.dtype": "float32", "zoo.seed": 0})
    d = HEAD_D
    fm = Sequential([Dense(d, activation="relu", input_shape=(d,)),
                     Dense(d, activation="relu"),
                     Dense(d, activation="relu"),
                     Dense(HEAD_CLASSES, activation="softmax")],
                    device="cuda").init_weights()
    fm.compile(optimizer="adam", loss="scce", lr=1e-4)
    rng = np.random.default_rng(2)
    xf = rng.normal(size=(HEAD_ROWS, d)).astype(np.float32)
    yf = rng.integers(0, HEAD_CLASSES, HEAD_ROWS).astype(np.int32)
    hist = fm.fit(FeatureSet.array(xf, yf, seed=0), batch_size=64,
                  nb_epoch=1)
    check(bool(np.all(np.isfinite(hist["loss"]))), f"head loss {hist}")
    host = copy.deepcopy(fm).to("cpu")
    host.device = torch.device("cpu")

    def resident(build):
        """The runtime ``build()`` makes and the device bytes it holds."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        im = build()
        torch.cuda.synchronize()
        return im, torch.cuda.memory_allocated() - before

    fp, fp_bytes = resident(
        lambda: InferenceModel(device="cuda").from_keras(host))
    w8, w8_bytes = resident(lambda: InferenceModel(device="cuda").from_keras(
        host, quantize="int8"))
    st, st_bytes = resident(lambda: InferenceModel(device="cuda").from_keras(
        host, quantize="int8", calibrate=xf[:8]))
    print(f"int8 head: resident weight bytes fp32 {fp_bytes}, weight-only "
          f"int8 {w8_bytes} ({w8_bytes / fp_bytes:.4f}x), static int8 "
          f"{st_bytes} ({st_bytes / fp_bytes:.4f}x)")
    check(w8_bytes <= 0.3 * fp_bytes and st_bytes <= 0.3 * fp_bytes,
          f"int8 resident bytes {w8_bytes}, {st_bytes} vs fp32 {fp_bytes}")

    deq = InferenceModel(device="cuda").from_keras(dequantized_copy(w8._model))
    p_fp, p_w8, p_st = fp.predict(xf), w8.predict(xf), st.predict(xf)
    w8_rel = rel_err(p_w8, deq.predict(xf))
    cpu_static = InferenceModel(device="cpu").from_keras(
        host, quantize="int8", calibrate=xf[:8])
    st_rel = rel_err(st.predict(xf[:8]), cpu_static.predict(xf[:8]))
    print(f"int8 head: weight-only vs fp32 on the dequantized weights "
          f"{w8_rel:.3e}, static vs its plain CPU route (8 rows) "
          f"{st_rel:.3e} (relative, limit {INT8_REL_TOL})")
    check(w8_rel <= INT8_REL_TOL, f"weight-only int8 vs dequantized fp32 "
          f"{w8_rel}")
    check(st_rel <= INT8_REL_TOL, f"static int8 vs its CPU route {st_rel}")
    top1 = {mode: float((p.argmax(1) == p_fp.argmax(1)).mean() * 100.0)
            for mode, p in (("int8_weight_only", p_w8),
                            ("int8_static", p_st))}

    x1 = torch.from_numpy(xf[:1]).cuda()
    b1 = {mode: graph_ms(lambda im=im: im._forward([x1]))
          for mode, im in (("fp32", fp), ("int8_weight_only", w8),
                           ("int8_static", st))}
    launches_b1 = {"int8_weight_only": device_kernels(
        lambda: w8._forward([x1]))}
    with unfused_epilogue():
        # the weight-only predict as it ran before the epilogue fusion:
        # each bias add and ReLU a torch op of its own after K6
        b1["int8_weight_only_unfused"] = graph_ms(
            lambda: w8._forward([x1]))
        launches_b1["int8_weight_only_unfused"] = device_kernels(
            lambda: w8._forward([x1]))
    speedup = {mode: b1["fp32"] / b1[mode]
               for mode in ("int8_weight_only", "int8_static",
                            "int8_weight_only_unfused")}
    print(f"int8 head: top-1 agreement with fp32 over {HEAD_ROWS} rows "
          f"{json.dumps(top1)} (%); batch-1 device ms {json.dumps(b1)}; "
          f"fp32 / int8 {json.dumps(speedup)}")
    print(f"int8 head: device kernels of one batch-1 weight-only _forward, "
          f"fused epilogue {len(launches_b1['int8_weight_only'])}, before "
          f"the fusion {len(launches_b1['int8_weight_only_unfused'])}: "
          f"{json.dumps(launches_b1)}")
    check(len(launches_b1["int8_weight_only"])
          < len(launches_b1["int8_weight_only_unfused"]),
          f"the fused epilogue launched no fewer kernels: {launches_b1}")

    registry = MetricsRegistry()

    def make_server(backend):
        server = ClusterServing(fm, backend=backend, batch_size=T_BATCH,
                                dtype="int8", registry=registry)
        check(isinstance(server.model, InferenceModel)
              and server.model._quantize == "int8",
              "ClusterServing did not wrap the head on the int8 path")
        server.model.predict(xf[:T_BATCH])          # warm-up, not counted
        return server

    got, wall, server = serve(make_server, xf, [KERNEL_INT8_MATMUL,
                                                *KERNEL_INT8_ROUTES.values()])
    launches = KERNEL_INT8_MATMUL.launches
    routes = {name: c.launches for name, c in KERNEL_INT8_ROUTES.items()}
    batches = int(registry.snapshot()["zoo_serving_batches_total"]["value"])
    served_rel = rel_err(got, p_w8)
    print(f"int8 head: ClusterServing(dtype='int8') answered {HEAD_ROWS} "
          f"records in {wall:.3f}s = {HEAD_ROWS / wall:.1f} records/s; "
          f"{batches} dispatches, {launches} int8_matmul launches; vs "
          f"predict {served_rel:.3e}")
    check(server.served == HEAD_ROWS, f"served {server.served}")
    check(got.shape == (HEAD_ROWS, HEAD_CLASSES), f"shape {got.shape}")
    check(launches == 4 * batches and batches > 0,
          f"{launches} K6 launches for {batches} dispatches of 4 layers")
    check(routes["skinny"] == launches, f"K6 routes {routes}: a dispatch of "
          f"at most {T_BATCH} rows off the skinny kernel")
    check(served_rel <= INT8_REL_TOL, f"served vs predict {served_rel}")
    return {"loss": hist["loss"], "resident_bytes": {
        "fp32": fp_bytes, "int8_weight_only": w8_bytes,
        "int8_static": st_bytes},
        "weight_only_vs_dequantized": w8_rel, "static_vs_cpu": st_rel,
        "top1_agreement_pct": top1, "b1_device_ms": b1,
        "b1_speedup": speedup, "b1_device_kernels": {
            mode: len(names) for mode, names in launches_b1.items()},
        "records_per_s": HEAD_ROWS / wall,
        "wall_s": wall, "dispatches": batches, "launches": launches,
        "launches_by_route": routes}


def int8_serving_phase(bf16_records_per_s):
    """Config B: BERT-base served through ClusterServing on the weight-only
    int8 InferenceModel that ``_wrap_model`` builds for ``dtype="int8"``,
    behind the serving phase's adapter and on its records."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import KERNEL
    from analytics_zoo_tpu_torch.ops.pallas.quantized import (
        KERNEL_INT8_MATMUL, KERNEL_INT8_ROUTES)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.self_attention \
        import DenseParams
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    from analytics_zoo_tpu_torch.serving import ClusterServing
    from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
        BERTClassifier

    init_zoo_context(conf={"zoo.pallas.attention": True,
                           "zoo.compute.dtype": "bfloat16", "zoo.seed": 0})
    t0 = time.perf_counter()
    model = BERTClassifier(num_classes=2, device="cuda").init_weights()
    cfg = model.get_config()
    im = ClusterServing._wrap_model(model, "int8")
    del model
    check(isinstance(im, InferenceModel) and im._quantize == "int8"
          and im.concurrent_num == 2, "_wrap_model: not the int8 runtime")
    mats = [mod.W for mod in im._model.modules()
            if isinstance(mod, (Dense, DenseParams))]
    int8_weights = sum(w.numel() for w in mats if w.dtype == torch.int8)
    check(all(w.dtype == torch.int8 for w in mats),
          "a BERT matmul weight is not int8")
    print(f"int8 serving: BERT-base quantized in "
          f"{time.perf_counter() - t0:.1f}s; {len(mats)} matmul weights, "
          f"{int8_weights} int8 bytes on the device")
    check(int8_weights >= 85e6, f"{int8_weights} int8 matmul weights")
    deq = InferenceModel(concurrent_num=2, device="cuda").from_keras(
        dequantized_copy(im._model))
    deq_jax = InferenceModel(concurrent_num=2, device="cuda").from_keras(
        dequantized_copy(im._model, torch.bfloat16))
    n_block = cfg["n_block"]
    ids = serving_records(cfg["vocab"])
    adapter = BertAdapter(im)
    adapter.predict_async(ids[:T_BATCH])()          # warm-up, not counted
    adapter.dispatches = 0
    got, wall, server = serve(
        lambda backend: ClusterServing(adapter, backend=backend,
                                       batch_size=T_BATCH), ids,
        [KERNEL, KERNEL_INT8_MATMUL, *KERNEL_INT8_ROUTES.values()])
    k6, k2, chunks = KERNEL_INT8_MATMUL.launches, KERNEL.launches, \
        adapter.dispatches
    routes = {name: c.launches for name, c in KERNEL_INT8_ROUTES.items()}
    print(f"int8 serving: {N_RECORDS} records in {wall:.3f}s = "
          f"{N_RECORDS / wall:.1f} records/s (bf16 serving in this run: "
          f"{bf16_records_per_s:.1f}); {chunks} dispatches, {k6} "
          f"int8_matmul ({json.dumps(routes)} by route) and {k2} "
          f"flash_attention_fwd launches")
    check(server.served == N_RECORDS, f"served {server.served}")
    check(got.shape == (N_RECORDS, 2), f"result shape {got.shape}")
    check(bool(np.isfinite(got).all()), "non-finite probabilities")
    sums = float(np.abs(got.sum(-1) - 1.0).max())
    check(sums <= 1e-2, f"probabilities sum off 1 by {sums}")
    check(chunks > 0 and k6 == (4 * n_block + 2) * chunks,
          f"{k6} K6 launches for {chunks} dispatches")
    check(k2 == n_block * chunks, f"{k2} K2 launches for {chunks} dispatches")
    # every product over the 32 x 512 tokens (M > 32) on the wgmma tile
    # path; the pooler and the Dense(2) head (M = 32) on the skinny kernel
    check(routes == {"wgmma": 4 * n_block * chunks, "mma": 0,
                     "skinny": 2 * chunks, "fma": 0},
          f"K6 routes {routes} for {chunks} dispatches")
    want, want_jax = (
        np.concatenate([m.predict(adapter.inputs(ids[i:i + T_BATCH]))
                        for i in range(0, N_RECORDS, T_BATCH)])
        for m in (deq, deq_jax))
    diff = float(np.abs(got - want).max())
    diff_jax = float(np.abs(got - want_jax).max())
    print(f"int8 serving: max |int8 - bf16 on the dequantized weights| "
          f"probability {diff:.3e} (tolerance 2e-2); on the weights the JAX "
          f"predict forms, bf16(q) * bf16(s) in bf16: {diff_jax:.3e}")
    check(diff <= 2e-2, f"int8 vs dequantized bf16 {diff}")
    check(diff_jax <= 2e-2, f"int8 vs the JAX predict's weights {diff_jax}")
    return {"records_per_s": N_RECORDS / wall, "wall_s": wall,
            "bf16_records_per_s": bf16_records_per_s, "dispatches": chunks,
            "launches": k6, "launches_by_route": routes,
            "flash_launches": k2, "int8_bytes": int8_weights,
            "vs_dequantized": diff, "vs_jax_predict_weights": diff_jax}


def int8_kernel_row(int8_rows, launches, launches_by_route):
    """K6's row of the kernels line: at BERT's qkv shape (config B's
    largest product, the wgmma tile path), with the scoring head's batch-1
    and batch-32 shapes (config A's f32, the skinny route; bf16 too)
    beside."""
    main = int8_rows["bfloat16_16384x768x2304"]
    row = {"name": "int8_matmul", "route": "cuda",
           "source": "analytics_zoo_tpu_torch/csrc/quantized.cu",
           "replaces": "analytics_zoo_tpu/ops/pallas/quantized.py:63",
           "launches": sum(launches.values()),
           "launches_by_path": launches,
           "launches_by_route": launches_by_route,
           "max_abs_err": main["max_abs_err"], "ms": main["ms"],
           "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
           "bound_by": main["bound_by"], "library_ms": main["library_ms"],
           "library_by": "torch.matmul on the dequantized weight",
           "device_ms": main["device_ms"],
           "library_device_ms": main["library_device_ms"]}
    for tag, case in (("head_b1", "float32_1x4096x4096"),
                      ("head_b32", "float32_32x4096x4096"),
                      ("head_b1_bf16", "bfloat16_1x4096x4096"),
                      ("head_b32_bf16", "bfloat16_32x4096x4096")):
        for key in ("ms", "device_ms", "plain_ms", "library_ms",
                    "library_device_ms", "bound_ms", "splits"):
            row[f"{key}_{tag}"] = int8_rows[case][key]
    return row


def same_bits(a, b):
    """Same bits, bf16 or f32."""
    import torch
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.view(view), b.view(view))


def bwd_kernel_phase():
    """K3a and K3b against their plain versions on one forward's output and
    lse, and against themselves: the same bits on a second run.
    Tolerances relative to the case's largest gradient: f32 1e-4
    (summation order), bf16 2e-2 (one bf16 step where the two f32 sums
    fall on either side of a rounding boundary)."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        bwd_dkv, bwd_dkv_reference, bwd_dq, bwd_dq_reference,
        flash_attention)

    g = torch.Generator().manual_seed(2)
    cases = [  # name, dtype, tol, tq, tk, causal, empty_row
        ("f32_padded", torch.float32, 1e-4, 512, 512, False, False),
        ("bf16_padded", torch.bfloat16, 2e-2, 512, 512, False, False),
        ("f32_causal", torch.float32, 1e-4, 512, 512, True, False),
        ("bf16_causal", torch.bfloat16, 2e-2, 512, 512, True, False),
        ("f32_tq384_tk512", torch.float32, 1e-4, 384, 512, False, False),
        ("bf16_causal_tq512_tk384", torch.bfloat16, 2e-2, 512, 384, True,
         False),
        ("f32_fully_masked_row", torch.float32, 1e-4, 512, 512, False, True),
        ("bf16_fully_masked_row", torch.bfloat16, 2e-2, 512, 512, True,
         True),
    ]
    rows = []
    for name, dtype, tol, tq, tk, causal, empty in cases:
        q, k, v, do, mask = attention_inputs(8, 12, tq, tk, 64, dtype, g,
                                             empty)
        out, lse = flash_attention(q, k, v, mask=mask, causal=causal,
                                   want_lse=True)
        delta = (do.float() * out.float()).sum(-1)
        dq = bwd_dq(q, k, v, mask, lse, delta, do, causal)
        dk, dv = bwd_dkv(q, k, v, mask, lse, delta, do, causal)
        again = (bwd_dq(q, k, v, mask, lse, delta, do, causal),
                 *bwd_dkv(q, k, v, mask, lse, delta, do, causal))
        torch.cuda.synchronize()
        want = (bwd_dq_reference(q, k, v, mask, lse, delta, do, causal),
                *bwd_dkv_reference(q, k, v, mask, lse, delta, do, causal))
        row = {"case": name, "shape": [8, 12, tq, tk, 64],
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "tol_rel": tol}
        for key, got, ref, got2 in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                       want, again):
            check(same_bits(got, got2), f"{name}: {key} not the same bits "
                  f"on a second run")
            check(bool(torch.isfinite(got).all()), f"{name}: {key} not "
                  f"finite")
            err = (got.float() - ref.float()).abs().max().item()
            top = ref.float().abs().max().item()
            row[f"{key}_max_abs_err"] = err
            row[f"{key}_max_abs"] = top
            check(err <= tol * top, f"{name}: {key} max |kernel - plain| "
                  f"{err} > {tol} x {top}")
            if empty:
                check(bool(torch.all(got[0] == 0)),
                      f"{name}: {key} of the empty batch row not 0")
        rows.append(row)
        print(f"bwd kernel case {json.dumps(row)}")
    return rows


def training_data(n: int):
    """``n`` seeded BERT input rows (valid lengths uniform in 64..512,
    pad id 0) and binary labels: ``(x, y, ids)``."""
    import numpy as np

    from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
        make_bert_inputs
    rng = np.random.default_rng(0)
    ids = rng.integers(1, TRAIN_CFG["vocab"], (n, SEQ)).astype(np.int32)
    lens = rng.integers(64, SEQ + 1, n)
    ids[np.arange(SEQ)[None, :] >= lens[:, None]] = 0
    y = rng.integers(0, 2, n).astype(np.int32)
    return make_bert_inputs(ids, attention_mask=(ids != 0)), y, ids


def step_breakdown(model, xb, yb):
    """Separate device timings of one training step's parts on one batch:
    the forward with autograd recording, forward + backward, and the
    AdamW update with its parameter add."""
    import torch

    from analytics_zoo_tpu_torch.pipeline.api.keras.optimizers import (
        apply_updates, scalar_rows)
    from analytics_zoo_tpu_torch.pipeline.api.keras.training import \
        step_generator
    loop = model._loop
    params = loop._params()
    row = scalar_rows(loop.optimizer, model.opt_state["count"], 1, "cuda")[0]

    def forward():
        return loop.loss(yb, model(xb, training=True,
                                   generator=step_generator(0, 0)))

    def forward_backward():
        model.zero_grad(set_to_none=True)
        forward().backward()

    grads = {n: torch.full_like(p, 1e-3) for n, p in params.items()}

    def update():
        upd, _ = loop.optimizer.update(dict(grads), model.opt_state["state"],
                                       params, row)
        apply_updates(params, upd)

    out = {"forward": time_ms(forward, iters=5, warmup=1),
           "forward_backward": time_ms(forward_backward, iters=5, warmup=1),
           "optimizer": time_ms(update, iters=5, warmup=1)}
    model.zero_grad(set_to_none=True)
    return out


def training_phase():
    """compile/fit of the seq-512 fine-tune configuration; returns the
    summary and the token ids of one batch (its padding is the kernels'
    main-path padding)."""
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        KERNEL, KERNEL_BWD_DKV, KERNEL_BWD_DQ)
    from analytics_zoo_tpu_torch.pipeline.api.keras.training import (
        _to_device, step_generator)
    from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
        BERTClassifier

    conf = {"zoo.pallas.attention": True, "zoo.compute.dtype": "bfloat16",
            "zoo.seed": 0}
    init_zoo_context(conf=conf)
    t0 = time.perf_counter()
    model = BERTClassifier(**TRAIN_CFG, device="cuda").init_weights()
    model.compile(optimizer="adamw", loss="scce", metrics=["accuracy"],
                  lr=2e-5)
    print(f"training: BERT-base built in {time.perf_counter() - t0:.1f}s "
          f"({json.dumps(model.get_config())}), bf16 compute, f32 params, "
          f"AdamW lr 2e-5")
    x, y, ids = training_data(N_RECORDS)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}

    t0 = time.perf_counter()
    model.fit(x, y, batch_size=T_BATCH, nb_epoch=1)     # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0

    kernels = (KERNEL, KERNEL_BWD_DQ, KERNEL_BWD_DKV)
    for c in kernels:
        c.reset()
    records = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = model.fit(x, y, batch_size=T_BATCH, nb_epoch=1,
                     callbacks=[records.append])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [c.launches for c in kernels]
    steps = N_RECORDS // T_BATCH
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss = hist["loss"][0]
    summary = {"steps": steps, "batch": T_BATCH, "epoch_loss": loss,
               "samples_per_s": records[0]["throughput"],
               "ms_per_step": 1e3 * wall / steps, "wall_s": wall,
               "warmup_epoch_s": warm, "peak_memory_gb": peak_gb,
               "launches": dict(zip(("flash_attention_fwd",
                                     "flash_attention_bwd_dq",
                                     "flash_attention_bwd_dkv"), launches))}
    print(f"training: {steps} steps of {T_BATCH} in {wall:.3f}s = "
          f"{summary['samples_per_s']:.2f} samples/s, "
          f"{summary['ms_per_step']:.1f} ms/step (warm-up epoch "
          f"{warm:.1f}s, peak {peak_gb:.1f} GB); epoch loss {loss:.4f}; "
          f"launches K2/K3a/K3b {launches}")
    check(math.isfinite(loss), f"epoch loss {loss}")
    want = TRAIN_CFG["n_block"] * steps
    check(launches == [want] * 3, f"launches {launches}, want {want} each "
          f"(n_block x steps)")
    unmoved = [n for n, p in model.named_parameters()
               if not bool(torch.isfinite(p).all())
               or torch.equal(p.detach(), start[n])]
    check(not unmoved, f"parameters not moved or not finite: {unmoved}")
    del start

    xb = _to_device([a[:T_BATCH] for a in x], torch.device("cuda"))
    yb = _to_device(y[:T_BATCH], torch.device("cuda"))
    summary["step_breakdown_ms"] = step_breakdown(model, xb, yb)
    print(f"training: step parts (separate timings) "
          f"{json.dumps(summary['step_breakdown_ms'])}")

    # one step's gradients, flash route against the oracle route
    grads = {}
    for route in (True, False):
        init_zoo_context(conf={**conf, "zoo.pallas.attention": route})
        model.zero_grad(set_to_none=True)
        out = model(xb, training=True, generator=step_generator(0, 0))
        model._loop.loss(yb, out).backward()
        grads[route] = {n: p.grad.detach().clone()
                        for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    rel = {n: ((grads[True][n] - grads[False][n]).norm()
               / grads[False][n].norm().clamp_min(1e-30)).item()
           for n in grads[True]}
    worst = max(rel, key=rel.get)
    summary["grad_rel_err_max"] = rel[worst]
    summary["grad_rel_err_leaf"] = worst
    print(f"training: flash vs oracle route, one step's gradients: largest "
          f"per-leaf relative error {rel[worst]:.3e} ({worst}; bf16 "
          f"tolerance {GRAD_REL_TOL})")
    check(rel[worst] <= GRAD_REL_TOL, f"flash vs oracle gradients: {worst} "
          f"{rel[worst]}")
    init_zoo_context(conf=conf)
    return summary, ids[:T_BATCH]


def main_path_kernel_rows(ids, launches):
    """Every kernel at the shape the training path gave it: one batch of
    32 BERT-base records in bf16 with this run's key padding (B=32, H=12,
    T=512, D=64)."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        bwd_dkv, bwd_dkv_reference, bwd_dq, bwd_dq_reference,
        flash_attention, flash_attention_reference)
    g = torch.Generator().manual_seed(1)
    q, k, v, do, mask = attention_inputs(T_BATCH, 12, SEQ, SEQ, 64,
                                         torch.bfloat16, g, lens_from=ids)
    out, lse = flash_attention(q, k, v, mask=mask, want_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    dq = bwd_dq(q, k, v, mask, lse, delta, do)
    dk, dv = bwd_dkv(q, k, v, mask, lse, delta, do)
    again = (bwd_dq(q, k, v, mask, lse, delta, do),
             *bwd_dkv(q, k, v, mask, lse, delta, do))
    torch.cuda.synchronize()
    for key, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
        check(same_bits(a, b), f"main-path shape: {key} not the same bits "
              f"on a second run")
    del again
    ref_out, _ = flash_attention_reference(q, k, v, mask, want_lse=True)
    ref_dq = bwd_dq_reference(q, k, v, mask, lse, delta, do)
    ref_dk, ref_dv = bwd_dkv_reference(q, k, v, mask, lse, delta, do)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    fwd_err = err(out, ref_out)
    dq_err = err(dq, ref_dq)
    dkv_err = max(err(dk, ref_dk), err(dv, ref_dv))
    check(fwd_err <= 2e-2, f"main-path shape: K2 vs plain {fwd_err}")
    for name, e, ref in (("K3a", dq_err, ref_dq),
                         ("K3b", dkv_err, torch.stack([ref_dk, ref_dv]))):
        top = ref.float().abs().max().item()
        check(e <= 2e-2 * top, f"main-path shape: {name} vs plain {e} > "
              f"2e-2 x {top}")

    attn = (mask >= 1.0)[:, None, None, :]
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=attn)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        sdpa_out, (qs, ks, vs), do, retain_graph=True))
    timings = {
        "flash_attention_fwd": (
            time_ms(lambda: flash_attention(q, k, v, mask=mask,
                                            want_lse=True)),
            time_ms(lambda: flash_attention_reference(q, k, v, mask,
                                                      want_lse=True)),
            time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn)),
            attention_bound(q, k, mask, False, n_row_f32=1)),
        "flash_attention_bwd_dq": (
            time_ms(lambda: bwd_dq(q, k, v, mask, lse, delta, do)),
            time_ms(lambda: bwd_dq_reference(q, k, v, mask, lse, delta, do)),
            sdpa_bwd_ms,
            # reads q, dO, k, v; writes dq; reads lse and delta
            attention_bound(q, k, mask, False, 6, n_q_sized=3,
                            n_kv_sized=2, n_row_f32=2)),
        "flash_attention_bwd_dkv": (
            time_ms(lambda: bwd_dkv(q, k, v, mask, lse, delta, do)),
            time_ms(lambda: bwd_dkv_reference(q, k, v, mask, lse, delta,
                                              do)),
            sdpa_bwd_ms,
            # reads q, dO, k, v; writes dk, dv; reads lse and delta
            attention_bound(q, k, mask, False, 8, n_q_sized=2,
                            n_kv_sized=4, n_row_f32=2)),
    }
    errors = {"flash_attention_fwd": fwd_err, "flash_attention_bwd_dq": dq_err,
              "flash_attention_bwd_dkv": dkv_err}
    src = "analytics_zoo_tpu_torch/csrc/"
    meta = {
        "flash_attention_fwd": (src + "flash_attention_fwd.cu",
                                "analytics_zoo_tpu/ops/pallas/"
                                "flash_attention.py:385"),
        "flash_attention_bwd_dq": (src + "flash_attention_bwd.cu",
                                   "analytics_zoo_tpu/ops/pallas/"
                                   "flash_attention.py:524"),
        "flash_attention_bwd_dkv": (src + "flash_attention_bwd.cu",
                                    "analytics_zoo_tpu/ops/pallas/"
                                    "flash_attention.py:544"),
    }
    rows = []
    for name, (ms, plain_ms, library_ms, (bound_ms, bound_by)) \
            in timings.items():
        rows.append({"name": name, "route": "cuda", "source": meta[name][0],
                     "replaces": meta[name][1],
                     "launches": launches[name],
                     "max_abs_err": errors[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms})
    return rows


#: CE kernels against their plain versions (tests/test_torch_port_cuda.py):
#: f32 only summation order differs; in bf16 a logit that the two f32
#: sums leave on either side of a rounding boundary moves by one bf16 step
#: (2^-8 relative), so lse 2e-2, the label logit one step of its size and
#: the gradients 2e-2 of the case's largest
CE_TOL = {"float32": dict(lse=1e-4, ll_rel=1e-5, grad=1e-4),
          "bfloat16": dict(lse=2e-2, ll_rel=2.0 ** -7, grad=2e-2)}


def bit_equal(a, b):
    """Same bits, NaN payloads included."""
    import torch
    return (a is None and b is None) or torch.equal(a.view(torch.int32),
                                                    b.view(torch.int32))


def ce_kernel_phase():
    """K4, K5a and K5b against their plain versions at N=4100, H=512."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import (
        LAST_DH_LAUNCH, LAST_DW_LAUNCH, LAST_FWD_LAUNCH, fused_ce_backward,
        fused_ce_backward_reference, fused_ce_forward,
        fused_ce_forward_reference)
    n, hidden = 4100, 512
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # name, dtype, V, bias, over-range labels, one bias of 100
        ("f32_v8192", f32, 8192, True, False, False),
        ("bf16_v8192", bf16, 8192, True, False, False),
        ("bf16_v8000_ragged_vocab", bf16, 8000, True, False, False),
        ("bf16_no_bias", bf16, 8192, False, False, False),
        ("f32_over_range", f32, 8000, True, True, False),
        ("bf16_over_range", bf16, 8192, True, True, False),
        ("bf16_bias100_ragged_rows", bf16, 8000, True, False, True),
    ]
    g = torch.Generator().manual_seed(4)
    rows = []
    for name, dtype, v, bias, over, big in cases:
        tol = CE_TOL[str(dtype).replace("torch.", "")]
        h = torch.randn(n, hidden, generator=g).to("cuda", dtype)
        w = (torch.randn(hidden, v, generator=g) * hidden ** -0.5).to(
            "cuda", dtype)
        b = (torch.randn(v, generator=g) * 0.5).cuda() if bias else None
        labels = torch.randint(0, v, (n,), generator=g,
                               dtype=torch.int32).cuda()
        labels[::3] = -1                                # masked rows
        bad = torch.zeros(n, dtype=torch.bool, device="cuda")
        if over:
            bad[[7, 2000, 4099]] = True
            labels[bad] = torch.tensor([v, v + 1, 10 ** 6],
                                       dtype=torch.int32, device="cuda")
        if big:
            b[3] = 100.0
        lse, ll = fused_ce_forward(h, w, b, labels)
        torch.cuda.synchronize()
        fwd_route = LAST_FWD_LAUNCH.route
        ref_lse, ref_ll = fused_ce_forward_reference(h, w, b, labels)
        lse_err = (lse - ref_lse).abs().max().item()
        ll_err = ((ll - ref_ll).abs() / ref_ll.abs().clamp_min(1.0)
                  ).max().item()
        check(lse_err <= tol["lse"], f"{name}: K4 lse {lse_err}")
        check(ll_err <= tol["ll_rel"], f"{name}: K4 label logit {ll_err}")
        valid = labels >= 0
        scale = torch.where(valid, 1.0 / valid.sum().float(),
                            torch.zeros((), device="cuda"))
        scale = torch.where(labels >= v, torch.full((), float("nan"),
                                                    device="cuda"), scale)
        runs = []
        for _ in range(2):
            runs.append(fused_ce_backward(h, w, b, labels, lse, scale))
            torch.cuda.synchronize()
        dh, dw, db = runs[0]
        want_route = "wgmma" if dtype == bf16 else "fma"
        routes = {"fused_ce_fwd": fwd_route,
                  "fused_ce_bwd_dh": LAST_DH_LAUNCH.route,
                  "fused_ce_bwd_dw": LAST_DW_LAUNCH.route}
        for kernel, route in routes.items():
            check(route == want_route, f"{name}: {kernel} took {route}, "
                  f"want {want_route}")
        dh_same = bit_equal(runs[0][0].float(), runs[1][0].float())
        check(dh_same, f"{name}: K5a dh differs between two runs")
        same = bit_equal(runs[0][1], runs[1][1]) and bit_equal(runs[0][2],
                                                               runs[1][2])
        check(same, f"{name}: K5b dW/db differ between two runs")
        ref = fused_ce_backward_reference(h, w, b, labels, lse, scale)
        check(bool(torch.all(dh[labels < 0] == 0)),
              f"{name}: masked rows' dh not exactly 0")
        row = {"case": name, "n": n, "hidden": hidden, "vocab": v,
               "dtype": str(dtype).replace("torch.", ""), "bias": bias,
               "lse_err": lse_err, "ll_rel_err": ll_err,
               "tol": tol, "dw_db_bit_identical": same,
               "routes": routes, "dh_bit_identical": dh_same}
        if over:
            check(bool(torch.isnan(dh[bad]).all()
                       and torch.isfinite(dh[~bad]).all()),
                  f"{name}: NaN rows of dh")
            check(bool(torch.isnan(dw).all()), f"{name}: dW not all NaN")
            row["nan_rows"] = int(torch.isnan(dh).any(dim=1).sum())
            pairs = (("dh", dh[~bad], ref[0][~bad]),)
        else:
            pairs = (("dh", dh, ref[0]), ("dw", dw, ref[1]),
                     ("db", db, ref[2]))
        for key, got, want in pairs:
            if want is None:
                check(got is None, f"{name}: {key} without a bias")
                continue
            check(bool(torch.isfinite(got).all()), f"{name}: {key} not "
                  f"finite")
            err = (got.float() - want.float()).abs().max().item()
            top = want.float().abs().max().item()
            row[f"{key}_max_abs_err"] = err
            row[f"{key}_max_abs"] = top
            check(err <= tol["grad"] * top, f"{name}: {key} {err} > "
                  f"{tol['grad']} x {top}")
        rows.append(row)
        print(f"ce kernel case {json.dumps(row)}")
    return rows


def lm_data(n: int = LM_SEQS):
    """The bench's data: ``n`` sequences of 4096 ids from numpy seed 7 and
    the learnable map y = (7x + 13) mod V."""
    import numpy as np
    rng = np.random.default_rng(7)
    x = rng.integers(0, LM_VOCAB, (n, LM_SEQ)).astype(np.int32)
    return x, ((7 * x + 13) % LM_VOCAB).astype(np.int32)


def lm_phase():
    """compile/fit of the 4k causal LM with every flag at auto; returns
    the summary and the labels of one batch."""
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import (
        KERNEL_CE_BWD_DH, KERNEL_CE_BWD_DH_ROUTES, KERNEL_CE_BWD_DW,
        KERNEL_CE_BWD_DW_ROUTES, KERNEL_CE_FWD, KERNEL_CE_FWD_ROUTES)
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        KERNEL, KERNEL_BWD_DKV, KERNEL_BWD_DQ)
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.fused_loss import \
        resolve_fused_loss
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense, TransformerLayer)
    from analytics_zoo_tpu_torch.pipeline.api.keras.training import (
        _to_device, step_generator)

    init_zoo_context(conf={"zoo.compute.dtype": "bfloat16", "zoo.seed": 0,
                           "zoo.pallas.attention": "auto",
                           "zoo.pallas.cross_entropy": "auto",
                           "zoo.train.fused_ce": "auto"})
    t0 = time.perf_counter()
    model = Sequential([TransformerLayer(**LM_CFG, input_shape=(LM_SEQ,)),
                        Dense(LM_VOCAB)]).init_weights()
    model.compile(optimizer="adam", loss="scce_with_logits", lr=3e-4)
    print(f"lm: built in {time.perf_counter() - t0:.1f}s "
          f"({json.dumps(LM_CFG)}, head Dense({LM_VOCAB})), bf16 compute, "
          f"f32 params, Adam lr 3e-4, batch {LM_BATCH}")
    x, y = lm_data()
    records = []
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=LM_BATCH, nb_epoch=2,
              callbacks=[records.append])                 # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0

    kernels = (KERNEL_CE_FWD, KERNEL_CE_BWD_DH, KERNEL_CE_BWD_DW, KERNEL,
               KERNEL_BWD_DQ, KERNEL_BWD_DKV)
    by_route = {"fused_ce_fwd": KERNEL_CE_FWD_ROUTES,
                "fused_ce_bwd_dh": KERNEL_CE_BWD_DH_ROUTES,
                "fused_ce_bwd_dw": KERNEL_CE_BWD_DW_ROUTES}
    for c in kernels + tuple(c for routes in by_route.values()
                             for c in routes.values()):
        c.reset()
    timed = []
    t0 = time.perf_counter()
    model.fit(x, y, batch_size=LM_BATCH, nb_epoch=2,
              callbacks=[timed.append])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(("fused_ce_fwd", "fused_ce_bwd_dh",
                         "fused_ce_bwd_dw", "flash_attention_fwd",
                         "flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
                        (c.launches for c in kernels)))
    ce_routes = {name: {k: c.launches for k, c in routes.items()}
                 for name, routes in by_route.items()}
    records += timed
    steps = 2 * (LM_SEQS // LM_BATCH)
    loss_first, loss_last = records[0]["loss"], records[-1]["loss"]
    summary = {"steps": steps, "batch": LM_BATCH, "seq_len": LM_SEQ,
               "tokens_per_s": max(r["throughput"] for r in timed) * LM_SEQ,
               "ms_per_step": 1e3 * wall / steps, "wall_s": wall,
               "warmup_s": warm,
               "losses": [r["loss"] for r in records],
               "launches": launches, "ce_routes": ce_routes}
    print(f"lm: {steps} steps of {LM_BATCH}x{LM_SEQ} tokens in {wall:.3f}s "
          f"= {summary['tokens_per_s']:.1f} tokens/s (best epoch), "
          f"{summary['ms_per_step']:.1f} ms/step (warm-up {warm:.1f}s); "
          f"loss {loss_first:.4f} -> {loss_last:.4f}; launches "
          f"{json.dumps(launches)}; CE kernels by route "
          f"{json.dumps(ce_routes)}")
    check(math.isfinite(loss_last) and loss_last < 0.98 * loss_first,
          f"loss gate: {loss_first} -> {loss_last}")
    n_block = LM_CFG["n_block"]
    for name, count in launches.items():
        want = steps * (n_block if name.startswith("flash") else 1)
        check(count == want, f"{name}: {count} launches, want {want}")
    for name, routes in ce_routes.items():
        check(routes["wgmma"] == steps, f"{name} on the wgmma route "
              f"{routes}, want all {steps}")

    # one step's gradients and peak memory: the fused route against the
    # full-logits oracle on the same batch and weights
    loss_fn = model._loop.loss
    spec = resolve_fused_loss(model, loss_fn)
    check(spec is not None, "the fused loss did not resolve")
    xb = _to_device(x[:LM_BATCH], torch.device("cuda"))
    yb = _to_device(y[:LM_BATCH], torch.device("cuda"))
    grads, peaks, losses = {}, {}, {}
    for route in ("fused", "oracle"):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        gen = step_generator(0, 0)
        if route == "fused":
            loss = spec.apply_and_loss(model, xb, yb, generator=gen)
        else:
            loss = loss_fn(yb, model(xb, training=True, generator=gen))
        loss.backward()
        torch.cuda.synchronize()
        peaks[route] = torch.cuda.max_memory_allocated() - base
        losses[route] = loss.item()
        del loss
        grads[route] = {n: p.grad.detach().clone()
                        for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    rel = {n: ((grads["fused"][n] - grads["oracle"][n]).norm()
               / grads["oracle"][n].norm().clamp_min(1e-30)).item()
           for n in grads["fused"]}
    worst = max(rel, key=rel.get)
    saved = peaks["oracle"] - peaks["fused"]
    logits_bytes = LM_BATCH * LM_SEQ * LM_VOCAB * 2
    summary.update(grad_rel_err_max=rel[worst], grad_rel_err_leaf=worst,
                   step_losses=losses, peak_step_bytes=peaks,
                   peak_saved_bytes=saved)
    print(f"lm: fused vs oracle, one step: losses {losses['fused']:.6f} / "
          f"{losses['oracle']:.6f}; largest per-leaf gradient relative "
          f"error {rel[worst]:.3e} ({worst}; tolerance {LM_GRAD_REL_TOL}); "
          f"peak memory over the step {peaks['fused'] / 1e9:.3f} GB fused, "
          f"{peaks['oracle'] / 1e9:.3f} GB oracle ({saved / 1e9:.3f} GB "
          f"saved, at least {logits_bytes / 1e9:.3f} GB required)")
    check(rel[worst] <= LM_GRAD_REL_TOL, f"fused vs oracle gradients: "
          f"{worst} {rel[worst]}")
    check(saved >= logits_bytes, f"fused peak only {saved} bytes under the "
          f"oracle's")
    del grads
    return summary, y[:LM_BATCH]


def lm_kernel_rows(labels_np, launches, launches_by_route):
    """K4, K5a and K5b at the LM path's shape (N=65,536, H=512, V=8192,
    bf16, a bias, the run's labels), and the attention kernels at the LM's
    causal B=16, H=8, T=4096, D=64 (time, launches on the LM path and
    bound): ``(ce_rows, flash_lm)``."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import (
        LAST_DH_LAUNCH, LAST_DW_LAUNCH, LAST_FWD_LAUNCH, fused_ce_backward_dh,
        fused_ce_backward_dw, fused_ce_backward_reference, fused_ce_forward,
        fused_ce_forward_reference)
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        bwd_dkv, bwd_dq, flash_attention)
    n, hidden, v = LM_BATCH * LM_SEQ, LM_CFG["hidden_size"], LM_VOCAB
    g = torch.Generator().manual_seed(3)
    h = torch.randn(n, hidden, generator=g).to("cuda", torch.bfloat16)
    w = (torch.randn(hidden, v, generator=g) * hidden ** -0.5).to(
        "cuda", torch.bfloat16)
    b = (torch.randn(v, generator=g) * 0.1).cuda()
    labels = torch.from_numpy(labels_np.reshape(-1)).cuda()
    scale = torch.full((n,), 1.0 / n, device="cuda")
    lse, ll = fused_ce_forward(h, w, b, labels)
    dh = fused_ce_backward_dh(h, w, b, labels, lse, scale)
    dw, db = fused_ce_backward_dw(h, w, b, labels, lse, scale)
    torch.cuda.synchronize()
    routes = {"fused_ce_fwd": LAST_FWD_LAUNCH.route,
              "fused_ce_bwd_dh": LAST_DH_LAUNCH.route,
              "fused_ce_bwd_dw": LAST_DW_LAUNCH.route}
    for name, route in routes.items():
        check(route == "wgmma", f"LM shape: {name} took {route}")
    ref_lse, ref_ll = fused_ce_forward_reference(h, w, b, labels)
    ref_dh, ref_dw, ref_db = fused_ce_backward_reference(h, w, b, labels,
                                                         lse, scale)

    def err(a, c):
        return (a.float() - c.float()).abs().max().item()

    tol = CE_TOL["bfloat16"]
    lse_err = err(lse, ref_lse)
    ll_rel = ((ll - ref_ll).abs() / ref_ll.abs().clamp_min(1.0)).max().item()
    errors = {"fused_ce_fwd": max(lse_err, err(ll, ref_ll)),
              "fused_ce_bwd_dh": err(dh, ref_dh),
              "fused_ce_bwd_dw": max(err(dw, ref_dw), err(db, ref_db))}
    check(lse_err <= tol["lse"], f"LM shape: K4 lse {lse_err}")
    check(ll_rel <= tol["ll_rel"], f"LM shape: K4 label logit {ll_rel}")
    del ref_lse, ref_ll
    for name, ref in (("fused_ce_bwd_dh", ref_dh), ("fused_ce_bwd_dw",
                                                    ref_dw)):
        top = ref.float().abs().max().item()
        check(errors[name] <= tol["grad"] * top, f"LM shape: {name} "
              f"{errors[name]} > {tol['grad']} x {top}")
    del ref_dh, ref_dw, ref_db

    dl = torch.randn(n, v, device="cuda", dtype=torch.bfloat16)
    plain_bwd_ms = time_ms(lambda: fused_ce_backward_reference(
        h, w, b, labels, lse, scale), iters=5, warmup=1)
    flops_fwd = 2.0 * n * hidden * v
    bytes_in = n * hidden * 2 + hidden * v * 2 + v * 4 + n * 4
    timings = {
        "fused_ce_fwd": (
            time_ms(lambda: fused_ce_forward(h, w, b, labels)),
            time_ms(lambda: fused_ce_forward_reference(h, w, b, labels),
                    iters=5, warmup=1),
            time_ms(lambda: torch.matmul(h, w)),
            flops_fwd, bytes_in + 2 * n * 4),
        "fused_ce_bwd_dh": (
            time_ms(lambda: fused_ce_backward_dh(h, w, b, labels, lse,
                                                 scale)),
            plain_bwd_ms,
            time_ms(lambda: (torch.matmul(h, w), torch.matmul(dl, w.T))),
            2 * flops_fwd, bytes_in + 2 * n * 4 + n * hidden * 2),
        "fused_ce_bwd_dw": (
            time_ms(lambda: fused_ce_backward_dw(h, w, b, labels, lse,
                                                 scale)),
            plain_bwd_ms,
            time_ms(lambda: (torch.matmul(h, w), torch.matmul(h.T, dl))),
            2 * flops_fwd, bytes_in + 2 * n * 4 + hidden * v * 4 + v * 4),
    }
    del dl
    src = "analytics_zoo_tpu_torch/csrc/fused_cross_entropy.cu"
    replaces = {"fused_ce_fwd": "analytics_zoo_tpu/ops/pallas/"
                                "cross_entropy.py:325",
                "fused_ce_bwd_dh": "analytics_zoo_tpu/ops/pallas/"
                                   "cross_entropy.py:496",
                "fused_ce_bwd_dw": "analytics_zoo_tpu/ops/pallas/"
                                   "cross_entropy.py:525"}
    rows = []
    for name, (ms, plain_ms, lib_ms, flops, nbytes) in timings.items():
        t_ops = flops / PEAK_FLOPS["bfloat16"]
        t_bytes = nbytes / PEAK_BYTES_PER_S
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces[name],
                     "launches": launches[name],
                     "max_abs_err": errors[name], "ms": ms,
                     "plain_ms": plain_ms,
                     "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": ("operations" if t_ops >= t_bytes
                                  else "bytes"),
                     "library_ms": lib_ms,
                     "library_by": "cuBLAS products, no softmax"})
        if name != "fused_ce_fwd":
            rows[-1]["plain_by"] = ("the plain backward computes dh, dW "
                                    "and db together: the pair's time")
        rows[-1]["kernel_route"] = routes[name]
        rows[-1]["launches_by_route"] = launches_by_route[name]
    del h, w, dh, dw

    q, k, vv, do = (torch.randn(LM_BATCH, LM_CFG["n_head"], LM_SEQ, 64,
                                generator=g).to("cuda", torch.bfloat16)
                    for _ in range(4))
    out, lse = flash_attention(q, k, vv, causal=True, want_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    errors_lm = lm_attention_errors(q, k, vv, do, out, lse, delta)
    bounds_lm = {   # operation and byte counts as main_path_kernel_rows'
        "flash_attention_fwd": attention_bound(q, k, None, True,
                                               n_row_f32=1),
        "flash_attention_bwd_dq": attention_bound(q, k, None, True, 6,
                                                  n_q_sized=3, n_kv_sized=2,
                                                  n_row_f32=2),
        "flash_attention_bwd_dkv": attention_bound(q, k, None, True, 8,
                                                   n_q_sized=2,
                                                   n_kv_sized=4,
                                                   n_row_f32=2),
    }
    flash_lm = {
        "flash_attention_fwd": time_ms(lambda: flash_attention(
            q, k, vv, causal=True, want_lse=True), iters=5, warmup=1),
        "flash_attention_bwd_dq": time_ms(lambda: bwd_dq(
            q, k, vv, None, lse, delta, do, True), iters=5, warmup=1),
        "flash_attention_bwd_dkv": time_ms(lambda: bwd_dkv(
            q, k, vv, None, lse, delta, do, True), iters=5, warmup=1),
    }
    # yardsticks only: SDPA forward and backward (dq, dk, dv in one call),
    # causal, at this shape
    sdpa_lm = lm_sdpa_ms(q, k, vv, do)
    print(f"lm attention SDPA yardsticks, causal bf16: {json.dumps(sdpa_lm)}")
    return rows, {name: {"launches_lm": launches[name], "ms_lm": ms,
                         "max_abs_err_lm": errors_lm[name],
                         "bound_ms_lm": bounds_lm[name][0],
                         "bound_by_lm": bounds_lm[name][1],
                         "library_ms_lm": sdpa_lm[
                             "fwd" if name == "flash_attention_fwd"
                             else "bwd"]}
                  for name, ms in flash_lm.items()}


def fused_ce_speedup():
    """The JAX bench's ``fused_ce_speedup`` yardstick (``bench.py:254-325``):
    one forward and backward (gradients of h, W and b) of the fused LM-head
    loss against the full-logits objective as ``Dense`` +
    ``scce_with_logits`` run it, at T = 32,768 rows, V = 8192, H = 512, bf16
    h, f32 W and b, the inputs made as that function makes them (numpy seed
    11); tokens/s best of three each, and their ratio. Printed, not gated
    (the JAX bench floors it at 1.0, ``bench.py:1528``)."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.ops.fused_cross_entropy import \
        fused_sparse_cross_entropy
    from analytics_zoo_tpu_torch.pipeline.api.keras import objectives
    t, v, h_dim = 32768, 8192, 512
    rng = np.random.default_rng(11)
    h = torch.from_numpy(rng.normal(size=(t, h_dim)).astype(np.float32)).to(
        "cuda", torch.bfloat16).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(h_dim, v)).astype(np.float32)
                         * 0.02).cuda().requires_grad_()
    b = torch.zeros(v, device="cuda", requires_grad=True)
    y = torch.from_numpy(rng.integers(0, v, t).astype(np.int32)).cuda()

    def full_loss():
        logits = torch.matmul(h, w.to(h.dtype)) + b.to(h.dtype)
        return objectives.sparse_categorical_crossentropy_from_logits(
            y, logits)

    def fused_loss():
        return fused_sparse_cross_entropy(y, h, w, b)

    rates = {}
    for tag, fn in (("fullvocab", full_loss), ("fused", fused_loss)):
        torch.autograd.grad(fn(), (h, w, b))        # warm-up
        torch.cuda.synchronize()
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            torch.autograd.grad(fn(), (h, w, b))
            torch.cuda.synchronize()
            best = max(best, t / (time.perf_counter() - t0))
        rates[tag] = best
    out = {f"{tag}_ce_tokens_per_sec": rate for tag, rate in rates.items()}
    out["fused_ce_speedup"] = rates["fused"] / rates["fullvocab"]
    print(f"fused ce speedup (T={t}, V={v}, H={h_dim}, bf16 h; the JAX "
          f"bench's yardstick, floored there at 1.0): {json.dumps(out)}")
    return out


def lm_sdpa_ms(q, k, v, do):
    """``scaled_dot_product_attention(is_causal=True)`` at the LM shape: the
    forward's time, and the backward's (one call computes dq, dk and dv:
    the K3a + K3b pair's yardstick). Timed here only; the port never calls
    it."""
    import torch
    import torch.nn.functional as F
    fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True),
                  iters=5, warmup=1)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    bwd = time_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                              retain_graph=True),
                  iters=5, warmup=1)
    return {"fwd": fwd, "bwd": bwd}


def lm_attention_errors(q, k, v, do, out, lse, delta):
    """K2, K3a and K3b against their plain versions at the LM shape
    (causal, no mask, bf16), with the tolerances of the BERT-shape phases:
    K2's output 2e-2 absolute and its lse 1e-3, the gradients 2e-2 of the
    largest, and the same gradient bits on a second run. The plain versions form the f32 score matrix, 8.6 GB at this
    shape, so they run one batch row at a time. Returns each kernel's
    largest absolute error."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        bwd_dkv, bwd_dkv_reference, bwd_dq, bwd_dq_reference,
        flash_attention_reference)
    dq = bwd_dq(q, k, v, None, lse, delta, do, True)
    dk, dv = bwd_dkv(q, k, v, None, lse, delta, do, True)
    again = (bwd_dq(q, k, v, None, lse, delta, do, True),
             *bwd_dkv(q, k, v, None, lse, delta, do, True))
    torch.cuda.synchronize()
    for key, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
        check(same_bits(a, b), f"LM shape: {key} not the same bits on a "
              f"second run")
    del again
    got = {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    err = dict.fromkeys(got, 0.0)
    top = dict.fromkeys(got, 0.0)
    for i in range(q.shape[0]):
        sl = slice(i, i + 1)
        args = (q[sl], k[sl], v[sl], None, lse[sl], delta[sl], do[sl], True)
        ref = dict(zip(("out", "lse"), flash_attention_reference(
            q[sl], k[sl], v[sl], None, True, want_lse=True)))
        ref["dq"] = bwd_dq_reference(*args)
        ref["dk"], ref["dv"] = bwd_dkv_reference(*args)
        for key, want in ref.items():
            err[key] = max(err[key], (got[key][sl].float() - want.float()
                                      ).abs().max().item())
            top[key] = max(top[key], want.float().abs().max().item())
        del ref
    print(f"lm attention kernels vs plain, B={q.shape[0]} H={q.shape[1]} "
          f"T={q.shape[2]} D={q.shape[3]} causal bf16: "
          f"{json.dumps({'max_abs_err': err, 'max_abs': top})}")
    check(err["out"] <= 2e-2, f"LM shape: K2 vs plain {err['out']}")
    check(err["lse"] <= 1e-3, f"LM shape: K2 lse {err['lse']}")
    for key in ("dq", "dk", "dv"):
        check(bool(torch.isfinite(got[key]).all()), f"LM shape: {key} not "
              f"finite")
        check(err[key] <= 2e-2 * top[key], f"LM shape: {key} vs plain "
              f"{err[key]} > 2e-2 x {top[key]}")
    return {"flash_attention_fwd": max(err["out"], err["lse"]),
            "flash_attention_bwd_dq": err["dq"],
            "flash_attention_bwd_dkv": max(err["dk"], err["dv"])}


def fault_l_phase():
    """``fused_cross_entropy_rows`` on views the kernels do not take as
    they lie, a column slice of a wider hidden array and a tied head's
    transposed ``(V, H)`` embedding, at the CE phase's N=4100, H=512,
    V=8192 (f32 and bf16): one launch each of K4, K5a and K5b on dense
    copies, held to the plain route, the loss rows and the gradients of
    the wide array, the embedding and the bias (each in its caller's
    layout) at CE_TOL."""
    import torch

    from analytics_zoo_tpu_torch.ops.fused_cross_entropy import \
        fused_cross_entropy_rows
    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import (
        KERNEL_CE_BWD_DH, KERNEL_CE_BWD_DW, KERNEL_CE_FWD,
        fused_ce_forward_reference)
    n, hidden, v = 4100, 512, 8192
    out = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        g = torch.Generator().manual_seed(11)
        wide = torch.randn(n, hidden + 64, generator=g).to("cuda", dtype)
        emb = (torch.randn(v, hidden, generator=g)
               * hidden ** -0.5).to("cuda", dtype)
        b = (torch.randn(v, generator=g) * 0.5).cuda()
        labels = torch.randint(0, v, (n,), generator=g, dtype=torch.int32)
        labels[::3] = -1
        labels = labels.cuda()

        def run(use_pallas):
            ts = [t.detach().clone().requires_grad_()
                  for t in (wide, emb, b)]
            rows = fused_cross_entropy_rows(ts[0][:, 32:32 + hidden],
                                            ts[1].T, ts[2], labels,
                                            use_pallas=use_pallas)
            grads = torch.autograd.grad(rows.sum(), ts)
            check(all(gr.shape == t.shape and gr.dtype == t.dtype
                      for t, gr in zip(ts, grads)),
                  "fault l: a gradient left its caller's layout")
            return rows.detach(), grads
        counters = (KERNEL_CE_FWD, KERNEL_CE_BWD_DH, KERNEL_CE_BWD_DW)
        before = [c.launches for c in counters]
        got, g_got = run(True)
        torch.cuda.synchronize()
        launched = [c.launches - n0 for c, n0 in zip(counters, before)]
        want, g_want = run(False)
        _, ll = fused_ce_forward_reference(
            wide[:, 32:32 + hidden].contiguous(), emb.T.contiguous(), b,
            labels)
        tol = CE_TOL[name]
        err = (got - want).abs().max().item()
        bound = tol["lse"] + tol["ll_rel"] * ll.abs().max().item()
        g_err = [((a.float() - c.float()).abs().max()
                  / c.float().abs().max()).item()
                 for a, c in zip(g_got, g_want)]
        out[name] = {"loss_err": err, "loss_tol": bound,
                     "grad_rel_err": g_err, "launches": launched}
        print(f"fault l ({name}): hidden[:, 32:544] and emb.T through the "
              f"kernels vs the plain route: loss rows {err:.3e} (tol "
              f"{bound:.3e}), gradients of the wide array, emb, b "
              f"{[f'{e:.3e}' for e in g_err]} of their largest (tol "
              f"{tol['grad']}); K4/K5a/K5b launches {launched}")
        check(launched == [1, 1, 1], f"fault l: launches {launched}")
        check(err <= bound and all(e <= tol["grad"] for e in g_err),
              f"fault l ({name}): {out[name]}")
    return out


#: the captured BERT check: BERT-base width, 2 blocks, seq 512, batch 8,
#: hidden dropout 0.1 (attention dropout 0, so the flash kernels run)
CAPTURE_CFG = dict(TRAIN_CFG, n_block=2, hidden_drop=0.1)
CAPTURE_BATCH, CAPTURE_STEPS = 8, 8


def captured_bert_phase():
    """BERT at two blocks of full width, four steps a captured graph
    (``zoo.train.scan_steps=4``): K2, K3a and K3b and the dropout draws run
    inside the graph. With sgd at lr 0 on one record repeated (so the
    weights and the batch never change), every step loss of the two
    replays differs (each step draws new masks) and equals the eager
    loop's at that iteration; with dropout 0 and AdamW, the captured
    fit's losses and final parameters against the eager fit's (the same
    bits, or within 1e-6 relative, said which)."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        KERNEL, KERNEL_BWD_DKV, KERNEL_BWD_DQ)
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
        BERTClassifier
    x, y, _ = training_data(CAPTURE_BATCH * CAPTURE_STEPS)
    counters = (KERNEL, KERNEL_BWD_DQ, KERNEL_BWD_DKV)

    def fit(keyed, drop, one_record):
        init_zoo_context(conf={"zoo.pallas.attention": True,
                               "zoo.compute.dtype": "bfloat16",
                               "zoo.seed": 0,
                               "zoo.train.scan_steps": 4 if keyed else 1})
        reset_uids()
        model = BERTClassifier(**dict(CAPTURE_CFG, hidden_drop=drop),
                               device="cuda").init_weights()
        if one_record:
            model.compile(optimizer="sgd", loss="scce", lr=0.0)
            xs = [np.repeat(a[:1], len(a), 0) for a in x]
            ys = np.repeat(y[:1], len(y), 0)
        else:
            model.compile(optimizer="adamw", loss="scce", lr=2e-5)
            xs, ys = x, y
        model.fit(xs, ys, batch_size=CAPTURE_BATCH, nb_epoch=1,
                  shuffle=False)                     # captures when keyed
        for c in counters:
            c.reset()
        model.fit(xs, ys, batch_size=CAPTURE_BATCH, nb_epoch=1,
                  shuffle=False)
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        return (np.concatenate(model._loop.step_losses),
                [p.detach().clone() for p in model.parameters()], launches)

    keyed, _, launches = fit(True, 0.1, True)
    eager, _, _ = fit(False, 0.1, True)
    want = CAPTURE_CFG["n_block"] * CAPTURE_STEPS
    distinct = len(set(keyed.tolist()))
    masks_equal = bool(np.array_equal(keyed.view(np.int32),
                                      eager.view(np.int32)))
    print(f"captured BERT (2 blocks, seq 512, batch {CAPTURE_BATCH}, hidden "
          f"dropout 0.1, lr 0, one record): {CAPTURE_STEPS} step losses "
          f"over two replays, {distinct} distinct (a new mask every step); "
          f"the eager steps' losses, the same bits: {masks_equal}; "
          f"K2/K3a/K3b launches under replay {launches} (want {want} each)")
    check(distinct == CAPTURE_STEPS, f"captured dropout repeated a mask: "
          f"{keyed.tolist()}")
    check(masks_equal, f"captured dropout draws differ from the eager "
          f"steps': {keyed.tolist()} vs {eager.tolist()}")
    check(launches == [want] * 3, f"captured BERT launches {launches}")

    k_loss, k_params, _ = fit(True, 0.0, False)
    e_loss, e_params, _ = fit(False, 0.0, False)
    loss_bits = bool(np.array_equal(k_loss.view(np.int32),
                                    e_loss.view(np.int32)))
    param_bits = all(torch.equal(a, b) for a, b in zip(k_params, e_params))
    rel = max([float(np.max(np.abs(k_loss - e_loss) / np.abs(e_loss)))]
              + [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
                 for a, b in zip(k_params, e_params)])
    print(f"captured BERT, dropout 0, AdamW 2e-5: captured vs eager step "
          f"losses the same bits {loss_bits}, final parameters the same "
          f"bits {param_bits}"
          + ("" if loss_bits and param_bits
             else f"; largest relative difference {rel:.3e} (tolerance "
                  f"1e-6)"))
    check((loss_bits and param_bits) or rel <= 1e-6,
          f"captured BERT differs from eager by {rel}")
    return {"distinct_step_losses": distinct,
            "dropout_masks_eager_bits": masks_equal,
            "launches": launches, "losses_same_bits": loss_bits,
            "params_same_bits": param_bits, "max_rel_diff": rel}


def ce_hidden_phase():
    """K4, K5a and K5b at hidden widths the kernels pad (H = 100 to 128)
    or slice (H = 1280 and 2048, two slices of 640 and 1024) against their
    plain versions, bf16, N=4100, V=8192, and their times."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import (
        fused_ce_backward_dh, fused_ce_backward_dw,
        fused_ce_backward_reference, fused_ce_forward,
        fused_ce_forward_reference)
    n, v = 4100, 8192
    tol = CE_TOL["bfloat16"]
    g = torch.Generator().manual_seed(5)
    rows = []
    for hidden in (100, 1280, 2048):
        h = torch.randn(n, hidden, generator=g).to("cuda", torch.bfloat16)
        w = (torch.randn(hidden, v, generator=g) * hidden ** -0.5).to(
            "cuda", torch.bfloat16)
        b = (torch.randn(v, generator=g) * 0.5).cuda()
        labels = torch.randint(0, v, (n,), generator=g,
                               dtype=torch.int32).cuda()
        labels[::3] = -1
        scale = torch.where(labels >= 0, 1.0 / n, 0.0).float()
        lse, ll = fused_ce_forward(h, w, b, labels)
        dh = fused_ce_backward_dh(h, w, b, labels, lse, scale)
        dw, db = fused_ce_backward_dw(h, w, b, labels, lse, scale)
        torch.cuda.synchronize()
        ref_lse, ref_ll = fused_ce_forward_reference(h, w, b, labels)
        ref = fused_ce_backward_reference(h, w, b, labels, lse, scale)
        row = {"case": f"bf16_h{hidden}", "n": n, "hidden": hidden,
               "vocab": v, "lse_err": (lse - ref_lse).abs().max().item(),
               "ll_rel_err": ((ll - ref_ll).abs()
                              / ref_ll.abs().clamp_min(1.0)).max().item()}
        check(row["lse_err"] <= tol["lse"], f"H={hidden}: K4 lse "
              f"{row['lse_err']}")
        check(row["ll_rel_err"] <= tol["ll_rel"], f"H={hidden}: K4 label "
              f"logit {row['ll_rel_err']}")
        check(dh.shape == h.shape and dw.shape == w.shape,
              f"H={hidden}: gradient shapes {dh.shape} {dw.shape}")
        for key, got, want in (("dh", dh, ref[0]), ("dw", dw, ref[1]),
                               ("db", db, ref[2])):
            err = (got.float() - want.float()).abs().max().item()
            top = want.float().abs().max().item()
            row[f"{key}_max_abs_err"], row[f"{key}_max_abs"] = err, top
            check(bool(torch.isfinite(got).all()) and err <= tol["grad"]
                  * top, f"H={hidden}: {key} {err} > {tol['grad']} x {top}")
        row["ms"] = {
            "fused_ce_fwd": time_ms(lambda: fused_ce_forward(h, w, b,
                                                             labels)),
            "fused_ce_bwd_dh": time_ms(lambda: fused_ce_backward_dh(
                h, w, b, labels, lse, scale)),
            "fused_ce_bwd_dw": time_ms(lambda: fused_ce_backward_dw(
                h, w, b, labels, lse, scale))}
        # the products' operations over the bf16 peak
        row["bound_ms"] = {
            "fused_ce_fwd": 2.0 * n * hidden * v / PEAK_FLOPS["bfloat16"]
            * 1e3,
            "fused_ce_bwd_dh": 4.0 * n * hidden * v / PEAK_FLOPS["bfloat16"]
            * 1e3,
            "fused_ce_bwd_dw": 4.0 * n * hidden * v / PEAK_FLOPS["bfloat16"]
            * 1e3}
        rows.append(row)
        print(f"ce hidden case {json.dumps(row)}")
        del h, w, dh, dw, ref
    return rows


def make_movielens_like(rng):
    """The JAX package's bench data (bench.py:87-102): ratings from a
    ground-truth latent-factor model, quantized to 5 balanced classes."""
    import numpy as np
    dim = 8
    uf = rng.normal(0, 1.0, (N_USERS + 1, dim))
    vf = rng.normal(0, 1.0, (N_ITEMS + 1, dim))
    users = rng.integers(1, N_USERS + 1, N_EXAMPLES).astype(np.int32)
    items = rng.integers(1, N_ITEMS + 1, N_EXAMPLES).astype(np.int32)
    score = np.einsum("nd,nd->n", uf[users], vf[items]) / np.sqrt(dim)
    score += rng.normal(0, 0.25, N_EXAMPLES)
    # quantize to 5 roughly-balanced classes
    edges = np.quantile(score, [0.2, 0.4, 0.6, 0.8])
    y = np.digitize(score, edges).astype(np.int32)
    x = np.stack([users, items], axis=1)
    return x, y


def host_ms_in_turns(*fns, rounds=5, iters=100):
    """Per-call ms of each of ``fns`` timed in turns (one batch of
    ``iters`` calls each, ``rounds`` times) and the median of each's
    rounds: where the host's launch rate sets the time, this keeps the
    drift of a shared host out of the comparison."""
    import statistics
    times = [[] for _ in fns]
    for _ in range(rounds):
        for fn, t in zip(fns, times):
            t.append(time_ms(fn, iters=iters))
    return [statistics.median(t) for t in times]


def bytes_bound_ms(nbytes):
    return nbytes / PEAK_BYTES_PER_S * 1e3


def embed_case(name, table, ids, dtype, g_seed):
    """K1 and SA on one lookup's dedup'd block: ``ids`` clamped, made
    unique at ``dedup_capacity``, the unique rows gathered; K1 expands
    them (bit for bit against ``rows[inv]``), SA sums a seeded cotangent
    per slot both ways: through the forward's sort (the engine's call, one
    device kernel) and standalone (it sorts first), each bit for bit
    against the CPU's index_add_ and the engine's call the same bits over
    two runs. Returns the case's row with times and byte bounds. ``ms``
    times calls of the wrapper, in turns with ``index_select`` /
    ``index_add_`` (medians of five rounds): at the NCF shapes it reads
    the host's launch rate; ``device_ms`` the same call's device work
    alone (``graph_ms``)."""
    import torch

    from analytics_zoo_tpu_torch.ops.pallas.embedding import (
        dedup_scatter_add, dedup_scatter_add_reference, embed_expand,
        embed_expand_reference)
    from analytics_zoo_tpu_torch.ops.sharded_embedding import (
        _dedup_sort, dedup_capacity)
    v, d = table.shape
    n = ids.shape[0]
    cap = dedup_capacity(n, v)
    uniq, inv, order, slot = _dedup_sort(ids.clamp(0, v - 1), cap, fill=v)
    rows = table.index_select(0, uniq.clamp(0, v - 1).long()).to(dtype)
    g = torch.randn(n, d, generator=torch.Generator().manual_seed(g_seed)
                    ).to("cuda", dtype)

    def sa_engine():
        return dedup_scatter_add(g, inv, cap, order=order, sorted_slot=slot)

    def sa_alone():
        return dedup_scatter_add(g, inv, cap)
    out = embed_expand(rows, inv)
    sums = [sa_engine() for _ in range(2)]
    alone = sa_alone()
    torch.cuda.synchronize()
    es = rows.element_size()
    n_unique = int(torch.unique(inv).numel())
    k1_ref = embed_expand_reference(rows, inv)
    sa_ref = dedup_scatter_add_reference(g.cpu(), inv.cpu(), cap)
    k1_equal = torch.equal(out.view(torch.int16), k1_ref.view(torch.int16))
    sa_same = torch.equal(sums[0].view(torch.int32), sums[1].view(torch.int32))
    sa_equal = torch.equal(sums[0].cpu().view(torch.int32),
                           sa_ref.view(torch.int32))
    alone_equal = torch.equal(alone.cpu().view(torch.int32),
                              sa_ref.view(torch.int32))
    check(k1_equal, f"{name}: K1 differs from rows[inv]")
    check(sa_equal, f"{name}: SA differs from the CPU's position-order sum")
    check(alone_equal, f"{name}: standalone SA differs from the CPU's sum")
    check(sa_same, f"{name}: SA differs between two runs")
    engine_kernels = device_kernels(sa_engine)
    check(len(engine_kernels) == 1, f"{name}: SA through the forward's sort "
          f"launched {engine_kernels}")
    inv64 = inv.long()
    acc = torch.zeros(cap, d, dtype=torch.float32, device="cuda")
    gf = g.float()
    row = {"case": name, "n": n, "capacity": cap, "unique": n_unique, "d": d,
           "dtype": str(dtype).replace("torch.", ""),
           "k1_bit_equal": k1_equal, "sa_bit_equal_cpu": sa_equal,
           "sa_standalone_bit_equal_cpu": alone_equal,
           "sa_same_bits_two_runs": sa_same,
           "embed_expand": {
               "max_abs_err": (out.float() - k1_ref.float()).abs().max()
               .item(),
               **dict(zip(("ms", "library_ms"), host_ms_in_turns(
                   lambda: embed_expand(rows, inv),
                   lambda: torch.index_select(rows, 0, inv64)))),
               "device_ms": graph_ms(lambda: embed_expand(rows, inv)),
               "plain_ms": time_ms(lambda: embed_expand_reference(rows, inv),
                                   iters=50),
               # the referenced unique rows and the ids read, the rows
               # written
               "bound_ms": bytes_bound_ms(n_unique * d * es + n * 4
                                          + n * d * es)},
           "dedup_scatter_add": {
               "max_abs_err": (sums[0].cpu() - sa_ref).abs().max().item(),
               **dict(zip(("ms", "ms_standalone", "library_ms"),
                          host_ms_in_turns(
                              sa_engine, sa_alone,
                              lambda: acc.index_add_(0, inv64, gf)))),
               "device_ms": graph_ms(sa_engine),
               "device_ms_standalone": graph_ms(sa_alone),
               "library_device_ms": graph_ms(
                   lambda: acc.index_add_(0, inv64, gf)),
               "device_kernels": len(engine_kernels),
               "device_kernels_standalone": len(device_kernels(sa_alone)),
               "plain_ms": time_ms(lambda: dedup_scatter_add_reference(
                   g, inv, cap), iters=50),
               # what the function needs: g and the int32 ids read, the
               # (capacity, D) f32 block written
               "bound_ms": bytes_bound_ms(n * d * es + n * 4
                                          + cap * d * 4),
               # the same with the int64 sorted positions and slots this
               # design reads in place of the ids
               "bytes_ms_as_read": bytes_bound_ms(n * d * es + 2 * n * 8
                                                  + cap * d * 4)}}
    print(f"embed kernel case {json.dumps(row)}")
    return row


def embed_kernel_phase(x):
    """K1 and SA at the NCF path's shapes (its first batch's user and item
    ids) and at a DLRM-Terabyte width."""
    import torch
    g = torch.Generator().manual_seed(6)
    batch = torch.from_numpy(x[:NCF_BATCH]).cuda()
    cases = [
        ("ncf_user", torch.randn(N_USERS + 1, 20, generator=g).cuda(),
         batch[:, 0].contiguous(), torch.float32),
        ("ncf_item", torch.randn(N_ITEMS + 1, 20, generator=g).cuda(),
         batch[:, 1].contiguous(), torch.float32)]
    dlrm_table = torch.randn(DLRM_V, DLRM_D, generator=g).cuda()
    dlrm_ids = torch.randint(0, DLRM_V, (DLRM_N,), generator=g,
                             dtype=torch.int32).cuda()
    cases += [("dlrm_f32", dlrm_table, dlrm_ids, torch.float32),
              ("dlrm_bf16", dlrm_table, dlrm_ids, torch.bfloat16)]
    rows = {name: embed_case(name, table, ids, dtype, i)
            for i, (name, table, ids, dtype) in enumerate(cases)}
    del dlrm_table
    return rows


def sharded_ncf(user_count, item_count, class_num, device="cuda"):
    """NeuralCF's graph (``models/recommendation/neural_cf.py``: embeddings
    20/20, MLP 40-20-10, MF 20) built with the functional API on
    ``ShardedEmbedding`` tables: what a user writes to put the tables on
    the dedup'd engine."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import (Input,
                                                                   Model)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense, Merge, Select, ShardedEmbedding)
    inp = Input(shape=(2,))
    user = Select(1, 0)(inp)
    item = Select(1, 1)(inp)
    h = Merge(mode="concat", concat_axis=-1)([
        ShardedEmbedding(user_count + 1, 20, init="normal")(user),
        ShardedEmbedding(item_count + 1, 20, init="normal")(item)])
    for units in (40, 20, 10):
        h = Dense(units, activation="relu")(h)
    mf = Merge(mode="mul")([
        ShardedEmbedding(user_count + 1, 20, init="normal")(user),
        ShardedEmbedding(item_count + 1, 20, init="normal")(item)])
    h = Merge(mode="concat", concat_axis=-1)([h, mf])
    return Model(inp, Dense(class_num, activation="softmax")(h),
                 device=device)


def step_kernels(net, xb, yb, loss_fn):
    """The names of the device kernels one forward (with the loss) and one
    backward of ``net`` launch, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def names(prof):
        return [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    net.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as fwd:
        loss = loss_fn(yb, net(xb, training=True))
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as bwd:
        loss.backward()
        torch.cuda.synchronize()
    net.zero_grad(set_to_none=True)
    return names(fwd), names(bwd)


def ncf_plain_forward(params, pairs):
    """NeuralCF's forward written out on the weight tensors, in the
    order of ``neural_cf.py`` (the eager reference for the ranking)."""
    import torch
    p = list(params)
    mlp_u, mlp_i, d1w, d1b, d2w, d2b, d3w, d3b, mf_u, mf_i, ow, ob = p
    users, items = pairs[:, 0].long(), pairs[:, 1].long()
    h = torch.cat([mlp_u[users], mlp_i[items]], dim=-1)
    for w, b in ((d1w, d1b), (d2w, d2b), (d3w, d3b)):
        h = torch.relu(h @ w + b)
    h = torch.cat([h, mf_u[users] * mf_i[items]], dim=-1)
    return torch.softmax(h @ ow + ob, dim=-1)


def busy_share(intervals, t0, t1):
    """Fraction of [t0, t1] covered by the union of ``intervals``."""
    covered, end = 0.0, t0
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, t1)
        if e > s:
            covered += e - s
            end = e
    return covered / (t1 - t0) if t1 > t0 else 0.0


def profiled_busy_share(fn):
    """``fn()`` under ``torch.profiler``: the share of the wall window (the
    first to the last traced event) in which a device kernel ran, and the
    summed kernel ms; None when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, window = [], [float("inf"), float("-inf")]
    for evt in prof.events():
        tr = evt.time_range
        window[0] = min(window[0], tr.start)
        window[1] = max(window[1], tr.end)
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((tr.start, tr.end))
    if not kernels:
        return None, None
    return (busy_share(kernels, *window),
            sum(e - s for s, e in kernels) / 1e3)


def ncf_fit(name, model, fs, counters):
    """compile/fit: a warm-up epoch, then two timed epochs with the
    launch counters set to 0 just before and read just after."""
    import numpy as np
    import torch
    model.compile(optimizer="adam", loss="scce", metrics=["accuracy"],
                  lr=1e-3)
    records = []
    t0 = time.perf_counter()
    model.fit(fs, batch_size=NCF_BATCH, nb_epoch=1,
              callbacks=[records.append])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    step_losses = list(model._loop.step_losses)
    for c in counters:
        c.reset()
    timed = []
    t0 = time.perf_counter()
    model.fit(fs, batch_size=NCF_BATCH, nb_epoch=2,
              callbacks=[timed.append])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    step_losses += model._loop.step_losses
    records += timed
    steps = 2 * fs.steps_per_epoch(NCF_BATCH)
    losses = [r["loss"] for r in records]
    summary = {"steps": steps, "batch": NCF_BATCH,
               "recs_per_s": max(r["throughput"] for r in timed),
               "ms_per_step": 1e3 * wall / steps, "wall_s": wall,
               "warmup_s": warm, "losses": losses,
               "step_losses": np.concatenate(step_losses),
               "launches": dict(zip(("embed_expand", "dedup_scatter_add"),
                                    launches))}
    print(f"ncf {name}: {steps} steps of {NCF_BATCH} in {wall:.3f}s = "
          f"{summary['recs_per_s']:.1f} recs/s (best epoch), "
          f"{summary['ms_per_step']:.2f} ms/step (warm-up {warm:.1f}s); "
          f"losses {losses}; launches {json.dumps(summary['launches'])}")
    check(all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0] and losses[-1] < math.log(N_CLASSES),
          f"ncf {name} loss gate: {losses}")
    return summary


def ncf_build(kind, n_users, n_items):
    """A fresh NCF of ``kind`` (stock or sharded) with the seeded start
    weights (``zoo.seed`` 0, names from a reset uid counter): ``(model,
    net)``, ``net`` the module holding the parameters."""
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    reset_uids()
    if kind == "stock":
        model = NeuralCF(n_users, n_items, N_CLASSES, device="cuda")
        model.init_weights()
        return model, model.model
    net = sharded_ncf(n_users, n_items, N_CLASSES).init_weights()
    return net, net


def ncf_conf(keyed):
    return {"zoo.seed": 0, "zoo.compute.dtype": "float32",
            "zoo.pallas.embed_gather": "auto",
            **(NCF_KEYED_CONF if keyed else {})}


def ncf_in_turns(kind, fs, counters, n_users, n_items):
    """``kind``'s fit four times from the same start, eager, keyed, keyed,
    eager (the host's speed moves NCF between machines, so the loops are
    compared within one call), each the device's busy share over one
    more epoch under the profiler after its timed epochs; then the keyed
    loop once more with the device permutation replaced by the
    FeatureSet's own order, its step losses held to the first eager
    run's."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras import dispatch
    runs = {"eager": [], "keyed": []}
    first = None
    for mode in ("eager", "keyed", "keyed", "eager"):
        init_zoo_context(conf=ncf_conf(mode == "keyed"))
        model, net = ncf_build(kind, n_users, n_items)
        summary = ncf_fit(f"{kind} {mode} run {len(runs[mode]) + 1}",
                          model, fs, counters)
        share, kernel_ms = profiled_busy_share(
            lambda: model.fit(fs, batch_size=NCF_BATCH, nb_epoch=1))
        summary.update(busy_share=share, profiled_kernel_ms=kernel_ms)
        print(f"ncf {kind} {mode}: device busy "
              f"{'not measured' if share is None else f'{100 * share:.1f}%'}"
              f" of one profiled epoch ({kernel_ms} ms of kernels)")
        runs[mode].append(summary)
        if first is None:
            first = (model, net)
        else:
            del model, net
    order = dispatch.device_permutation
    dispatch.device_permutation = (
        lambda n, seed, device: torch.from_numpy(
            np.random.default_rng(seed).permutation(n)).to(device))
    try:
        init_zoo_context(conf=ncf_conf(True))
        model, _ = ncf_build(kind, n_users, n_items)
        same = ncf_fit(f"{kind} keyed in the FeatureSet's order", model, fs,
                       counters)
    finally:
        dispatch.device_permutation = order
    del model
    want = runs["eager"][0]["step_losses"]
    got = same["step_losses"]
    bits = bool(np.array_equal(got.view(np.int32), want.view(np.int32)))
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    print(f"ncf {kind}: keyed loop in the FeatureSet's order vs the eager "
          f"loop, {len(want)} step losses: the same bits {bits}"
          + ("" if bits else f", largest relative difference {rel:.3e} "
             f"(tolerance {NCF_STEP_REL_TOL})"))
    check(len(got) == len(want) and (bits or rel <= NCF_STEP_REL_TOL),
          f"ncf {kind}: keyed step losses differ from the eager loop's by "
          f"{rel}")
    for mode, rs in runs.items():
        for r in rs:
            r.pop("step_losses")
    return runs, {"same_bits": bits, "max_rel_diff": rel}, first


def ncf_phase(x, y):
    """Both NCF configurations through compile/fit at the bench width, each
    in turns eager and with the JAX bench's dispatch keys, their launch
    counts, one step's gradients against each other, the dW bits of two
    backward passes, and recommend_for_user."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.feature.feature_set import FeatureSet
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.ops.pallas.embedding import (
        KERNEL_EMBED_EXPAND, KERNEL_SCATTER_ADD)
    from analytics_zoo_tpu_torch.pipeline.api.keras import objectives

    counters = (KERNEL_EMBED_EXPAND, KERNEL_SCATTER_ADD)
    n_users = max(N_USERS, int(x[:, 0].max()))
    n_items = max(N_ITEMS, int(x[:, 1].max()))
    fs = FeatureSet.array(x, y, seed=0)
    steps_per_epoch = fs.steps_per_epoch(NCF_BATCH)
    out = {}
    nets = {}
    for kind in ("stock", "sharded"):
        runs, same, (model, net) = ncf_in_turns(kind, fs, counters, n_users,
                                                n_items)
        nets[kind] = (model, net)
        want = ({"embed_expand": 0, "dedup_scatter_add": 0}
                if kind == "stock" else
                {"embed_expand": 4 * runs["eager"][0]["steps"],
                 "dedup_scatter_add": 4 * runs["eager"][0]["steps"]})
        for mode, rs in runs.items():
            for r in rs:
                check(r["launches"] == want,
                      f"ncf {kind} {mode}: launches {r['launches']}, want "
                      f"{want} (4 tables x steps on the sharded graph, "
                      f"none on the stock model)")
        out[kind] = runs["eager"][0]
        out[kind + "_runs"] = runs
        out[kind + "_keyed_vs_eager"] = same
        print(f"ncf {kind}: records/s eager "
              f"{[r['recs_per_s'] for r in runs['eager']]}, keyed "
              f"{[r['recs_per_s'] for r in runs['keyed']]}; ms/step eager "
              f"{[r['ms_per_step'] for r in runs['eager']]}, keyed "
              f"{[r['ms_per_step'] for r in runs['keyed']]}; device busy "
              f"eager {[r['busy_share'] for r in runs['eager']]}, keyed "
              f"{[r['busy_share'] for r in runs['keyed']]}")
    init_zoo_context(conf=ncf_conf(False))
    stock, sharded = nets["stock"][0], nets["sharded"][1]
    start_stock = ncf_build("stock", n_users, n_items)[1]
    start = [p.detach().clone() for p in start_stock.parameters()]
    del start_stock

    # one step's gradients of the two from the same (starting) weights
    xb = torch.from_numpy(x[:NCF_BATCH]).cuda()
    yb = torch.from_numpy(y[:NCF_BATCH]).cuda()
    loss_fn = objectives.get_loss("scce")
    with torch.no_grad():
        for net in (stock.model, sharded):
            for p, p0 in zip(net.parameters(), start):
                p.copy_(p0)
    grads = {}
    for key, net in (("stock", stock.model), ("sharded", sharded),
                     ("sharded_again", sharded)):
        net.zero_grad(set_to_none=True)
        loss_fn(yb, net(xb, training=True)).backward()
        grads[key] = [p.grad.detach().clone() for p in net.parameters()]
    names = [n for n, _ in sharded.named_parameters()]
    rel = {n: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
           for n, a, b in zip(names, grads["sharded"], grads["stock"])}
    worst = max(rel, key=rel.get)
    tables = [i for i, n in enumerate(names) if n.endswith("embeddings")]
    same_bits = all(torch.equal(grads["sharded"][i].view(torch.int32),
                                grads["sharded_again"][i].view(torch.int32))
                    for i in tables)
    print(f"ncf: one step, sharded graph vs stock NeuralCF: largest "
          f"per-leaf gradient relative error {rel[worst]:.3e} ({worst}; "
          f"tolerance {NCF_GRAD_REL_TOL}); the tables' dW the same bits "
          f"over two backward passes: {same_bits}")
    # the device kernels of one forward and one backward of the sharded
    # graph: SA once a table, nothing sorted or searched in the backward
    fwd_names, bwd_names = step_kernels(sharded, xb, yb, loss_fn)
    sa = [k for k in bwd_names if "segment_sum_sorted" in k]
    searched = [k for k in bwd_names if "radix" in k.lower()
                or "searchsorted" in k.lower()]
    print(f"ncf: one step of the sharded graph launches {len(fwd_names)} "
          f"device kernels forward and {len(bwd_names)} backward; SA "
          f"{len(sa)} in the backward, sorts and searches there "
          f"{len(searched)}")
    check(len(sa) == 4 and not searched, f"the sharded backward launched "
          f"SA {len(sa)} times and {searched}")
    out.update(step_kernels_fwd=len(fwd_names),
               step_kernels_bwd=len(bwd_names))
    check(rel[worst] <= NCF_GRAD_REL_TOL, f"ncf gradients: {worst} "
          f"{rel[worst]}")
    check(same_bits, "the sharded tables' dW differ between two runs")
    out.update(grad_rel_err_max=rel[worst], grad_rel_err_leaf=worst,
               dw_same_bits=same_bits, steps_per_epoch=steps_per_epoch)
    del grads

    # recommend_for_user against the plain eager forward
    items = np.arange(1, n_items + 1, dtype=np.int32)
    recs = {}
    for user in (1, 1234, n_users):
        got = stock.recommend_for_user(user, items, max_items=10,
                                       batch_size=NCF_BATCH)
        # the same (padded) batch predict runs: the last pair repeated
        pairs = np.stack([np.full_like(items, user), items], axis=1)
        pairs = np.concatenate([pairs, np.repeat(
            pairs[-1:], NCF_BATCH - len(items), axis=0)])
        with torch.no_grad():
            probs = ncf_plain_forward(stock.model.parameters(),
                                      torch.from_numpy(pairs).cuda())
        want = NeuralCF._top_ids(items, probs[:len(items)].cpu().numpy(), 10)
        check(np.array_equal(got, want), f"recommend_for_user({user}): "
              f"{got} vs the plain forward's {want}")
        recs[user] = got.tolist()
    print(f"ncf: recommend_for_user matches the plain forward: "
          f"{json.dumps(recs)}")
    out["recommend_for_user"] = recs
    return out


def embed_kernel_rows(embed_rows, launches):
    """The K1 and SA rows of the kernels line: at the NCF path's user-table
    shape, with the DLRM-width times beside."""
    src = "analytics_zoo_tpu_torch/csrc/embedding.cu"
    replaces = {"embed_expand": "analytics_zoo_tpu/ops/pallas/"
                                "embedding.py:104",
                "dedup_scatter_add": "analytics_zoo_tpu/ops/"
                                     "sharded_embedding.py:148 (XLA "
                                     "scatter; no Pallas kernel)"}
    main, dlrm = embed_rows["ncf_user"], embed_rows["dlrm_f32"]
    rows = []
    for name in ("embed_expand", "dedup_scatter_add"):
        t, td = main[name], dlrm[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces[name],
                     "launches": launches[name],
                     "max_abs_err": max(t["max_abs_err"], td["max_abs_err"]),
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": "bytes",
                     "library_ms": t["library_ms"],
                     "library_by": ("index_select" if name == "embed_expand"
                                    else "index_add_ (float atomics)"),
                     "device_ms": t["device_ms"],
                     "ms_dlrm": td["ms"], "device_ms_dlrm": td["device_ms"],
                     "plain_ms_dlrm": td["plain_ms"],
                     "bound_ms_dlrm": td["bound_ms"],
                     "library_ms_dlrm": td["library_ms"]})
        if name == "dedup_scatter_add":
            rows[-1].update({
                key + suffix: case[key]
                for key in ("ms_standalone", "device_ms_standalone",
                            "library_device_ms", "device_kernels",
                            "device_kernels_standalone", "bytes_ms_as_read")
                for suffix, case in (("", t), ("_dlrm", td))})
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from analytics_zoo_tpu_torch.ops.cuda_build import build_all
    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import \
        LIBRARY as LIBRARY_CE
    from analytics_zoo_tpu_torch.ops.pallas.embedding import \
        LIBRARY as LIBRARY_EMB
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        LIBRARY, LIBRARY_BWD)
    from analytics_zoo_tpu_torch.ops.pallas.quantized import \
        LIBRARY as LIBRARY_Q

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build_all([LIBRARY, LIBRARY_BWD, LIBRARY_CE, LIBRARY_EMB, LIBRARY_Q])
    print(f"build: flash_attention_fwd, flash_attention_bwd, "
          f"fused_cross_entropy, embedding, quantized in "
          f"{time.perf_counter() - t0:.1f}s (nvcc sm_90a, in parallel)")

    import numpy as np
    t0 = time.perf_counter()
    ncf_x, ncf_y = make_movielens_like(np.random.default_rng(0))
    print(f"ncf: {N_EXAMPLES} ratings made in {time.perf_counter() - t0:.1f}s")
    kernel_rows = kernel_phase()
    bwd_rows = bwd_kernel_phase()
    ce_rows = ce_kernel_phase()
    ce_hidden_rows = ce_hidden_phase()
    embed_rows = embed_kernel_phase(ncf_x)
    int8_rows = int8_kernel_phase()
    serving = serving_phase()
    int8_serving = int8_serving_phase(serving["records_per_s"])
    int8_head = int8_head_phase()
    training, main_ids = training_phase()
    rows = main_path_kernel_rows(main_ids, training["launches"])
    lm, lm_labels = lm_phase()
    ce_kernel_rows, flash_lm = lm_kernel_rows(lm_labels, lm["launches"],
                                              lm["ce_routes"])
    lm["fused_ce_speedup"] = fused_ce_speedup()
    for row in rows:
        row.update(flash_lm[row["name"]])
    rows += ce_kernel_rows
    fault_l = fault_l_phase()
    ncf = ncf_phase(ncf_x, ncf_y)
    captured_bert = captured_bert_phase()
    rows = embed_kernel_rows(
        embed_rows, ncf["sharded_runs"]["keyed"][0]["launches"]) + rows
    rows.append(int8_kernel_row(int8_rows, {
        "head_serving": int8_head["launches"],
        "bert_serving": int8_serving["launches"]},
        {name: int8_head["launches_by_route"][name]
         + int8_serving["launches_by_route"][name]
         for name in int8_serving["launches_by_route"]}))
    print(json.dumps({"kernel_cases": kernel_rows, "bwd_cases": bwd_rows,
                      "ce_cases": ce_rows, "ce_hidden_cases": ce_hidden_rows,
                      "embed_cases": embed_rows, "int8_cases": int8_rows,
                      "serving": serving, "int8_serving": int8_serving,
                      "int8_head": int8_head, "training": training,
                      "lm": lm, "ncf": ncf, "fault_l": fault_l,
                      "captured_bert": captured_bert, "card": card}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
