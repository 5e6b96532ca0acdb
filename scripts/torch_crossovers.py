#!/usr/bin/env python3
"""Measure the two crossovers the port keeps from the JAX package, on one
GPU.

    python3 scripts/torch_crossovers.py [--out PATH]

1. Attention: one ``MultiHeadSelfAttention`` forward and backward (bf16
   compute, f32 weights) with ``zoo.pallas.attention`` forced true (K2,
   K3a, K3b) against forced false (the oracle route: batched products and
   a softmax), at T = 256, 512, 1024, 2048 and 4096, at BERT-base's width
   (batch 32, hidden 768, 12 heads, bidirectional, every key kept) and
   the LM's (batch 16, hidden 512, 8 heads, causal). The JAX package
   hands attention to the flash kernel on ``auto`` from T = 2048
   (``FLASH_AUTO_MIN_SEQ``).
2. The LM-head loss: one forward and backward (gradients of h, W and b)
   of the fused LM-head cross-entropy (K4, K5a, K5b) against the
   full-logits objective as ``Dense`` + ``scce_with_logits`` run it, at
   V = 256, 512, 1024, 2048, 4096 and 8192, N = 65,536 rows, H = 512,
   bf16 h, f32 W and b, with each one's peak memory above its inputs.
   ``zoo.train.fused_ce=auto`` engages from V = 1024 (``AUTO_MIN_VOCAB``).

Each case is the mean device time of 10 calls after 3 warm-ups (CUDA
events), the two routes timed in turns (a, b, b, a) and each the mean of
its two runs; a route that runs out of device memory reads ``inf`` (the
oracle's f32 score matrices at BERT's width and T = 4096). Prints the card's name and power limit, one line a case,
the smallest T (V) from which the kernels win at every larger size, and
one JSON summary as the last line (also written to ``--out``). Exits
non-zero without a CUDA device. The constants are not changed here.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQS = (256, 512, 1024, 2048, 4096)
VOCABS = (256, 512, 1024, 2048, 4096, 8192)
#: (name, batch, hidden, heads, causal)
WIDTHS = (("bert_base", 32, 768, 12, False), ("lm", 16, 512, 8, True))
CE_ROWS, CE_HIDDEN = 65536, 512


def device_ms(fn, iters=10, warmup=3):
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


def in_turns(time_a, time_b):
    """Each route's mean ms over runs a, b, b, a (``time_a()`` and
    ``time_b()`` each time one run)."""
    a1, b1, b2, a2 = time_a(), time_b(), time_b(), time_a()
    return (a1 + a2) / 2, (b1 + b2) / 2


def crossover(sizes, kernel_ms, other_ms):
    """The smallest size from which the kernels are faster at every
    larger size measured, or None."""
    best = None
    for size, k, o in reversed(list(zip(sizes, kernel_ms, other_ms))):
        if k >= o:
            break
        best = size
    return best


def attention_sweep():
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
        MultiHeadSelfAttention
    out = {}
    for name, batch, hidden, heads, causal in WIDTHS:
        rows = []
        for t in SEQS:
            init_zoo_context(conf={"zoo.compute.dtype": "bfloat16"})
            layer = MultiHeadSelfAttention(hidden, heads, causal=causal)
            layer.build(generator=torch.Generator().manual_seed(0))
            layer.to("cuda")
            g = torch.Generator().manual_seed(1)
            x = torch.randn(batch, t, hidden, generator=g).to(
                "cuda", torch.bfloat16).requires_grad_()
            dy = torch.randn(batch, t, hidden, generator=g).to(
                "cuda", torch.bfloat16)

            def run():
                y = layer(x)
                torch.autograd.grad(y, [x] + list(layer.parameters()), dy)

            def route(flash):
                def time_it():
                    init_zoo_context(conf={"zoo.compute.dtype": "bfloat16",
                                           "zoo.pallas.attention": flash})
                    try:
                        return device_ms(run)
                    except torch.OutOfMemoryError:
                        # the oracle's f32 score matrices outgrow the card
                        torch.cuda.empty_cache()
                        return float("inf")
                return time_it
            flash_ms, oracle_ms = in_turns(route(True), route(False))
            oom = oracle_ms == float("inf")
            rows.append({"seq": t, "flash_ms": flash_ms,
                         "oracle_ms": None if oom else oracle_ms})
            print(f"attention {name} B={batch} H={hidden} heads={heads} "
                  f"causal={causal} T={t}: flash {flash_ms:.4f} ms, oracle "
                  + ("out of memory" if oom else f"{oracle_ms:.4f} ms")
                  + " (fwd+bwd)", flush=True)
            del layer, x, dy
            torch.cuda.empty_cache()
        out[name] = {"cases": rows, "crossover_seq": crossover(
            SEQS, [r["flash_ms"] for r in rows],
            [float("inf") if r["oracle_ms"] is None else r["oracle_ms"]
             for r in rows])}
    return out


def ce_sweep():
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.ops.fused_cross_entropy import \
        fused_sparse_cross_entropy
    from analytics_zoo_tpu_torch.pipeline.api.keras import objectives
    init_zoo_context(conf={"zoo.compute.dtype": "bfloat16"})
    rows = []
    for v in VOCABS:
        rng = np.random.default_rng(11)
        h = torch.from_numpy(rng.normal(size=(CE_ROWS, CE_HIDDEN)).astype(
            np.float32)).to("cuda", torch.bfloat16).requires_grad_()
        w = torch.from_numpy(rng.normal(size=(CE_HIDDEN, v)).astype(
            np.float32) * 0.02).cuda().requires_grad_()
        b = torch.zeros(v, device="cuda", requires_grad=True)
        y = torch.from_numpy(rng.integers(0, v, CE_ROWS).astype(
            np.int32)).cuda()

        def full():
            logits = torch.matmul(h, w.to(h.dtype)) + b.to(h.dtype)
            torch.autograd.grad(
                objectives.sparse_categorical_crossentropy_from_logits(
                    y, logits), (h, w, b))

        def fused():
            torch.autograd.grad(fused_sparse_cross_entropy(y, h, w, b),
                                (h, w, b))

        fused_ms, full_ms = in_turns(lambda: device_ms(fused),
                                     lambda: device_ms(full))
        peaks = {}
        for tag, fn in (("fused", fused), ("full", full)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peaks[tag] = torch.cuda.max_memory_allocated() - base
        rows.append({"vocab": v, "fused_ms": fused_ms, "full_ms": full_ms,
                     "fused_peak_bytes": peaks["fused"],
                     "full_peak_bytes": peaks["full"]})
        print(f"lm head N={CE_ROWS} H={CE_HIDDEN} V={v}: fused "
              f"{fused_ms:.4f} ms, full logits {full_ms:.4f} ms (fwd+bwd); "
              f"peak {peaks['fused'] / 1e9:.3f} / {peaks['full'] / 1e9:.3f} "
              f"GB", flush=True)
        del h, w, b, y
        torch.cuda.empty_cache()
    return {"cases": rows, "crossover_vocab": crossover(
        VOCABS, [r["fused_ms"] for r in rows],
        [r["full_ms"] for r in rows])}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write the JSON summary to this file")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_crossovers: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from analytics_zoo_tpu_torch.ops.cuda_build import build_all
    from analytics_zoo_tpu_torch.ops.pallas.cross_entropy import \
        LIBRARY as LIBRARY_CE
    from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (
        LIBRARY, LIBRARY_BWD)
    from analytics_zoo_tpu_torch.ops.fused_cross_entropy import \
        AUTO_MIN_VOCAB
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
        MultiHeadSelfAttention
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all([LIBRARY, LIBRARY_BWD, LIBRARY_CE])
    summary = {"card": card,
               "FLASH_AUTO_MIN_SEQ": MultiHeadSelfAttention.FLASH_AUTO_MIN_SEQ,
               "AUTO_MIN_VOCAB": AUTO_MIN_VOCAB,
               "attention": attention_sweep(), "lm_head": ce_sweep()}
    for name, sweep in summary["attention"].items():
        print(f"attention {name}: flash wins from T = "
              f"{sweep['crossover_seq']} (FLASH_AUTO_MIN_SEQ "
              f"{summary['FLASH_AUTO_MIN_SEQ']})")
    print(f"lm head: fused wins from V = "
          f"{summary['lm_head']['crossover_vocab']} (AUTO_MIN_VOCAB "
          f"{AUTO_MIN_VOCAB})")
    line = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
