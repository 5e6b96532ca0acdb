#!/usr/bin/env python3
"""Trace full-width training steps of the PyTorch port on one GPU.

    python3 scripts/torch_train_profile.py [--model bert|lm|ncf|ncf_sharded]
                                           [--steps 3] [--trace PATH]

``--model bert`` (the default) builds the JAX package's seq-512 fine-tune
configuration as ``chip_smoke.py``'s training phase does (BERT-base,
vocab 30522, bf16 compute with f32 params, AdamW lr 2e-5, batch 32,
``zoo.pallas.attention=true``). ``--model lm`` builds its 4k causal
language model as ``chip_smoke.py``'s LM phase does (``TransformerLayer``
+ ``Dense(8192)``, seq 4096, batch 16, Adam lr 3e-4, bf16 compute, every
flag at auto, so the fused LM-head cross-entropy and the attention run
through their kernels). ``--model ncf`` builds the JAX package's NeuralCF
bench configuration as ``chip_smoke.py``'s NCF phase does (``NeuralCF(6040,
3706, 5)``, Adam lr 1e-3, batch 8192, MovieLens-1M-shaped ratings);
``--model ncf_sharded`` the same graph on ``ShardedEmbedding`` tables (the
dedup'd engine with K1 and SA). Fits a warm-up epoch of two steps, then records
``--steps`` steps of ``fit`` under ``torch.profiler``. ``--keyed`` fits with
the JAX bench's dispatch keys (``zoo.train.scan_steps=16``,
``device_cache=true``): the warm-up is a whole epoch of the same
FeatureSet, so the graphs are captured before the traced epoch, which then
replays them. Prints the card's
name and power limit, the device time per step by kernel family and for
the top kernels, the share of the traced window in which any kernel ran
(the device busy share), and one JSON summary as the last line.
``--trace`` also writes the Chrome trace. Exits non-zero without a CUDA
device or when the profiler records no device time.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: kernel families by name fragment, first match wins
FAMILIES = (
    ("fused_ce_fwd (K4)", ("ce_fwd_wgmma", "ce_fwd_mma", "ce_fwd_fma")),
    ("fused_ce_bwd_dh (K5a)", ("ce_bwd_dh_wgmma", "ce_bwd_dh_mma",
                               "ce_bwd_dh_fma")),
    ("fused_ce_bwd_dw (K5b)", ("ce_bwd_dw_wgmma", "ce_bwd_dw_mma",
                               "ce_bwd_dw_fma")),
    ("flash_attention_fwd (K2)", ("flash_fwd_wgmma", "flash_fwd_fma")),
    ("flash_attention_bwd_dq (K3a)", ("bwd_dq_wgmma", "bwd_dq_fma")),
    ("flash_attention_bwd_dkv (K3b)", ("bwd_dkv_wgmma", "bwd_dkv_fma")),
    ("embed_expand (K1)", ("expand_rows",)),
    ("dedup_scatter_add (SA)", ("segment_sum_sorted",)),
    ("sort (unique ids, SA order)", ("Sort", "sort")),
    ("gemm (cuBLAS)", ("gemm", "cutlass", "xmma", "nvjet", "gemv")),
    ("optimizer (foreach)", ("multi_tensor_apply", "foreach")),
    ("memcpy/memset", ("memcpy", "memset", "Memcpy", "Memset")),
    ("reduction", ("reduce_kernel", "Reduce", "reduce")),
    ("embedding gather/scatter", ("index", "Index", "scatter", "gather")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "elementwise/other"


def build_bert(steps: int):
    """The seq-512 BERT-base fine-tune: ``(model, x, y, batch)``."""
    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.tfpark.bert_classifier import \
        BERTClassifier
    from chip_smoke import T_BATCH, TRAIN_CFG, training_data
    init_zoo_context(conf={"zoo.pallas.attention": True,
                           "zoo.compute.dtype": "bfloat16", "zoo.seed": 0})
    model = BERTClassifier(**TRAIN_CFG, device="cuda").init_weights()
    model.compile(optimizer="adamw", loss="scce", lr=2e-5)
    x, y, _ = training_data(T_BATCH * steps)
    return model, x, y, T_BATCH


def build_lm(steps: int):
    """The 4k causal LM: ``(model, x, y, batch)``."""
    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense, TransformerLayer)
    from chip_smoke import LM_BATCH, LM_CFG, LM_SEQ, LM_VOCAB, lm_data
    init_zoo_context(conf={"zoo.compute.dtype": "bfloat16", "zoo.seed": 0})
    model = Sequential([TransformerLayer(**LM_CFG, input_shape=(LM_SEQ,)),
                        Dense(LM_VOCAB)]).init_weights()
    model.compile(optimizer="adam", loss="scce_with_logits", lr=3e-4)
    x, y = lm_data(max(LM_BATCH * steps, 2 * LM_BATCH))
    return model, x, y, LM_BATCH


def build_ncf(steps: int, sharded: bool = False):
    """The NeuralCF bench configuration, stock or on ShardedEmbedding
    tables: ``(model, x, y, batch)``."""
    import numpy as np

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from chip_smoke import (N_CLASSES, N_ITEMS, N_USERS, NCF_BATCH,
                            make_movielens_like, sharded_ncf)
    init_zoo_context(conf={"zoo.seed": 0})
    model = (sharded_ncf(N_USERS, N_ITEMS, N_CLASSES) if sharded
             else NeuralCF(N_USERS, N_ITEMS, N_CLASSES, device="cuda"))
    model.init_weights()
    model.compile(optimizer="adam", loss="scce", lr=1e-3)
    x, y = make_movielens_like(np.random.default_rng(0))
    n = NCF_BATCH * max(steps, 2)
    return model, x[:n], y[:n], NCF_BATCH


def main() -> int:
    import torch
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", choices=("bert", "lm", "ncf",
                                            "ncf_sharded"), default="bert")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--trace", default=None)
    parser.add_argument("--keyed", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import busy_share

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    builders = {"bert": build_bert, "lm": build_lm, "ncf": build_ncf,
                "ncf_sharded": lambda n: build_ncf(n, sharded=True)}
    model, x, y, batch = builders[args.model](args.steps)
    if args.keyed:
        from analytics_zoo_tpu_torch.common.context import (get_zoo_context,
                                                            init_zoo_context)
        from analytics_zoo_tpu_torch.feature.feature_set import FeatureSet
        from chip_smoke import NCF_KEYED_CONF
        init_zoo_context(conf={**get_zoo_context().conf, **NCF_KEYED_CONF})
        x, y = FeatureSet.array(x, y, seed=0), None
        model.fit(x, batch_size=batch, nb_epoch=1)       # warm-up, capture
    else:
        model.fit([a[:2 * batch] for a in x] if isinstance(x, list)
                  else x[:2 * batch], y[:2 * batch], batch_size=batch,
                  nb_epoch=1)                            # warm-up
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.fit(x, y, batch_size=batch, nb_epoch=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)

    kernels, window = [], [float("inf"), float("-inf")]
    for evt in prof.events():
        tr = evt.time_range
        window[0] = min(window[0], tr.start)
        window[1] = max(window[1], tr.end)
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((evt.name, tr.start, tr.end))
    if not kernels:
        print("torch_train_profile: the profiler recorded no device time "
              "(not measured)", file=sys.stderr)
        return 1
    by_name, by_family = {}, {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        by_family[family(name)] = by_family.get(family(name), 0.0) + (e - s)
    steps = args.steps
    device_ms = sum(by_name.values()) / 1e3 / steps
    share = busy_share([(s, e) for _, s, e in kernels], *window)
    print(f"{args.model}{' keyed' if args.keyed else ''}: {steps} steps "
          f"of {batch} in {wall:.3f}s "
          f"({1e3 * wall / steps:.1f} ms/step under the profiler); kernel "
          f"time {device_ms:.1f} ms/step; device busy {100 * share:.1f}% "
          f"of the traced window")
    print("device ms per step by family:")
    for fam, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        ms = us / 1e3 / steps
        print(f"  {ms:9.3f}  {100 * ms / device_ms:5.1f}%  {fam}")
    print("top kernels, device ms per step:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print(f"  {us / 1e3 / steps:9.3f}  {name[:110]}")
    print(json.dumps({
        "card": card, "model": args.model, "keyed": args.keyed,
        "steps": steps, "batch": batch,
        "ms_per_step_profiled": 1e3 * wall / steps,
        "kernel_ms_per_step": device_ms, "device_busy_share": share,
        "family_ms_per_step": {f: us / 1e3 / steps
                               for f, us in by_family.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
