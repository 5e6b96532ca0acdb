#!/usr/bin/env python3
"""Where the 32k causal LM's training step holds device memory in each
``zoo.train.remat`` mode, on one GPU.

    python3 scripts/torch_remat_memory.py [--modes false,dots,full]
                                          [--out PATH]

Builds the JAX bench's 32k long-context configuration as
``chip_smoke.py``'s 32k phase does (``TransformerLayer`` + ``Dense(8192)``,
seq 32768, batch 1, 4 blocks, hidden 512, 8 heads, bf16 compute over f32
parameters, Adam 3e-4, every other flag at auto) and, in each mode, fits
two epochs of 4 steps eagerly. For every step it prints the memory
allocated before the step, the peak above that in the forward and
backward (``TrainingLoop._grads``) and in the whole step, and the memory
allocated after it: memory that a step leaves behind shows as a rise of
"after" from step to step. The sixth step is recorded with
``torch.cuda.memory._record_memory_history`` (with the checkpoint's
early stop off, whose exception the recorder cannot walk) and replayed: the
allocations made in that step and live at its peak, grouped by the
innermost frame in the port (or "autograd engine" for an allocation with
no Python frame, made by a built-in backward on the engine's thread),
largest first. Prints the card's name and power limit, and one JSON
summary as the last line (also written to ``--out``). Exits non-zero
without a CUDA device.
"""

import argparse
import collections
import contextlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: chip_smoke.py's LC_* (bench.py:424-428)
SEQ, BATCH, SEQS, VOCAB = 32768, 1, 4, 8192
CFG = dict(vocab=VOCAB, seq_len=SEQ, n_block=4, hidden_size=512, n_head=8,
           hidden_drop=0.0, attn_drop=0.0, embedding_drop=0.0,
           bidirectional=False)
#: the step whose allocations are recorded (0-based, over both epochs)
RECORDED = 5
PORT = "analytics_zoo_tpu_torch"


def frame_key(frames):
    """The innermost frame of the port among ``frames`` (innermost first)
    as ``path:line name``; else the innermost frame; else the engine."""
    for f in frames:
        name = f.get("filename", "")
        if PORT in name:
            return (f"{name[name.index(PORT):]}:{f.get('line')} "
                    f"{f.get('name')}")
    if frames:
        f = frames[0]
        return f"{f.get('filename')}:{f.get('line')} {f.get('name')}"
    return "autograd engine (no Python frame)"


def live_at_peak(trace, before):
    """Replays one step's allocator trace from ``before`` bytes allocated:
    ``(peak, [(key, bytes, count)...])``, the allocations of the step
    live at its peak grouped by :func:`frame_key`."""
    def replay(stop=None):
        live, total, peak, at = {}, before, before, -1
        for i, ev in enumerate(trace):
            action = ev.get("action")
            if action == "alloc":
                live[ev["addr"]] = ev
                total += ev["size"]
            elif action in ("free_requested", "free_completed"):
                if ev["addr"] in live:
                    total -= live.pop(ev["addr"])["size"]
                elif action == "free_requested":
                    total -= ev["size"]      # allocated before the step
            if total > peak:
                peak, at = total, i
            if i == stop:
                return live
        return peak, at
    peak, at = replay()
    groups = collections.defaultdict(lambda: [0, 0])
    for ev in (replay(at) if at >= 0 else {}).values():
        g = groups[frame_key(ev.get("frames") or [])]
        g[0] += ev["size"]
        g[1] += 1
    return peak, sorted(((k, b, n) for k, (b, n) in groups.items()),
                        key=lambda r: -r[1])


def run_mode(mode):
    import numpy as np
    import torch
    from torch.utils.checkpoint import set_checkpoint_early_stop

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Dense, TransformerLayer)
    init_zoo_context(conf={"zoo.compute.dtype": "bfloat16", "zoo.seed": 0,
                           "zoo.pallas.attention": "auto",
                           "zoo.pallas.cross_entropy": "auto",
                           "zoo.train.fused_ce": "auto",
                           "zoo.train.remat": mode})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(7)
    x = rng.integers(0, VOCAB, (SEQS, SEQ)).astype(np.int32)
    y = ((7 * x + 13) % VOCAB).astype(np.int32)
    model = Sequential([TransformerLayer(**CFG, input_shape=(SEQ,)),
                        Dense(VOCAB)]).init_weights()
    model.compile(optimizer="adam", loss="scce_with_logits", lr=3e-4)
    loop = model._loop
    grads_fn, step_fn = loop._grads, loop.train_step
    steps, recorded = [], {}

    def grads(*args):
        out = grads_fn(*args)
        torch.cuda.synchronize()
        steps[-1]["grads_peak"] = (torch.cuda.max_memory_allocated()
                                   - steps[-1]["before"])
        steps[-1]["after_grads"] = torch.cuda.memory_allocated()
        return out

    def step(*args, **kwargs):
        torch.cuda.synchronize()
        steps.append({"before": torch.cuda.memory_allocated()})
        torch.cuda.reset_peak_memory_stats()
        record = len(steps) - 1 == RECORDED
        if record:
            torch.cuda.memory._record_memory_history(
                max_entries=1_000_000, stacks="python")
        # the recompute's early stop raises through the forward, and the
        # recorder's frame walk fails while that exception is in flight,
        # so the recorded step recomputes to the loss (two scalar ops more)
        with (set_checkpoint_early_stop(False) if record
              else contextlib.nullcontext()):
            out = step_fn(*args, **kwargs)
        torch.cuda.synchronize()
        s = steps[-1]
        s["step_peak"] = torch.cuda.max_memory_allocated() - s["before"]
        s["after"] = torch.cuda.memory_allocated()
        if record:
            snap = torch.cuda.memory._snapshot()
            torch.cuda.memory._record_memory_history(enabled=None)
            trace = snap["device_traces"][torch.cuda.current_device()]
            recorded["peak"], recorded["groups"] = live_at_peak(
                trace, s["before"])
            recorded["events"] = len(trace)
        return out

    loop._grads, loop.train_step = grads, step
    model.fit(x, y, batch_size=BATCH, nb_epoch=1)
    model.fit(x, y, batch_size=BATCH, nb_epoch=1)
    print(f"remat={mode}: params "
          f"{sum(p.numel() for p in model.parameters())}")
    for i, s in enumerate(steps):
        print(f"remat={mode} step {i}: allocated before "
              f"{s['before'] / 1e9:.4f} GB, peak above it "
              f"{s['grads_peak'] / 1e9:.4f} GB in forward and backward, "
              f"{s['step_peak'] / 1e9:.4f} GB in the step; after the "
              f"backward {s['after_grads'] / 1e9:.4f} GB, after the step "
              f"{s['after'] / 1e9:.4f} GB", flush=True)
    if recorded:
        print(f"remat={mode} step {RECORDED}: {recorded['events']} allocator "
              f"events, replayed peak {recorded['peak'] / 1e9:.4f} GB "
              f"(allocated, the step's live allocations by frame):")
        for key, b, n in recorded["groups"][:14]:
            print(f"  {b / 1e6:10.1f} MB in {n:4d}  {key}")
    out = {"mode": mode, "steps": steps,
           "recorded_step": RECORDED,
           "recorded_peak": recorded.get("peak"),
           "live_at_peak": [{"where": k, "bytes": b, "count": n}
                            for k, b, n in recorded.get("groups", [])[:30]]}
    del model, loop
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_remat_memory: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--modes", default="false,dots,full")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    summary = {"modes": [run_mode(m) for m in args.modes.split(",")]}
    line = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
