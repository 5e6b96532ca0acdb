"""Where the guarded step's extra device time goes at the JAX bench's
sentinel shape (``bench.py:847-914``: NCF 6040 x 3706 x 5, batch 8192,
16-step captured dispatches, Adam).

Fits the NCF once with ``zoo.train.sentinel`` off and once in recover
mode (as ``chip_smoke.py``'s ``sentinel_phase`` does), then replays each
captured 16-step block under ``torch.profiler`` and prints, per kernel
name, the device microseconds a step in each mode and their difference,
largest first, with both modes' replay time by CUDA events; then the
kernels of one step of each mode matched by name in order, where the
guarded one runs slower. Modes are replayed in turns, ``--rounds``
times.

Run on a machine with a CUDA device:
``python3 scripts/sentinel_kernels.py [--rounds 3] [--out FILE.json]``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH = 16, 8192
USERS, ITEMS, CLASSES = 6040, 3706, 5


def fit(mode):
    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import reset_uids
    rng = np.random.default_rng(11)
    n = STEPS * BATCH
    x = np.stack([rng.integers(1, USERS + 1, n),
                  rng.integers(1, ITEMS + 1, n)], axis=1).astype(np.int32)
    y = rng.integers(0, CLASSES, n).astype(np.int32)
    init_zoo_context(conf={"zoo.seed": 0, "zoo.compute.dtype": "float32",
                           "zoo.train.scan_steps": STEPS,
                           "zoo.train.sentinel": mode})
    reset_uids()
    model = NeuralCF(USERS, ITEMS, CLASSES, device="cuda").init_weights()
    model.compile(optimizer="adam", loss="scce", lr=1e-3)
    model.fit(x, y, batch_size=BATCH, nb_epoch=1, shuffle=False)
    return model


def profile(program, reps=3):
    """(event ms a step, {kernel name: device us a step}) over ``reps``
    replays of the block."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    seeds = list(range(STEPS))
    program.replay(STEPS, seeds)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        program.replay(STEPS, seeds)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps / STEPS
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            program.replay(STEPS, seeds)
        torch.cuda.synchronize()
    per = collections.Counter()
    kernels = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per[ev.name[:240]] += ev.device_time_total
            kernels.append((ev.time_range.start, ev.name[:240],
                            ev.device_time_total))
    kernels.sort()
    # the kernels of one step in order (the last step of the last replay)
    step = kernels[-(len(kernels) // (reps * STEPS)):]
    return ms, {k: v / reps / STEPS for k, v in per.items()}, [
        (name, us) for _, name, us in step]


def matched_slower(off, rec, min_us=0.2):
    """The kernels of the off step and the guarded step matched by name in
    order (``difflib``), with their device us, where the guarded one is
    slower by ``min_us`` or more: ``(position in the guarded step, name,
    off us, guarded us)``."""
    import difflib
    sm = difflib.SequenceMatcher(a=[n for n, _ in off],
                                 b=[n for n, _ in rec], autojunk=False)
    out = []
    for tag, i0, i1, j0, _ in sm.get_opcodes():
        if tag != "equal":
            continue
        for k in range(i1 - i0):
            (name, a), (_, b) = off[i0 + k], rec[j0 + k]
            if b - a >= min_us:
                out.append((j0 + k, name, a, b))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    models = {mode: fit(mode) for mode in ("off", "recover")}
    runs = {"off": [], "recover": []}
    for _ in range(args.rounds):
        for mode, model in models.items():
            runs[mode].append(profile(model._loop._program[1]))
    out = {}
    slower = matched_slower(runs["off"][-1][2], runs["recover"][-1][2])
    for mode, rs in runs.items():
        names = set().union(*(r[1] for r in rs))
        out[mode] = {"ms": [r[0] for r in rs],
                     "us": {k: float(np.median([r[1].get(k, 0.0)
                                                for r in rs]))
                            for k in names}}
    diff = {k: out["recover"]["us"].get(k, 0.0) - out["off"]["us"].get(k, 0.0)
            for k in set(out["recover"]["us"]) | set(out["off"]["us"])}
    print(f"{torch.cuda.get_device_name(0)}; event ms a step: off "
          f"{out['off']['ms']}, recover {out['recover']['ms']}")
    print(f"kernel us a step: off {sum(out['off']['us'].values()):.2f}, "
          f"recover {sum(out['recover']['us'].values()):.2f}")
    for k, d in sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:12]:
        print(f"  {d:+8.3f} us  (off {out['off']['us'].get(k, 0.0):7.3f}, "
              f"recover {out['recover']['us'].get(k, 0.0):7.3f})  {k}")
    print(f"kernels a step: off {len(runs['off'][-1][2])}, recover "
          f"{len(runs['recover'][-1][2])}; matched kernels slower guarded "
          f"(position, us off -> recover):")
    for pos, name, a, b in slower:
        print(f"  #{pos} {a:7.3f} -> {b:7.3f}  {name[:160]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"modes": out, "diff_us": diff,
                       "matched_slower": slower,
                       "steps": {m: rs[-1][2] for m, rs in runs.items()}},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
