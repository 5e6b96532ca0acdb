#!/usr/bin/env python3
"""Time the phases of N1, the batched NMS keep-mask (``csrc/nms.cu``), on
one GPU: where a row's time goes between loading the boxes, the IoU
phase (the upper triangle's ``iou > threshold`` bits) and the greedy scan.

    python3 scripts/nms_phases.py [--source NAME=PATH ...] [--out PATH]

Each source (``csrc/nms.cu`` as ``current``, and any ``--source``, such as
an earlier version of the kernel) is built four times under
``build/nms_phases/``, with ``NMS_PHASES`` defined as 3 (every phase), 1
(no scan), 2 (no IoU phase: a zeroed mask, so the scan keeps every box)
and 0 (the load and the output alone); a source must read the macro as
``csrc/nms.cu`` does. The rows are SSD300's batch-32 decode shape, 672
rows of 400 boxes at threshold 0.45, drawn two ways from a seed:
``uniform`` (corners uniform in [0, 0.7], sides in [0.01, 0.31], as
``scripts/nms_probe.py`` draws them) and ``clustered`` (each row's boxes
jittered around four centres, as a class's candidates gather on a few
objects). Each variant's time is the device time of a CUDA-graph replay
of 20 launches, the variants in turns (in order, then in reverse) and
each the mean of its two runs; the full builds are checked bit for bit
against ``nms_keep_mask_reference``. Times use ``chip_smoke.py``'s
``graph_ms``. Prints the card's name and power limit, one line a case
and the JSON summary last (also written to ``--out``). Exits non-zero
without a CUDA device or on a mismatch.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from analytics_zoo_tpu_torch.ops import nms as nms_ops  # noqa: E402
from analytics_zoo_tpu_torch.ops.cuda_build import (  # noqa: E402
    BUILD_DIR, CudaLibrary, build_all, launch)

ROWS, K, THRESHOLD = 672, 400, 0.45
PHASES = {"all": 3, "no_scan": 1, "no_iou": 2, "load_only": 0}


def boxes(kind, g):
    if kind == "uniform":
        xy = torch.rand(ROWS, K, 2, generator=g) * 0.7
        wh = torch.rand(ROWS, K, 2, generator=g) * 0.3 + 0.01
    else:
        centre = torch.rand(ROWS, 4, 2, generator=g) * 0.6 + 0.1
        pick = torch.randint(0, 4, (ROWS, K), generator=g)
        side = torch.rand(ROWS, 4, 2, generator=g) * 0.2 + 0.1
        c = torch.gather(centre, 1, pick[..., None].expand(-1, -1, 2))
        s = torch.gather(side, 1, pick[..., None].expand(-1, -1, 2))
        c = c + (torch.rand(ROWS, K, 2, generator=g) - 0.5) * s * 0.6
        wh = s * (0.7 + 0.6 * torch.rand(ROWS, K, 2, generator=g))
        xy = c - wh / 2
    return torch.cat([xy, xy + wh], -1).clamp(0.0, 1.0).cuda()


def variant(name, path, phases):
    src_dir = BUILD_DIR / "nms_phases" / f"{name}_{phases}"
    src_dir.mkdir(parents=True, exist_ok=True)
    with open(path) as f:
        text = f.read()
    (src_dir / "nms.cu").write_text(f"#define NMS_PHASES {phases}\n{text}")
    return CudaLibrary(f"nms_{name}_{phases}", ["nms.cu"], nms_ops._bind,
                       src_dir=src_dir)


def run(lib, b, threshold=THRESHOLD):
    """One launch of ``lib``'s N1 on the rows of ``b (..., K, 4)``."""
    keep = torch.empty(b.shape[:-1], dtype=torch.bool, device=b.device)
    k = b.shape[-2]
    err = launch(lib.entry("nms_keep"), b, b.data_ptr(), keep.numel() // k,
                 k, threshold, keep.data_ptr())
    if err:
        raise RuntimeError(f"nms_keep: CUDA error {err}")
    return keep


def phase_ms(libs, b, graph_ms, threshold=THRESHOLD):
    """Each of ``libs`` (name -> library) timed on ``b`` by ``graph_ms``
    (``chip_smoke.py``'s) in turns (in order, then in reverse): ``{name:
    [device ms, device ms]}``."""
    times = {key: [] for key in libs}
    for key in list(libs) + list(libs)[::-1]:
        times[key].append(graph_ms(lambda: run(libs[key], b, threshold)))
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH of another nms.cu to time")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("nms_phases: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import graph_ms
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    sources = {"current": os.path.join(REPO, "analytics_zoo_tpu_torch",
                                       "csrc", "nms.cu")}
    for spec in args.source:
        name, _, path = spec.partition("=")
        sources[name] = path
    libs = {(name, ph): variant(name, path, code)
            for name, path in sources.items() for ph, code in PHASES.items()}
    build_all(list(libs.values()))
    g = torch.Generator().manual_seed(24)
    sets = {kind: boxes(kind, g) for kind in ("uniform", "clustered")}
    ok, result = True, {"card": card, "rows": ROWS, "k": K,
                        "threshold": THRESHOLD, "cases": {}}
    for kind, b in sets.items():
        want = nms_ops.nms_keep_mask_reference(b, THRESHOLD)
        for name in sources:
            same = torch.equal(run(libs[(name, "all")], b), want)
            ok &= same
            result["cases"][f"{kind}/{name}/bit_equal"] = same
        result["cases"][f"{kind}/kept"] = int(want.sum())
        for (name, ph), ms in phase_ms(libs, b, graph_ms).items():
            row = {"set": kind, "source": name, "phases": ph,
                   "device_ms": sum(ms) / len(ms), "runs": ms}
            result["cases"][f"{kind}/{name}/{ph}"] = row
            print(f"nms phase case {json.dumps(row)}")
    print("OK" if ok else "MISMATCH")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
