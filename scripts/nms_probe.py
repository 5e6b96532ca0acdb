"""N1 (``csrc/nms.cu``) built alone and held to its plain version (the
torch loop, ``ops/nms.py`` ``nms_keep_mask_reference``) bit for bit on
seeded rows of boxes: SSD300's batch-32 decode shape (672 rows of 400),
a class's rows, a ragged K, one box, and K = 700 and 1024 (shared memory
above the default 48 KB); an IoU of 0.5 exactly at threshold 0.5 and a
duplicate box in the first row. Then N1's and the plain loop's device ms
at 672 x 400 (CUDA events over back-to-back calls). A short call that
checks the kernel after an edit, without ``chip_smoke.py``'s phases.

Run on a machine with a CUDA device: ``python3 scripts/nms_probe.py``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from analytics_zoo_tpu_torch.ops.nms import (  # noqa: E402
    LIBRARY, nms_keep_mask, nms_keep_mask_reference)

CASES = ((672, 400, 0.45), (21, 400, 0.5), (3, 37, 0.45), (5, 1, 0.45),
         (2, 1024, 0.5), (7, 700, 0.45))


def boxes(rows, k, g):
    xy = torch.rand(rows, k, 2, generator=g) * 0.7
    wh = torch.rand(rows, k, 2, generator=g) * 0.3 + 0.01
    b = torch.cat([xy, xy + wh], -1)
    if k >= 5:
        b[0, :5] = torch.tensor([[0, 0, .5, 1.], [0, 0, 1, 1.],
                                 [.9, 0, 1, .05], [.25, .25, .75, .75],
                                 [.25, .25, .75, .75]])
    return b.cuda()


def events_ms(fn, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("nms_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    LIBRARY.get()
    print(f"build {time.perf_counter() - t0:.1f} s")
    print(LIBRARY.build_log.strip()[-2000:])
    g = torch.Generator().manual_seed(0)
    ok = True
    for rows, k, thr in CASES:
        b = boxes(rows, k, g)
        got = nms_keep_mask(b, thr)
        same = torch.equal(got, nms_keep_mask_reference(b, thr))
        ok &= same
        print(f"{rows} x {k} at {thr}: bits {same}, kept {int(got.sum())} "
              f"of {got.numel()}")
    b = boxes(672, 400, g)
    print(f"672 x 400: N1 {events_ms(lambda: nms_keep_mask(b), 20):.4f} ms, "
          f"plain {events_ms(lambda: nms_keep_mask_reference(b), 2):.4f} ms")
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
