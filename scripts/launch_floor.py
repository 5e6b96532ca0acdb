#!/usr/bin/env python3
"""The floor of one kernel launch on one GPU: the device time of an empty
kernel under the CUDA-graph timing ``chip_smoke.py`` gives every kernel
(``graph_ms``: 20 launches captured in one graph, replayed between two
events, the time divided by the launches), the yardstick for the
guarded step's two smallest kernels, G1 and G2 (``csrc/guard.cu``),
which ``chip_smoke.py``'s sentinel phase times the same way.

    python3 scripts/launch_floor.py [--out PATH]

The empty kernel is built with the port's own ``nvcc`` path
(``ops/cuda_build.py``) from a source this script writes under
``build/launch_floor/``, launched as one block of 32 threads and as one
of 256, each timed three times in turns. Prints the card's name and
power limit and one JSON line (also written to ``--out``). Exits
non-zero without a CUDA device.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from analytics_zoo_tpu_torch.ops.cuda_build import (  # noqa: E402
    BUILD_DIR, CudaLibrary, build_all, launch)
from chip_smoke import graph_ms  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int launch_empty(int threads, cudaStream_t stream) {
  empty_kernel<<<1, threads, 0, stream>>>();
  return (int)cudaGetLastError();
}
"""


def _bind(lib):
    lib.launch_empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.launch_empty.restype = ctypes.c_int


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("launch_floor: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    src_dir = BUILD_DIR / "launch_floor"
    src_dir.mkdir(parents=True, exist_ok=True)
    (src_dir / "empty.cu").write_text(SOURCE)
    lib = CudaLibrary("launch_floor", ["empty.cu"], _bind, src_dir=src_dir)
    build_all([lib])
    probe = torch.zeros(1, device="cuda")

    def empty(threads):
        def call():
            err = launch(lib.entry("launch_empty"), probe, threads)
            if err:
                raise RuntimeError(f"empty kernel: CUDA error {err}")
        return call
    cases = {"empty_1x32": empty(32), "empty_1x256": empty(256)}
    times = {name: [] for name in cases}
    for _ in range(3):
        for name, fn in cases.items():
            times[name].append(graph_ms(fn))
    result = {"card": card, "graph_ms": {
        name: {"mean": sum(t) / len(t), "runs": t}
        for name, t in times.items()}}
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
