#!/usr/bin/env python3
"""``chip_smoke.py``'s fleet phase at several reclaim idles, on one GPU:
whether part (c), a replica killed with a batch in flight and reclaimed
by two survivors, writes every result once. A reclaim takes any pending
entry idle past ``claim_idle_ms``, a live survivor's too, so the phase
holds only while a survivor reads, dispatches and acks within it.

    python3 scripts/fleet_claim_idle.py IDLE_MS [IDLE_MS ...] [--out PATH]

Each ``IDLE_MS`` is one run of the whole phase with
``FLEET_CLAIM_IDLE_MS`` set to it (give them in turns, e.g. ``500 2000
500 2000``). A run that fails a check is recorded with its message and
the next one goes on. Prints the card's name and power limit, the phase's
own lines, a ``RUN`` line a run (the idle, pass or the failure, the
entries reclaimed by previous owner, the survivors' dispatch-to-publish
p99, the kill to the last reclaimed answer) and the list of runs as JSON
last (also written to ``--out``). Exits non-zero without a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from analytics_zoo_tpu_torch.ops.cuda_build import build_all  # noqa: E402
from analytics_zoo_tpu_torch.ops.pallas.flash_attention import (  # noqa: E402
    LIBRARY, LIBRARY_BWD)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("idle_ms", type=int, nargs="+")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fleet_claim_idle: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all([LIBRARY, LIBRARY_BWD])
    runs = []
    for idle in args.idle_ms:
        chip_smoke.FLEET_CLAIM_IDLE_MS = idle
        t0 = time.perf_counter()
        try:
            kr = chip_smoke.fleet_phase()["kill_reclaim"]
            run = {"idle_ms": idle, "ok": True,
                   "reclaimed": kr["reclaimed"],
                   "dispatch_p99_ms": kr["dispatch_p99_ms"],
                   "kill_to_reclaimed_s": kr["kill_to_reclaimed_s"]}
        except Exception as e:
            traceback.print_exc()
            run = {"idle_ms": idle, "ok": False, "error": str(e)}
        run["seconds"] = time.perf_counter() - t0
        runs.append(run)
        print("RUN", json.dumps(run), flush=True)
    print(json.dumps(runs))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
