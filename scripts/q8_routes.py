#!/usr/bin/env python3
"""Time Q8, the static int8 dense layer (``csrc/quantized.cu``), on each
of its routes on one GPU, where the plan's crossovers are read:

    python3 scripts/q8_routes.py [--out PATH]

Cases: config A's Dense(4096) layer (K = N = 4096) at 1, 2, 4, 5, 6, 7,
8, 9, 12, 16, 24 and 32 rows; VGG-16's fc6 (25088 -> 4096) and fc8 (4096
-> 1000) at 1 and 32 rows; TextClassifier's Dense(128) and Dense(20) at
32 rows; each with the bias and the fused ReLU. Each case runs every route
that takes it (``q8_dp4a`` always, ``q8_wgmma_xq`` where K % 16 == 0),
the wrapper's plan replaced by that route's own (``forced``). Every
route's output is held bit for bit to the plain version on the card
(``static_int8_dense_reference``: the torch ops and the padded
``torch._int_mm``) and to its own second run. Times: the device time of a
CUDA-graph replay of 20 calls, the routes in turns (in order, then in
reverse) and each the mean of its two runs; where the weights are above 8
MB, the calls rotate over enough copies to exceed the 50 MB L2. Beside
them: the plan's route and splits, ``torch._int_mm`` on the padded int8
operands alone (the library's call for the product), and the bound (the
bytes, or 2 M K N operations at the int8 peak). At 32 rows of config A's
layer and of fc6, one call of each route is profiled (``torch.
profiler``): each kernel's device time and its start after the call's
first kernel. Where the plan takes the tensor-core route, that route is
also timed at 1, 2, 4 and 8 K splits (those the shape allows). Times use
``chip_smoke.py``'s ``graph_ms``. Prints the card's name and power
limit, one line a case and the JSON summary last (also written to
``--out``). Exits non-zero without a CUDA device or on a mismatch.
"""

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from analytics_zoo_tpu_torch.ops.cuda_build import build_all  # noqa: E402
from analytics_zoo_tpu_torch.ops.pallas import quantized as pq  # noqa: E402
from chip_smoke import graph_ms  # noqa: E402

CASES = ([(m, 4096, 4096) for m in (1, 2, 4, 5, 6, 7, 8, 9, 12, 16, 24,
                                    32)]
         + [(1, 25088, 4096), (32, 25088, 4096), (1, 4096, 1000),
            (32, 4096, 1000), (32, 256, 128), (32, 128, 20)])
PEAK_INT8, PEAK_BYTES = 1979e12, 3.35e12


def bound_ms(m, k, n):
    t_bytes = (m * k * 4 + 4 + k * n + n * 8 + m * n * 4) / PEAK_BYTES
    t_ops = 2.0 * m * n * k / PEAK_INT8
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def cycling(fn, copies):
    state = [0]

    def call():
        j = state[0]
        state[0] = (j + 1) % copies
        return fn(j)
    return call


ROUTE_PLANS = {"q8_dp4a": pq._plan_dp4a, "q8_wgmma_xq": pq._plan_wgmma}


@contextlib.contextmanager
def forced(plan):
    """``static_plan`` replaced by one ``(route, splits, per)`` while the
    block runs."""
    real = pq.static_plan
    pq.static_plan = lambda *a: plan
    try:
        yield plan
    finally:
        pq.static_plan = real


def split_plan(route, splits, steps):
    """``route`` with ``splits`` K splits over ``steps`` steps (``per``
    rounded up, as the plan does)."""
    per = -(-steps // splits)
    return route, -(-steps // per), per


def kernel_times(fn):
    """One call of ``fn`` profiled: ``[(kernel, start us after the first
    kernel's start, device us)]``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return []
    t0 = min(e.time_range.start for e in evs)
    return [(e.name[:60], e.time_range.start - t0,
             e.time_range.end - e.time_range.start)
            for e in sorted(evs, key=lambda e: e.time_range.start)]


def same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("q8_routes: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    build_all([pq.LIBRARY, pq.LIBRARY_CONV])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok, result = True, {"card": card, "sms": sms, "cases": {}}
    for m, k, n in CASES:
        g = torch.Generator().manual_seed(m * 7 + k + n)
        copies = math.ceil(64e6 / (k * n)) if k * n > 8e6 else 1
        x = (torch.randn(m, k, generator=g) * 3.0).cuda()
        xs = torch.tensor(0.05).cuda()
        ws = [torch.randint(-127, 128, (k, n), generator=g,
                            dtype=torch.int8).cuda() for _ in range(copies)]
        sc = (torch.rand(n, generator=g) * 0.02 + 0.001).cuda()
        bias = (torch.randn(n, generator=g) * 2.0).cuda()
        want = pq.static_int8_dense_reference(x, xs, ws[0], sc, bias, True)
        routes = ["q8_dp4a"] + (["q8_wgmma_xq"]
                                if pq.static_takes_wgmma(k) else [])
        plans = {r: ROUTE_PLANS[r](m, k, n, sms) for r in routes}
        row = {"m": m, "k": k, "n": n, "weight_copies": copies,
               "plan": pq.static_plan(m, k, n, sms), "routes": {}}
        for route in routes:
            with forced(plans[route]):
                got = pq.static_int8_dense(x, xs, ws[0], sc, bias, True)
                again = pq.static_int8_dense(x, xs, ws[0], sc, bias, True)
            torch.cuda.synchronize()
            same = same_bits(got, want) and same_bits(got, again)
            ok &= same
            row["routes"][route] = {"bit_equal": same,
                                    "splits": plans[route][1],
                                    "device_ms": []}
        order = routes + routes[::-1]
        for route in order:
            with forced(plans[route]):
                row["routes"][route]["device_ms"].append(graph_ms(cycling(
                    lambda j: pq.static_int8_dense(x, xs, ws[j], sc, bias,
                                                   True),
                    copies)))
        for r in row["routes"].values():
            r["device_ms"] = sum(r["device_ms"]) / len(r["device_ms"])
        if row["plan"][0] != "q8_dp4a":
            route = row["plan"][0]
            steps = -(-k // 128)
            row["by_splits"] = {}
            for sp in (1, 2, 4, 8):
                if sp > pq.STATIC_WGMMA_MAX_SPLITS or (sp > 1 and sp > steps // 2):
                    continue
                with forced(split_plan(route, sp, steps)) as plan:
                    got = pq.static_int8_dense(x, xs, ws[0], sc, bias, True)
                    ok &= same_bits(got, want)
                    row["by_splits"][str(plan[1])] = graph_ms(cycling(
                        lambda j: pq.static_int8_dense(
                            x, xs, ws[j], sc, bias, True),
                        copies))
        if m == 32 and k in (4096, 25088) and n == 4096:
            row["profile"] = {}
            for r in routes:
                with forced(plans[r]):
                    row["profile"][r] = kernel_times(
                        lambda: pq.static_int8_dense(x, xs, ws[0], sc, bias,
                                                     True))
        xq = pq.quantize_static(x, xs)
        xq_pad = torch.nn.functional.pad(xq, (0, max(128, k + -k % 8) - k,
                                              0, max(17 - m, 0)))
        w_pad = [torch.nn.functional.pad(w, (0, -n % 8,
                                             0, max(128, k + -k % 8) - k))
                 for w in ws]
        row["int_mm_device_ms"] = graph_ms(cycling(
            lambda j: torch._int_mm(xq_pad, w_pad[j]), copies))
        row["bound_ms"], row["bound_by"] = bound_ms(m, k, n)
        result["cases"][f"{m}x{k}x{n}"] = row
        print(f"q8 route case {json.dumps(row)}")
        del x, ws, w_pad
    print("OK" if ok else "MISMATCH")
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
