#!/usr/bin/env python3
"""Where G2's time goes (``csrc/guard.cu`` ``guard_check_kernel``, given
the step's gradients): the warps' loads and sums, the last warps'
per-tensor norms and norm of norms, and what is left (the tickets, the
scalar chain, the launch); and what its descriptors' size costs.

    python3 scripts/g2_phases.py [--rounds 3] [--out PATH]

The kernel source carries no profiling switch: this probe writes patched
copies of ``csrc/guard.cu`` under ``build/g2_phases/`` and builds each
(every patch must find its anchor in the source, or the probe stops):

- ``all``: the source as it is;
- ``no_loads``: each warp sum 0 (``unit_sum`` returns at once);
- ``no_norms``: each tensor norm and the norm of norms 0;
- ``neither``: both;
- ``cap16``: gradients up to 16 take a 16-descriptor instantiation of
  the kernel (384 bytes of arguments) in place of the 1024-descriptor
  one (24 KB), the split the source does not make;
- ``stamps``: lane 0 of each warp stamps ``%globaltimer`` at G2's steps
  (the earliest or latest of each kept), for the timeline of one launch.

The gradients are NCF's 12 at the sentinel shape (6040 x 3706 x 5) and
BERT-base's 153, f32, drawn from a seed. Each variant's time is
``chip_smoke.py``'s ``graph_ms`` (20 launches in a CUDA graph, replayed),
with the loop's own tickets, the variants in turns (in order, then in
reverse) ``--rounds`` times: the mean and the range of each. ``all`` and
``cap16`` are checked bit for bit against ``guard_check_reference``. G2
followed by the recover step's keep (G1 on its ``bad``, over a state of
three times the gradients) is timed on a good and on a bad step (a NaN
loss: every call copies the state). The timeline is the median, over 30
eager launches, of the ns from the first warp in to the last warp in,
the first and last warp sums, the last tensor norm and the chain's start
and end. Prints the card's name and power limit, one line a case and
the JSON summary last (also written to ``--out``). Exits non-zero
without a CUDA device or on a mismatch.
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

from analytics_zoo_tpu_torch.ops import guard as gk  # noqa: E402
from analytics_zoo_tpu_torch.ops.cuda_build import (  # noqa: E402
    BUILD_DIR, CudaLibrary, build_all)
from chip_smoke import g2_bert_shapes, graph_ms  # noqa: E402

SOURCE = os.path.join(REPO, "analytics_zoo_tpu_torch", "csrc", "guard.cu")

NO_LOADS = [("__device__ float unit_sum(const Grad& g, long long chunk, "
             "int w, int lane) {", "\n  return 0.0f;")]
NO_NORMS = [("__device__ float tensor_norm(const float* sums, int chunks, "
             "int lane) {", "\n  return 0.0f;"),
            ("__device__ float vector_norm(const float* x, int n, float* sv, "
             "int lane) {", "\n  return 0.0f;")]
CAP16 = [(": launch_check<PARAM_CAP>(host, n_grads, a, stream);",
          None, ": n_grads <= 16 ? launch_check<16>(host, n_grads, a, "
          "stream) : launch_check<PARAM_CAP>(host, n_grads, a, stream);")]
STAMP_HEAD = """#include <cuda_runtime.h>
// first warp in, last warp in, first warp sum, last warp sum, last
// tensor norm, the chain begun, the chain done
__device__ unsigned long long g_stamps[7];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i, op) op(&g_stamps[i], now_ns())
"""
STAMP_TAIL = """
extern "C" int guard_stamps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
  unsigned long long fresh[7];
  for (int i = 0; i < 7; ++i) fresh[i] = (i == 0 || i == 2) ? ~0ull : 0ull;
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_stamps, fresh, sizeof(fresh));
  return static_cast<int>(err);
}
"""
STAMPS_AT = [
    ("  if (lane == 0) s = read_scalars(a);", None,
     "  if (lane == 0) {\n    STAMP(0, atomicMin);\n    STAMP(1, atomicMax);"
     "\n    s = read_scalars(a);\n  }"),
    ("    a.scratch[u] = v;", None,
     "    STAMP(2, atomicMin);\n    STAMP(3, atomicMax);\n"
     "    a.scratch[u] = v;"),
    ("    a.tickets[lo] = 0u;", None,
     "    STAMP(4, atomicMax);\n    a.tickets[lo] = 0u;"),
    ("    scalar_chain(g, s, a);", None,
     "    STAMP(5, atomicMax);\n    scalar_chain(g, s, a);\n"
     "    STAMP(6, atomicMax);")]
VARIANTS = {"all": [], "no_loads": NO_LOADS, "no_norms": NO_NORMS,
            "neither": NO_LOADS + NO_NORMS, "cap16": CAP16}
STAMPS = ("last warp in", "first warp sum", "last warp sum",
          "last tensor norm", "chain begun", "chain done")


def patched(text, patches):
    """``text`` with each ``(anchor, after)`` patch (``after`` put after
    the anchor) or ``(anchor, None, replacement)``; each anchor must occur
    once."""
    for patch in patches:
        anchor = patch[0]
        if text.count(anchor) != 1:
            raise SystemExit(f"g2_phases: anchor not found once in "
                             f"guard.cu: {anchor!r}")
        new = anchor + patch[1] if patch[1] is not None else patch[2]
        text = text.replace(anchor, new)
    return text


def variant(name, patches, stamps=False):
    src_dir = BUILD_DIR / "g2_phases" / name
    src_dir.mkdir(parents=True, exist_ok=True)
    with open(SOURCE) as f:
        text = patched(f.read(), patches)
    if stamps:
        text = STAMP_HEAD + text + STAMP_TAIL
    (src_dir / "guard.cu").write_text(text)

    def bind(lib):
        gk._bind(lib)
        if stamps:
            lib.guard_stamps.argtypes = [ctypes.c_void_p]
            lib.guard_stamps.restype = ctypes.c_int
    return CudaLibrary(f"guard_{name}", ["guard.cu"], bind, src_dir=src_dir)


def timeline(lib, grads, tickets, launches=30):
    """The median ns from the first warp in to each stamp, over
    ``launches`` eager launches of the stamping build."""
    out = (ctypes.c_ulonglong * 7)()
    lib.entry("guard_stamps")(out)
    rows = []
    for _ in range(launches):
        torch.cuda.synchronize()
        call(lib, grads, fresh_state(), tickets)
        torch.cuda.synchronize()
        lib.entry("guard_stamps")(out)
        rows.append([out[i] - out[0] for i in range(1, 7)])
    return {name: sorted(r[i] for r in rows)[len(rows) // 2]
            for i, name in enumerate(STAMPS)}


def gradients(kind, g):
    if kind == "ncf":
        from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
        shapes = [tuple(p.shape) for p in NeuralCF(
            6040, 3706, 5, device="cpu").init_weights().parameters()]
    else:
        shapes = g2_bert_shapes()
    return [torch.randn(s, generator=g, device="cuda") * 1e-2
            for s in shapes]


def fresh_state():
    return [torch.zeros((), device="cuda"), torch.zeros((), device="cuda"),
            torch.tensor(0, device="cuda")]


LOSS, BASE = {}, {}


def call(lib, grads, state, tickets, bad=False):
    """One G2 launch through ``lib`` (the wrapper's own argument path,
    its library swapped), as a first guarded step without clipping; a
    NaN loss makes it a bad step."""
    if not LOSS:
        LOSS[False] = torch.tensor(0.7, device="cuda")
        LOSS[True] = torch.tensor(float("nan"), device="cuda")
        BASE[0] = torch.tensor(0, device="cuda")
    real = gk.LIBRARY
    gk.LIBRARY = lib
    try:
        return gk.guard_check(
            LOSS[bad], None, *state, BASE[0], None, sentinel=True,
            spike_factor=10.0, grad_clip=0.0, recover=True, grads=grads,
            tickets=tickets)
    finally:
        gk.LIBRARY = real


def same_bits(lib, grads, tickets):
    outs = []
    for run in (gk.guard_check_reference, None):
        st = fresh_state()
        res = (call(lib, grads, st, tickets) if run is None
               else run(torch.tensor(0.7, device="cuda"), None, *st,
                        torch.tensor(0, device="cuda"), None, sentinel=True,
                        spike_factor=10.0, grad_clip=0.0, recover=True,
                        grads=grads))
        outs.append([res[0], res[1]] + st)
    return all(torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
               for a, b in zip(*outs))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("g2_phases: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    libs = {name: variant(name, p) for name, p in VARIANTS.items()}
    stamped = variant("stamps", STAMPS_AT, stamps=True)
    build_all(list(libs.values()) + [stamped])
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card, "cases": {}}
    ok = True
    for kind in ("ncf", "bert_base"):
        grads = gradients(kind, g)
        tickets = torch.zeros(len(grads) + 1, dtype=torch.int32,
                              device="cuda")
        nbytes = sum(t.numel() * t.element_size() for t in grads)
        same = {name: same_bits(libs[name], grads, tickets)
                for name in ("all", "cap16")}
        ok &= all(same.values())
        state = fresh_state()
        times = {name: [] for name in VARIANTS}
        order = list(VARIANTS)
        for _ in range(args.rounds):
            for name in order + order[::-1]:
                lib = libs[name]
                times[name].append(graph_ms(
                    lambda lib=lib: call(lib, grads, state, tickets)))
        ms = {name: sum(t) / len(t) for name, t in times.items()}
        spread = {name: [min(t), max(t)] for name, t in times.items()}
        # G2, then the keep's G1 on its `bad` over a state of three times
        # the gradients (parameters and two moments): a good and a bad step
        kept = [t.clone() for t in grads for _ in range(3)]
        copies = [torch.empty_like(t) for t in kept]
        keep = gk.commit_table(copies, kept)
        for bad in (False, True):
            ms["keep_bad" if bad else "keep_good"] = graph_ms(
                lambda: gk.guard_commit(copies, kept, call(
                    libs["all"], grads, state, tickets, bad)[1], keep))
        line = timeline(stamped, grads, tickets)
        result["cases"][kind] = {
            "tensors": len(grads), "bytes": nbytes, "same_bits": same,
            "ms": ms, "range": spread, "runs": times, "timeline_ns": line}
        print(f"{kind} ({len(grads)} tensors, {nbytes} bytes): bits "
              f"{same}; " + ", ".join(
                  f"{name} {v:.5f}" + (f" [{spread[name][0]:.5f}-"
                                        f"{spread[name][1]:.5f}]"
                                        if name in spread else "")
                  for name, v in ms.items()))
        print(f"{kind}, ns from the first warp in (median of 30 eager "
              f"launches): " + ", ".join(f"{k} {v}" for k, v in line.items()))
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
