#!/usr/bin/env python3
"""Where the fused CE's dh kernel (K5a, its ``wgmma`` route) spends its time
at the LM shape (N = 65,536, H = 512, V = 8192, bf16), on one GPU:

    python3 scripts/ce_dh_breakdown.py [OTHER_CSRC_DIR]

Builds ``ce_bwd_dh_wgmma<512>`` from this checkout and three copies of
``csrc/fused_cross_entropy.cu`` with one phase cut out (the logits
products, the exponentials, the dh products; their results are wrong and
only timed), under ``build/ce_dh_breakdown/``, and times each in turns
(CUDA events, 10 launches, three rounds). With ``OTHER_CSRC_DIR`` (e.g.
the parent commit's ``csrc`` unpacked by ``git archive``) it also builds
that tree's K5a entry point, holds this checkout's dh to it bit for bit
and times it in the same turns (that tree's entry point may take the
``int* route`` this one reports through, or not: its source says which).
Prints one JSON line ``K5A {...}``;
exits non-zero without a CUDA device or when the bits differ.
"""

import ctypes
import json
import os
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# the cut each copy makes: (text in the kernel, its replacement)
CUTS = {
    "no_logits": ("""    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk)
      wgmma_ss32<1>(sc, 0, desc_k<H>(sH, kk),
                    desc_mn<64>(w_tile + 64 * wg, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
""", """#pragma unroll
    for (int e = 0; e < 16; ++e) sc[e] = 0.f;
"""),
    "no_exp": ("              p = expf(x - row_lse[hh]);",
               "              p = x;"),
    "no_dh": ("        wgmma_ss256(acc, desc_k<64>(dl_tile, kk), "
              "desc_k<64>(w_rows, kk));", ""),
}

ENTRY = """
extern "C" int breakdown_dh(const void* h, const void* w, const void* b,
                            const void* labels, const void* lse,
                            const void* scale, void* dh, int N, int V,
                            void* stream) {
  return (int)launch_dh_wgmma<512>(
      h, w, static_cast<const float*>(b), static_cast<const int*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(scale), dh,
      1, N, V, static_cast<cudaStream_t>(stream));
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ce_dh_breakdown: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from analytics_zoo_tpu_torch.ops import cuda_build
    from analytics_zoo_tpu_torch.ops.pallas import cross_entropy as ce

    p, i = ctypes.c_void_p, ctypes.c_int

    def bind(lib):
        lib.breakdown_dh.argtypes = [p] * 7 + [i] * 2 + [p]
        lib.breakdown_dh.restype = i

    other_dir = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else None
    # whether the other tree's dh entry point reports its route through an
    # int* before the stream
    other_route = other_dir is not None and "int* route" in (
        other_dir / "fused_cross_entropy.cu").read_text()

    def bind_other(lib):
        lib.fused_ce_bwd_dh.argtypes = ([p] * 7 + [i] * 5
                                        + [ctypes.POINTER(i)] * other_route
                                        + [p])
        lib.fused_ce_bwd_dh.restype = i

    src = (cuda_build.CSRC_DIR / "fused_cross_entropy.cu").read_text()
    libs = {}
    for name, (cut, repl) in {"kernel": ("", ""), **CUTS}.items():
        if cut and cut not in src:
            print(f"ce_dh_breakdown: the {name} cut no longer matches the "
                  f"source", file=sys.stderr)
            return 1
        d = cuda_build.BUILD_DIR / "ce_dh_breakdown" / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(cuda_build.CSRC_DIR / "hopper.cuh", d)
        (d / "breakdown.cu").write_text(
            (src.replace(cut, repl) if cut else src) + ENTRY)
        libs[name] = cuda_build.CudaLibrary(f"ce_dh_{name}", ["breakdown.cu"],
                                            bind, src_dir=d)
    other = None
    if other_dir is not None:
        other = cuda_build.CudaLibrary("ce_dh_other",
                                       ["fused_cross_entropy.cu"], bind_other,
                                       src_dir=other_dir)
    cuda_build.build_all(list(libs.values()) + ([other] if other else []))

    n, hidden, v = 65536, 512, 8192
    g = torch.Generator().manual_seed(3)
    h = torch.randn(n, hidden, generator=g).to("cuda", torch.bfloat16)
    w = (torch.randn(hidden, v, generator=g) * hidden ** -0.5).to(
        "cuda", torch.bfloat16)
    b = (torch.randn(v, generator=g) * 0.1).cuda()
    labels = torch.randint(0, v, (n,), generator=g, dtype=torch.int32).cuda()
    scale = torch.full((n,), 1.0 / n, device="cuda")
    lse, _ = ce.fused_ce_forward(h, w, b, labels)
    ptrs = [t.data_ptr() for t in ce._backward_operands(h, w, b, labels, lse,
                                                        scale)]
    out = torch.empty(n, hidden, dtype=torch.bfloat16, device="cuda")
    runs = {name: (lambda lib=lib: cuda_build.launch(
        lib.entry("breakdown_dh"), h, *ptrs, out.data_ptr(), n, v))
        for name, lib in libs.items()}
    if other is not None:
        route = ctypes.c_int(-1)
        runs["other"] = lambda: cuda_build.launch(
            other.entry("fused_ce_bwd_dh"), h, *ptrs, out.data_ptr(), n,
            hidden, v, 1, 1, *[ctypes.byref(route)] * other_route)
    result = {"shape": [n, hidden, v]}
    if other is not None:
        assert runs["kernel"]() == 0
        mine = out.clone()
        assert runs["other"]() == 0
        torch.cuda.synchronize()
        result["same_bits_as_other"] = bool(torch.equal(mine, out))
        if other_route:
            result["other_route"] = route.value

    def ms(fn, iters=10):
        assert fn() == 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    times = {name: [] for name in runs}
    for _ in range(3):
        for name, fn in runs.items():
            times[name].append(ms(fn))
    result["ms"] = times
    print("K5A " + json.dumps(result))
    return 0 if result.get("same_bits_as_other", True) else 1


if __name__ == "__main__":
    sys.exit(main())
