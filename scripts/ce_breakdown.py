#!/usr/bin/env python3
"""Where the fused CE kernels spend their time on their ``wgmma`` routes at
the LM shape (N = 65,536, H = 512, V = 8192, bf16, a bias), on one GPU:

    python3 scripts/ce_breakdown.py [OTHER_CSRC_DIR]

Builds ``csrc/fused_cross_entropy.cu`` from this checkout and copies of it
with phases cut out, under ``build/ce_breakdown/``, and times each kernel
in turns (CUDA events, 10 launches, three rounds):

* K4 (``fwd``): ``logits`` (the products alone), ``logits+epilogue``
  (roundings, row max, label logit; no exponentials), ``kernel``;
* K5a (``dh``): ``no_logits``, ``no_exp``, ``no_dh`` (one phase cut out
  each), ``kernel``;
* K5b (``dw``): ``logits`` (no exponentials, no dW products),
  ``logits+exp`` (no dW products), ``kernel``.

The cut copies compute wrong results and are only timed. With
``OTHER_CSRC_DIR`` (e.g. the parent commit's ``csrc`` unpacked by ``git
archive``) it also builds that tree's entry points (each with or without
the ``int* route`` argument: its source says which), reports whether this
checkout's lse, label logit, dh, dW and db are that tree's bits (and the
largest differences), and times them in the same turns. Prints the card's
name and power limit, then one JSON line ``CE_BREAKDOWN {...}``; exits
non-zero without a CUDA device or when a cut no longer matches the source.
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_FINISH = """    if (v0 + Y_BV <= V)
      finish(std::false_type{});
    else
      finish(std::true_type{});
"""
_FWD_EXP = """          ls[hh][j & 3] += ex2(fmaf(lo_bf16(x), LOG2E, -msc[hh]));
          ls[hh][j & 3] += ex2(fmaf(hi_bf16(x), LOG2E, -msc[hh]));"""
_DH_LOGITS = """    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk)
      wgmma_ss32<1>(sc, 0, desc_k<H>(sH, kk),
                    desc_mn<64>(w_tile + 64 * wg, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
"""
# K5a's and K5b's dl (the text is the same in both; a copy times only one)
_EXP = ("              p = expf(x - row_lse[hh]);", "              p = x;")
_DW_PRODUCT = """        wgmma_ss256<1, 1>(acc, desc_mn<64>(dl_tile, kk),
                          desc_mn<256>(h_tile + wg * 4 * Tile<64>::BYTES,
                                       kk));"""
# each copy: its kernel and its cuts (text in the source, its replacement)
VARIANTS = {
    "fwd_logits": ("fwd", [(_FINISH, "")]),
    "fwd_logits+epilogue": ("fwd", [(_FWD_EXP, "          ls[hh][j & 3] += "
                                               "lo_bf16(x) + hi_bf16(x);")]),
    "dh_no_logits": ("dh", [(_DH_LOGITS, "#pragma unroll\n    for (int e = 0; "
                                         "e < 16; ++e) sc[e] = 0.f;\n")]),
    "dh_no_exp": ("dh", [_EXP]),
    "dh_no_dh": ("dh", [("        wgmma_ss256(acc, desc_k<64>(dl_tile, kk), "
                         "desc_k<64>(w_rows, kk));", "")]),
    "dw_logits": ("dw", [_EXP, (_DW_PRODUCT, "")]),
    "dw_logits+exp": ("dw", [(_DW_PRODUCT, "")]),
}
ENTRIES = {"fwd": "fused_ce_fwd", "dh": "fused_ce_bwd_dh",
           "dw": "fused_ce_bwd_dw"}


def _takes_route(src: str, name: str) -> bool:
    """Whether entry point ``name`` of a source takes ``int* route``."""
    sig = re.search(r'extern "C" int %s\(([^)]*)\)' % name, src)
    return sig is not None and "int* route" in sig.group(1)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ce_breakdown: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from analytics_zoo_tpu_torch.ops import cuda_build
    from analytics_zoo_tpu_torch.ops.pallas import cross_entropy as ce

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    p, i = ctypes.c_void_p, ctypes.c_int

    def binder(routes):
        def bind(lib):
            for name, (n_ptr, n_int) in (("fused_ce_fwd", (6, 4)),
                                         ("fused_ce_bwd_dh", (7, 5)),
                                         ("fused_ce_bwd_dw", (8, 4))):
                fn = getattr(lib, name)
                fn.argtypes = ([p] * n_ptr + [i] * n_int
                               + [ctypes.POINTER(i)] * routes[name] + [p])
                fn.restype = i
        return bind

    src = (cuda_build.CSRC_DIR / "fused_cross_entropy.cu").read_text()
    libs = {"kernel": ce.LIBRARY}
    for name, (_, cuts) in VARIANTS.items():
        text = src
        for cut, repl in cuts:
            if cut not in text:
                print(f"ce_breakdown: the {name} cut no longer matches the "
                      f"source", file=sys.stderr)
                return 1
            text = text.replace(cut, repl)
        tag = name.replace("+", "_")
        d = cuda_build.BUILD_DIR / "ce_breakdown" / tag
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(cuda_build.CSRC_DIR / "hopper.cuh", d)
        (d / "fused_cross_entropy.cu").write_text(text)
        libs[name] = cuda_build.CudaLibrary(
            "ce_bd_" + tag, ["fused_cross_entropy.cu"],
            binder(dict.fromkeys(ENTRIES.values(), True)), src_dir=d)
    other_dir = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else None
    if other_dir is not None:
        other_src = (other_dir / "fused_cross_entropy.cu").read_text()
        other_routes = {e: _takes_route(other_src, e)
                        for e in ENTRIES.values()}
        libs["other"] = cuda_build.CudaLibrary(
            "ce_bd_other", ["fused_cross_entropy.cu"], binder(other_routes),
            src_dir=other_dir)
    cuda_build.build_all(list(libs.values()))
    log = libs["kernel"].build_log.splitlines()
    for k, line in enumerate(log):  # the wgmma kernels' registers, spills
        if re.search(r"ce_(fwd|bwd_dh|bwd_dw)_wgmma", line) or \
                "serializ" in line:
            for text in log[k:k + 4]:
                print("ptxas:", text.strip())

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
    outs = {"fwd": (torch.empty(n, device="cuda"),
                    torch.empty(n, device="cuda")),
            "dh": (torch.empty(n, hidden, dtype=torch.bfloat16,
                               device="cuda"),),
            "dw": (torch.empty(hidden, v, device="cuda"),
                   torch.empty(v, device="cuda"))}
    out_ptrs = {k: [t.data_ptr() for t in o] for k, o in outs.items()}
    args = {"fwd": ptrs[:4] + out_ptrs["fwd"] + [n, hidden, v, 1],
            "dh": ptrs + out_ptrs["dh"] + [n, hidden, v, 1, 1],
            "dw": ptrs + out_ptrs["dw"] + [n, hidden, v, 1]}
    route = ctypes.c_int(-1)

    def runner(lib, kernel, with_route):
        entry, extra = ENTRIES[kernel], [ctypes.byref(route)] * with_route
        return lambda: cuda_build.launch(lib.entry(entry), h, *args[kernel],
                                         *extra)

    runs = {f"{k}_kernel": runner(libs["kernel"], k, True) for k in ENTRIES}
    for name, (kernel, _) in VARIANTS.items():
        runs[name] = runner(libs[name], kernel, True)
    result = {"shape": [n, hidden, v]}
    for kernel in ENTRIES:
        assert runs[f"{kernel}_kernel"]() == 0
        torch.cuda.synchronize()
        result[f"{kernel}_route"] = ce.ROUTES[route.value]
    if other_dir is not None:
        same, diff = {}, {}
        for kernel, keys in (("fwd", ("lse", "ll")), ("dh", ("dh",)),
                             ("dw", ("dw", "db"))):
            runs[f"{kernel}_other"] = runner(libs["other"], kernel,
                                             other_routes[ENTRIES[kernel]])
            assert runs[f"{kernel}_kernel"]() == 0
            mine = [t.clone() for t in outs[kernel]]
            assert runs[f"{kernel}_other"]() == 0
            torch.cuda.synchronize()
            for key, a, c in zip(keys, mine, outs[kernel]):
                same[key] = bool(torch.equal(a.view(torch.int16 if a.dtype
                                                    == torch.bfloat16 else
                                                    torch.int32),
                                             c.view(torch.int16 if c.dtype
                                                    == torch.bfloat16 else
                                                    torch.int32)))
                diff[key] = (a.float() - c.float()).abs().max().item()
        result["same_bits_as_other"] = same
        result["max_abs_diff_to_other"] = diff

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
    print("CE_BREAKDOWN " + json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
