#!/usr/bin/env python3
"""Time C8, the static int8 conv, against variants of its own design on
one GPU, at every distinct conv of VGG-16 at 112 pixels, batch 32 and 1.

    python3 scripts/c8_variants.py [--out PATH]

Variants, each built from an edited copy of ``csrc/conv_int8.cu`` (and
``hopper.cuh``) under ``build/c8_variants/``:

* ``current``: the source as it is.
* ``tn64_4_stages``: the 64-filter tile with a ring of 4 stages (96 KB of
  shared memory, two blocks an SM) instead of 3 (72 KB, three).
* ``quantize_16_a_thread``: the quantize pass with each thread reading 16
  consecutive activations (four 16-byte loads 64 bytes apart across the
  warp) and storing their 16 bytes, instead of each warp's coalesced
  loads and a store staged through shared memory.
* ``reciprocal``: the quantize pass multiplying by ``1 / x_scale``,
  dividing exactly only where the product lies within 2^-14 of a
  half-way point (the same bits: the product is within 2^-15 of the IEEE
  quotient below 128).
* ``tn128_4_stages``: the 128-filter tile with a ring of 4 stages (128
  KB, one block an SM) instead of 3 (96 KB, two).
* ``wgmma_in_flight``: one ``wgmma`` group left in flight across K tiles
  (``wgmma.wait_group 1``; the refill then goes two stages back, one
  stage ahead) instead of waiting for each tile's products.
* ``no_split``: the shapes the plan splits over K (``c8_split``) run on
  ``c8_wgmma`` unsplit.
* ``quantize_on_load``: every conv on the ``c8_small_c`` route (the
  implicit GEMM that gathers and quantizes the f32 input itself on
  ``mma.sync`` tiles), as the 3-channel stems run.

Each case is the device time of a CUDA-graph replay of 10 wrapper calls
(the weight repacked beforehand), and of the quantize pass alone, the
variants timed in turns (in order, then in reverse) and each the mean of
its two runs. Every variant's output is checked bit for bit against
``static_int8_conv2d_reference`` and its quantize pass against
``quantize_static``, over half-way quotients too. Prints the card's name
and power limit, one line a case, and one JSON summary as the last line
(also written to ``--out``). Exits non-zero without a CUDA device or on a
mismatch.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: VGG-16's distinct convs at 112 pixels: (c, f, hw), and how many of its
#: 13 each shape is
VGG_CONVS = [(3, 64, 112), (64, 64, 112), (64, 128, 56), (128, 128, 56),
             (128, 256, 28), (256, 256, 28), (256, 512, 14),
             (512, 512, 14), (512, 512, 7)]
VGG_COUNT = {(256, 256, 28): 2, (512, 512, 14): 2, (512, 512, 7): 3}
VARIANTS = ("current", "tn64_4_stages", "tn128_4_stages",
            "wgmma_in_flight", "quantize_16_a_thread", "reciprocal",
            "no_split", "quantize_on_load")
#: variants that change the plan, not the source
PLANNED = ("no_split", "quantize_on_load")

QUANTIZE_16 = '''
__global__ void __launch_bounds__(Q_THREADS)
    conv_int8_quantize(const float* __restrict__ x,
                       const float* __restrict__ x_scale,
                       int8_t* __restrict__ xq, long long n, int vec) {
  const float xs = *x_scale;
  const long long stride = (long long)gridDim.x * Q_THREADS;
  const long long first = (long long)blockIdx.x * Q_THREADS + threadIdx.x;
  const long long nv = vec ? n / 16 : 0;
  for (long long v = first; v < nv; v += stride) {
    const float4* p = reinterpret_cast<const float4*>(x) + 4 * v;
    uint32_t word[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = __ldcs(p + j);
      word[j] = quantize(f.x, xs) | quantize(f.y, xs) << 8 |
                quantize(f.z, xs) << 16 | quantize(f.w, xs) << 24;
    }
    reinterpret_cast<uint4*>(xq)[v] =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
  for (long long e = nv * 16 + first; e < n; e += stride)
    xq[e] = static_cast<int8_t>(quantize(x[e], xs));
}

'''

RECIPROCAL = '''
__device__ __forceinline__ uint32_t quantize_r(float v, float xs, float xr) {
  const float t = v * xr;
  const float fr = t - floorf(t);
  if (fabsf(fr - 0.5f) < 0x1p-14f) return quantize(v, xs);
  const float q = fminf(fmaxf(rintf(t), -127.f), 127.f);
  return static_cast<uint32_t>(
      static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(q))));
}
'''


#: the GEMM's main loop as it waits for each K tile's products, and as
#: ``wgmma_in_flight`` leaves one group in flight
LOOP_WAITED = (
    "  for (int i = 0; i < S - 1; ++i) {\n",
    "    cp_async_wait<S - 2>();",
    "    if (i + S - 1 < nk) load(i + S - 1);",
    "    wgmma_wait<0>();\n    fence_regs(acc);\n  }\n")
LOOP_IN_FLIGHT = (
    "  for (int i = 0; i < S - 2; ++i) {\n",
    "    cp_async_wait<S - 3>();",
    "    if (i + S - 2 < nk) load(i + S - 2);",
    "    wgmma_wait<1>();\n    fence_regs(acc);\n  }\n"
    "  wgmma_wait<0>();\n  fence_regs(acc);\n")


def variant_source(name, src):
    """``conv_int8.cu`` as variant ``name`` edits it."""
    stages = "static constexpr int STAGES = 3;"
    if name in ("tn64_4_stages", "tn128_4_stages"):
        assert stages in src
        four = "TN == 64 ? 4 : 3" if name == "tn64_4_stages" else \
            "TN == 64 ? 3 : 4"
        return src.replace(stages, f"static constexpr int STAGES = {four};")
    if name == "wgmma_in_flight":
        for old, new in zip(LOOP_WAITED, LOOP_IN_FLIGHT):
            assert src.count(old) == 1, old
            src = src.replace(old, new)
        return src
    if name == "quantize_16_a_thread":
        head = src.index("__global__ void __launch_bounds__(Q_THREADS)")
        tail = src.index("// -----", head)
        src = src[:head] + QUANTIZE_16 + src[tail:]
        old = "vec ? std::max(n / Q_CHUNK * 32, n % Q_CHUNK) : n;"
        assert old in src
        return src.replace(old, "vec ? std::max(n / 16, n % 16) : n;")
    if name == "reciprocal":
        head = src.index("__global__ void __launch_bounds__(Q_THREADS)")
        tail = src.index("// -----", head)
        body = src[head:tail]
        body = body.replace("const float xs = *x_scale;",
                            "const float xs = *x_scale, xr = 1.f / xs;", 1)
        for c in "xyzw":
            body = body.replace(f"quantize(f[j].{c}, xs)",
                                f"quantize_r(f[j].{c}, xs, xr)")
        assert "quantize_r(" in body
        return src[:head] + RECIPROCAL + body + src[tail:]
    return src


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("c8_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from analytics_zoo_tpu_torch.ops import cuda_build
    from analytics_zoo_tpu_torch.ops.pallas import quantized as Q
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.convolution \
        import same_pads
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cudnn.allow_tf32 = False

    src = (cuda_build.CSRC_DIR / "conv_int8.cu").read_text()
    libs = {}
    for name in VARIANTS:
        if name in PLANNED:
            libs[name] = Q.LIBRARY_CONV
            continue
        d = cuda_build.BUILD_DIR / "c8_variants" / name
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        (d / "conv_int8.cu").write_text(variant_source(name, src))
        shutil.copy(cuda_build.CSRC_DIR / "hopper.cuh", d / "hopper.cuh")
        libs[name] = cuda_build.CudaLibrary(f"conv_int8_{name}",
                                            ["conv_int8.cu"], Q._bind_conv,
                                            src_dir=d)
    cuda_build.build_all(list({id(v): v for v in libs.values()}.values()))

    plan = Q.conv_plan

    def small_c_plan(m, f, k, c, sms):
        return plan(m, f, k, 3, sms)       # the quantize-on-load route

    def unsplit_plan(m, f, k, c, sms):
        route, tn, splits, per = plan(m, f, k, c, sms)
        if route != "c8_split":
            return route, tn, splits, per
        return "c8_wgmma", tn, 1, -(-k // Q.WGMMA_STEP)

    def use(name):
        Q.LIBRARY_CONV = libs[name]
        Q.conv_plan = {"quantize_on_load": small_c_plan,
                       "no_split": unsplit_plan}.get(name, plan)

    def graph_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        graph.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 5 / iters

    g = torch.Generator().manual_seed(0)
    cases = []
    for b in (32, 1):
        for c, f, hw in VGG_CONVS:
            x = (torch.randn(b, hw, hw, c, generator=g) * 2).cuda()
            wq = torch.randint(-127, 128, (3, 3, c, f), generator=g,
                               dtype=torch.int8).cuda()
            ws = (torch.rand(f, generator=g) * 0.01 + 1e-3).cuda()
            bias = torch.randn(f, generator=g).cuda()
            xs = torch.tensor(0.05).cuda()
            pads = [same_pads(n, 3, 1, 1) for n in (hw, hw)]
            op = (x, xs, wq, ws, bias, True, (1, 1), (1, 1), pads)
            cases.append({"key": f"b{b}_{c}x{f}_{hw}", "b": b, "shape":
                          (c, f, hw), "op": op,
                          "wk": Q.repack_conv_weight(wq),
                          "ref": Q.static_int8_conv2d_reference(*op)})
    half = torch.cat([(torch.arange(-300, 300, dtype=torch.float32) + 0.5)
                      * 0.0371, torch.randn(1 << 20, generator=g) * 3,
                      torch.tensor([1e6, -1e6, 0.0])]).cuda()
    ok, times = True, {}
    for order in (VARIANTS, VARIANTS[::-1]):
        for name in order:
            use(name)
            for case in cases:
                op, wk = case["op"], case["wk"]
                y = Q.static_int8_conv2d(*op, w_kmajor=wk)
                same = torch.equal(y.view(torch.int32),
                                   case["ref"].view(torch.int32))
                t = graph_ms(lambda: Q.static_int8_conv2d(*op, w_kmajor=wk))
                tq = (graph_ms(lambda: Q.static_int8_quantize(op[0], op[1]))
                      if case["shape"][0] % 16 == 0 else None)
                rec = times.setdefault(name, {}).setdefault(
                    case["key"], {"ms": [], "quantize_ms": [],
                                  "route": Q.LAST_CONV_LAUNCH.route,
                                  "bit_equal": True})
                rec["ms"].append(t)
                if tq is not None:
                    rec["quantize_ms"].append(tq)
                rec["bit_equal"] &= same
                ok &= same
            for s in (0.0371, 0.05, 1e-3, 7.0):
                st = torch.tensor(s).cuda()
                q_same = torch.equal(Q.static_int8_quantize(half, st),
                                     Q.quantize_static(half, st))
                ok &= q_same
                times[name].setdefault("quantize_bits", True)
                times[name]["quantize_bits"] &= q_same
    use("current")
    summary = {"card": card, "variants": {}}
    for name in VARIANTS:
        rows = {}
        for case in cases:
            rec = times[name][case["key"]]
            ms = sum(rec["ms"]) / len(rec["ms"])
            q = (sum(rec["quantize_ms"]) / len(rec["quantize_ms"])
                 if rec["quantize_ms"] else None)
            rows[case["key"]] = {"device_ms": ms, "quantize_ms": q,
                                 "route": rec["route"],
                                 "bit_equal": rec["bit_equal"]}
            print(f"c8 variant {name} {case['key']} "
                  f"{json.dumps(rows[case['key']])}")
        sums = {f"vgg16_b{b}_device_ms_sum": sum(
            rows[c["key"]]["device_ms"] * VGG_COUNT.get(c["shape"], 1)
            for c in cases if c["b"] == b) for b in (32, 1)}
        summary["variants"][name] = {"cases": rows, **sums,
                                     "quantize_bits":
                                         times[name]["quantize_bits"]}
        print(f"c8 variant {name} sums {json.dumps(sums)}")
    summary["ok"] = ok
    line = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
