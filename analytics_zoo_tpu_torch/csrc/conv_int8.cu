// C8: the static int8 conv layer for Hopper (sm_90a), bound through a plain
// C entry point and loaded with ctypes.
//
// Replaces no Pallas kernel: the JAX package's Convolution2D.quantized_call
// (pipeline/api/keras/layers/convolution.py:134-151) leaves its int8 x int8
// -> int32 conv to XLA's conv_general_dilated. PyTorch has no int8 conv on
// CUDA; its one library route, im2col and the padded torch._int_mm, writes
// every activation kh * kw times to memory and pads K to a multiple of 8.
// C8 is that whole layer in one kernel, the conv counterpart of Q8:
//   out[b, oh, ow, f] = act(float(sum_{r, s, c} xq[b, ih, iw, c] *
//                       w[r, s, c, f]) * (x_scale * w_scale[f]) + bias[f])
// with xq = clamp(rint(x / x_scale), -127, 127) (the IEEE quotient, round
// half to even), ih = oh * sh - ph + r * dh, iw = ow * sw - pw + s * dw, and
// zeros outside the input (padding after quantizing: exact zeros), so any
// stride, dilation and (lo, hi) padding; the hi side needs no argument, as
// the output size the caller gives bounds the windows.
//
// Design: an implicit GEMM with M = B * Ho * Wo output pixels, N = F filters
// and K = kh * kw * C (k = (r * kw + s) * C + c, the row of the HWIO
// weight read as a (K, N) matrix). A block owns a 64 x 64 output tile and
// walks K 32 at a time: each thread gathers 16 k of one A row from the NHWC
// input, quantizing on load, and 16 k of one B column from the weight, and
// stores both as int8 rows of shared memory (48-byte rows: the fragment
// loads below are free of bank conflicts). Four warps (2 x 2) each run a
// 32 x 32 quarter of the tile as 2 x 4 mma.sync.m16n8k32 s8 x s8 -> s32
// tiles. K tails (VGG's first layer, K = 27) and the M and N edges load
// zeros; nothing is padded in memory. Where the output tiles are too few
// to fill the card (batch 1: VGG-16's 7-pixel layers give 8 blocks for
// K = 4608), the K steps are split over blockIdx.z (split_steps: about
// four blocks an SM, at least four K steps a split): each split adds its
// int32 sums into a zeroed workspace with integer atomics and
// conv_int8_finish, a programmatic dependent, applies the epilogue. The
// int32 sums are exact, so any order gives the same bits. The epilogue is
// Q8's, per output channel: __fmul_rn and __fadd_rn, never contracted into
// an FMA, in the JAX order.
//
// What bounds it on this card: the int8 tensor-core operations (2 M N K at
// 1,979 TOP/s) or the bytes (x read once as f32, w once, out written once
// as f32 at 3.35 TB/s), whichever is larger; at VGG-16's 112-pixel layers
// the bytes do below 256 filters and the products above. This first kernel
// is simple: no cp.async or TMA pipeline, no wgmma, and the A gather reads
// each activation once per filter tap it feeds (from L1 and L2) and divides
// it again each time; a faster one is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int MIN_SPLIT_STEPS = 4;  // K steps a split takes at least
constexpr int BLOCKS_PER_SM = 4;    // the split grid's target
constexpr int LDS = BK + 16;  // bytes a shared row of A or B takes

// v quantized as the static path does (Q8's q8_quantize), as an int8 byte
__device__ __forceinline__ uint32_t quantize(float v, float xs) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, xs)), -127.f), 127.f);
  return static_cast<uint32_t>(
      static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(q))));
}

// an output from its exact int32 sum, in the static path's order
__device__ __forceinline__ float finish(int acc, int n, float xs,
                                        const float* __restrict__ w_scale,
                                        const float* __restrict__ bias,
                                        int relu) {
  float y = __fmul_rn(__int2float_rn(acc), __fmul_rn(xs, w_scale[n]));
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  if (relu && y < 0.f) y = 0.f;
  return y;
}

// d += a (16 x 32, row) * b (32 x 8, col), s8 x s8 -> s32 (PTX ISA fragment
// layouts, g = lane / 4, t = lane % 4: a[0] row g, k 4t..4t+3; a[1] row
// g + 8; a[2], a[3] the same rows at k + 16; b[0] column g, k 4t..4t+3,
// b[1] at k + 16; d[0], d[1] row g, columns 2t, 2t + 1; d[2], d[3] row g + 8)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(THREADS)
    conv_int8_igemm(const float* __restrict__ x,
                    const float* __restrict__ x_scale,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ w_scale,
                    const float* __restrict__ bias, int relu,
                    float* __restrict__ out, int* __restrict__ ws, int H,
                    int W, int C, int KW, int F, int HO, int WO, int SH,
                    int SW, int DH, int DW, int PH, int PW, int M, int K,
                    int split_k) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const float xs = *x_scale;

  // this thread's A row (an output pixel) and B column (a filter), and
  // its half of each 32-deep K step
  const int row = tid >> 1, half = (tid & 1) * 16;
  const int am = m0 + row, bn = n0 + row;
  const bool row_ok = am < M, col_ok = bn < F;
  int ih0 = 0, iw0 = 0;
  const float* xb = x;
  if (row_ok) {
    const int b = am / (HO * WO), rem = am - b * HO * WO;
    const int oh = rem / WO, ow = rem - oh * WO;
    ih0 = oh * SH - PH;
    iw0 = ow * SW - PW;
    xb = x + (size_t)b * H * W * C;
  }

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int k_beg = blockIdx.z * split_k, k_end = min(K, k_beg + split_k);
  for (int k0 = k_beg; k0 < k_end; k0 += BK) {
    uint32_t aw[4] = {0u, 0u, 0u, 0u}, bw[4] = {0u, 0u, 0u, 0u};
    int k = k0 + half;
    int rs = k / C, c = k - rs * C;
    int r = rs / KW, s = rs - r * KW;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (k < k_end) {
        if (row_ok) {
          const int ih = ih0 + r * DH, iw = iw0 + s * DW;
          if (ih >= 0 && ih < H && iw >= 0 && iw < W)
            aw[j >> 2] |= quantize(xb[((size_t)ih * W + iw) * C + c], xs)
                          << (8 * (j & 3));
        }
        if (col_ok)
          bw[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                            w[(size_t)k * F + bn]))
                        << (8 * (j & 3));
      }
      ++k;
      if (++c == C) {
        c = 0;
        if (++s == KW) {
          s = 0;
          ++r;
        }
      }
    }
    *reinterpret_cast<uint4*>(As + row * LDS + half) =
        make_uint4(aw[0], aw[1], aw[2], aw[3]);
    *reinterpret_cast<uint4*>(Bs + row * LDS + half) =
        make_uint4(bw[0], bw[1], bw[2], bw[3]);
    __syncthreads();

    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* pa = As + (wm + i * 16 + g) * LDS + t * 4;
      a[i][0] = ld32(pa);
      a[i][1] = ld32(pa + 8 * LDS);
      a[i][2] = ld32(pa + 16);
      a[i][3] = ld32(pa + 8 * LDS + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* pb = Bs + (wn + j * 8 + g) * LDS + t * 4;
      b[j][0] = ld32(pb);
      b[j][1] = ld32(pb + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + i * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn + j * 8 + 2 * t + (e & 1);
        if (m >= M || n >= F) continue;
        if (gridDim.z == 1)
          out[(size_t)m * F + n] =
              finish(acc[i][j][e], n, xs, w_scale, bias, relu);
        else
          atomicAdd(ws + (size_t)m * F + n, acc[i][j][e]);
      }
}

// the split sums of each output, finished; a programmatic dependent of
// conv_int8_igemm
__global__ void __launch_bounds__(256)
    conv_int8_finish(const int* __restrict__ ws,
                     const float* __restrict__ x_scale,
                     const float* __restrict__ w_scale,
                     const float* __restrict__ bias, int relu,
                     float* __restrict__ out, long long total, int F) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  out[i] = finish(ws[i], (int)(i % F), *x_scale, w_scale, bias, relu);
}

int sm_count(int device) {
  static std::atomic<int> cached[64];
  if (device < 0 || device >= 64) return -1;
  int v = cached[device].load();
  if (v == 0) {
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      return -1;
    cached[device].store(v);
  }
  return v;
}

// the K steps a split takes for an (M, F, K) conv on `sms` SMs: all of K
// when the output tiles alone fill BLOCKS_PER_SM blocks an SM
int split_steps(long long M, int F, int K, int sms) {
  const long long tiles = ((M + BM - 1) / BM) * ((F + BN - 1) / BN);
  const int steps = (K + BK - 1) / BK;
  const long long want = (long long)sms * BLOCKS_PER_SM;
  if (tiles >= want || steps < 2 * MIN_SPLIT_STEPS) return steps;
  long long splits = (want + tiles - 1) / tiles;
  splits = std::min<long long>(splits, steps / MIN_SPLIT_STEPS);
  splits = std::min<long long>(splits, 65535);
  return (int)((steps + splits - 1) / splits);
}

}  // namespace

// C8's plan for an (M, F, K) conv on CUDA device `device`:
// *workspace_ints receives the int32 workspace int8_static_conv2d then
// needs (0 without a K split). Returns the K splits, or -1.
extern "C" int int8_static_conv2d_plan(long long M, int F, int K, int device,
                                       long long* workspace_ints) {
  const int sms = sm_count(device);
  if (sms <= 0 || M <= 0 || F <= 0 || K <= 0) return -1;
  const int steps = (K + BK - 1) / BK;
  const int per = split_steps(M, F, K, sms);
  const int splits = (steps + per - 1) / per;
  *workspace_ints = splits > 1 ? M * F : 0;
  return splits;
}

// C8: x (B, H, W, C) f32, x_scale (1,) f32 on the device, w (KH, KW, C, F)
// int8, w_scale (F,) f32, bias (F,) f32 or null, out (B, HO, WO, F) f32,
// all contiguous; strides (SH, SW), dilation (DH, DW), the low-side
// padding (PH, PW); workspace the plan's int32 workspace (zeroed here) or
// null. *splits receives the K splits it ran. Returns the launches' CUDA
// error code.
extern "C" int int8_static_conv2d(const void* x, const void* x_scale,
                                  const void* w, const void* w_scale,
                                  const void* bias, int relu, void* out,
                                  void* workspace, long long workspace_ints,
                                  int B, int H, int W, int C, int KH, int KW,
                                  int F, int HO, int WO, int SH, int SW,
                                  int DH, int DW, int PH, int PW,
                                  int* splits, void* stream) {
  const long long M = (long long)B * HO * WO;
  const long long K = (long long)KH * KW * C;
  if (M <= 0 || F <= 0 || K <= 0 || M >= (1LL << 31) || K >= (1LL << 31) ||
      SH < 1 || SW < 1 || DH < 1 || DW < 1 || PH < 0 || PW < 0 ||
      (F + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return (int)cudaErrorInvalidValue;
  const int sms = sm_count(dev);
  if (sms <= 0) return (int)cudaErrorInvalidValue;
  const int steps = (int)((K + BK - 1) / BK);
  const int per = split_steps(M, F, (int)K, sms);
  const int nsplit = (steps + per - 1) / per;
  if (nsplit > 1 && (workspace == nullptr || workspace_ints < M * F))
    return (int)cudaErrorInvalidValue;
  *splits = nsplit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ws = static_cast<int*>(workspace);
  if (nsplit > 1) {
    const cudaError_t err =
        cudaMemsetAsync(ws, 0, (size_t)M * F * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((F + BN - 1) / BN),
                  (unsigned)nsplit);
  conv_int8_igemm<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(x_scale),
      static_cast<const int8_t*>(w), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), relu, static_cast<float*>(out), ws, H,
      W, C, KW, F, HO, WO, SH, SW, DH, DW, PH, PW, (int)M, (int)K, per * BK);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const long long total = M * F;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((total + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, conv_int8_finish, (const int*)ws,
                                 static_cast<const float*>(x_scale),
                                 static_cast<const float*>(w_scale),
                                 static_cast<const float*>(bias), relu,
                                 static_cast<float*>(out), total, (int)F);
}
