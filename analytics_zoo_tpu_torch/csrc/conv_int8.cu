// C8: the static int8 conv layer for Hopper (sm_90a), bound through plain
// C entry points and loaded with ctypes.
//
// Replaces no Pallas kernel: the JAX package's Convolution2D.quantized_call
// (pipeline/api/keras/layers/convolution.py:134-151) leaves its int8 x int8
// -> int32 conv to XLA's conv_general_dilated. PyTorch has no int8 conv on
// CUDA; its one library route, im2col and the padded torch._int_mm, writes
// every activation kh * kw times to memory and pads K to a multiple of 8.
// C8 is that whole layer, the conv counterpart of Q8:
//   out[b, oh, ow, f] = act(float(sum_{r, s, c} xq[b, ih, iw, c] *
//                       w[r, s, c, f]) * (x_scale * w_scale[f]) + bias[f])
// with xq = clamp(rint(x / x_scale), -127, 127) (the IEEE quotient, round
// half to even), ih = oh * sh - ph + r * dh, iw = ow * sw - pw + s * dw, and
// zeros outside the input (padding after quantizing: exact zeros), so any
// stride, dilation and (lo, hi) padding; the hi side needs no argument, as
// the output size the caller gives bounds the windows. It is an implicit
// GEMM with M = B * Ho * Wo output pixels, N = F filters and K = kh * kw *
// C (k = (r * kw + s) * C + c, the row of the HWIO weight read as a (K, N)
// matrix). The int32 sums are exact, so any order of summation gives the
// same bits; the epilogue is Q8's, per output channel: __fmul_rn and
// __fadd_rn, never contracted into an FMA, in the JAX order.
//
// Three routes, chosen by shape (the wrapper's conv_plan):
//
//  * c8_wgmma (C % 16 == 0: a filter tap's C bytes are whole 16-byte
//    chunks). Two passes. conv_int8_quantize divides each activation once
//    and writes x as int8 NHWC with 16-byte loads and stores (x read once
//    as f32, 1 byte an element written). conv_int8_wgmma then runs the
//    GEMM on wgmma.m64nNk32.s32.s8.s8: a block owns 128 output pixels by
//    BN = 64 (F <= 64) or 128 filters, two warpgroups of 64 pixels each,
//    and walks K 128 bytes a stage through a ring of 3 stages (72 KB of
//    shared memory at BN = 64, three blocks an SM; 96 KB at BN = 128,
//    two), so one block's epilogue and loads overlap another's products.
//    B, the weight repacked once as (F, K) with K contiguous (wgmma takes
//    s8 operands only K-major), comes by TMA in the 128-byte swizzle,
//    completing on an mbarrier a stage. A, the implicit-GEMM rows, comes
//    by 16-byte cp.async: eight threads a row, each one chunk of 16 k,
//    written where the 128-byte swizzle puts it (chunk j of row r at j ^
//    (r % 8)); src-size 0 zero-fills the padding, the image edges and the
//    K tail. These tiles give VGG-16's batch-32 convs 392-3136 tiles (3-24
//    an SM) and 196 at 512 filters on 14 pixels, one wave of two blocks an
//    SM. The epilogue finishes each accumulator and pairs lanes with one
//    shuffle so that each thread stores 4 filters of a pixel as one
//    16-byte f32 store (F % 4 == 0; single floats otherwise).
//  * c8_split (the same kernels where the output tiles fill less than half
//    the SMs: batch 1, the 7-pixel layers). The K tiles are split over
//    blockIdx.z, at least two a split and about two blocks an SM; each
//    split adds its int32 sums into a zeroed workspace with integer
//    atomics and conv_int8_finish, a programmatic dependent, applies the
//    epilogue.
//  * c8_small_c (C % 16 != 0: the 3-channel stems of VGG-16, ResNet-50 and
//    Inception-v1). conv_int8_igemm quantizes on load: a block owns a 64 x
//    64 tile and walks K 32 at a time, each thread gathering 16 k of one A
//    row from the f32 input and 16 k of one B column from the HWIO weight
//    into shared memory, four warps running mma.sync.m16n8k32 s8 tiles; K
//    is split as above where the tiles are few.
//
// What bounds it on this card: the int8 tensor-core operations (2 M N K at
// 1,979 TOP/s) or the bytes (x read once as f32, w once, out written once
// as f32 at 3.35 TB/s), whichever is larger. At VGG-16's 112- and 56-pixel
// layers the bytes do, and the f32 output is their largest term; at the
// 14- and 7-pixel layers the products do. The quantize pass adds 2 bytes
// an activation (written once as int8, read back by the GEMM) above that
// bound: the design's cost for dividing each activation once instead of kh
// * kw times.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;

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

// ---------------------------------------------------------------------------
// the quantize pass: x (n f32) -> xq (n int8). Where both lie on 16 bytes,
// each warp takes 512 elements a step: four coalesced 16-byte loads a lane,
// the packed words staged through shared memory, one coalesced 16-byte
// store a lane; the tail (and unaligned tensors) one element a thread
// ---------------------------------------------------------------------------

constexpr int Q_THREADS = 256, Q_WARPS = Q_THREADS / 32, Q_CHUNK = 512;

__global__ void __launch_bounds__(Q_THREADS)
    conv_int8_quantize(const float* __restrict__ x,
                       const float* __restrict__ x_scale,
                       int8_t* __restrict__ xq, long long n, int vec) {
  __shared__ __align__(16) uint32_t stage[Q_WARPS][Q_CHUNK / 4];
  const float xs = *x_scale;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long chunks = vec ? n / Q_CHUNK : 0;
  for (long long ch = (long long)blockIdx.x * Q_WARPS + warp; ch < chunks;
       ch += (long long)gridDim.x * Q_WARPS) {
    const float4* p = reinterpret_cast<const float4*>(x) + ch * 128;
    float4 f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = __ldcs(p + 32 * j + lane);  // once
#pragma unroll
    for (int j = 0; j < 4; ++j)
      stage[warp][32 * j + lane] =
          quantize(f[j].x, xs) | quantize(f[j].y, xs) << 8 |
          quantize(f[j].z, xs) << 16 | quantize(f[j].w, xs) << 24;
    __syncwarp();
    reinterpret_cast<uint4*>(xq)[ch * 32 + lane] =
        reinterpret_cast<const uint4*>(stage[warp])[lane];
    __syncwarp();
  }
  for (long long e = chunks * Q_CHUNK + (long long)blockIdx.x * Q_THREADS +
                     threadIdx.x;
       e < n; e += (long long)gridDim.x * Q_THREADS)
    xq[e] = static_cast<int8_t>(quantize(x[e], xs));
}

// ---------------------------------------------------------------------------
// the repack: the HWIO weight read as (K, F) -> (F, K), K contiguous, through
// a 32 x 32 tile of shared memory
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
    conv_int8_repack(const int8_t* __restrict__ w, int8_t* __restrict__ wk,
                     int K, int F) {
  __shared__ int8_t tile[32][33];
  const int f0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {
    const int k = k0 + r, f = f0 + tx;
    tile[r][tx] = (k < K && f < F) ? w[(size_t)k * F + f] : 0;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int f = f0 + r, k = k0 + tx;
    if (f < F && k < K) wk[(size_t)f * K + k] = tile[tx][r];
  }
}

// ---------------------------------------------------------------------------
// c8_small_c: quantize on load, mma.sync tiles
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int LDS = BK + 16;  // bytes a shared row of A or B takes

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

// ---------------------------------------------------------------------------
// c8_wgmma and c8_split: int8 x from the quantize pass, the (F, K) weight
// ---------------------------------------------------------------------------

constexpr int W_BM = 128, W_BK = 128, W_THREADS = 256;

// 3 stages: 72 KB of shared memory at TN = 64 (three blocks an SM), 96 KB
// at TN = 128 (two)
template <int TN>
struct WTile {
  static constexpr int STAGES = 3;
  static constexpr int A_BYTES = W_BM * W_BK;
  static constexpr int B_BYTES = TN * W_BK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES +
                                 8 * STAGES;
};

// 16 bytes from global to shared memory, asynchronously; all 16 written as
// zeros when src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Block (x, y, z): output pixels 128 x .., filters TN y .., K tiles
// per z .. per (z + 1) - 1 (of 128 k each). Warpgroup wg multiplies pixels
// 64 wg .. 64 wg + 63 of the tile.
template <int TN>
__global__ void __launch_bounds__(W_THREADS, 2)
    conv_int8_wgmma(const __grid_constant__ CUtensorMap tm_w,
                    const int8_t* __restrict__ xq,
                    const float* __restrict__ x_scale,
                    const float* __restrict__ w_scale,
                    const float* __restrict__ bias, int relu,
                    float* __restrict__ out, int* __restrict__ ws, int H,
                    int W, int C, int KW, int F, int HO, int WO, int SH,
                    int SW, int DH, int DW, int PH, int PW, int M, int K,
                    int per) {
  typedef WTile<TN> T;
  constexpr int S = T::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  auto a_slot = [&](int i) { return base + (i % S) * T::STAGE_BYTES; };
  auto b_slot = [&](int i) { return a_slot(i) + T::A_BYTES; };
  const uint32_t full = base + S * T::STAGE_BYTES;  // a stage's B landed

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * W_BM, n0 = blockIdx.y * TN;
  const int kt0 = blockIdx.z * per;
  const int nk = min((K + W_BK - 1) / W_BK, kt0 + per) - kt0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(full + 8 * s);
    fence_barrier_init();
  }
  __syncthreads();

  // this thread's A chunk: 16 k (chunk `chunk` of each 128-k stage) of
  // pixels row0 + 32 j, j < 4, at the swizzled place in the stage
  const int chunk = tid & 7, row0 = tid >> 3;
  const uint32_t dst0 = row0 * W_BK + ((chunk ^ (row0 & 7)) << 4);
  int ih0[4], iw0[4], pix[4];  // pix: b * H * W, or -1 past M
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + row0 + 32 * j;
    ih0[j] = iw0[j] = 0;
    pix[j] = -1;
    if (m < M) {
      const int b = m / (HO * WO), rem = m - b * HO * WO;
      const int oh = rem / WO, ow = rem - oh * WO;
      ih0[j] = oh * SH - PH;
      iw0[j] = ow * SW - PW;
      pix[j] = b * H * W;
    }
  }
  // the chunk's k as its filter tap (r, s) and channel c; C % 16 == 0, so
  // a chunk never straddles two taps
  int k = kt0 * W_BK + 16 * chunk;
  int rs = k / C, c = k - rs * C;
  int r = rs / KW, s = rs - r * KW;

  // K tile kt0 + i into stage i % S: A by cp.async (this thread's four
  // chunks), B by one TMA from thread 0; then the chunk's k moves 128 on
  auto load = [&](int i) {
    const uint32_t a = a_slot(i) + dst0;
    const bool k_in = k < K;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ih = ih0[j] + r * DH, iw = iw0[j] + s * DW;
      const bool ok = k_in && pix[j] >= 0 && (unsigned)ih < (unsigned)H &&
                      (unsigned)iw < (unsigned)W;
      const int8_t* src =
          ok ? xq + ((size_t)(pix[j] + ih * W + iw) * C + c) : xq;
      cp_async16(a + j * 32 * W_BK, src, ok ? 16 : 0);
    }
    const uint32_t bar = full + 8 * (i % S);
    mbar_expect_if(tid == 0, bar, T::B_BYTES);
    tma_2d_if(tid == 0, b_slot(i), &tm_w, bar, (kt0 + i) * W_BK, n0);
    k += W_BK;
    c += W_BK;
    while (c >= C) {
      c -= C;
      if (++s == KW) {
        s = 0;
        ++r;
      }
    }
  };

  int acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < nk) load(i);
    cp_async_commit();
  }
  const int wg = warp >> 2;
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<S - 2>();  // this thread's chunks of K tile i landed
    fence_proxy_async();     // ... and are visible to wgmma
    __syncthreads();         // everyone's; and K tile i - 1 multiplied
    if (i + S - 1 < nk) load(i + S - 1);  // into K tile i - 1's stage
    cp_async_commit();
    mbar_wait(full + 8 * (i % S), (i / S) & 1);
    wgmma_fence();
    const uint32_t a = a_slot(i) + wg * 64 * W_BK;
#pragma unroll
    for (int kk = 0; kk < W_BK / 32; ++kk)
      wgmma_s8(acc, desc_s8(a, kk), desc_s8(b_slot(i), kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // register 4 j + e: pixel m0 + 64 wg + 16 v + g + 8 (e >> 1), filter
  // n0 + 8 j + 2 t + (e & 1) (the accumulator layout in hopper.cuh)
  const int v = warp & 3, g = lane >> 2, t = lane & 3;
  const int mrow = m0 + 64 * wg + 16 * v + g;
  if (gridDim.z > 1) {
#pragma unroll
    for (int j = 0; j < TN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mrow + 8 * (e >> 1), n = n0 + 8 * j + 2 * t + (e & 1);
        if (m < M && n < F) atomicAdd(ws + (size_t)m * F + n, acc[4 * j + e]);
      }
    return;
  }
  // lanes t and t ^ 1 swap halves: an even t stores filters 4 (t / 2) ..
  // + 3 of pixel g, an odd t the same filters of pixel g + 8
  const float xs = *x_scale;
  const bool odd = t & 1, vec4 = (F & 3) == 0;
  const int m = mrow + (odd ? 8 : 0);
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + 8 * j + 2 * t + (e & 1);
      y[e] = n < F ? finish(acc[4 * j + e], n, xs, w_scale, bias, relu) : 0.f;
    }
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? y[0] : y[2], 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? y[1] : y[3], 1);
    const float4 q = odd ? make_float4(r0, r1, y[2], y[3])
                         : make_float4(y[0], y[1], r0, r1);
    const int n = n0 + 8 * j + 4 * (t >> 1);
    if (m >= M || n >= F) continue;
    float* o = out + (size_t)m * F + n;
    if (vec4) {
      *reinterpret_cast<float4*>(o) = q;
    } else {
      o[0] = q.x;
      if (n + 1 < F) o[1] = q.y;
      if (n + 2 < F) o[2] = q.z;
      if (n + 3 < F) o[3] = q.w;
    }
  }
}

// the split sums of each output, finished; a programmatic dependent of
// conv_int8_igemm or conv_int8_wgmma
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

// host: the (F, K) weight as boxes of 128 k x TN filters in the 128-byte
// swizzle; k past K and filters past F read as zeros
bool encode_wk(CUtensorMap* map, const void* wk, int K, int F, int TN) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)F};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)W_BK, (cuuint32_t)TN};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, wk, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

template <int TN>
cudaError_t launch_wgmma(const CUtensorMap& tm, dim3 grid, cudaStream_t st,
                         const int8_t* xq, const float* xs, const float* wsc,
                         const float* bias, int relu, float* out, int* ws,
                         int H, int W, int C, int KW, int F, int HO, int WO,
                         int SH, int SW, int DH, int DW, int PH, int PW,
                         int M, int K, int per) {
  const size_t bytes = WTile<TN>::SMEM;
  cudaError_t err = set_smem(conv_int8_wgmma<TN>, bytes);
  if (err != cudaSuccess) return err;
  conv_int8_wgmma<TN><<<grid, W_THREADS, bytes, st>>>(
      tm, xq, xs, wsc, bias, relu, out, ws, H, W, C, KW, F, HO, WO, SH, SW,
      DH, DW, PH, PW, M, K, per);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// C8's quantize pass: xq (n int8) = x (n f32) quantized to *x_scale (on
// the device). Returns the launch's CUDA error code.
extern "C" int int8_conv_quantize(const void* x, const void* x_scale,
                                  void* xq, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int vec = aligned16(x) && aligned16(xq);
  const long long work =
      vec ? std::max(n / Q_CHUNK * 32, n % Q_CHUNK) : n;  // threads
  const long long blocks =
      std::min<long long>((work + Q_THREADS - 1) / Q_THREADS, 1 << 20);
  conv_int8_quantize<<<(unsigned)blocks, Q_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(x_scale),
      static_cast<int8_t*>(xq), n, vec);
  return (int)cudaGetLastError();
}

// C8's weight repack: wk (F, K) = w (K, F) transposed, int8. Returns the
// launch's CUDA error code.
extern "C" int int8_conv_repack(const void* w, void* wk, int K, int F,
                                void* stream) {
  if (K <= 0 || F <= 0 || (K + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  conv_int8_repack<<<dim3((F + 31) / 32, (K + 31) / 32), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<int8_t*>(wk), K, F);
  return (int)cudaGetLastError();
}

// C8's GEMM on route `route` (0 c8_small_c: x (B, H, W, C) f32 and w (KH,
// KW, C, F) int8; 1 c8_wgmma or c8_split: x the quantize pass's int8 and w
// the repacked (F, KH * KW * C) int8, C % 16 == 0, tn 64 or 128 filters a
// tile); x_scale (1,) f32 on the device, w_scale (F,) f32, bias (F,) f32
// or null, out (B, HO, WO, F) f32, all contiguous; strides (SH, SW),
// dilation (DH, DW), the low-side padding (PH, PW). K is split `splits`
// ways, `per` K steps a split (32 k a step on route 0, 128 on route 1);
// with more than one split, workspace holds M * F int32 (zeroed here).
// Returns the launches' CUDA error code.
extern "C" int int8_static_conv2d(const void* x, const void* x_scale,
                                  const void* w, const void* w_scale,
                                  const void* bias, int relu, void* out,
                                  void* workspace, long long workspace_ints,
                                  int B, int H, int W, int C, int KH, int KW,
                                  int F, int HO, int WO, int SH, int SW,
                                  int DH, int DW, int PH, int PW, int route,
                                  int tn, int splits, int per, void* stream) {
  const long long M = (long long)B * HO * WO;
  const long long K = (long long)KH * KW * C;
  const int step = route == 0 ? BK : W_BK;
  const long long steps = (K + step - 1) / step;
  if (M <= 0 || F <= 0 || K <= 0 || M >= (1LL << 31) || K >= (1LL << 31) ||
      (long long)B * H * W * C >= (1LL << 31) || SH < 1 || SW < 1 ||
      DH < 1 || DW < 1 || PH < 0 || PW < 0 || splits < 1 || per < 1 ||
      splits > 65535 || (long long)(splits - 1) * per >= steps ||
      (long long)splits * per < steps)
    return (int)cudaErrorInvalidValue;
  if (route == 1 && (C % 16 != 0 || (tn != 64 && tn != 128) ||
                     !aligned16(x) || !aligned16(w)))
    return (int)cudaErrorInvalidValue;
  if (route != 0 && route != 1) return (int)cudaErrorInvalidValue;
  const int tile_n = route == 0 ? BN : tn;
  if ((F + tile_n - 1) / tile_n > 65535) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (workspace == nullptr || workspace_ints < M * F))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* ws = static_cast<int*>(workspace);
  if (splits > 1) {
    const cudaError_t err =
        cudaMemsetAsync(ws, 0, (size_t)M * F * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
  }
  const float* xs = static_cast<const float*>(x_scale);
  const float* wsc = static_cast<const float*>(w_scale);
  const float* bb = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (route == 0) {
    const dim3 grid((unsigned)((M + BM - 1) / BM),
                    (unsigned)((F + BN - 1) / BN), (unsigned)splits);
    conv_int8_igemm<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), xs, static_cast<const int8_t*>(w), wsc,
        bb, relu, o, ws, H, W, C, KW, F, HO, WO, SH, SW, DH, DW, PH, PW,
        (int)M, (int)K, per * BK);
    err = cudaGetLastError();
  } else {
    CUtensorMap tm;
    if (!encode_wk(&tm, w, (int)K, F, tn)) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((M + W_BM - 1) / W_BM),
                    (unsigned)((F + tn - 1) / tn), (unsigned)splits);
    const int8_t* xq = static_cast<const int8_t*>(x);
    err = tn == 64
              ? launch_wgmma<64>(tm, grid, st, xq, xs, wsc, bb, relu, o, ws,
                                 H, W, C, KW, F, HO, WO, SH, SW, DH, DW, PH,
                                 PW, (int)M, (int)K, per)
              : launch_wgmma<128>(tm, grid, st, xq, xs, wsc, bb, relu, o,
                                  ws, H, W, C, KW, F, HO, WO, SH, SW, DH, DW,
                                  PH, PW, (int)M, (int)K, per);
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = M * F;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((total + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, conv_int8_finish, (const int*)ws, xs,
                                 wsc, bb, relu, o, total, (int)F);
}
