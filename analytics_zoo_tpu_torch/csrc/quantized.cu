// Int8 weight-only dequant-matmul for Hopper (sm_90a): K6, bound through a
// plain C entry point and loaded with ctypes.
//
// Replaces: analytics_zoo_tpu/ops/pallas/quantized.py, the Pallas kernel
// _kernel (pl.pallas_call in int8_matmul at :63). Int8 weights, f32
// per-column scales, x and out in f32 or bf16, f32 accumulation. Two
// modes, chosen by the caller:
//  * scale after (the Pallas contract, the default of the Python
//    wrapper): out = (x @ w_q as f32) * scales[col], the scale applied to
//    each column after its reduction, then one rounding to x's dtype.
//  * dequantize first (what the JAX package's weight-only predict
//    computes, dequantize_int8 in pipeline/inference/inference_model.py,
//    and what the port's dense layer asks for): each weight is formed in
//    x's dtype before the product, w = q * s with s first rounded to that
//    dtype and the product rounded once (exact before that rounding:
//    |q| <= 127 has 7 bits, a bf16 s 8), then out = x @ w summed in f32
//    and rounded once, with no scale after. In bf16 the two modes differ
//    by up to half a bf16 step per column (the rounding of s) and per
//    weight; only the second gives the JAX predict's numbers.
// The int8 weights stay int8 in device memory: they are widened (and, in
// the second mode, scaled) on the way from device memory to the
// products, so the bytes read per weight stay one, the point of
// weight-only quantization.
//
// What bounds it on this card: at batch 1 (config A's M = 1, K = N = 4096)
// it is a matrix-vector product, 16.8 MB of int8 and nothing else, so the
// bytes bound it (0.0050 ms at 3.35 TB/s). At BERT's shapes (M = 16,384
// rows of 32 x 512 tokens, K and N 768 to 3072, bf16) it does thousands
// of operations per byte and the products bound it. Four kernels:
//  * skinny (M <= 32, f32 or bf16 x): a block owns 32 columns and up to 4
//    rows (1 at M = 1) and loops over all of K: each of its 128 pairs of
//    threads walks every 128th row of w, a thread loading 16 int8 of a row
//    in one 16-byte load (where N and w's alignment allow; byte loads
//    elsewhere, as for the Dense(8) and Dense(2) heads), four rows ahead.
//    Products in f32 FMAs (a bf16 x int8 or bf16 x bf16 product is exact
//    in f32). The 128 partial sums of each output are then added in a
//    fixed tree: a butterfly over the 16 k-groups of a warp, then the 8
//    warps in order. The second mode scales the 16 weights where they are
//    widened in registers.
//  * wgmma (M > 32, bf16 x, K % 8 == 0, N % 16 == 0, 16-byte aligned x
//    and w: every BERT product): the product is taken transposed, out^T =
//    w^T x^T, so the int8 weights are wgmma's register A operand and are
//    never written back widened. A block owns 256 rows of x and 128
//    columns of w and loops over K in 64-wide steps through a ring of 5
//    stages, each holding the x tile (bf16, 256 rows in the 128-byte
//    swizzle: wgmma's K-major B operand) and the w tile as int8 (one byte
//    a weight from device memory, 128-byte swizzled), copied by TMA from a
//    producer warp. Two consumer warpgroups own 64 columns of w each: a
//    thread loads the int8 pairs of its A fragment (its two accumulator
//    rows are two adjacent columns, so one 2-byte load a k row) and widens
//    them in registers with two byte permutes and a subtraction (exact:
//    |q| <= 127 fits bf16's 8-bit mantissa; in the second mode q * s
//    rounded once to bf16), then runs wgmma m64n256k16 (bf16 in, f32
//    accumulate) against the x tile, and releases the stage on an
//    mbarrier the producer waits on before refilling it. Widening in
//    registers keeps shared memory for the copies and the x operand: a
//    design that widened each w tile into shared memory as wgmma's B
//    operand moved more shared-memory bytes than the products could hide
//    and ran at less than half this one's speed. Epilogue: the
//    accumulator holds out^T, each thread two adjacent columns of 64 rows;
//    in the first mode acc * scales[col] in f32; one rounding to bf16.
//  * mma (M > 32, bf16 x, the shapes TMA cannot address): a block owns a
//    128 x 128 output tile and loops over K in 32-wide steps. The x tile
//    and the int8 w tile widened to bf16 are staged in shared memory, the
//    next step's tiles loaded into registers while the current one is
//    multiplied. Products with mma.sync m16n8k16 (bf16 in, f32
//    accumulate); 8 warps of 64 x 32 outputs each; the w fragments come
//    from the row-major tile through ldmatrix.trans. Epilogue: in the
//    first mode acc * scales[col] in f32; one rounding to bf16. bf16 x bf16
//    products are exact in f32, so the only difference between the tile
//    kernels and the TPU kernel (or the JAX predict) is the order of the
//    sum.
//  * fma (M > 32, f32 x): a block owns a 64 x 64 output tile, 16 rows of
//    K at a time through shared memory, each thread 4 x 4 outputs, plain
//    FMAs on the CUDA cores (TF32 would round x to 10 mantissa bits, which
//    the f32 contract does not allow).
// No block carries anything to another and nothing is split over K across
// blocks: every output is written once by one thread, its sum taken in a
// fixed order, so the result is the same bits from run to run. Any M, K
// and N: edges are masked on load (zeros) and on store.

#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and widened back: the value a T holds
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// a column's scale as the dequantize-first mode uses it: rounded to the
// compute dtype T (0 past N)
template <typename T>
__device__ __forceinline__ float col_scale(const float* __restrict__ scales,
                                           int col, int N) {
  return col < N ? round_to<T>(scales[col]) : 0.f;
}

__device__ __forceinline__ float int8_at(uint32_t word, int byte) {
  return static_cast<float>(static_cast<int8_t>(word >> (8 * byte)));
}

// the 4 int8 of `word` as two bf16 pairs (bytes 0-1 in lo, 2-3 in hi),
// exactly and without conversion instructions: each byte, offset to
// unsigned, becomes the low mantissa byte of the f32 2^23 + 128 + q (one
// byte permute), one subtraction leaves q, and since |q| <= 128 needs at
// most 8 significant bits the f32's upper half is q in bf16
__device__ __forceinline__ void widen4(uint32_t word, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = word ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) -
        8388736.f);
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}

// 16 int8 of row k of w (K x N), columns c .. c + 15; zeros past N. `vec`:
// N is a multiple of 16 and w is 16-byte aligned, so one 16-byte load.
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ w, int k,
                                        int c, int N, int vec) {
  const int8_t* p = w + (size_t)k * N + c;
  if (vec) return c < N ? *reinterpret_cast<const uint4*>(p) : uint4{};
  uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (c + j < N)
      u[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j]))
                   << (8 * (j & 3));
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// ---------------------------------------------------------------------------
// skinny: M <= 32
// ---------------------------------------------------------------------------

constexpr int S_THREADS = 256;
constexpr int S_BN = 32;                // columns per block
constexpr int S_KG = S_THREADS / 2;     // k groups (pairs of threads)
constexpr int S_AHEAD = 4;              // rows of w in flight per thread
constexpr int SKINNY_MAX_M = 32;

// PRE: dequantize first (each weight q * s rounded to T before its
// product, no scale after); else the scale after the reduction
template <typename T, int MT, bool PRE>
__global__ void __launch_bounds__(S_THREADS)
    int8_mm_skinny(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scales, T* __restrict__ out,
                   int M, int K, int N, int vec) {
  __shared__ float part[S_THREADS / 32][MT][S_BN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = tid & 1, kg = tid >> 1;
  const int c0 = blockIdx.x * S_BN + 16 * half;
  const int m0 = blockIdx.y * MT;
  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;
  float sc[16];  // this thread's 16 column scales, rounded to T
#pragma unroll
  for (int j = 0; j < 16; ++j)
    sc[j] = PRE ? col_scale<T>(scales, c0 + j, N) : 0.f;

  for (int kb = kg; kb < K; kb += S_KG * S_AHEAD) {
    uint4 raw[S_AHEAD];
    float xv[S_AHEAD][MT];
#pragma unroll
    for (int u = 0; u < S_AHEAD; ++u) {
      const int k = kb + u * S_KG;
      raw[u] = k < K ? load16(w, k, c0, N, vec) : uint4{};
#pragma unroll
      for (int m = 0; m < MT; ++m)
        xv[u][m] = k < K && m0 + m < M
                       ? to_f32(x[(size_t)(m0 + m) * K + k])
                       : 0.f;
    }
#pragma unroll
    for (int u = 0; u < S_AHEAD; ++u) {
      const uint32_t word[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float q = int8_at(word[j >> 2], j & 3);
        const float wv = PRE ? round_to<T>(q * sc[j]) : q;
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][j] = fmaf(xv[u][m], wv, acc[m][j]);
      }
    }
  }

  // the 16 k groups of a warp with the same column half: a butterfly, so
  // every lane ends with the same bits of the same tree
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[m][j];
#pragma unroll
      for (int o = 2; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[m][j] = v;
    }
  if (lane < 2) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) part[warp][m][16 * lane + j] = acc[m][j];
  }
  __syncthreads();
  if (tid < MT * S_BN) {
    const int m = tid / S_BN, c = tid % S_BN;
    const int row = m0 + m, col = blockIdx.x * S_BN + c;
    if (row < M && col < N) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < S_THREADS / 32; ++p) s += part[p][m][c];
      out[(size_t)row * N + col] = from_f32<T>(PRE ? s : s * scales[col]);
    }
  }
}

// ---------------------------------------------------------------------------
// mma: M > 32, bf16. mma.sync m16n8k16 fragments (PTX ISA): with g = lane / 4
// and t = lane % 4 a thread holds A rows g and g+8 at columns 2t, 2t+1 (and
// +8); B columns g at rows 2t, 2t+1 (and +8); C rows g and g+8 at columns
// 2t, 2t+1.
// ---------------------------------------------------------------------------

constexpr int T_BM = 128, T_BN = 128, T_BK = 32, T_THREADS = 256;
constexpr int LDA = T_BK + 8;   // bf16; 80-byte rows: conflict-free fragments
constexpr int LDB = T_BN + 8;   // bf16; 272-byte rows: conflict-free ldmatrix

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 8x8 b16 matrices, transposed on the way: lanes 8j..8j+7 give the
// row addresses of matrix j, and register j receives that matrix's
// fragment with rows and columns swapped
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <bool PRE>
__global__ void __launch_bounds__(T_THREADS)
    int8_mm_mma(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scales, bf16* __restrict__ out,
                int M, int K, int N, int xvec, int wvec) {
  __shared__ __align__(16) bf16 sA[2][T_BM * LDA];
  __shared__ __align__(16) bf16 sB[2][T_BK * LDB];
  // PRE: the block's column scales rounded to bf16, in pairs (in shared
  // memory, not registers: 16 more live registers a thread would halve
  // the blocks an SM holds)
  __shared__ __align__(16) __nv_bfloat162 sS[T_BN / 2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * T_BM, n0 = blockIdx.x * T_BN;

  // the next step's tiles, in registers: x as 2 x 8 bf16 (rows tid / 4
  // and 64 + tid / 4, columns 8 (tid % 4) ..), w as 16 int8 (row tid / 8,
  // columns 16 (tid % 8) ..)
  uint4 ra[2];
  uint4 rb;
  if (PRE && tid < T_BN / 2)
    sS[tid] =
        __floats2bfloat162_rn(col_scale<bf16>(scales, n0 + 2 * tid, N),
                              col_scale<bf16>(scales, n0 + 2 * tid + 1, N));
  auto load = [&](int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + tid / 4 + 64 * h, c = k0 + (tid % 4) * 8;
      const bf16* p = x + (size_t)r * K + c;
      if (xvec) {
        ra[h] = r < M && c < K ? *reinterpret_cast<const uint4*>(p) : uint4{};
      } else {
        uint32_t u[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bf16 zero = __float2bfloat16(0.f);
          const bf16 lo = r < M && c + 2 * e < K ? p[2 * e] : zero;
          const bf16 hi = r < M && c + 2 * e + 1 < K ? p[2 * e + 1] : zero;
          __nv_bfloat162 v(lo, hi);
          u[e] = *reinterpret_cast<uint32_t*>(&v);
        }
        ra[h] = make_uint4(u[0], u[1], u[2], u[3]);
      }
    }
    const int kr = k0 + tid / 8;
    rb = kr < K ? load16(w, kr, n0 + (tid % 8) * 16, N, wvec) : uint4{};
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint4*>(&sA[buf][(tid / 4 + 64 * h) * LDA +
                                         (tid % 4) * 8]) = ra[h];
    const uint32_t word[4] = {rb.x, rb.y, rb.z, rb.w};
    uint32_t v[8];  // columns 2e and 2e + 1 of the 16
    if (PRE) {
      // q * s in one bf16 rounding of the exact product (a bf16x2
      // multiply; q is exact in bf16)
      __nv_bfloat162 s2[8];
      const uint4* sp = reinterpret_cast<const uint4*>(sS) + (tid % 8) * 2;
      *reinterpret_cast<uint4*>(s2) = sp[0];
      *reinterpret_cast<uint4*>(s2 + 4) = sp[1];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        __nv_bfloat162 w = __hmul2(
            __floats2bfloat162_rn(int8_at(word[e >> 1], 2 * (e & 1)),
                                  int8_at(word[e >> 1], 2 * (e & 1) + 1)),
            s2[e]);
        v[e] = *reinterpret_cast<uint32_t*>(&w);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = pack_bf16(int8_at(word[e >> 1], 2 * (e & 1)),
                         int8_at(word[e >> 1], 2 * (e & 1) + 1));
    }
    uint4* dst = reinterpret_cast<uint4*>(
        &sB[buf][(tid / 8) * LDB + (tid % 8) * 16]);
    dst[0] = make_uint4(v[0], v[1], v[2], v[3]);
    dst[1] = make_uint4(v[4], v[5], v[6], v[7]);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // matrix j = lane / 8 of each ldmatrix: k rows +8 for odd j, columns +8
  // for j >= 2 -> B fragments (b0, b1) of two adjacent 8-column tiles
  const int b_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDB + wn +
                    8 * (lane >> 4);
  const int nk = (K + T_BK - 1) / T_BK;
  load(0);
  if (PRE) __syncthreads();  // sS is written
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * T_BK);
    const bf16* A = sA[buf];
    const bf16* B = sB[buf] + b_off;
#pragma unroll
    for (int kk = 0; kk < T_BK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bf16* p = A + (wm + 16 * i + g) * LDA + kk + 2 * t;
        a[i][0] = ld32(p);
        a[i][1] = ld32(p + 8 * LDA);
        a[i][2] = ld32(p + 8);
        a[i][3] = ld32(p + 8 * LDA + 8);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t b[4];
        ldsm_x4_trans(b, B + kk * LDB + 16 * p);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_bf16(acc[i][2 * p], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  const int ovec = N % 2 == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + 8 * j + 2 * t;
    const float s0 = PRE ? 1.f : (col < N ? scales[col] : 0.f);
    const float s1 = PRE ? 1.f : (col + 1 < N ? scales[col + 1] : 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + 16 * i + g + 8 * h;
        if (row >= M) continue;
        const float v0 = acc[i][j][2 * h] * s0, v1 = acc[i][j][2 * h + 1] * s1;
        bf16* o = out + (size_t)row * N + col;
        if (ovec && col + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < N) o[0] = __float2bfloat16(v0);
          if (col + 1 < N) o[1] = __float2bfloat16(v1);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// wgmma: M > 32, bf16 x, K % 8 == 0 and N % 16 == 0 (the rows TMA can
// address), 16-byte aligned bases. Warps 0-7 (two warpgroups) consume,
// warp 8 issues the copies (the helpers and fragment layouts are in
// hopper.cuh).
// ---------------------------------------------------------------------------

constexpr int G_BM = 256, G_BN = 128, G_BK = 64;  // x rows, w columns, k
constexpr int G_THREADS = 288;  // two consumer warpgroups, a producer warp
constexpr int G_STAGES = 5;
// a stage: x (four 64-row K-major boxes in the 128-byte swizzle, one
// K-major B operand of 256 rows) and w as it lies in device memory (64
// rows of 128 int8, 128-byte swizzled)
constexpr int G_XBOX_BYTES = Tile<64>::BYTES;
constexpr int G_X_BYTES = 4 * G_XBOX_BYTES;
constexpr int G_W_BYTES = G_BK * G_BN;
constexpr int G_STAGE_BYTES = G_X_BYTES + G_W_BYTES;
constexpr size_t G_SMEM = 1024 + (size_t)G_STAGES * G_STAGE_BYTES +
                          16 * G_STAGES;

template <bool PRE>
__global__ void __launch_bounds__(G_THREADS, 1)
    int8_mm_wgmma(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w,
                  const float* __restrict__ scales, bf16* __restrict__ out,
                  int M, int K, int N) {
  constexpr int S = G_STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  auto x_slot = [&](int i) { return base + (i % S) * G_STAGE_BYTES; };
  auto w_slot = [&](int i) { return x_slot(i) + G_X_BYTES; };
  const uint32_t full = base + S * G_STAGE_BYTES;  // a k step's tiles landed
  const uint32_t empty = full + 8 * S;  // both warpgroups multiplied them

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * G_BN, m0 = blockIdx.y * G_BM;
  const int nk = (K + G_BK - 1) / G_BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s);
      mbar_init(empty + 8 * s, 8);  // the consumers' eight warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {
    // producer: k step j into stage j % S once both warpgroups are done
    // with step j - S; x's rows m0 .. m0 + 255 (the boxes with any row
    // before M) and w's rows 64 j .., columns n0 .. n0 + 127, zeros past
    // M, K and N
    if (lane == 0) {
      const int n_box = min(4, (M - m0 + 63) / 64);
      for (int j = 0; j < nk; ++j) {
        const uint32_t bar = full + 8 * (j % S);
        if (j >= S) mbar_wait(empty + 8 * (j % S), (j / S - 1) & 1);
        mbar_expect(bar, n_box * G_XBOX_BYTES + G_W_BYTES);
        for (int b = 0; b < n_box; ++b)
          tma_2d(x_slot(j) + b * G_XBOX_BYTES, &tm_x, bar, j * G_BK,
                 m0 + 64 * b);
        tma_2d(w_slot(j), &tm_w, bar, n0, j * G_BK);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns w columns n0 + 64 wg .. + 63. Its A rows
  // are those columns, ordered so that a thread's two rows (g, g + 8 of
  // its warp's 16) are two adjacent columns: one 2-byte load a k row
  const int wg = warp >> 2, v = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int c = 64 * wg + 16 * v + 2 * g;  // this thread's column pair
  const int n = n0 + c;
  const bool active = n0 + 64 * wg < N;
  // dequantize-first: each column's scale rounded to bf16, in both halves
  __nv_bfloat162 s2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sc = PRE ? col_scale<bf16>(scales, n + h, N) : 1.f;
    s2[h] = __floats2bfloat162_rn(sc, sc);
  }
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    mbar_wait(full + 8 * (i % S), (i / S) & 1);
    if (active) {
      // A = w^T: for each 16-row k step, rows k = 2t, 2t + 1 (registers 0
      // and 1) and 2t + 8, 2t + 9 (2 and 3) of this thread's two columns,
      // widened in registers (in the dequantize-first mode times the
      // column's bf16 scale, one rounding)
      const unsigned char* w8 = smem_raw + (w_slot(i) - raw);
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k = 16 * kk + 2 * t + 8 * half;
          // the 128-byte swizzle: 16-byte chunk c / 16 of row k lies at
          // chunk (c / 16) ^ (k % 8)
          const uint32_t lo = *reinterpret_cast<const uint16_t*>(
              w8 + k * G_BN + ((((c >> 4) ^ (k & 7)) << 4) | (c & 15)));
          const uint32_t hi = *reinterpret_cast<const uint16_t*>(
              w8 + (k + 1) * G_BN + ((((c >> 4) ^ ((k + 1) & 7)) << 4) |
                                     (c & 15)));
          uint32_t r0, r1;  // (k, k + 1) of column c, of column c + 1
          widen4(__byte_perm(lo, hi, 0x5140), r0, r1);
          if (PRE) {
            __nv_bfloat162 p0 = __hmul2(
                *reinterpret_cast<__nv_bfloat162*>(&r0), s2[0]);
            __nv_bfloat162 p1 = __hmul2(
                *reinterpret_cast<__nv_bfloat162*>(&r1), s2[1]);
            r0 = *reinterpret_cast<uint32_t*>(&p0);
            r1 = *reinterpret_cast<uint32_t*>(&p1);
          }
          a[kk][2 * half] = r0;
          a[kk][2 * half + 1] = r1;
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs256_k(acc, a[kk], desc_k<64>(x_slot(i), kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(a);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (i % S));
  }
  if (!active || n >= N) return;

  // epilogue: acc holds out^T; register 4j + e is column n + (e >> 1) of
  // row m0 + 8j + 2t + (e & 1). In the scale-after mode acc * scales[col]
  // in f32; one rounding to bf16
  const float s0 = PRE ? 1.f : scales[n], s1 = PRE ? 1.f : scales[n + 1];
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * j + 2 * t + h;
      if (m < M)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
            __floats2bfloat162_rn(acc[4 * j + h] * s0,
                                  acc[4 * j + 2 + h] * s1);
    }
}

// host: x (M, K) bf16 as 64 x 64 boxes and w (K, N) int8 as 64-row x
// 128-column boxes, both in the 128-byte swizzle
bool encode_x(CUtensorMap* map, const void* x, int M, int K) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {64, 64};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

bool encode_w(CUtensorMap* map, const void* w, int K, int N) {
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {(cuuint32_t)G_BN, (cuuint32_t)G_BK};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

// ---------------------------------------------------------------------------
// fma: M > 32, f32. Thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16 i and columns tx + 16 j of the block's tile, i, j < 4.
// ---------------------------------------------------------------------------

constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;

template <bool PRE>
__global__ void __launch_bounds__(F_THREADS)
    int8_mm_fma(const float* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scales, float* __restrict__ out,
                int M, int K, int N, int xvec, int wvec) {
  __shared__ float sA[F_BK][F_BM + 4];   // x tile, transposed: [k][row]
  __shared__ float sB[F_BK][F_BN];       // w tile widened to f32
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  // the next step's tiles: x row tid / 4, columns 4 (tid % 4) ..; w row
  // tid / 16, columns 4 (tid % 16) ..
  float ra[4];
  uint32_t rb;
  float sc[4];  // the scales of this thread's 4 w columns (PRE only)
#pragma unroll
  for (int e = 0; e < 4; ++e)
    sc[e] = PRE ? col_scale<float>(scales, n0 + (tid % 16) * 4 + e, N) : 1.f;
  auto load = [&](int k0) {
    const int r = m0 + tid / 4, c = k0 + (tid % 4) * 4;
    const float* p = x + (size_t)r * K + c;
    if (xvec && r < M && c < K) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      ra[0] = v.x, ra[1] = v.y, ra[2] = v.z, ra[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) ra[e] = r < M && c + e < K ? p[e] : 0.f;
    }
    const int kr = k0 + tid / 16, cw = n0 + (tid % 16) * 4;
    const int8_t* q = w + (size_t)kr * N + cw;
    if (wvec) {
      rb = kr < K && cw < N ? *reinterpret_cast<const uint32_t*>(q) : 0u;
    } else {
      rb = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kr < K && cw + e < N)
          rb |= static_cast<uint32_t>(static_cast<uint8_t>(q[e])) << (8 * e);
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int nk = (K + F_BK - 1) / F_BK;
  if (nk > 0) load(0);
  for (int kt = 0; kt < nk; ++kt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sA[(tid % 4) * 4 + e][tid / 4] = ra[e];
      sB[tid / 16][(tid % 16) * 4 + e] =
          PRE ? int8_at(rb, e) * sc[e] : int8_at(rb, e);
    }
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * F_BK);
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx + 16 * j;
    if (col >= N) continue;
    const float s = PRE ? 1.f : scales[col];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row < M) out[(size_t)row * N + col] = acc[i][j] * s;
    }
  }
}

int aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T, bool PRE>
void launch_skinny(const T* x, const int8_t* w, const float* s, T* out, int M,
                   int K, int N, cudaStream_t stream) {
  const int vec = N % 16 == 0 && aligned(w, 16);
  if (M == 1) {
    int8_mm_skinny<T, 1, PRE>
        <<<dim3(cdiv(N, S_BN), 1), S_THREADS, 0, stream>>>(x, w, s, out, M,
                                                          K, N, vec);
  } else {
    int8_mm_skinny<T, 4, PRE>
        <<<dim3(cdiv(N, S_BN), cdiv(M, 4)), S_THREADS, 0, stream>>>(
            x, w, s, out, M, K, N, vec);
  }
}

// the kernel each shape takes (reported to the caller)
enum Route { ROUTE_WGMMA = 0, ROUTE_MMA = 1, ROUTE_SKINNY = 2, ROUTE_FMA = 3 };

template <bool PRE>
cudaError_t launch(const void* x, const int8_t* wq, const float* sc,
                   void* out, int M, int K, int N, int dtype, cudaStream_t s,
                   int* route) {
  if (M <= SKINNY_MAX_M) {
    *route = ROUTE_SKINNY;
    if (dtype == 0)
      launch_skinny<float, PRE>(static_cast<const float*>(x), wq, sc,
                                static_cast<float*>(out), M, K, N, s);
    else
      launch_skinny<bf16, PRE>(static_cast<const bf16*>(x), wq, sc,
                               static_cast<bf16*>(out), M, K, N, s);
  } else if (dtype == 1 && K > 0 && K % 8 == 0 && N % 16 == 0 &&
             aligned(x, 16) && aligned(wq, 16)) {
    *route = ROUTE_WGMMA;
    CUtensorMap mx, mw;
    if (!encode_x(&mx, x, M, K) || !encode_w(&mw, wq, K, N))
      return cudaErrorInvalidValue;
    cudaError_t err = set_smem(int8_mm_wgmma<PRE>, G_SMEM);
    if (err != cudaSuccess) return err;
    int8_mm_wgmma<PRE>
        <<<dim3(cdiv(N, G_BN), cdiv(M, G_BM)), G_THREADS, G_SMEM, s>>>(
            mx, mw, sc, static_cast<bf16*>(out), M, K, N);
  } else if (dtype == 1) {
    *route = ROUTE_MMA;
    const int xvec = K % 8 == 0 && aligned(x, 16);
    const int wvec = N % 16 == 0 && aligned(wq, 16);
    int8_mm_mma<PRE>
        <<<dim3(cdiv(N, T_BN), cdiv(M, T_BM)), T_THREADS, 0, s>>>(
        static_cast<const bf16*>(x), wq, sc, static_cast<bf16*>(out), M, K,
        N, xvec, wvec);
  } else {
    *route = ROUTE_FMA;
    const int xvec = K % 4 == 0 && aligned(x, 16);
    const int wvec = N % 4 == 0 && aligned(wq, 4);
    int8_mm_fma<PRE>
        <<<dim3(cdiv(N, F_BN), cdiv(M, F_BM)), F_THREADS, 0, s>>>(
        static_cast<const float*>(x), wq, sc, static_cast<float*>(out), M, K,
        N, xvec, wvec);
  }
  return cudaGetLastError();
}

}  // namespace

// x (M, K) f32 (dtype 0) or bf16 (dtype 1), w (K, N) int8, scales (N,) f32,
// out (M, N) in x's dtype; all contiguous. dequantize_first: 0 applies the
// scale after the reduction (the Pallas contract), 1 forms each weight
// q * s in x's dtype before the product (the JAX weight-only predict).
// *route receives the kernel taken: 0 wgmma, 1 mma, 2 skinny, 3 fma.
// Returns the launch's cudaError_t (0 on success; cudaErrorInvalidValue
// also where a tensor map cannot be built); the kernel runs on `stream`
// and the call does not synchronise.
extern "C" int int8_matmul(const void* x, const void* w, const void* scales,
                           void* out, int M, int K, int N, int dtype,
                           int dequantize_first, void* stream, int* route) {
  *route = -1;
  if (M <= 0 || N <= 0 || K < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scales);
  return (int)(dequantize_first
                   ? launch<true>(x, wq, sc, out, M, K, N, dtype, s, route)
                   : launch<false>(x, wq, sc, out, M, K, N, dtype, s, route));
}
