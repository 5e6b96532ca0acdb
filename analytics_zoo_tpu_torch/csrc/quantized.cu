// Int8 weight-only dequant-matmul for Hopper (sm_90a): K6, bound through a
// plain C entry point and loaded with ctypes.
//
// Replaces: analytics_zoo_tpu/ops/pallas/quantized.py, the Pallas kernel
// _kernel (pl.pallas_call in int8_matmul at :63). Same contract:
// out (M, N) = (x (M, K) @ w_q (K, N) as f32) * scales[col], in x's dtype
// (f32 or bf16); int8 weights, f32 per-column scales, f32 accumulation,
// the scale applied to each column after its reduction, then one rounding
// to the output dtype. The int8 weights stay int8 in device memory: they
// are widened on the way from device memory to the products, so the bytes
// read per weight stay one, the point of weight-only quantization.
//
// What bounds it on this card: at batch 1 (config A's M = 1, K = N = 4096)
// it is a matrix-vector product, 16.8 MB of int8 and nothing else, so the
// bytes bound it (0.0050 ms at 3.35 TB/s). At BERT's shapes (M = 16,384
// rows of 32 x 512 tokens, K and N 768 to 3072, bf16) it does thousands
// of operations per byte and the products bound it. Three kernels:
//  * skinny (M <= 32, f32 or bf16 x): a block owns 32 columns and up to 4
//    rows (1 at M = 1) and loops over all of K: each of its 128 pairs of
//    threads walks every 128th row of w, a thread loading 16 int8 of a row
//    in one 16-byte load (where N and w's alignment allow; byte loads
//    elsewhere, as for the Dense(8) and Dense(2) heads), four rows ahead.
//    Products in f32 FMAs (a bf16 x int8 product is exact in f32). The
//    128 partial sums of each output are then added in a fixed tree: a
//    butterfly over the 16 k-groups of a warp, then the 8 warps in order.
//  * mma (M > 32, bf16 x): a block owns a 128 x 128 output tile and loops
//    over K in 32-wide steps. The x tile and the int8 w tile widened to
//    bf16 (exact: |q| <= 127 fits bf16's 8-bit mantissa) are staged in
//    shared memory, the next step's tiles loaded into registers while the
//    current one is multiplied. Products with mma.sync m16n8k16 (bf16 in,
//    f32 accumulate), as K2 and K4 do; 8 warps of 64 x 32 outputs each;
//    the w fragments come from the row-major tile through ldmatrix.trans.
//    Epilogue: acc * scales[col] in f32, one rounding to bf16. bf16 x bf16
//    products are exact in f32, so the only difference from the TPU
//    kernel is the order of the sum. wgmma and TMA staging are later work.
//  * fma (M > 32, f32 x): a block owns a 64 x 64 output tile, 16 rows of
//    K at a time through shared memory, each thread 4 x 4 outputs, plain
//    FMAs on the CUDA cores (TF32 would round x to 10 mantissa bits, which
//    the f32 contract does not allow).
// No block carries anything to another and nothing is split over K across
// blocks: every output is written once by one thread, its sum taken in a
// fixed order, so the result is the same bits from run to run. Any M, K
// and N: edges are masked on load (zeros) and on store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float int8_at(uint32_t word, int byte) {
  return static_cast<float>(static_cast<int8_t>(word >> (8 * byte)));
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

template <typename T, int MT>
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
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][j] = fmaf(xv[u][m], q, acc[m][j]);
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
      out[(size_t)row * N + col] = from_f32<T>(s * scales[col]);
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

__global__ void __launch_bounds__(T_THREADS)
    int8_mm_mma(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scales, bf16* __restrict__ out,
                int M, int K, int N, int xvec, int wvec) {
  __shared__ __align__(16) bf16 sA[2][T_BM * LDA];
  __shared__ __align__(16) bf16 sB[2][T_BK * LDB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int m0 = blockIdx.y * T_BM, n0 = blockIdx.x * T_BN;

  // the next step's tiles, in registers: x as 2 x 8 bf16 (rows tid / 4
  // and 64 + tid / 4, columns 8 (tid % 4) ..), w as 16 int8 (row tid / 8,
  // columns 16 (tid % 8) ..)
  uint4 ra[2];
  uint4 rb;
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
    uint32_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = pack_bf16(int8_at(word[e >> 1], 2 * (e & 1)),
                       int8_at(word[e >> 1], 2 * (e & 1) + 1));
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
    const float s0 = col < N ? scales[col] : 0.f;
    const float s1 = col + 1 < N ? scales[col + 1] : 0.f;
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
// fma: M > 32, f32. Thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16 i and columns tx + 16 j of the block's tile, i, j < 4.
// ---------------------------------------------------------------------------

constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_THREADS = 256;

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
      sB[tid / 16][(tid % 16) * 4 + e] = int8_at(rb, e);
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
    const float s = scales[col];
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

template <typename T>
void launch_skinny(const T* x, const int8_t* w, const float* s, T* out, int M,
                   int K, int N, cudaStream_t stream) {
  const int vec = N % 16 == 0 && aligned(w, 16);
  if (M == 1) {
    int8_mm_skinny<T, 1><<<dim3(cdiv(N, S_BN), 1), S_THREADS, 0, stream>>>(
        x, w, s, out, M, K, N, vec);
  } else {
    int8_mm_skinny<T, 4><<<dim3(cdiv(N, S_BN), cdiv(M, 4)), S_THREADS, 0,
                           stream>>>(x, w, s, out, M, K, N, vec);
  }
}

}  // namespace

// x (M, K) f32 (dtype 0) or bf16 (dtype 1), w (K, N) int8, scales (N,) f32,
// out (M, N) in x's dtype; all contiguous. Returns the launch's cudaError_t
// (0 on success); the kernel runs on `stream` and the call does not
// synchronise.
extern "C" int int8_matmul(const void* x, const void* w, const void* scales,
                           void* out, int M, int K, int N, int dtype,
                           void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scales);
  if (M <= SKINNY_MAX_M) {
    if (dtype == 0)
      launch_skinny(static_cast<const float*>(x), wq, sc,
                    static_cast<float*>(out), M, K, N, s);
    else
      launch_skinny(static_cast<const bf16*>(x), wq, sc,
                    static_cast<bf16*>(out), M, K, N, s);
  } else if (dtype == 1) {
    const int xvec = K % 8 == 0 && aligned(x, 16);
    const int wvec = N % 16 == 0 && aligned(w, 16);
    int8_mm_mma<<<dim3(cdiv(N, T_BN), cdiv(M, T_BM)), T_THREADS, 0, s>>>(
        static_cast<const bf16*>(x), wq, sc, static_cast<bf16*>(out), M, K,
        N, xvec, wvec);
  } else {
    const int xvec = K % 4 == 0 && aligned(x, 16);
    const int wvec = N % 4 == 0 && aligned(w, 4);
    int8_mm_fma<<<dim3(cdiv(N, F_BN), cdiv(M, F_BM)), F_THREADS, 0, s>>>(
        static_cast<const float*>(x), wq, sc, static_cast<float*>(out), M, K,
        N, xvec, wvec);
  }
  return (int)cudaGetLastError();
}
