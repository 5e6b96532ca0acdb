// Flash-attention backward for Hopper (sm_90a): two kernels, bound through
// plain C entry points and loaded with ctypes.
//
// Replaces: analytics_zoo_tpu/ops/pallas/flash_attention.py, the Pallas
// kernels launched by _flash_bwd: _bwd_dq_kernel (K3a, pl.pallas_call at
// :524) and _bwd_dkv_kernel (K3b, pl.pallas_call at :544). Same contract:
// q/dO (B,H,Tq,D), k/v (B,H,Tk,D) in f32 or bf16; lse and delta =
// rowsum(dO*O) as f32 (B*H, Tq); an optional (B,Tk) f32 key-padding
// keep-mask (>= 1.0 attends); bottom-right aligned causal masking (offset
// = Tk - Tq). Each kernel rebuilds the probability tile from the saved
// lse, p = visible ? exp(s*scale - lse) : 0, so a row with lse = +inf (no
// visible key) gives exact zeros and never an inf - inf. Then
// ds = p * (dp - delta), dq = scale * ds K, dk = scale * ds^T Q,
// dv = p^T dO, accumulated in f32 and written once in the input dtype.
// Rounding points in bf16 follow the Pallas kernels: p enters the dv
// product in bf16, ds enters the dq and dk products in bf16, and the
// scale multiplies the f32 sum after the products.
//
// Two kernels, no atomics: K3a owns a (batch*head, 64-query) tile and
// loops over key tiles; K3b owns a (batch*head, 64-key) tile and loops
// over query tiles. Each output element is written by exactly one block
// in a fixed summation order, so dq/dk/dv are deterministic. A one-kernel
// scheme (dk/dv per block, dq by atomic adds) would save recomputing P
// once but makes dq depend on the order blocks finish in.
//
// What bounds it on this card: at BERT's shapes (T=512, D=64) K3a does
// 6*D and K3b 8*D operations per visible (query, key) pair against a few
// elements per row moved, so the products bound both. Hence:
//  * bf16 (the training path): every product runs on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, f32 accumulate). The score and dP
//    accumulators become the next product's A operand in registers; the
//    B operands that need the other orientation (K for dq, Q and dO for
//    dk/dv) are stored transposed in shared memory. wgmma and TMA staging
//    are later work.
//  * f32: plain FMAs on the CUDA cores (TF32 would round the operands to
//    10 mantissa bits, outside the f32 contract).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // four warps

typedef __nv_bfloat16 bf16;

// the first query tile (multiple of BQ) that can see key k0 under causal
// masking: query q sees key k when k <= q + offset
__device__ __forceinline__ int first_q_tile(int k0, int offset) {
  const int q = k0 - offset;
  return q <= 0 ? 0 : (q / BQ) * BQ;
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs. Two threads share a row of the block's own tile:
// each handles every other column of the streamed tile and every other
// output column.
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_fma_smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               const float* __restrict__ mask, float* __restrict__ dq, int H,
               int t_q, int t_kv, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int LDS = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;             // BQ x LD
  float* sDO = sQ + BQ * LD;    // BQ x LD
  float* sK = sDO + BQ * LD;    // BK x LD
  float* sV = sK + BK * LD;     // BK x LD
  float* sDS = sV + BK * LD;    // BQ x LDS
  __shared__ float sKeep[BK];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int row = tid >> 1;
  const int half = tid & 1;
  const int qpos = q0 + row;
  const int offset = t_kv - t_q;
  const size_t q_base = (size_t)bh * t_q * D;
  const size_t kv_base = (size_t)bh * t_kv * D;
  const float* mrow = mask ? mask + (size_t)(bh / H) * t_kv : nullptr;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const bool in = q0 + r < t_q;
    const size_t g = q_base + (size_t)(q0 + r) * D + c;
    sQ[r * LD + c] = in ? q[g] : 0.f;
    sDO[r * LD + c] = in ? dout[g] : 0.f;
  }
  const bool q_in = qpos < t_q;
  const float row_lse = q_in ? lse[(size_t)bh * t_q + qpos] : INFINITY;
  const float row_delta = q_in ? delta[(size_t)bh * t_q + qpos] : 0.f;

  // the last row of this block sees keys up to q0 + BQ - 1 + offset
  int k_end = t_kv;
  if (causal) k_end = min(k_end, q0 + BQ + offset);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; sQ/sDO are written
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < t_kv;
      const size_t g = kv_base + (size_t)(k0 + r) * D + c;
      sK[r * LD + c] = in ? k[g] : 0.f;
      sV[r * LD + c] = in ? v[g] : 0.f;
    }
    if (tid < BK) {
      const int kp = k0 + tid;
      sKeep[tid] = (kp < t_kv && (mrow == nullptr || mrow[kp] >= 1.0f))
                       ? 1.f
                       : 0.f;
    }
    __syncthreads();

    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[row * LD + d];
      const float od = sDO[row * LD + d];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int kj = 2 * j + half;
        s[j] = fmaf(qd, sK[kj * LD + d], s[j]);
        dp[j] = fmaf(od, sV[kj * LD + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int kj = 2 * j + half;
      const bool ok = q_in && sKeep[kj] != 0.f &&
                      (!causal || k0 + kj <= qpos + offset);
      const float p = ok ? expf(s[j] * scale - row_lse) : 0.f;
      sDS[row * LDS + kj] = p * (dp[j] - row_delta);
    }
    __syncthreads();  // the row's dS is complete

    for (int j = 0; j < BK; ++j) {
      const float ds = sDS[row * LDS + j];
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        acc[i] = fmaf(ds, sK[j * LD + 2 * i + half], acc[i]);
    }
  }

  if (q_in) {
    float* drow = dq + q_base + (size_t)qpos * D;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) drow[2 * i + half] = acc[i] * scale;
  }
}

template <int D>
constexpr size_t dkv_fma_smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    bwd_dkv_fma(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const float* __restrict__ mask, float* __restrict__ dk,
                float* __restrict__ dv, int H, int t_q, int t_kv, int causal,
                float scale) {
  constexpr int LD = D + 1;
  constexpr int LDP = BQ + 1;
  extern __shared__ float smem[];
  float* sK = smem;             // BK x LD
  float* sV = sK + BK * LD;     // BK x LD
  float* sQ = sV + BK * LD;     // BQ x LD
  float* sDO = sQ + BQ * LD;    // BQ x LD
  float* sP = sDO + BQ * LD;    // BK x LDP
  float* sDS = sP + BK * LDP;   // BK x LDP
  __shared__ float sLse[BQ];
  __shared__ float sDelta[BQ];

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int row = tid >> 1;  // this thread's key within the tile
  const int half = tid & 1;
  const int kpos = k0 + row;
  const int offset = t_kv - t_q;
  const size_t q_base = (size_t)bh * t_q * D;
  const size_t kv_base = (size_t)bh * t_kv * D;
  const float* mrow = mask ? mask + (size_t)(bh / H) * t_kv : nullptr;

  for (int i = tid; i < BK * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < t_kv;
    const size_t g = kv_base + (size_t)(k0 + r) * D + c;
    sK[r * LD + c] = in ? k[g] : 0.f;
    sV[r * LD + c] = in ? v[g] : 0.f;
  }
  const bool keep =
      kpos < t_kv && (mrow == nullptr || mrow[kpos] >= 1.0f);

  float gk[D / 2], gv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.f;

  const int q_begin = causal ? first_q_tile(k0, offset) : 0;
  for (int q0 = q_begin; q0 < t_q; q0 += BQ) {
    __syncthreads();  // the previous tile is consumed; sK/sV are written
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool in = q0 + r < t_q;
      const size_t g = q_base + (size_t)(q0 + r) * D + c;
      sQ[r * LD + c] = in ? q[g] : 0.f;
      sDO[r * LD + c] = in ? dout[g] : 0.f;
    }
    if (tid < BQ) {
      const bool in = q0 + tid < t_q;
      sLse[tid] = in ? lse[(size_t)bh * t_q + q0 + tid] : INFINITY;
      sDelta[tid] = in ? delta[(size_t)bh * t_q + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = sK[row * LD + d];
      const float vd = sV[row * LD + d];
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        const int qi = 2 * j + half;
        s[j] = fmaf(kd, sQ[qi * LD + d], s[j]);
        dp[j] = fmaf(vd, sDO[qi * LD + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) {
      const int qi = 2 * j + half;
      const int qp = q0 + qi;
      const bool ok = keep && qp < t_q && (!causal || kpos <= qp + offset);
      const float p = ok ? expf(s[j] * scale - sLse[qi]) : 0.f;
      sP[row * LDP + qi] = p;
      sDS[row * LDP + qi] = p * (dp[j] - sDelta[qi]);
    }
    __syncthreads();  // the key row's P and dS are complete

    for (int j = 0; j < BQ; ++j) {
      const float p = sP[row * LDP + j];
      const float ds = sDS[row * LDP + j];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        gv[i] = fmaf(p, sDO[j * LD + 2 * i + half], gv[i]);
        gk[i] = fmaf(ds, sQ[j * LD + 2 * i + half], gk[i]);
      }
    }
  }

  if (kpos < t_kv) {
    const size_t o = kv_base + (size_t)kpos * D;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dk[o + 2 * i + half] = gk[i] * scale;
      dv[o + 2 * i + half] = gv[i];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync.m16n8k16. Each warp owns 16 rows of
// the block's tile. Fragment layouts (PTX ISA, m16n8k16 .bf16): with
// g = lane / 4 and t = lane % 4, a thread holds A rows g and g+8 at
// columns 2t, 2t+1 (and +8); B columns g at rows 2t, 2t+1 (and +8); and
// C rows g and g+8 at columns 2t, 2t+1.
// ---------------------------------------------------------------------------

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

// the lower column lands in the low half, as the fragments expect
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of rows r0, r0+8, columns c..c+15 from a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base,
                                       int ld, int r0, int c, int t) {
  const bf16* p = base + r0 * ld + c + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// 16 x 64 = A (16 x D, rows r0/r0+8 of sA) times B^T where B is a 64 x D
// row-major tile (the 64 output columns are B's rows)
template <int D>
__device__ __forceinline__ void mma_rows_by_rows(float (&acc)[8][4],
                                                 const bf16* sA,
                                                 const bf16* sB, int ld,
                                                 int r0, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a(a, sA, ld, r0, kk * 16, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* b = sB + (j * 8 + g) * ld + kk * 16 + 2 * t;
      mma_bf16(acc[j], a, ld32(b), ld32(b + 8));
    }
  }
}

// out (16 x D) += P (16 x 64, the C layout of mma_rows_by_rows, rounded
// to bf16) times a 64 x D operand stored transposed: sBt is D x ldt
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&p)[8][4],
                                       int kk) {
  a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
  a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
  a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
  a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
}

template <int D>
__device__ __forceinline__ void mma_acc_by_cols(float (&out)[D / 8][4],
                                                const float (&p)[8][4],
                                                const bf16* sBt, int ldt,
                                                int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    pack_a(a, p, kk);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const bf16* b = sBt + (n * 8 + g) * ldt + kk * 16 + 2 * t;
      mma_bf16(out[n], a, ld32(b), ld32(b + 8));
    }
  }
}

// copy rows [r_begin, r_begin + 64) of a (rows x D) bf16 matrix into a
// row-major tile (stride ld) and, when sT is given, its transpose (D x ldt);
// rows past `rows` are zero
template <int D>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src,
                                          int r_begin, int rows, bf16* sM,
                                          int ld, bf16* sT, int ldt,
                                          int tid) {
  constexpr int VEC = 8;  // bf16 per 16-byte load
  for (int i = tid; i < 64 * D / VEC; i += THREADS) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r_begin + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r_begin + r) * D +
                                            c);
    *reinterpret_cast<uint4*>(sM + r * ld + c) = val;
    if (sT != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int x = 0; x < VEC; ++x) sT[(c + x) * ldt + r] = e[x];
    }
  }
}

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // sQ, sDO, sK, sV: 64 x (D+8); sKt: D x (64+8)
  return sizeof(bf16) * (size_t)(4 * 64 * (D + 8) + D * (64 + 8));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta,
               const float* __restrict__ mask, bf16* __restrict__ dq, int H,
               int t_q, int t_kv, int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int LDT = BK + 8;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + BQ * LD;
  bf16* sK = sDO + BQ * LD;
  bf16* sV = sK + BK * LD;
  bf16* sKt = sV + BK * LD;
  __shared__ float sKeep[BK];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int qp[2] = {q0 + r0, q0 + r0 + 8};
  const int offset = t_kv - t_q;
  const float* mrow = mask ? mask + (size_t)(bh / H) * t_kv : nullptr;

  load_tile<D>(q + (size_t)bh * t_q * D, q0, t_q, sQ, LD, nullptr, 0, tid);
  load_tile<D>(dout + (size_t)bh * t_q * D, q0, t_q, sDO, LD, nullptr, 0,
               tid);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = qp[h] < t_q;
    row_lse[h] = in ? lse[(size_t)bh * t_q + qp[h]] : INFINITY;
    row_delta[h] = in ? delta[(size_t)bh * t_q + qp[h]] : 0.f;
  }

  int k_end = t_kv;
  if (causal) k_end = min(k_end, q0 + BQ + offset);

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; sQ/sDO are written
    load_tile<D>(k + (size_t)bh * t_kv * D, k0, t_kv, sK, LD, sKt, LDT, tid);
    load_tile<D>(v + (size_t)bh * t_kv * D, k0, t_kv, sV, LD, nullptr, 0,
                 tid);
    if (tid < BK) {
      const int kp = k0 + tid;
      sKeep[tid] = (kp < t_kv && (mrow == nullptr || mrow[kp] >= 1.0f))
                       ? 1.f
                       : 0.f;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_rows_by_rows<D>(s, sQ, sK, LD, r0, g, t);    // Q K^T
    mma_rows_by_rows<D>(dp, sDO, sV, LD, r0, g, t);  // dO V^T
    // p and ds for rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3); ds into s
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int kl = j * 8 + 2 * t + (e & 1);
        const bool ok = qp[h] < t_q && sKeep[kl] != 0.f &&
                        (!causal || k0 + kl <= qp[h] + offset);
        const float p = ok ? expf(s[j][e] * scale - row_lse[h]) : 0.f;
        s[j][e] = p * (dp[j][e] - row_delta[h]);
      }
    }
    mma_acc_by_cols<D>(o, s, sKt, LDT, g, t);  // dS K
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qp[h] >= t_q) continue;
    bf16* drow = dq + (size_t)bh * t_q * D + (size_t)qp[h] * D;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8 + 2 * t) =
          pack_bf16(o[n][2 * h] * scale, o[n][2 * h + 1] * scale);
  }
}

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // sK, sV, sQ, sDO: 64 x (D+8); sQt, sDOt: D x (64+8)
  return sizeof(bf16) * (size_t)(4 * 64 * (D + 8) + 2 * D * (64 + 8));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const float* __restrict__ mask, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int H, int t_q, int t_kv, int causal,
                float scale) {
  constexpr int LD = D + 8;
  constexpr int LDT = BQ + 8;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BK * LD;
  bf16* sQ = sV + BK * LD;
  bf16* sDO = sQ + BQ * LD;
  bf16* sQt = sDO + BQ * LD;
  bf16* sDOt = sQt + D * LDT;
  __shared__ float sLse[BQ];
  __shared__ float sDelta[BQ];

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8
  const int kp[2] = {k0 + r0, k0 + r0 + 8};
  const int offset = t_kv - t_q;
  const float* mrow = mask ? mask + (size_t)(bh / H) * t_kv : nullptr;
  bool keep[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    keep[h] = kp[h] < t_kv && (mrow == nullptr || mrow[kp[h]] >= 1.0f);

  load_tile<D>(k + (size_t)bh * t_kv * D, k0, t_kv, sK, LD, nullptr, 0, tid);
  load_tile<D>(v + (size_t)bh * t_kv * D, k0, t_kv, sV, LD, nullptr, 0, tid);

  float gk[NT][4], gv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.f;

  const int q_begin = causal ? first_q_tile(k0, offset) : 0;
  for (int q0 = q_begin; q0 < t_q; q0 += BQ) {
    __syncthreads();  // the previous tile is consumed; sK/sV are written
    load_tile<D>(q + (size_t)bh * t_q * D, q0, t_q, sQ, LD, sQt, LDT, tid);
    load_tile<D>(dout + (size_t)bh * t_q * D, q0, t_q, sDO, LD, sDOt, LDT,
                 tid);
    if (tid < BQ) {
      const bool in = q0 + tid < t_q;
      sLse[tid] = in ? lse[(size_t)bh * t_q + q0 + tid] : INFINITY;
      sDelta[tid] = in ? delta[(size_t)bh * t_q + q0 + tid] : 0.f;
    }
    __syncthreads();

    float p[8][4], ds[8][4];
    mma_rows_by_rows<D>(p, sK, sQ, LD, r0, g, t);    // K Q^T = S^T
    mma_rows_by_rows<D>(ds, sV, sDO, LD, r0, g, t);  // V dO^T = dP^T
    // key rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3), query columns
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int ql = j * 8 + 2 * t + (e & 1);
        const int qpos = q0 + ql;
        const bool ok = keep[h] && qpos < t_q &&
                        (!causal || kp[h] <= qpos + offset);
        const float pv = ok ? expf(p[j][e] * scale - sLse[ql]) : 0.f;
        p[j][e] = pv;
        ds[j][e] = pv * (ds[j][e] - sDelta[ql]);
      }
    }
    mma_acc_by_cols<D>(gv, p, sDOt, LDT, g, t);  // P^T dO
    mma_acc_by_cols<D>(gk, ds, sQt, LDT, g, t);  // dS^T Q
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kp[h] >= t_kv) continue;
    const size_t o = (size_t)bh * t_kv * D + (size_t)kp[h] * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(dk + o + n * 8 + 2 * t) =
          pack_bf16(gk[n][2 * h] * scale, gk[n][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + o + n * 8 + 2 * t) =
          pack_bf16(gv[n][2 * h], gv[n][2 * h + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D>
cudaError_t launch_dq(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* mask, void* dq, int B, int H, int t_q,
                      int t_kv, int causal, float scale,
                      cudaStream_t stream) {
  const dim3 grid(B * H, (t_q + BQ - 1) / BQ);
  cudaError_t err;
  if (dtype == 0) {
    const size_t smem = dq_fma_smem_bytes<D>();
    if ((err = set_smem(bwd_dq_fma<D>, smem)) != cudaSuccess) return err;
    bwd_dq_fma<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, mask, static_cast<float*>(dq), H, t_q, t_kv, causal, scale);
  } else {
    const size_t smem = dq_mma_smem_bytes<D>();
    if ((err = set_smem(bwd_dq_mma<D>, smem)) != cudaSuccess) return err;
    bwd_dq_mma<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, mask, static_cast<bf16*>(dq), H, t_q, t_kv, causal, scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(int dtype, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse,
                       const float* delta, const float* mask, void* dk,
                       void* dv, int B, int H, int t_q, int t_kv, int causal,
                       float scale, cudaStream_t stream) {
  const dim3 grid(B * H, (t_kv + BK - 1) / BK);
  cudaError_t err;
  if (dtype == 0) {
    const size_t smem = dkv_fma_smem_bytes<D>();
    if ((err = set_smem(bwd_dkv_fma<D>, smem)) != cudaSuccess) return err;
    bwd_dkv_fma<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, mask, static_cast<float*>(dk), static_cast<float*>(dv), H,
        t_q, t_kv, causal, scale);
  } else {
    const size_t smem = dkv_mma_smem_bytes<D>();
    if ((err = set_smem(bwd_dkv_mma<D>, smem)) != cudaSuccess) return err;
    bwd_dkv_mma<D><<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, mask, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, t_q,
        t_kv, causal, scale);
  }
  return cudaGetLastError();
}

bool bad_dims(int B, int H, int t_q, int t_kv, int dtype) {
  return B <= 0 || H <= 0 || t_q <= 0 || t_kv <= 0 ||
         (long long)B * H > 2147483647LL || (t_q + BQ - 1) / BQ > 65535 ||
         (t_kv + BK - 1) / BK > 65535 || (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse and delta are f32 (B*H, t_q);
// mask may be null. Each returns the launch's cudaError_t (0 on success);
// the kernel runs on `stream` and the call does not synchronise. q/k/v/
// dout and the outputs must be contiguous; the bf16 path reads and writes
// 16-byte vectors, so their base pointers must be 16-byte aligned.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* mask, void* dq, int B,
                                      int H, int t_q, int t_kv, int D,
                                      int causal, int dtype, float scale,
                                      void* stream) {
  if (bad_dims(B, H, t_q, t_kv, dtype)) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)launch_dq<32>(dtype, q, k, v, dout, l, dl, m, dq, B, H,
                                t_q, t_kv, causal, scale, s);
    case 64:
      return (int)launch_dq<64>(dtype, q, k, v, dout, l, dl, m, dq, B, H,
                                t_q, t_kv, causal, scale, s);
    case 128:
      return (int)launch_dq<128>(dtype, q, k, v, dout, l, dl, m, dq, B, H,
                                 t_q, t_kv, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       const void* mask, void* dk, void* dv,
                                       int B, int H, int t_q, int t_kv, int D,
                                       int causal, int dtype, float scale,
                                       void* stream) {
  if (bad_dims(B, H, t_q, t_kv, dtype)) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)launch_dkv<32>(dtype, q, k, v, dout, l, dl, m, dk, dv, B,
                                 H, t_q, t_kv, causal, scale, s);
    case 64:
      return (int)launch_dkv<64>(dtype, q, k, v, dout, l, dl, m, dk, dv, B,
                                 H, t_q, t_kv, causal, scale, s);
    case 128:
      return (int)launch_dkv<128>(dtype, q, k, v, dout, l, dl, m, dk, dv, B,
                                  H, t_q, t_kv, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
