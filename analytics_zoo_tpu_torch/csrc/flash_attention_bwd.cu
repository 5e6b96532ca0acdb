// Flash-attention backward for Hopper (sm_90a): two kernels, bound through
// plain C entry points and loaded with ctypes.
//
// Replaces: analytics_zoo_tpu/ops/pallas/flash_attention.py, the Pallas
// kernels launched by _flash_bwd: _bwd_dq_kernel (K3a, pl.pallas_call at
// :524) and _bwd_dkv_kernel (K3b, pl.pallas_call at :544). Same contract:
// q/dO (B,H,Tq,D), k/v (B,H,Tk,D) in f32 or bf16, D in {32, 64, 128}, any
// Tq and Tk; lse and delta = rowsum(dO*O) as f32 (B*H, Tq); an optional
// (B,Tk) f32 key-padding keep-mask (>= 1.0 attends); bottom-right aligned
// causal masking (offset = Tk - Tq, either sign). Each kernel rebuilds the
// probability tile from the saved lse, p = visible ? exp(s*scale - lse) :
// 0, so a row with lse = +inf (no visible key) gives exact zeros and never
// an inf - inf. Then ds = p * (dp - delta), dq = scale * ds K, dk = scale *
// ds^T Q, dv = p^T dO, accumulated in f32 and written once in the input
// dtype. Rounding points in bf16 follow the Pallas kernels: p enters the dv
// product in bf16, ds enters the dq and dk products in bf16, and the scale
// multiplies the f32 sum after the products.
//
// Two kernels, no atomics: K3a owns a (batch*head, 64-query) tile and
// loops over key tiles; K3b owns a (batch*head, 64-key) tile and loops
// over query tiles. Each output element is written by exactly one block
// in a fixed summation order, so dq/dk/dv are the same bits from run to
// run. A one-kernel scheme (dk/dv per block, dq by atomic adds) would save
// recomputing P once but makes dq depend on the order blocks finish in.
//
// What bounds it on this card: K3a does 6*D and K3b 8*D operations per
// visible (query, key) pair against a few elements per row moved, so at
// BERT's (T=512) and the LM's (T=4096) shapes the tensor-core products
// bound both (0.42 and 0.56 ms at the LM's causal shape). The bf16 path
// (training's) is built for that:
//  * Products on wgmma (m64nNk16, bf16 in, f32 accumulate) from one
//    warpgroup of 128 threads, 64 rows of the block's tile. The first two
//    products (S = Q K^T and dP = dO V^T in K3a; S^T = K Q^T and dP^T =
//    V dO^T in K3b) read both operands from shared memory; their f32
//    accumulators are turned into p and ds in registers, rounded to bf16
//    and fed to the second products (dq += ds K; dv += p^T dO, dk +=
//    ds^T Q) as the register A operand.
//  * No transposed copies: the operand the second products need in the
//    other orientation (K for dq, Q and dO for dk/dv) is the tile already
//    in shared memory, read through an MN-major descriptor.
//  * Tiles arrive by TMA (cp.async.bulk.tensor, a CUtensorMap per operand
//    built on the host) in the 128-byte swizzled layout the descriptors
//    name (64-byte for D = 32), into a ring of stages of the streamed
//    tiles (2 of K and V in K3a; 3 of Q, dO, lse and delta in K3b, 2 at
//    D = 128),
//    each completed on an mbarrier. One thread issues them: the next tiles
//    load while the current one is multiplied. TMA zero-fills rows past
//    T, so ragged tiles need no branch on load.
//  * Tiles are classified before any work: invisible key tiles (beyond the
//    causal diagonal, or hidden entirely by the key-padding mask, whose
//    bits each K3a block reads once) are never loaded; a K3b key tile that
//    the mask hides entirely writes zeros without looping; only diagonal,
//    partly masked or ragged tiles test each element.
//  * f32: plain FMAs on the CUDA cores (TF32 would round the operands to
//    10 mantissa bits, outside the f32 contract).

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // four warps: one warpgroup in the bf16 path

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
// bf16: wgmma on TMA-fed tiles (the helpers and fragment layouts are in
// hopper.cuh).
// ---------------------------------------------------------------------------

using namespace hopper;

// ring depths: K3a's 2 stages keep a block at about 50 KB of shared
// memory at D = 64, so four blocks share an SM (measured: 3-5% faster
// than 3 stages); K3b's third stage costs no block (its registers allow
// three)
template <int D>
struct Stages {
  static constexpr int DQ = 2;
  static constexpr int DKV = D == 128 ? 2 : 3;
};

constexpr int ROW_STRIDE = 384;  // bytes from a stage's lse to its delta

// dynamic shared memory of K3a: the Q and dO tiles, the K/V ring, its
// barriers (and Q/dO's), the keep-mask bits of every key and the list of
// visible key tiles; 1024 bytes of slack align the tiles
template <int D>
size_t dq_wgmma_smem_bytes(int t_kv) {
  constexpr int S = Stages<D>::DQ;
  const int n_words = (t_kv + 31) / 32, n_tiles = (t_kv + BK - 1) / BK;
  return 1024 + (size_t)(2 + 2 * S) * Tile<D>::BYTES + 8 * (S + 1) +
         4 * (size_t)(n_words + n_tiles + 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ mask, bf16* __restrict__ dq,
                 int H, int t_q, int t_kv, int causal, float scale) {
  typedef Tile<D> G;
  constexpr int S = Stages<D>::DQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sDO = base + G::BYTES;
  const uint32_t sRing = base + 2 * G::BYTES;  // stage s: K, then V
  const uint32_t sBar = sRing + 2 * S * G::BYTES;  // S ring barriers, Q/dO's
  const uint32_t qbar = sBar + 8 * S;
  const int n_words = (t_kv + 31) / 32;
  uint32_t* keep_bits = reinterpret_cast<uint32_t*>(
      smem_raw + (sBar - raw) + 8 * (S + 1));
  int* tiles = reinterpret_cast<int*>(keep_bits + n_words);
  int* n_vis_shared = tiles + (t_kv + BK - 1) / BK;

  // the last query tiles see the most keys under causal masking: start them
  // first
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int qp[2] = {q0 + r0, q0 + r0 + 8};
  const int offset = t_kv - t_q;
  const float* mrow = mask ? mask + (size_t)(bh / H) * t_kv : nullptr;
  const CUtensorMap *pk = &tm_k, *pv = &tm_v;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s <= S; ++s) mbar_init(sBar + 8 * s);
    fence_barrier_init();
    mbar_expect(qbar, 2 * G::BYTES);
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c) {
      tma_rows(sQ + c * G::CHUNK_BYTES, &tm_q, qbar, c * G::CW, q0, bh);
      tma_rows(sDO + c * G::CHUNK_BYTES, &tm_do, qbar, c * G::CW, q0, bh);
    }
  }

  // the keys this tile can see: causally up to q0 + BQ - 1 + offset; the
  // mask's keep bits of those keys, 0 past t_kv
  int k_end = t_kv;
  if (causal) k_end = min(k_end, q0 + BQ + offset);
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  for (int b0 = 0; b0 < n_tiles * BK; b0 += THREADS) {
    const int key = b0 + tid;
    const bool keep = key < t_kv && (mrow == nullptr || mrow[key] >= 1.0f);
    const uint32_t bits = __ballot_sync(0xffffffffu, keep);
    const int word = (b0 >> 5) + warp;
    if (lane == 0 && word < n_words) keep_bits[word] = bits;
  }
  __syncthreads();
  // the key tiles with any visible key, in order
  if (warp == 0) {
    int n = 0;
    for (int jb = 0; jb < n_tiles; jb += 32) {
      const int j = jb + lane;
      bool vis = false;
      if (j < n_tiles) {
        const uint32_t w1 = 2 * j + 1 < n_words ? keep_bits[2 * j + 1] : 0u;
        vis = (keep_bits[2 * j] | w1) != 0u;
      }
      const uint32_t ballot = __ballot_sync(0xffffffffu, vis);
      if (vis) tiles[n + __popc(ballot & ((1u << lane) - 1u))] = j;
      n += __popc(ballot);
    }
    if (lane == 0) *n_vis_shared = n;
  }
  __syncthreads();
  const int n_vis = *n_vis_shared;

  // K and V of the i-th visible key tile into ring stage i % S
  auto issue = [&](int i) {
    const int s = i % S;
    const uint32_t bar = sBar + 8 * s;
    const uint32_t dst = sRing + 2 * s * G::BYTES;
    const int k0 = tiles[i] * BK;
    mbar_expect(bar, 2 * G::BYTES);
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c) {
      tma_rows(dst + c * G::CHUNK_BYTES, pk, bar, c * G::CW, k0, bh);
      tma_rows(dst + G::BYTES + c * G::CHUNK_BYTES, pv, bar, c * G::CW, k0,
               bh);
    }
  };
  if (tid == 0)
    for (int i = 0; i < min(S, n_vis); ++i) issue(i);

  float lse2[2], dlt[2];  // lse in log2 units (+inf past t_q), delta
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = qp[h] < t_q;
    lse2[h] = in ? lse[(size_t)bh * t_q + qp[h]] * LOG2E : INFINITY;
    dlt[h] = in ? delta[(size_t)bh * t_q + qp[h]] : 0.f;
  }
  const float sl2 = scale * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(qbar, 0);  // also when no key tile is visible: no TMA in flight

  for (int i = 0; i < n_vis; ++i) {
    const int s = i % S;
    if (i > 0) {
      __syncthreads();  // every thread is done with tile i - 1's stage
      if (tid == 0 && i - 1 + S < n_vis) issue(i - 1 + S);
    }
    mbar_wait(sBar + 8 * s, (i / S) & 1);
    const uint32_t sK = sRing + 2 * s * G::BYTES, sV = sK + G::BYTES;

    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss64(sc, desc_k<D>(sQ, kk), desc_k<D>(sK, kk), kk);  // Q K^T
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss64(dp, desc_k<D>(sDO, kk), desc_k<D>(sV, kk), kk);  // dO V^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // a tile is fully visible when every key is kept and lies on or before
    // the diagonal of the tile's first row; only the others test elements
    // (rows past t_q have lse = +inf, so they give p = 0 either way)
    const int j = tiles[i];
    const int k0 = j * BK;
    const uint32_t w0 = keep_bits[2 * j];
    const uint32_t w1 = 2 * j + 1 < n_words ? keep_bits[2 * j + 1] : 0u;
    const bool full = (w0 & w1) == 0xffffffffu &&
                      (!causal || k0 + BK - 1 <= q0 + offset);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const uint32_t word = jj < 4 ? w0 : w1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int kl = 8 * jj + 2 * t + (e & 1);
        float p = exp2f(fmaf(sc[4 * jj + e], sl2, -lse2[h]));
        if (!full) {
          const bool ok = ((word >> (kl & 31)) & 1u) != 0u &&
                          (!causal || k0 + kl <= qp[h] + offset);
          p = ok ? p : 0.f;
        }
        sc[4 * jj + e] = p * (dp[4 * jj + e] - dlt[h]);  // ds
      }
    }
    uint32_t a[4][4];
    pack_a(a, sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc, a[kk], desc_mn<D>(sK, kk));  // dS K
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(a);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qp[h] >= t_q) continue;
    bf16* drow = dq + ((size_t)bh * t_q + qp[h]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8 + 2 * t) =
          pack_bf16(acc[4 * n + 2 * h] * scale, acc[4 * n + 2 * h + 1] * scale);
  }
}

// dynamic shared memory of K3b: the K and V tiles, the Q/dO ring, each
// stage's lse and delta rows (2 * ROW_STRIDE bytes), the ring's barriers
// and K/V's
template <int D>
size_t dkv_wgmma_smem_bytes() {
  constexpr int S = Stages<D>::DKV;
  return 1024 + (size_t)(2 + 2 * S) * Tile<D>::BYTES + 2 * ROW_STRIDE * S +
         8 * (S + 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_lse,
                  const __grid_constant__ CUtensorMap tm_delta,
                  const float* __restrict__ mask, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int H, int t_q, int t_kv, int causal,
                  float scale) {
  typedef Tile<D> G;
  constexpr int S = Stages<D>::DKV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + G::BYTES;
  const uint32_t sRing = base + 2 * G::BYTES;  // stage s: Q, then dO
  const uint32_t sRows = sRing + 2 * S * G::BYTES;  // stage s: lse, delta
  const uint32_t sBar = sRows + 2 * ROW_STRIDE * S;  // ring barriers, K/V's
  const uint32_t kvbar = sBar + 8 * S;
  const float* rows = reinterpret_cast<const float*>(smem_raw + (sRows - raw));

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8
  const int kp[2] = {k0 + r0, k0 + r0 + 8};
  const int offset = t_kv - t_q;
  const float* mrow = mask ? mask + (size_t)(bh / H) * t_kv : nullptr;
  const CUtensorMap *pq = &tm_q, *pdo = &tm_do, *plse = &tm_lse,
                    *pdelta = &tm_delta;
  bool keep[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    keep[h] = kp[h] < t_kv && (mrow == nullptr || mrow[kp[h]] >= 1.0f);
  // a key tile the mask hides entirely (or that no query sees) is zero
  const bool any = __syncthreads_or(keep[0] || keep[1]) != 0;
  const bool all = __syncthreads_and(keep[0] && keep[1]) != 0;
  const int q_begin = causal ? first_q_tile(k0, offset) : 0;
  const int n_q = any && q_begin < t_q ? (t_q - q_begin + BQ - 1) / BQ : 0;

  float gk[D / 2], gv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.f;

  // Q, dO, lse and delta of the i-th query tile into ring stage i % S
  auto issue = [&](int i) {
    const int s = i % S;
    const uint32_t bar = sBar + 8 * s;
    const uint32_t dst = sRing + 2 * s * G::BYTES;
    const int q0 = q_begin + i * BQ;
    const int row0 = (bh * t_q + q0) & ~3;
    mbar_expect(bar, 2 * G::BYTES + 2 * VEC_BYTES);
#pragma unroll
    for (int c = 0; c < G::CHUNKS; ++c) {
      tma_rows(dst + c * G::CHUNK_BYTES, pq, bar, c * G::CW, q0, bh);
      tma_rows(dst + G::BYTES + c * G::CHUNK_BYTES, pdo, bar, c * G::CW, q0,
               bh);
    }
    tma_vec(sRows + 2 * ROW_STRIDE * s, plse, bar, row0);
    tma_vec(sRows + 2 * ROW_STRIDE * s + ROW_STRIDE, pdelta, bar, row0);
  };

  if (n_q > 0) {
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s <= S; ++s) mbar_init(sBar + 8 * s);
      fence_barrier_init();
      mbar_expect(kvbar, 2 * G::BYTES);
#pragma unroll
      for (int c = 0; c < G::CHUNKS; ++c) {
        tma_rows(sK + c * G::CHUNK_BYTES, &tm_k, kvbar, c * G::CW, k0, bh);
        tma_rows(sV + c * G::CHUNK_BYTES, &tm_v, kvbar, c * G::CW, k0, bh);
      }
      for (int i = 0; i < min(S, n_q); ++i) issue(i);
    }
    __syncthreads();  // the barriers are initialised before anyone waits
    const float sl2 = scale * LOG2E;
    mbar_wait(kvbar, 0);

    for (int i = 0; i < n_q; ++i) {
      const int s = i % S;
      if (i > 0) {
        __syncthreads();  // every thread is done with tile i - 1's stage
        if (tid == 0 && i - 1 + S < n_q) issue(i - 1 + S);
      }
      mbar_wait(sBar + 8 * s, (i / S) & 1);
      const int q0 = q_begin + i * BQ;
      const uint32_t sQ = sRing + 2 * s * G::BYTES, sDO = sQ + G::BYTES;
      // this tile's lse and delta, past the copies' alignment
      const float* rl = rows + (2 * ROW_STRIDE / 4) * s + ((bh * t_q + q0) & 3);
      const float* rd = rl + ROW_STRIDE / 4;

      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss64(st, desc_k<D>(sK, kk), desc_k<D>(sQ, kk), kk);  // K Q^T
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss64(dpt, desc_k<D>(sV, kk), desc_k<D>(sDO, kk), kk);  // V dO^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // fully visible: every key kept, every query in range, every pair on
      // or before the diagonal; only the others test elements
      const bool full = all && q0 + BQ <= t_q &&
                        (!causal || k0 + BK - 1 <= q0 + offset);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int ql = 8 * jj + 2 * t + (e & 1);
          const float lv = rl[ql];
          const float dl = rd[ql];
          float p = exp2f(fmaf(st[4 * jj + e], sl2, -lv * LOG2E));
          float ds = p * (dpt[4 * jj + e] - dl);
          if (!full) {
            const bool ok = keep[h] && q0 + ql < t_q &&
                            (!causal || kp[h] <= q0 + ql + offset);
            p = ok ? p : 0.f;
            ds = ok ? ds : 0.f;
          }
          st[4 * jj + e] = p;
          dpt[4 * jj + e] = ds;
        }
      }
      uint32_t ap[4][4], as[4][4];
      pack_a(ap, st);
      pack_a(as, dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(gv, ap[kk], desc_mn<D>(sDO, kk));  // P^T dO
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(gk, as[kk], desc_mn<D>(sQ, kk));  // dS^T Q
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(gv);
      fence_regs(gk);
      fence_regs(ap);
      fence_regs(as);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kp[h] >= t_kv) continue;
    const size_t o = ((size_t)bh * t_kv + kp[h]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + o + n * 8 + 2 * t) =
          pack_bf16(gk[4 * n + 2 * h] * scale, gk[4 * n + 2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + o + n * 8 + 2 * t) =
          pack_bf16(gv[4 * n + 2 * h], gv[4 * n + 2 * h + 1]);
    }
  }
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
    CUtensorMap mq, mdo, mk, mv;
    if (!encode_rows<D>(&mq, q, t_q, B * H) ||
        !encode_rows<D>(&mdo, dout, t_q, B * H) ||
        !encode_rows<D>(&mk, k, t_kv, B * H) ||
        !encode_rows<D>(&mv, v, t_kv, B * H))
      return cudaErrorInvalidValue;
    const size_t smem = dq_wgmma_smem_bytes<D>(t_kv);
    if ((err = set_smem(bwd_dq_wgmma<D>, smem)) != cudaSuccess) return err;
    bwd_dq_wgmma<D><<<grid, THREADS, smem, stream>>>(
        mq, mdo, mk, mv, lse, delta, mask, static_cast<bf16*>(dq), H, t_q,
        t_kv, causal, scale);
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
    CUtensorMap mq, mdo, mk, mv, ml, md;
    const long long rows = (long long)B * H * t_q;
    if (!encode_rows<D>(&mq, q, t_q, B * H) ||
        !encode_rows<D>(&mdo, dout, t_q, B * H) ||
        !encode_rows<D>(&mk, k, t_kv, B * H) ||
        !encode_rows<D>(&mv, v, t_kv, B * H) ||
        !encode_vec(&ml, lse, rows) || !encode_vec(&md, delta, rows))
      return cudaErrorInvalidValue;
    const size_t smem = dkv_wgmma_smem_bytes<D>();
    if ((err = set_smem(bwd_dkv_wgmma<D>, smem)) != cudaSuccess) return err;
    bwd_dkv_wgmma<D><<<grid, THREADS, smem, stream>>>(
        mq, mdo, mk, mv, ml, md, mask, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), H, t_q, t_kv, causal, scale);
  }
  return cudaGetLastError();
}

bool bad_dims(int B, int H, int t_q, int t_kv, int dtype) {
  // TMA coordinates are 32-bit: the flat lse/delta index b*h*t_q + q too
  return B <= 0 || H <= 0 || t_q <= 0 || t_kv <= 0 ||
         (long long)B * H * t_q > 2147483647LL ||
         (long long)B * H * t_kv > 2147483647LL ||
         (t_q + BQ - 1) / BQ > 65535 || (t_kv + BK - 1) / BK > 65535 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse and delta are f32 (B*H, t_q);
// mask may be null. Each returns the launch's cudaError_t (0 on success;
// cudaErrorInvalidValue also where a tensor map cannot be built); the
// kernel runs on `stream` and the call does not synchronise. q/k/v/dout,
// lse, delta and the outputs must be contiguous; the bf16 path reads them
// through TMA, so their base pointers must be 16-byte aligned.
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
