// Flash-attention forward for Hopper (sm_90a), bound through a plain C
// entry point and loaded with ctypes.
//
// Replaces: analytics_zoo_tpu/ops/pallas/flash_attention.py, the Pallas
// kernel _fwd_kernel launched by _flash_fwd (pl.pallas_call at :385).
// Same contract: q (B,H,Tq,D), k/v (B,H,Tk,D) in f32 or bf16, D in {32,
// 64, 128}, any Tq and Tk; an optional (B,Tk) f32 key-padding keep-mask
// where >= 1.0 attends; bottom-right aligned causal masking (offset = Tk -
// Tq, either sign); a row with no visible key writes zeros; f32
// accumulation; an optional f32 row log-sum-exp (natural log, +inf for
// empty rows). In bf16 the probabilities enter the second product rounded
// to bf16 while the denominator keeps them in f32, as the Pallas kernel's
// p.astype(v.dtype) does.
//
// What bounds it on this card: 4*D operations per visible (query, key)
// pair against 4*T*D elements moved per head, so at BERT's (T=512) and the
// LM's (T=4096) shapes a kernel that keeps the score tile on chip is bound
// by the tensor-core products (0.278 ms at the LM's causal shape). The
// bf16 path (serving's and training's) is built for that:
//  * A block owns 128 query rows of one batch*head: two consumer
//    warpgroups of 64 rows each, sharing one ring of K/V tiles, and one
//    producer warp. The TPU kernel's sequential k-block grid axis becomes
//    the key loop inside the block, so the running max, denominator and
//    output live in registers. Two blocks share an SM at D <= 64, so four
//    warpgroups' products, exponentials and waits overlap. (Issuing the
//    next tile's S before this tile's softmax, FA3's overlap within a
//    warpgroup, needs 32 more registers a thread, leaves one block an SM,
//    and measured slower.)
//  * S = Q K^T on wgmma (m64n64k16, bf16 in, f32 accumulate) with both
//    operands in shared memory; the f32 accumulator becomes p in
//    registers (the running max, exp2 on a log2e-prescaled scale, the
//    denominator from the f32 p), p is rounded to bf16 and fed straight
//    to O += P V as the register A operand. V is read in its stored (Tk,
//    D) layout through an MN-major descriptor: no transposed copy exists.
//    What bounds the loop is instruction issue and the special-function
//    unit's exponentials, not the products, so the softmax is kept lean:
//    row maxima and sums in four partial chains, the output's rescale
//    skipped where no row max grew, and the per-element mask tests in a
//    branch of their own (left inline, the compiler predicated them into
//    every tile).
//  * Q is loaded once and 64-key K/V tiles stream by TMA (a CUtensorMap
//    per operand, the 128-byte swizzle the descriptors name, 64-byte at D
//    = 32) into a ring of 3 stages on mbarriers: the producer warp issues
//    a stage's copies once both warpgroups have released it, so the next
//    tiles land while this one is multiplied. TMA zero-fills rows past T.
//  * Tiles are classified before any work: key tiles past the causal
//    diagonal, or hidden entirely by the key-padding mask (whose bits each
//    block reads once), are never loaded; only diagonal, partly masked or
//    ragged tiles test elements. A batch*head's q tiles run side by side
//    (its K and V then come from L2), the causal ones longest first.
//  * f32: plain FMAs on the CUDA cores (TF32 tensor cores would round the
//    operands to 10 mantissa bits, outside the f32 contract), bound by the
//    f32 rate and shared-memory loads. One thread block owns one
//    (batch*head, 64-row q-tile) and loops over 64-key tiles; causal
//    blocks stop at the last tile the block's last row can see.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block of the f32 kernel
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // four warps (f32)

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs. Two threads share a query row: each scores every
// other key of the tile and accumulates every other output column; the row
// max and denominator are exchanged with one warp shuffle.
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) +
                                  BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ mask,
                  float* __restrict__ out, float* __restrict__ lse, int H,
                  int t_q, int t_kv, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int LDP = BK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;           // BQ x LD
  float* sK = sQ + BQ * LD;   // BK x LD
  float* sV = sK + BK * LD;   // BK x LD
  float* sP = sV + BK * LD;   // BQ x LDP
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
    sQ[r * LD + c] = (q0 + r < t_q) ? q[q_base + (size_t)(q0 + r) * D + c]
                                    : 0.f;
  }

  // the last row of this block sees keys up to q0 + BQ - 1 + offset
  int k_end = t_kv;
  if (causal) k_end = min(k_end, q0 + BQ + offset);

  float m = -INFINITY;
  float l = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; sQ is written
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

    float s[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[row * LD + d];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        s[j] = fmaf(qd, sK[(2 * j + half) * LD + d], s[j]);
    }

    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int kj = 2 * j + half;
      const bool ok = sKeep[kj] != 0.f &&
                      (!causal || k0 + kj <= qpos + offset);
      s[j] = ok ? s[j] * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m, tile_max);
    const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
    const float corr = (m == -INFINITY) ? 0.f : expf(m - m_safe);

    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const float p = (s[j] == -INFINITY) ? 0.f : expf(s[j] - m_safe);
      psum += p;
      sP[row * LDP + 2 * j + half] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr;
    __syncthreads();  // the probability tile is complete

    for (int j = 0; j < BK; ++j) {
      const float p = sP[row * LDP + j];
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        acc[i] = fmaf(p, sV[j * LD + 2 * i + half], acc[i]);
    }
  }

  if (qpos < t_q) {
    const float denom = (l == 0.f) ? 1.f : l;
    float* orow = out + q_base + (size_t)qpos * D;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) orow[2 * i + half] = acc[i] / denom;
    if (lse != nullptr && half == 0)
      lse[(size_t)bh * t_q + qpos] = (l == 0.f) ? INFINITY : m + logf(l);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed tiles (the helpers and fragment layouts are in
// hopper.cuh).
// ---------------------------------------------------------------------------

using namespace hopper;

constexpr int W_BQ = 128;                    // query rows per block
constexpr int W_CONSUMERS = 256;             // two consumer warpgroups
constexpr int W_THREADS = W_CONSUMERS + 32;  // and one producer warp
constexpr int W_STAGES = 3;                  // K/V ring depth
// blocks an SM holds: two at D <= 64 (four consumer warpgroups, whose
// phases overlap), one at D = 128 (two would spill registers)
template <int D>
constexpr int min_blocks() {
  return D == 128 ? 1 : 2;
}

// 2^x on the special-function unit (exp2f adds a range fix-up around
// the same instruction; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// dynamic shared memory: the two Q tiles, the K/V ring, its full and
// empty barriers and Q's, the keep-mask bits of every key and the list of
// visible key tiles; 1024 bytes of slack align the tiles
template <int D>
size_t wgmma_smem_bytes(int t_kv) {
  const int n_words = (t_kv + 31) / 32, n_tiles = (t_kv + BK - 1) / BK;
  return 1024 + (size_t)(2 + 2 * W_STAGES) * Tile<D>::BYTES +
         8 * (2 * W_STAGES + 1) + 4 * (size_t)(n_words + n_tiles + 1);
}

template <int D>
__global__ void __launch_bounds__(W_THREADS, min_blocks<D>())
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const float* __restrict__ mask, bf16* __restrict__ out,
                    float* __restrict__ lse, int H, int t_q, int t_kv,
                    int causal, float scale) {
  typedef Tile<D> G;
  constexpr int S = W_STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;                          // warpgroup w's: + w BYTES
  const uint32_t sRing = base + 2 * G::BYTES;        // stage s: K, then V
  const uint32_t sFull = sRing + 2 * S * G::BYTES;   // stage s's K/V landed
  const uint32_t sEmpty = sFull + 8 * S;             // both warpgroups done
  const uint32_t qbar = sEmpty + 8 * S;
  const int n_words = (t_kv + 31) / 32;
  uint32_t* keep_bits =
      reinterpret_cast<uint32_t*>(smem_raw + (qbar + 8 - raw));
  int* tiles = reinterpret_cast<int*>(keep_bits + n_words);
  int* n_vis_shared = tiles + (t_kv + BK - 1) / BK;

  // one batch*head's q tiles run side by side, so its K and V are read
  // from device memory once and then from L2; within it the last q tiles,
  // which see the most keys under causal masking, start first
  const int n_qt = (t_q + W_BQ - 1) / W_BQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x % n_qt)) * W_BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int offset = t_kv - t_q;
  const float* mrow = mask ? mask + (size_t)(bh / H) * t_kv : nullptr;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(sFull + 8 * s);
      mbar_init(sEmpty + 8 * s, W_CONSUMERS / 32);  // one arrival a warp
    }
    mbar_init(qbar);
    fence_barrier_init();
  }

  // the keys this block can see: causally up to q0 + W_BQ - 1 + offset;
  // the mask's keep bits of those keys, 0 past t_kv
  int k_end = t_kv;
  if (causal) k_end = min(k_end, q0 + W_BQ + offset);
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  for (int b0 = 0; b0 < n_tiles * BK; b0 += W_THREADS) {
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

  if (warp == W_CONSUMERS / 32) {
    // producer: Q once (the second warpgroup's rows only where any lies
    // before t_q), then K and V of the i-th visible key tile into ring
    // stage i % S once both warpgroups have released the tile before it
    if (lane == 0) {
      const int nq = q0 + 64 < t_q ? 2 : 1;
      mbar_expect(qbar, nq * G::BYTES);
      for (int w = 0; w < nq; ++w)
#pragma unroll
        for (int c = 0; c < G::CHUNKS; ++c)
          tma_rows(sQ + w * G::BYTES + c * G::CHUNK_BYTES, &tm_q, qbar,
                   c * G::CW, q0 + 64 * w, bh);
      for (int i = 0; i < n_vis; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(sEmpty + 8 * s, (i / S - 1) & 1);
        const uint32_t bar = sFull + 8 * s;
        const uint32_t dst = sRing + 2 * s * G::BYTES;
        const int k0 = tiles[i] * BK;
        mbar_expect(bar, 2 * G::BYTES);
#pragma unroll
        for (int c = 0; c < G::CHUNKS; ++c) {
          tma_rows(dst + c * G::CHUNK_BYTES, &tm_k, bar, c * G::CW, k0, bh);
          tma_rows(dst + G::BYTES + c * G::CHUNK_BYTES, &tm_v, bar,
                   c * G::CW, k0, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wq0 .. wq0 + 63
  const int wg = warp >> 2;
  const int wq0 = q0 + 64 * wg;
  const uint32_t sQw = sQ + wg * G::BYTES;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int qp[2] = {wq0 + r0, wq0 + r0 + 8};

  // the tiles this warpgroup multiplies: a prefix of the list (causally the
  // keys up to its last row's diagonal), none when its rows lie past t_q
  int n_mine = 0;
  if (wq0 < t_q) {
    n_mine = n_vis;
    if (causal)
      while (n_mine > 0 && tiles[n_mine - 1] * BK > wq0 + 63 + offset)
        --n_mine;
  }

  const float sl2 = scale * LOG2E;
  float m[2] = {-INFINITY, -INFINITY};  // running row max of the raw scores
  float l[2] = {0.f, 0.f};  // this thread's part of the running denominator
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (n_mine > 0) mbar_wait(qbar, 0);
  for (int i = 0; i < n_mine; ++i) {
    const int s = i % S;
    const uint32_t sK = sRing + 2 * s * G::BYTES, sV = sK + G::BYTES;
    mbar_wait(sFull + 8 * s, (i / S) & 1);
    float sc[32];  // S = Q K^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss64(sc, desc_k<D>(sQw, kk), desc_k<D>(sK, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // a tile is fully visible when every key is kept and lies on or before
    // the diagonal of the warpgroup's first row; only the others test
    // elements (masked scores become -inf)
    const int j = tiles[i];
    const int k0 = j * BK;
    const uint32_t w0 = keep_bits[2 * j];
    const uint32_t w1 = 2 * j + 1 < n_words ? keep_bits[2 * j + 1] : 0u;
    const bool full = (w0 & w1) == 0xffffffffu &&
                      (!causal || k0 + BK - 1 <= wq0 + offset);
    if (__builtin_expect(!full, 0)) {
      // diagonal, partly masked or ragged tiles only (a separate branch, so
      // fully visible tiles issue none of these tests)
      int lim[2];  // the last visible key of each row, from k0
#pragma unroll
      for (int h = 0; h < 2; ++h) lim[h] = causal ? qp[h] + offset - k0 : BK;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const uint32_t word = (jj < 4 ? w0 : w1) >> (8 * (jj & 3) + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = 8 * jj + 2 * t + (e & 1);
          const bool ok = ((word >> (e & 1)) & 1u) != 0u && kl <= lim[e >> 1];
          sc[4 * jj + e] = ok ? sc[4 * jj + e] : -INFINITY;
        }
      }
    }
    // row maxima and sums over four interleaved partial chains each (a
    // thread's 16 scores of a row), so the dependent steps are 4, not 16
    float mp[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) mp[h][c] = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mp[e >> 1][2 * (jj & 1) + (e & 1)] =
            fmaxf(mp[e >> 1][2 * (jj & 1) + (e & 1)], sc[4 * jj + e]);
    float corr[2], mu[2];
    bool moved = false;  // a row max of this thread's rows grew
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(fmaxf(mp[h][0], mp[h][1]), fmaxf(mp[h][2], mp[h][3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[h], mx);
      const float safe = mn == -INFINITY ? 0.f : mn;
      moved |= mn != m[h];
      corr[h] = ex2((m[h] - safe) * sl2);  // 0 while m is -inf
      mu[h] = safe * sl2;
      m[h] = mn;
    }
    float ps[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) ps[h][c] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = ex2(fmaf(sc[4 * jj + e], sl2, -mu[h]));
        ps[h][2 * (jj & 1) + (e & 1)] += p;
        sc[4 * jj + e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l[h] = l[h] * corr[h] + ((ps[h][0] + ps[h][1]) + (ps[h][2] + ps[h][3]));
    // the output's rescale, skipped where no row max of the warp grew
    // (corr is then exactly 1)
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int i2 = 0; i2 < D / 2; ++i2) acc[i2] *= corr[(i2 >> 1) & 1];
    }

    // O += P V: P in bf16 from registers, V (keys x D) MN-major
    uint32_t a[4][4];
    pack_a(a, sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], desc_mn<D>(sV, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(a);
    // release the stage: every warp of both warpgroups arrives once
    __syncwarp();
    if (lane == 0) mbar_arrive(sEmpty + 8 * s);
  }
  // the tiles past this warpgroup's diagonal (or all, when its rows lie
  // past t_q): released once they have landed, so each stage's release
  // counts both warpgroups in order
  for (int i = n_mine; i < n_vis; ++i) {
    const int s = i % S;
    mbar_wait(sFull + 8 * s, (i / S) & 1);
    __syncwarp();
    if (lane == 0) mbar_arrive(sEmpty + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (qp[h] >= t_q) continue;
    const float denom = l[h] == 0.f ? 1.f : l[h];
    bf16* orow = out + ((size_t)bh * t_q + qp[h]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(acc[4 * n + 2 * h] / denom,
                    acc[4 * n + 2 * h + 1] / denom);
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * t_q + qp[h]] =
          l[h] == 0.f ? INFINITY : m[h] * scale + logf(l[h]);
  }
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const float* mask, void* out, float* lse, int B, int H,
                   int t_q, int t_kv, int causal, float scale,
                   cudaStream_t stream) {
  cudaError_t err;
  if (dtype == 0) {
    const size_t smem = fma_smem_bytes<D>();
    if ((err = set_smem(flash_fwd_fma<D>, smem)) != cudaSuccess) return err;
    flash_fwd_fma<D><<<dim3(B * H, (t_q + BQ - 1) / BQ), THREADS, smem,
                       stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, static_cast<float*>(out), lse, H,
        t_q, t_kv, causal, scale);
  } else {
    CUtensorMap mq, mk, mv;
    if (!encode_rows<D>(&mq, q, t_q, B * H) ||
        !encode_rows<D>(&mk, k, t_kv, B * H) ||
        !encode_rows<D>(&mv, v, t_kv, B * H))
      return cudaErrorInvalidValue;
    const size_t smem = wgmma_smem_bytes<D>(t_kv);
    if ((err = set_smem(flash_fwd_wgmma<D>, smem)) != cudaSuccess) return err;
    const long long blocks = (long long)B * H * ((t_q + W_BQ - 1) / W_BQ);
    if (blocks > 2147483647LL) return cudaErrorInvalidValue;
    flash_fwd_wgmma<D><<<(unsigned)blocks, W_THREADS, smem, stream>>>(
        mq, mk, mv, mask, static_cast<bf16*>(out), lse, H, t_q, t_kv, causal,
        scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask and lse may be null. Returns the
// launch's cudaError_t (0 on success; cudaErrorInvalidValue also where a
// tensor map cannot be built); the kernel runs on `stream` and the call
// does not synchronise. q/k/v/out must be contiguous; the f32 path reads
// 16-byte vectors and the bf16 path reads q, k and v through TMA, so their
// base pointers must be 16-byte aligned.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   void* out, void* lse, int B, int H,
                                   int t_q, int t_kv, int D, int causal,
                                   int dtype, float scale, void* stream) {
  if (B <= 0 || H <= 0 || t_q <= 0 || t_kv <= 0 ||
      (long long)B * H > 2147483647LL || (t_q + BQ - 1) / BQ > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return (int)launch<32>(dtype, q, k, v, m, out, l, B, H, t_q, t_kv,
                             causal, scale, s);
    case 64:
      return (int)launch<64>(dtype, q, k, v, m, out, l, B, H, t_q, t_kv,
                             causal, scale, s);
    case 128:
      return (int)launch<128>(dtype, q, k, v, m, out, l, B, H, t_q, t_kv,
                              causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
