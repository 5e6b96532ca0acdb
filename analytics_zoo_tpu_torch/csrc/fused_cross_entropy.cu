// Fused LM-head cross-entropy for Hopper (sm_90a): three kernels, each in
// a wgmma, an mma.sync and an FMA form, bound through plain C entry points
// and loaded with ctypes.
//
// Replaces: analytics_zoo_tpu/ops/pallas/cross_entropy.py, the Pallas
// kernels _ce_fwd_kernel (K4, pl.pallas_call in fused_ce_forward at :325),
// _ce_bwd_dh_kernel (K5a, fused_ce_backward at :496) and _ce_bwd_dw_kernel
// (K5b, fused_ce_backward at :525). Same contract: h (N,H) and w (H,V) in
// the compute dtype (f32 or bf16), an optional f32 bias (V,), int32 labels
// (N,). Each kernel forms its logits tile with Dense's rounding: the f32
// product rounded to the compute dtype, the bias (rounded to the compute
// dtype) added in the compute dtype, the sum upcast to f32. Vocab columns
// past V are masked; rows past N are read as zeros and never written.
//  * K4 writes per row lse = m + log(l == 0 ? 1 : l) of the online max m
//    and denominator l, and the label's logit (0 when the label is not in
//    [0, V)). No logits tile reaches device memory.
//  * K5a re-forms p = exp(logit - lse) (0 on masked columns) and
//    dl = (p - onehot) * scale, rounds dl to the compute dtype and
//    accumulates dh = dl W^T in f32, written once in dh's dtype.
//  * K5b accumulates dW = h^T dl (dl rounded as in K5a) in f32 and
//    db = the column sum of the f32 dl, taken before the rounding.
// All three sum every logit over k = 0..H-1 in 16-wide tensor-core steps
// in the same order: the mma.sync kernels with one device function, the
// wgmma kernels with wgmma steps, which give the mma.sync steps' logits bit
// for bit (K5a's dh, on an H100 at the LM shape). The backward thus
// re-forms the forward's p bit for bit. Scale is 0 on masked rows and NaN
// on rows with an over-range label; nothing skips a row, so a NaN row
// spreads into dh's row and every column of dW, as in the XLA form.
//
// What bounds them on this card: at the LM path's shape (N=65,536, H=512,
// V=8192, bf16) K4 does 2NHV and K5a/K5b 4NHV operations each against
// O(NH + HV) bytes, thousands of operations per byte: the products bound
// all three. Hence:
//  * bf16 (the training path): every product runs on the tensor cores.
//    Where TMA can address the operands (padded H <= 512, V % 8 == 0, h and
//    w 16-byte aligned: the LM path) all three run on wgmma with TMA-fed
//    tiles (ce_fwd_wgmma, ce_bwd_dh_wgmma, ce_bwd_dw_wgmma, below); each
//    C entry point reports the kernel it took. The other bf16 shapes use
//    mma.sync m16n8k16 (bf16 in, f32 accumulate): operands that the
//    fragment wants in the other orientation (W for the logits, h^T and dl
//    for dW) are read from row-major shared-memory tiles with
//    ldmatrix.trans, so no tile is stored transposed.
//  * f32: plain FMAs on the CUDA cores (TF32 would round the operands to
//    10 mantissa bits, outside the f32 contract).
// On the wgmma routes at the LM shape (times on an H100 in PERF.md, phases
// by scripts/ce_breakdown.py): K4 is bound by its logits products (m64n256
// steps, two warpgroups sharing each W stage) and by its tile epilogue,
// which the products do not overlap; K5a and K5b by their m64n32 logits,
// whose shared-memory reads outrun the tensor cores, and by streaming W
// (K5a) or h (K5b) through L2 once a block. Each kernel's note names the
// designs tried and dropped.
//
// Design: on the TPU each kernel walks a sequential grid and carries its
// accumulator in VMEM scratch. Here blocks run in no order, so each output
// is owned by one block that loops itself. The wgmma kernels are described
// at each kernel; the mma.sync ones:
//  * K4: a block owns 64 rows and loops over 32-column vocab tiles; each
//    warp holds 16 rows' running max, denominator and label logit in
//    registers (the flash-forward scheme).
//  * K5a: a block owns 32 rows and loops over 64-column vocab tiles. The
//    logits tile becomes a bf16 dl tile in shared memory; then each of 8
//    warps accumulates a 16-row by H/4 slice of dh in registers (at most
//    128 f32 per thread at H=1024).
//  * K5b: a block owns 32 vocab columns of dW/db and loops over all rows in
//    64-row tiles; each of 8 warps carries an H/4 by 16 slice of dW in
//    registers (64 f32 per thread at H=512, 128 at H=1024). The other
//    choice, a split of the row loop into groups whose partial dW a second
//    kernel sums, buys parallelism only for small V and costs an extra
//    (H,V) f32 pass; it is not needed on the main path.
// Any hidden width: H must be a multiple of 64 (the wrapper pads h's
// columns and w's rows with zeros, which add exact zeros to every logit).
// In the mma.sync kernels H is cut into S = ceil(H / 1024) slices of KS <=
// 1024 columns (slice_width). K4 stages h and W one slice at a time through
// shared memory and carries each logits tile across the slices. K5a and
// K5b gain a grid dimension over the slices of dh or dW: each block
// re-forms its p tile over the full H, slice by slice, and carries only its
// own slice of dh or dW, so the shared memory and the register carry stay
// those of H = KS. With S = 1 (H <= 1024) the SLICED template flag is false
// and each kernel compiles to a single pass that stages h (K4, K5a) or W
// (K5b) once (a slice loop there cost K5b 16% at the LM shape on an H100).
// The k order of every logit is 0..H-1 in all kernels whatever S is.
// No float atomics anywhere: every output element is written by exactly
// one thread, summed in a fixed order (db over the row warps in a fixed
// order too), so dh, dW and db are the same bits from run to run.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// bf16 helpers: mma.sync m16n8k16 fragments (PTX ISA). With g = lane / 4 and
// t = lane % 4 a thread holds A rows g and g+8 at columns 2t, 2t+1 (and +8);
// B columns g at rows 2t, 2t+1 (and +8); C rows g and g+8 at columns 2t,
// 2t+1.
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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Dense's rounding of two adjacent logits at once: bf16(bf16(acc) + bf16(b))
// for both halves of bf16x2 words (a, b the rounded values). One bf16x2
// fma by 1.0 rounds the exact sum once, which is what the f32 add and its
// rounding give: two bf16 values whose exponents differ by at most 15 add
// exactly in f32, and further apart the smaller lies under half an ulp of
// the larger either way.
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(0x3F803F80u),
      "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// the lower and the upper half of a bf16x2 word as f32
__device__ __forceinline__ float lo_bf16(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
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

// A fragment of rows r, r+8, columns c..c+15 from a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base,
                                       int ld, int r, int c, int t) {
  const bf16* p = base + r * ld + c + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

template <int M>
__device__ __forceinline__ void zero_acc(float (&acc)[M][4]) {
#pragma unroll
  for (int j = 0; j < M; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// The one logits routine of all three bf16 kernels: adds to a 16 x (16 NP)
// f32 tile h[rows, slice] @ W[slice, c0 : c0 + 16 NP] over the slice's
// k = 0..K-1 in steps of 16, from a row-major h tile (rows x ldh) and a
// row-major W tile (K x ldw) of one H slice. The caller zeroes acc and
// calls it once per slice in ascending order, so every logit sums
// k = 0..H-1 in one order in all three kernels. `row` is this thread's
// first row (slab start + g). acc[j] holds columns c0 + 8j + 2t (+1) in
// the C layout.
template <int NP>
__device__ __forceinline__ void logits_tile(float (&acc)[2 * NP][4],
                                            const bf16* sH, int ldh, int row,
                                            const bf16* sW, int ldw, int c0,
                                            int K, int lane) {
  const int t = lane & 3;
  // matrix j = lane / 8 of each ldmatrix: k rows +8 for odd j, columns +8
  // for j >= 2 -> B fragments (b0, b1) of two adjacent 8-column tiles
  const bf16* wl = sW + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ldw + c0 +
                   8 * (lane >> 4);
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    load_a(a, sH, ldh, row, k0, t);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      uint32_t b[4];
      ldsm_x4_trans(b, wl + k0 * ldw + 16 * p);
      mma_bf16(acc[2 * p], a, b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// rows [n0, n0 + rows), columns [k0, k0 + kw) of h (N x H, bf16, 16-byte
// aligned rows) into a row-major tile; rows past N are zero
__device__ __forceinline__ void load_rows_bf16(const bf16* __restrict__ h,
                                               int n0, int rows, int N, int H,
                                               int k0, int kw, bf16* sH,
                                               int ldh, int tid,
                                               int nthreads) {
  const int per_row = kw / 8;
  for (int i = tid; i < rows * per_row; i += nthreads) {
    const int r = i / per_row, c = (i % per_row) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < N)
      val = *reinterpret_cast<const uint4*>(h + (size_t)(n0 + r) * H + k0 +
                                            c);
    *reinterpret_cast<uint4*>(sH + r * ldh + c) = val;
  }
}

// rows [k0, k0 + kw), columns [v0, v0 + cols) of w (H x V, bf16) into a
// row-major kw x cols tile; columns past V are zero. 16-byte loads where
// the row allows (vec: V is a multiple of 8 and w is 16-byte aligned),
// element loads elsewhere.
__device__ __forceinline__ void load_cols_bf16(const bf16* __restrict__ w,
                                               int v0, int cols, int V,
                                               int k0, int kw, bf16* sW,
                                               int ldw, int vec, int tid,
                                               int nthreads) {
  const int per_row = cols / 8;
  for (int i = tid; i < kw * per_row; i += nthreads) {
    const int r = i / per_row, c = (i % per_row) * 8;
    const int col = v0 + c;
    const bf16* src = w + (size_t)(k0 + r) * V + col;
    bf16* dst = sW + r * ldw + c;
    if (vec && col + 8 <= V) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int x = 0; x < 8; ++x)
        dst[x] = col + x < V ? src[x] : __float2bfloat16(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// K4, bf16: 64 rows per block, 4 warps of 16 rows, 32-column vocab tiles,
// H staged in slices of KS columns.
// ---------------------------------------------------------------------------

constexpr int F_BN = 64;
constexpr int F_BV = 32;
constexpr int F_THREADS = 128;

size_t fwd_mma_smem_bytes(int KS) {
  return sizeof(bf16) * ((size_t)F_BN * (KS + 8) + (size_t)KS * (F_BV + 8));
}

template <bool SLICED>
__global__ void __launch_bounds__(F_THREADS)
    ce_fwd_mma(const bf16* __restrict__ h, const bf16* __restrict__ w,
               const float* __restrict__ b, const int* __restrict__ labels,
               float* __restrict__ lse, float* __restrict__ ll, int N, int H,
               int V, int KS, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldh = KS + 8, ldw = F_BV + 8;
  bf16* sH = reinterpret_cast<bf16*>(smem_raw);
  bf16* sW = sH + F_BN * ldh;
  __shared__ float sB[F_BV];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * F_BN;
  const int row = warp * 16 + g;  // this thread's rows: row and row + 8

  // one slice: the h tile stays for the whole vocab loop
  if (!SLICED) load_rows_bf16(h, n0, F_BN, N, H, 0, H, sH, ldh, tid,
                              F_THREADS);
  int lab[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = n0 + row + 8 * hh;
    lab[hh] = r < N ? labels[r] : -1;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};

  for (int v0 = 0; v0 < V; v0 += F_BV) {
    float acc[4][4];
    zero_acc(acc);
    int k0 = 0;
    do {  // the H slices in order; one pass unless SLICED
      const int kw = SLICED ? min(KS, H - k0) : H;
      __syncthreads();  // the previous W (and h) tiles are consumed
      if (SLICED)
        load_rows_bf16(h, n0, F_BN, N, H, k0, kw, sH, ldh, tid, F_THREADS);
      load_cols_bf16(w, v0, F_BV, V, k0, kw, sW, ldw, vec, tid, F_THREADS);
      if (k0 == 0 && tid < F_BV)
        sB[tid] =
            (b != nullptr && v0 + tid < V) ? round_bf16(b[v0 + tid]) : 0.f;
      __syncthreads();
      logits_tile<2>(acc, sH, ldh, row, sW, ldw, 0, kw, lane);
      k0 += KS;
    } while (SLICED && k0 < H);
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = 8 * j + 2 * t + (e & 1);
        const int col = v0 + cl;
        const int hh = e >> 1;
        float x = -INFINITY;
        if (col < V) {
          x = round_bf16(round_bf16(acc[j][e]) + sB[cl]);
          if (col == lab[hh]) a[hh] += x;
        }
        acc[j][e] = x;
        tmax[hh] = fmaxf(tmax[hh], x);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = tmax[hh];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m[hh] == -INFINITY ? 0.f : expf(m[hh] - m_safe);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps += expf(acc[j][2 * hh] - m_safe);  // masked columns: exp(-inf)
        ps += expf(acc[j][2 * hh + 1] - m_safe);
      }
      l[hh] = l[hh] * corr + ps;
      m[hh] = m_new;
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float ls = l[hh], as = a[hh];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    as += __shfl_xor_sync(0xffffffffu, as, 1);
    as += __shfl_xor_sync(0xffffffffu, as, 2);
    const int r = n0 + row + 8 * hh;
    if (t == 0 && r < N) {
      lse[r] = m[hh] + logf(ls == 0.f ? 1.f : ls);
      ll[r] = as;
    }
  }
}

// ---------------------------------------------------------------------------
// K4, bf16 on wgmma: H <= 512 (padded), V % 8 == 0, h and w 16-byte aligned
// (what TMA can address; the LM path). A block owns 128 rows, 64 a
// warpgroup, and walks the vocab in 256-column tiles.
//  * The h tile is loaded once by TMA (H / 64 boxes of 64 x 64 a
//    warpgroup, the K-major A operand). W streams through a 5-stage ring
//    of 32 rows x 256 columns (four 64-column boxes in the 128-byte
//    swizzle, 16 KB) on mbarriers, one vocab tile after another in k
//    order; both warpgroups read every stage.
//  * Warpgroup wg forms its rows' 64 x 256 logits tile on wgmma m64n256k16
//    (B the W stage read MN-major: no transposed copy), k = 0..H-1 in
//    16-wide steps in order (the steps K5a's and K5b's m64n32 logits take:
//    the same bits). Each stage's wgmma group is committed on its own and
//    waited for one stage later, so two are in flight; then a block
//    barrier, and thread 0 refills the stage. Its copies are predicated
//    instructions, not a branch: ptxas serialises every wgmma of a kernel
//    whose in-flight groups cross a divergent path.
//  * The epilogue of a tile works in registers: Dense's roundings two
//    columns at a time on bf16x2 words (add_bf16x2: the same bits as the
//    f32 form), the running max, the denominator on ex2 of a
//    log2e-prescaled difference, both over four interleaved partials; the
//    label logit is picked by the one thread whose columns hold it. Only
//    the last tile of a ragged V tests columns. Each row's state lives in
//    the four threads of its quad and is summed by a fixed butterfly at
//    the end; no logits tile reaches device memory.
// Bound at the LM shape: the logits products (0.56 ms of bf16 tensor
// time); the m64n256 instruction reads 10 KB of shared memory for 128
// tensor cycles, under shared memory's 128 bytes a cycle, where K5a's
// m64n32 logits read 3 KB for 16. Each block streams all of W from L2 (4.3
// GB a call at the LM shape), and the tiles' epilogues do not overlap the
// products: two warps an SM quarter hide little latency, which is why the
// epilogue packs its arithmetic. Designs tried on an H100 and dropped
// (scripts/ce_breakdown.py and throwaway probes): thread 0 waiting
// on an empty mbarrier of both warpgroups inside the stage loop (the
// wgmmas were serialised, C7520, and the logits took much longer);
// 128-column tiles alternating between the warpgroups with a producer warp
// (ping-pong: 288 threads hold ptxas to 168 registers, which spilled, and
// the arrivals still serialised the wgmmas); the epilogue in f32, one
// element at a time; a write-only first step of each tile (to free the
// accumulator registers across the epilogue: the compiler then spilled
// more and the epilogue slowed down).
// ---------------------------------------------------------------------------

constexpr int Y_BN = 128, Y_BV = 256, Y_KC = 32, Y_STAGES = 5;
constexpr int Y_THREADS = 256;  // two warpgroups
constexpr uint32_t Y_STAGE_BYTES = Y_KC * Y_BV * 2;

constexpr size_t fwd_wgmma_smem(int H) {
  return 1024 + (size_t)H * 256 + Y_STAGES * Y_STAGE_BYTES +
         2 * Y_BV * sizeof(float) + 8 * (1 + Y_STAGES);
}

template <int H>
__global__ void __launch_bounds__(Y_THREADS, 1)
    ce_fwd_wgmma(const __grid_constant__ CUtensorMap tm_h,
                 const __grid_constant__ CUtensorMap tm_w,
                 const float* __restrict__ b, const int* __restrict__ labels,
                 float* __restrict__ lse, float* __restrict__ ll, int N,
                 int V) {
  constexpr int S = Y_STAGES;
  constexpr int KCH = H / Y_KC;                // ring stages a vocab tile
  constexpr uint32_t H_TILE = H * 128;         // one warpgroup's 64 rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sH = base;                    // warpgroup wg: + wg H_TILE
  const uint32_t sW = sH + 2 * H_TILE;         // stage s: + s Y_STAGE_BYTES
  const uint32_t sBias = sW + S * Y_STAGE_BYTES;  // tile i: + (i & 1) 1 KB
  const uint32_t full = sBias + 2 * Y_BV * sizeof(float);
  const uint32_t hbar = full + 8 * S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int t = lane & 3;
  const int r0 = 16 * (warp & 3) + (lane >> 2);  // rows r0, r0 + 8
  const int nb = blockIdx.x * Y_BN;
  const int n0 = nb + 64 * wg;                    // this warpgroup's rows
  const int nv = (V + Y_BV - 1) / Y_BV;
  const int nq = nv * KCH;                        // ring stages in all
  // stage q: W rows (q % KCH) KC .., columns (q / KCH) 256 .., issued by
  // the threads for which `pred` holds (thread 0; predicated, so the
  // wgmmas in flight around it are not serialised); boxes that lie wholly
  // past V are not loaded (their columns are masked)
  auto load_w = [&](bool pred, int q) {
    const int s = q % S;
    const int v0 = (q / KCH) * Y_BV, k0 = (q % KCH) * Y_KC;
    const int boxes = min(Y_BV / 64, (V - v0 + 63) / 64);
    mbar_expect_if(pred, full + 8 * s, boxes * Y_KC * 128);
#pragma unroll
    for (int a = 0; a < Y_BV / 64; ++a)
      tma_2d_if(pred && a < boxes, sW + s * Y_STAGE_BYTES + a * Y_KC * 128,
                &tm_w, full + 8 * s, v0 + 64 * a, k0);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(full + 8 * s);
    mbar_init(hbar);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    // the second warpgroup's rows only where some lie below N (a box wholly
    // past N is not loaded; those rows are never written)
    const int tiles = nb + 64 < N ? 2 : 1;
    mbar_expect(hbar, tiles * H_TILE);
    for (int w2 = 0; w2 < tiles; ++w2)
#pragma unroll
      for (int c = 0; c < H / 64; ++c)
        tma_2d(sH + w2 * H_TILE + c * Tile<64>::BYTES, &tm_h, hbar, 64 * c,
               nb + 64 * w2);
    for (int q = 0; q < S && q < nq; ++q) load_w(true, q);
  }
  __syncwarp();

  int lab[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = n0 + r0 + 8 * hh;
    lab[hh] = r < N ? labels[r] : -1;
    if (lab[hh] >= V) lab[hh] = -1;  // an over-range label hits no column
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
  float acc[128];
  const uint32_t h_tile = sH + wg * H_TILE;
  uint32_t* bias_base = reinterpret_cast<uint32_t*>(
      smem_raw + (sBias - raw));

  // stage q has been read by both warpgroups' wgmmas once every thread is
  // past its wait for them: thread 0 refills it with stage q + S
  auto refill = [&](int q) {
    __syncthreads();
    load_w(tid == 0 && q + S < nq, q + S);
  };

  mbar_wait(hbar, 0);
  for (int i = 0; i < nv; ++i) {
    const int v0 = i * Y_BV;
    // this tile's bias, rounded, as bf16x2 words of column pairs (read
    // after the barriers below; tile i + 2 reuses the buffer after tile i +
    // 1's)
    if (tid < Y_BV / 2) {
      const int col = v0 + 2 * tid;
      float pair[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        pair[e] = (b != nullptr && col + e < V) ? b[col + e] : 0.f;
      bias_base[(i & 1) * (Y_BV / 2) + tid] = pack_bf16(pair[0], pair[1]);
    }
    wgmma_fence();
    for (int c = 0; c < KCH; ++c) {
      const int q = i * KCH + c, s = q % S;
      mbar_wait(full + 8 * s, (q / S) & 1);
      const uint32_t stage = sW + s * Y_STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < Y_KC / 16; ++kk)
        wgmma_ss256<0, 1>(acc, desc_k<H>(h_tile, c * (Y_KC / 16) + kk),
                          smem_desc(stage + 16 * kk * 128, Y_KC * 128, 1024,
                                    1),
                          c > 0 || kk > 0);
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();  // stage q - 1's group is done
        refill(q - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    refill(i * KCH + KCH - 1);  // its barrier also publishes the bias tile

    // register 4j + e: row r0 + 8 (e >> 1), tile column 8j + 2t + (e & 1).
    // The rounded logits of columns 8j + 2t and + 1 go back into register
    // 4j + 2 (e >> 1) as a bf16x2 word; row maxima and sums are carried in
    // four interleaved partials (short dependence chains: two warps an SM
    // quarter hide little latency) and summed in a fixed order.
    const uint32_t* sb = bias_base + (i & 1) * (Y_BV / 2);
    auto finish = [&](auto ragged_tile) {
      constexpr bool RAGGED = decltype(ragged_tile)::value;
      uint32_t mx4[2][4];
#pragma unroll
      for (int j = 0; j < Y_BV / 8; ++j) {
        const uint32_t bias = sb[4 * j + t];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          uint32_t x = add_bf16x2(
              pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]), bias);
          if (RAGGED) {  // columns past V: -inf
            const int col = v0 + 8 * j + 2 * t;
            if (col >= V) x = (x & 0xFFFF0000u) | 0xFF80u;
            if (col + 1 >= V) x = (x & 0xFFFFu) | 0xFF800000u;
          }
          acc[4 * j + 2 * hh] = __uint_as_float(x);
          mx4[hh][j & 3] = j < 4 ? x : max_bf16x2(mx4[hh][j & 3], x);
        }
      }
      float msc[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t m2 = max_bf16x2(max_bf16x2(mx4[hh][0], mx4[hh][1]),
                                       max_bf16x2(mx4[hh][2], mx4[hh][3]));
        float mx = fmaxf(lo_bf16(m2), hi_bf16(m2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        l[hh] *= m[hh] == -INFINITY ? 0.f : ex2((m[hh] - m_safe) * LOG2E);
        m[hh] = m_new;
        msc[hh] = m_safe * LOG2E;
      }
      float ls[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < Y_BV / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {  // masked columns: ex2(-inf) = 0
          const uint32_t x = __float_as_uint(acc[4 * j + 2 * hh]);
          ls[hh][j & 3] += ex2(fmaf(lo_bf16(x), LOG2E, -msc[hh]));
          ls[hh][j & 3] += ex2(fmaf(hi_bf16(x), LOG2E, -msc[hh]));
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        l[hh] += (ls[hh][0] + ls[hh][1]) + (ls[hh][2] + ls[hh][3]);
      // the label's logit: only the thread whose columns hold it looks
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int lc = lab[hh] - v0 - 2 * t;
        if (lc >= 0 && lc < Y_BV && (lc & 6) == 0) {
#pragma unroll
          for (int j = 0; j < Y_BV / 8; ++j)
            if (lc >> 3 == j) {
              const uint32_t x = __float_as_uint(acc[4 * j + 2 * hh]);
              a[hh] += (lc & 1) ? hi_bf16(x) : lo_bf16(x);
            }
        }
      }
    };
    if (v0 + Y_BV <= V)
      finish(std::false_type{});
    else
      finish(std::true_type{});
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float ls = l[hh], as = a[hh];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    as += __shfl_xor_sync(0xffffffffu, as, 1);
    as += __shfl_xor_sync(0xffffffffu, as, 2);
    const int r = n0 + r0 + 8 * hh;
    if (t == 0 && r < N) {
      lse[r] = m[hh] + logf(ls == 0.f ? 1.f : ls);
      ll[r] = as;
    }
  }
}

// ---------------------------------------------------------------------------
// K5a, bf16: 32 rows per block, 8 warps, 64-column vocab tiles; grid y is
// the H slice of dh the block writes. Logits: warp (w & 1) takes rows
// 16 (w & 1), columns 16 (w >> 1). dh: warp takes rows 16 (w & 1) and
// columns [(w >> 1) D/4, (w >> 1 + 1) D/4) of the block's slice of width D.
// ---------------------------------------------------------------------------

constexpr int A_BN = 32;
constexpr int A_BV = 64;
constexpr int A_THREADS = 256;

size_t dh_mma_smem_bytes(int KS) {
  return sizeof(bf16) * ((size_t)A_BN * (KS + 8) + (size_t)KS * (A_BV + 8) +
                         (size_t)A_BN * (A_BV + 8));
}

template <int MAXNT, bool SLICED>
__global__ void __launch_bounds__(A_THREADS)
    ce_bwd_dh_mma(const bf16* __restrict__ h, const bf16* __restrict__ w,
                  const float* __restrict__ b, const int* __restrict__ labels,
                  const float* __restrict__ lse,
                  const float* __restrict__ scale, void* __restrict__ dh,
                  int dh_bf16, int N, int H, int V, int KS, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldh = KS + 8, ldw = A_BV + 8, ldd = A_BV + 8;
  bf16* sH = reinterpret_cast<bf16*>(smem_raw);
  bf16* sW = sH + A_BN * ldh;
  bf16* sDL = sW + KS * ldw;
  __shared__ float sB[A_BV];
  __shared__ float sLse[A_BN], sScale[A_BN];
  __shared__ int sLab[A_BN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * A_BN;
  const int wr = warp & 1, wc = warp >> 1;
  const int row = 16 * wr + g;
  const int y0 = SLICED ? blockIdx.y * KS : 0;  // this block's dh columns
  const int dwid = SLICED ? min(KS, H - y0) : H;
  const bool last_slice = !SLICED || y0 + KS >= H;
  const int nt = dwid / 32;       // 8-column tiles of this warp's dh slice
  const int hq0 = wc * (dwid / 4);

  if (!SLICED) load_rows_bf16(h, n0, A_BN, N, H, 0, H, sH, ldh, tid,
                              A_THREADS);
  if (tid < A_BN) {
    const int r = n0 + tid;
    const bool in = r < N;
    sLab[tid] = in ? labels[r] : -1;
    // pad rows: lse = +inf (every p is exactly 0) and scale 0
    sLse[tid] = in ? lse[r] : INFINITY;
    sScale[tid] = in ? scale[r] : 0.f;
  }

  float acc[MAXNT][4];
  zero_acc(acc);

  for (int v0 = 0; v0 < V; v0 += A_BV) {
    float lg[2][4];
    zero_acc(lg);
    int k0 = 0;
    do {  // the H slices in order; one pass unless SLICED
      const int kw = SLICED ? min(KS, H - k0) : H;
      __syncthreads();  // the previous W, h and dl tiles are consumed
      if (SLICED)
        load_rows_bf16(h, n0, A_BN, N, H, k0, kw, sH, ldh, tid, A_THREADS);
      load_cols_bf16(w, v0, A_BV, V, k0, kw, sW, ldw, vec, tid, A_THREADS);
      if (k0 == 0 && tid < A_BV)
        sB[tid] =
            (b != nullptr && v0 + tid < V) ? round_bf16(b[v0 + tid]) : 0.f;
      __syncthreads();
      logits_tile<1>(lg, sH, ldh, row, sW, ldw, 16 * wc, kw, lane);
      k0 += KS;
    } while (SLICED && k0 < H);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = row + 8 * (e >> 1);
        const int cl = 16 * wc + 8 * j + 2 * t + (e & 1);
        const int col = v0 + cl;
        float p = 0.f, oh = 0.f;
        if (col < V) {
          const float x = round_bf16(round_bf16(lg[j][e]) + sB[cl]);
          p = expf(x - sLse[rl]);
          oh = col == sLab[rl] ? 1.f : 0.f;
        }
        sDL[rl * ldd + cl] = __float2bfloat16((p - oh) * sScale[rl]);
      }
    }
    __syncthreads();  // the dl tile is complete; sW is free
    if (!last_slice) {
      // sW holds the last slice's W rows; the product needs this block's
      load_cols_bf16(w, v0, A_BV, V, y0, dwid, sW, ldw, vec, tid, A_THREADS);
      __syncthreads();
    }

#pragma unroll
    for (int kk = 0; kk < A_BV / 16; ++kk) {
      uint32_t a[4];
      load_a(a, sDL, ldd, row, 16 * kk, t);
#pragma unroll
      for (int i = 0; i < MAXNT; ++i) {
        if (i < nt) {
          const bf16* bp = sW + (hq0 + 8 * i + g) * ldw + 16 * kk + 2 * t;
          mma_bf16(acc[i], a, ld32(bp), ld32(bp + 8));
        }
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = n0 + row + 8 * hh;
    if (r >= N) continue;
#pragma unroll
    for (int i = 0; i < MAXNT; ++i) {
      if (i >= nt) break;
      const size_t o = (size_t)r * H + y0 + hq0 + 8 * i + 2 * t;
      if (dh_bf16) {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dh) + o) =
            pack_bf16(acc[i][2 * hh], acc[i][2 * hh + 1]);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(dh) + o) =
            make_float2(acc[i][2 * hh], acc[i][2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K5a, bf16 on wgmma: H <= 512 (padded), V % 8 == 0, h and w 16-byte
// aligned (what TMA can address; the LM path). A block owns 64 rows of h
// and walks the vocab in 64-column tiles with two warpgroups.
//  * The h tile is loaded once (H / 64 boxes of 64 x 64 by TMA, the
//    K-major A operand) and W tiles (H rows x 64 columns, 128 bytes a row
//    in the 128-byte swizzle) stream through a 2-stage ring on mbarriers.
//    Thread 0 issues every copy: the first two tiles up front, then tile i
//    + 2 as soon as both warpgroups have released tile i's stage, so it
//    lands while tile i + 1 is multiplied.
//  * Warpgroup wg forms the logits of tile columns 32 wg .. + 31, S = h
//    W_tile (m64n32k16 x H / 16, A the h tile, B the W tile read MN-major:
//    no transposed copy), k = 0..H-1 in 16-wide steps as K4's mma.sync
//    steps (the same logits bits, checked on the card); then p = exp(x -
//    lse) and dl = (p - onehot) * scale with Dense's roundings, rounded to
//    bf16 into a 64 x 64 dl tile in shared memory (128-byte swizzle, two
//    buffers). Behind a barrier over both warpgroups it adds dh[:, wg
//    H/2 ..] += dl W_tile^T over the tile's 64 vocab columns (A the dl
//    tile, B the same W tile's rows wg H/2 .. read K-major; m64n256k16 at
//    H = 512, else m64n32k16 pieces), then releases the stage.
//  * The dh carry, 64 x H/2 f32 a warpgroup (128 registers a thread at H
//    = 512), stays in registers over the whole vocab loop and is written
//    once in dh's dtype. Two warpgroups at one block an SM leave each
//    thread 255 registers.
// Where its time goes at the LM shape (65,536 x 512 x 8192) is measured by
// scripts/ce_breakdown.py: the logits, whose shared-memory reads (192
// KB a tile) bound them, take the most. Designs tried on an H100 and
// dropped as slower: a producer warp or warpgroup beside the two (the
// compiler then held every thread to 168 registers, setmaxnreg
// notwithstanding, and serialised the wgmmas); two-block clusters sharing
// each W tile by TMA multicast; one warpgroup forming all of dl (m64n64
// logits) for two dh warpgroups a tile behind; each tile's dh product
// issued before the next tile's logits (with two stages the load of tile
// i + 2 then waits for both); the column tests in every tile instead of
// the last (predicated around expf, they cost more than the products).
// ---------------------------------------------------------------------------

constexpr int X_BN = 64, X_BV = 64, X_STAGES = 2;
constexpr int X_THREADS = 256;  // two warpgroups
constexpr int X_DL_BYTES = 64 * 128;

constexpr size_t dh_wgmma_smem(int H) {
  return 1024 + (size_t)H * 128 * (1 + X_STAGES) + 2 * X_DL_BYTES +
         8 * (1 + 2 * X_STAGES);
}

// W tiles load as boxes of this many rows (at most 256, dividing H)
__host__ __device__ constexpr int dh_box_rows(int H) {
  return H <= 256 ? H : H / 2;
}

template <int H>
__global__ void __launch_bounds__(X_THREADS, 1)
    ce_bwd_dh_wgmma(const __grid_constant__ CUtensorMap tm_h,
                    const __grid_constant__ CUtensorMap tm_w,
                    const float* __restrict__ b, const int* __restrict__ labels,
                    const float* __restrict__ lse,
                    const float* __restrict__ scale, void* __restrict__ dh,
                    int dh_bf16, int N, int V) {
  constexpr int DW = H / 2;  // dh columns of a warpgroup
  constexpr int S = X_STAGES;
  constexpr uint32_t TILE_BYTES = H * 128;  // the h tile, a W tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sH = base;
  const uint32_t sW = sH + TILE_BYTES;             // stage s: + s TILE_BYTES
  const uint32_t sDL = sW + S * TILE_BYTES;        // dl tile i % 2
  const uint32_t full = sDL + 2 * X_DL_BYTES;      // stage s's W landed
  const uint32_t empty = full + 8 * S;             // both warpgroups done
  const uint32_t hbar = empty + 8 * S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3) + g;  // this thread's rows: r0, r0 + 8
  const int n0 = blockIdx.x * X_BN;
  const int nv = (V + X_BV - 1) / X_BV;
  auto load_w = [&](int i) {  // tile i into its stage
    const int s = i % S;
    mbar_expect(full + 8 * s, TILE_BYTES);
    for (int r = 0; r < H; r += dh_box_rows(H))
      tma_2d(sW + s * TILE_BYTES + r * 128, &tm_w, full + 8 * s, i * X_BV,
             r);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s);
      mbar_init(empty + 8 * s, 8);  // every warp
    }
    mbar_init(hbar);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(hbar, TILE_BYTES);
#pragma unroll
    for (int c = 0; c < H / 64; ++c)
      tma_2d(sH + c * Tile<64>::BYTES, &tm_h, hbar, 64 * c, n0);
    for (int i = 0; i < S && i < nv; ++i) load_w(i);
  }
  __syncwarp();

  int lab[2];
  float row_lse[2], row_scale[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = n0 + r0 + 8 * hh;
    const bool in = r < N;
    lab[hh] = in ? labels[r] : -1;
    // pad rows: lse = +inf (every p is exactly 0) and scale 0
    row_lse[hh] = in ? lse[r] : INFINITY;
    row_scale[hh] = in ? scale[r] : 0.f;
  }
  float acc[DW / 2];
#pragma unroll
  for (int j = 0; j < DW / 2; ++j) acc[j] = 0.f;
  unsigned char* dl_base = smem_raw + (sDL - raw);

  mbar_wait(hbar, 0);
  for (int i = 0; i < nv; ++i) {
    const int s = i % S;
    const uint32_t w_tile = sW + s * TILE_BYTES;
    mbar_wait(full + 8 * s, (i / S) & 1);
    // S = h W_tile over this warpgroup's 32 columns
    float sc[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk)
      wgmma_ss32<1>(sc, 0, desc_k<H>(sH, kk),
                    desc_mn<64>(w_tile + 64 * wg, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // dl, rounded to bf16, into this tile's dl buffer (the other buffer may
    // still feed the other warpgroup's product of the previous tile):
    // register 4j + e is row r0 + 8 (e >> 1), tile column 32 wg + 8j + 2t
    // + (e & 1). Only the last tile of a ragged V tests its columns: in
    // every tile the tests, predicated around expf, cost more than the dh
    // products.
    const int v0 = i * X_BV;
    unsigned char* dlb = dl_base + (i & 1) * X_DL_BYTES;
    auto form_dl = [&](auto ragged_tile) {
      constexpr bool RAGGED = decltype(ragged_tile)::value;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = 32 * wg + 8 * j + 2 * t;
        float bias[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          bias[e] = (b != nullptr && (!RAGGED || v0 + cl + e < V))
                        ? round_bf16(b[v0 + cl + e]) : 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = v0 + cl + e;
            float p = 0.f, oh = 0.f;
            if (!RAGGED || col < V) {
              const float x =
                  round_bf16(round_bf16(sc[4 * j + 2 * hh + e]) + bias[e]);
              p = expf(x - row_lse[hh]);
              oh = col == lab[hh] ? 1.f : 0.f;
            }
            d[e] = (p - oh) * row_scale[hh];
          }
          // the 128-byte swizzle: 16-byte chunk c / 8 of row r lies at
          // chunk (c / 8) ^ (r % 8)
          const int r = r0 + 8 * hh;
          *reinterpret_cast<uint32_t*>(
              dlb + r * 128 + (((cl >> 3) ^ (r & 7)) << 4) + (cl & 7) * 2) =
              pack_bf16(d[0], d[1]);
        }
      }
    };
    if (v0 + X_BV <= V)
      form_dl(std::false_type{});
    else
      form_dl(std::true_type{});
    fence_proxy_async();
    __syncthreads();  // both warpgroups' halves of dl are written

    // dh[:, wg DW ..] += dl W_tile^T: B the tile's rows wg DW .., K-major
    const uint32_t dl_tile = sDL + (i & 1) * X_DL_BYTES;
    const uint32_t w_rows = w_tile + wg * DW * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < X_BV / 16; ++kk) {
      if constexpr (DW == 256) {
        wgmma_ss256(acc, desc_k<64>(dl_tile, kk), desc_k<64>(w_rows, kk));
      } else {
#pragma unroll
        for (int nt = 0; nt < DW / 32; ++nt)
          wgmma_ss32<0>(acc, 16 * nt, desc_k<64>(dl_tile, kk),
                        desc_k<64>(w_rows + nt * 32 * 128, kk), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    // release the stage; thread 0 refills it with tile i + 2 once both
    // warpgroups have
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    if (tid == 0 && i + S < nv) {
      mbar_wait(empty + 8 * s, (i / S) & 1);
      load_w(i + S);
    }
    __syncwarp();
  }

  // register 4j + e: row r0 + 8 (e >> 1), dh column wg DW + 8j + 2t +
  // (e & 1)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = n0 + r0 + 8 * hh;
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      const size_t o = (size_t)r * H + wg * DW + 8 * j + 2 * t;
      if (dh_bf16)
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dh) + o) =
            pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(dh) + o) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K5b, bf16: 32 vocab columns per block, all rows in 64-row tiles, 8 warps;
// grid y is the H slice of dW the block writes. Logits: warp takes rows
// 16 (w & 3), columns 16 (w >> 2). dW: warp takes rows [(w & 3) D/4, ...)
// of the block's slice of width D and the same 16 columns.
// ---------------------------------------------------------------------------

constexpr int B_BN = 64;
constexpr int B_BV = 32;
constexpr int B_THREADS = 256;

size_t dw_mma_smem_bytes(int KS) {
  return sizeof(bf16) * ((size_t)B_BN * (KS + 8) + (size_t)KS * (B_BV + 8) +
                         (size_t)B_BN * (B_BV + 8));
}

template <int MAXMT, bool SLICED>
__global__ void __launch_bounds__(B_THREADS)
    ce_bwd_dw_mma(const bf16* __restrict__ h, const bf16* __restrict__ w,
                  const float* __restrict__ b, const int* __restrict__ labels,
                  const float* __restrict__ lse,
                  const float* __restrict__ scale, float* __restrict__ dw,
                  float* __restrict__ db, int N, int H, int V, int KS,
                  int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldh = KS + 8, ldw = B_BV + 8, ldd = B_BV + 8;
  bf16* sH = reinterpret_cast<bf16*>(smem_raw);
  bf16* sW = sH + B_BN * ldh;
  bf16* sDL = sW + KS * ldw;
  __shared__ float sB[B_BV];
  __shared__ float sLse[B_BN], sScale[B_BN];
  __shared__ int sLab[B_BN];
  __shared__ float sDB[4][B_BV];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int v0 = blockIdx.x * B_BV;
  const int wr = warp & 3, wc = warp >> 2;
  const int row = 16 * wr + g;
  const int y0 = SLICED ? blockIdx.y * KS : 0;  // this block's dW rows
  const int dwid = SLICED ? min(KS, H - y0) : H;
  const bool last_slice = !SLICED || y0 + KS >= H;
  const int mt = dwid / 64;       // 16-row tiles of this warp's dW slice
  const int hr0 = wr * (dwid / 4);

  // one slice: the W tile stays for the whole row loop
  if (!SLICED) load_cols_bf16(w, v0, B_BV, V, 0, H, sW, ldw, vec, tid,
                              B_THREADS);
  if (tid < B_BV)
    sB[tid] = (b != nullptr && v0 + tid < V) ? round_bf16(b[v0 + tid]) : 0.f;

  float acc[MAXMT][2][4];
#pragma unroll
  for (int i = 0; i < MAXMT; ++i) zero_acc(acc[i]);
  float dbp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  // ldmatrix lane offsets (matrix j = lane / 8): dl as B needs rows +8 for
  // odd j and columns +8 for j >= 2; h^T as A needs rows +8 for j >= 2 and
  // columns +8 for odd j
  const int lr = lane & 7, odd = (lane >> 3) & 1, hi = lane >> 4;

  for (int n0 = 0; n0 < N; n0 += B_BN) {
    float lg[2][4];
    zero_acc(lg);
    int k0 = 0;
    do {  // the H slices in order; one pass unless SLICED
      const int kw = SLICED ? min(KS, H - k0) : H;
      __syncthreads();  // the previous h, W and dl tiles are consumed
      load_rows_bf16(h, n0, B_BN, N, H, k0, kw, sH, ldh, tid, B_THREADS);
      if (SLICED)
        load_cols_bf16(w, v0, B_BV, V, k0, kw, sW, ldw, vec, tid, B_THREADS);
      if (k0 == 0 && tid < B_BN) {
        const int r = n0 + tid;
        const bool in = r < N;
        sLab[tid] = in ? labels[r] : -1;
        sLse[tid] = in ? lse[r] : INFINITY;
        sScale[tid] = in ? scale[r] : 0.f;
      }
      __syncthreads();
      logits_tile<1>(lg, sH, ldh, row, sW, ldw, 16 * wc, kw, lane);
      k0 += KS;
    } while (SLICED && k0 < H);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = row + 8 * (e >> 1);
        const int cl = 16 * wc + 8 * j + 2 * t + (e & 1);
        const int col = v0 + cl;
        float p = 0.f, oh = 0.f;
        if (col < V) {
          const float x = round_bf16(round_bf16(lg[j][e]) + sB[cl]);
          p = expf(x - sLse[rl]);
          oh = col == sLab[rl] ? 1.f : 0.f;
        }
        const float d = (p - oh) * sScale[rl];
        dbp[j][e & 1] += d;
        sDL[rl * ldd + cl] = __float2bfloat16(d);
      }
    }
    __syncthreads();  // the dl tile is complete; sH is free
    if (!last_slice) {
      // sH holds the last slice's h columns; the product needs this block's
      load_rows_bf16(h, n0, B_BN, N, H, y0, dwid, sH, ldh, tid, B_THREADS);
      __syncthreads();
    }

#pragma unroll
    for (int ks = 0; ks < B_BN / 16; ++ks) {
      uint32_t bb[4];
      ldsm_x4_trans(bb, sDL + (16 * ks + lr + 8 * odd) * ldd + 16 * wc +
                            8 * hi);
#pragma unroll
      for (int i = 0; i < MAXMT; ++i) {
        if (i < mt) {
          uint32_t a[4];
          ldsm_x4_trans(a, sH + (16 * ks + lr + 8 * hi) * ldh + hr0 +
                               16 * i + 8 * odd);
          mma_bf16(acc[i][0], a, bb[0], bb[1]);
          mma_bf16(acc[i][1], a, bb[2], bb[3]);
        }
      }
    }
  }

  // db (the slice-0 blocks write it): the 8 row groups of a warp by a fixed
  // butterfly, then the 4 row warps in a fixed order
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v = dbp[j][c];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) sDB[wr][16 * wc + 8 * j + 2 * t + c] = v;
    }
  }
  __syncthreads();
  if (db != nullptr && y0 == 0 && tid < B_BV && v0 + tid < V)
    db[v0 + tid] =
        ((sDB[0][tid] + sDB[1][tid]) + sDB[2][tid]) + sDB[3][tid];

#pragma unroll
  for (int i = 0; i < MAXMT; ++i) {
    if (i >= mt) break;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int col = v0 + 16 * wc + 8 * s + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* o = dw + (size_t)(y0 + hr0 + 16 * i + g + 8 * hh) * V + col;
        if (col < V) o[0] = acc[i][s][2 * hh];
        if (col + 1 < V) o[1] = acc[i][s][2 * hh + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K5b, bf16 on wgmma: the shapes of K5a's wgmma route. K5a's kernel with
// the roles of h and W swapped: a block owns 64 vocab columns and all of
// H, and walks the rows in 64-row tiles with two warpgroups.
//  * The W tile (H rows x 64 columns, 128 bytes a row in the 128-byte
//    swizzle) is loaded once by TMA; h tiles (H / 64 boxes of 64 x 64, the
//    K-major A operand) stream through a 2-stage ring on mbarriers. Thread
//    0 issues every copy: the first two tiles up front, then tile i + 2 as
//    soon as both warpgroups have released tile i's stage.
//  * Warpgroup wg forms the logits of tile columns 32 wg .. + 31 exactly
//    as K5a does (m64n32k16 x H / 16, A the h tile, B the W tile read
//    MN-major: the same bits), then dl = (p - onehot) * scale with K5a's
//    roundings into a 64 x 64 bf16 dl tile in shared memory (128-byte
//    swizzle, two buffers), and adds the f32 dl to its columns' db.
//  * Behind a barrier over both warpgroups each adds its chunks of H to
//    the dW carry over the tile's 64 rows: dW^T[64 columns, H chunk] +=
//    dl^T h, A the dl tile and B the same h tile, both read MN-major (no
//    transposed copy); m64n256k16 at H = 512, else m64n64k16 a 64-column
//    chunk.
//  * The carry (64 x H/2 f32 a warpgroup, 128 registers a thread at H =
//    512) stays in registers over the whole row loop; rows are summed in
//    ascending order, db by a fixed butterfly and then the warps in order.
//    dW and db are written once, with no atomics.
// Bound at the LM shape: the products (1.11 ms of bf16 tensor time); the
// m64n32 logits read 3 KB of shared memory for 16 tensor cycles, above the
// 128 bytes a cycle shared memory gives, and each block streams all of h
// from L2 (8.6 GB a call).
// ---------------------------------------------------------------------------

template <int H>
__global__ void __launch_bounds__(X_THREADS, 1)
    ce_bwd_dw_wgmma(const __grid_constant__ CUtensorMap tm_h,
                    const __grid_constant__ CUtensorMap tm_w,
                    const float* __restrict__ b, const int* __restrict__ labels,
                    const float* __restrict__ lse,
                    const float* __restrict__ scale, float* __restrict__ dw,
                    float* __restrict__ db, int N, int V) {
  constexpr int S = X_STAGES;
  constexpr uint32_t TILE_BYTES = H * 128;  // the W tile, an h tile
  constexpr int C = H / 64;                 // 64-column chunks of H
  constexpr int C0 = (C + 1) / 2;           // warpgroup 0's chunks (the more)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float sDB[8][32];  // each warp's column sums of db
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sW = base;
  const uint32_t sH = sW + TILE_BYTES;        // stage s: + s TILE_BYTES
  const uint32_t sDL = sH + S * TILE_BYTES;   // dl tile i % 2
  const uint32_t full = sDL + 2 * X_DL_BYTES; // stage s's h landed
  const uint32_t empty = full + 8 * S;        // both warpgroups done
  const uint32_t wbar = empty + 8 * S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3) + g;  // this thread's rows: r0, r0 + 8
  const int v0 = blockIdx.x * X_BV;
  const int nt = (N + X_BN - 1) / X_BN;
  auto load_h = [&](int i) {  // row tile i into its stage
    const int s = i % S;
    mbar_expect(full + 8 * s, TILE_BYTES);
#pragma unroll
    for (int c = 0; c < C; ++c)
      tma_2d(sH + s * TILE_BYTES + c * Tile<64>::BYTES, &tm_h, full + 8 * s,
             64 * c, i * X_BN);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s);
      mbar_init(empty + 8 * s, 8);  // every warp
    }
    mbar_init(wbar);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(wbar, TILE_BYTES);
    for (int r = 0; r < H; r += dh_box_rows(H))
      tma_2d(sW + r * 128, &tm_w, wbar, v0, r);
    for (int i = 0; i < S && i < nt; ++i) load_h(i);
  }
  __syncwarp();

  // this thread's columns 32 wg + 8j + 2t + e: their rounded bias, and
  // their db over this thread's rows
  float bias[4][2], dbp[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = v0 + 32 * wg + 8 * j + 2 * t + e;
      bias[j][e] = (b != nullptr && col < V) ? round_bf16(b[col]) : 0.f;
      dbp[j][e] = 0.f;
    }
  // this warpgroup's chunks of H: [c_lo, c_lo + nc)
  const int c_lo = wg == 0 ? 0 : C0, nc = wg == 0 ? C0 : C - C0;
  float acc[C0 * 32];
#pragma unroll
  for (int j = 0; j < C0 * 32; ++j) acc[j] = 0.f;
  unsigned char* dl_base = smem_raw + (sDL - raw);
  const bool ragged = v0 + X_BV > V;

  mbar_wait(wbar, 0);
  for (int i = 0; i < nt; ++i) {
    const int s = i % S;
    const uint32_t h_tile = sH + s * TILE_BYTES;
    // the tile's rows (pad rows: lse = +inf, so every p is exactly 0, and
    // scale 0)
    int lab[2];
    float row_lse[2], row_scale[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = i * X_BN + r0 + 8 * hh;
      const bool in = r < N;
      lab[hh] = in ? labels[r] : -1;
      row_lse[hh] = in ? lse[r] : INFINITY;
      row_scale[hh] = in ? scale[r] : 0.f;
    }
    mbar_wait(full + 8 * s, (i / S) & 1);
    // S = h_tile W over this warpgroup's 32 columns
    float sc[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk)
      wgmma_ss32<1>(sc, 0, desc_k<H>(h_tile, kk),
                    desc_mn<64>(sW + 64 * wg, kk), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // dl, rounded to bf16, into this tile's dl buffer, as K5a forms it:
    // register 4j + e is row r0 + 8 (e >> 1), tile column 32 wg + 8j + 2t
    // + (e & 1). Only a ragged V's last block tests its columns.
    unsigned char* dlb = dl_base + (i & 1) * X_DL_BYTES;
    auto form_dl = [&](auto ragged_tile) {
      constexpr bool RAGGED = decltype(ragged_tile)::value;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = 32 * wg + 8 * j + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = v0 + cl + e;
            float p = 0.f, oh = 0.f;
            if (!RAGGED || col < V) {
              const float x =
                  round_bf16(round_bf16(sc[4 * j + 2 * hh + e]) + bias[j][e]);
              p = expf(x - row_lse[hh]);
              oh = col == lab[hh] ? 1.f : 0.f;
            }
            d[e] = (p - oh) * row_scale[hh];
            dbp[j][e] += d[e];
          }
          // the 128-byte swizzle: 16-byte chunk c / 8 of row r lies at
          // chunk (c / 8) ^ (r % 8)
          const int r = r0 + 8 * hh;
          *reinterpret_cast<uint32_t*>(
              dlb + r * 128 + (((cl >> 3) ^ (r & 7)) << 4) + (cl & 7) * 2) =
              pack_bf16(d[0], d[1]);
        }
      }
    };
    if (!ragged)
      form_dl(std::false_type{});
    else
      form_dl(std::true_type{});
    fence_proxy_async();
    __syncthreads();  // both warpgroups' halves of dl are written

    // dW^T[64 columns, this warpgroup's chunks] += dl^T h_tile: A the dl
    // tile and B the h tile's chunks, both MN-major
    const uint32_t dl_tile = sDL + (i & 1) * X_DL_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < X_BN / 16; ++kk) {
      if constexpr (H == 512) {
        wgmma_ss256<1, 1>(acc, desc_mn<64>(dl_tile, kk),
                          desc_mn<256>(h_tile + wg * 4 * Tile<64>::BYTES,
                                       kk));
      } else {
        // every warpgroup issues C0 products (no branch around a wgmma);
        // with an odd C, warpgroup 1's last one repeats its last chunk
        // into a piece of the carry that is never written
#pragma unroll
        for (int p = 0; p < C0; ++p)
          wgmma_ss64<1, 1>(
              *reinterpret_cast<float(*)[32]>(acc + 32 * p),
              desc_mn<64>(dl_tile, kk),
              desc_mn<64>(h_tile + min(c_lo + p, C - 1) * Tile<64>::BYTES,
                          kk),
              1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    // release the stage; thread 0 refills it with tile i + 2 once both
    // warpgroups have
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    if (tid == 0 && i + S < nt) {
      mbar_wait(empty + 8 * s, (i / S) & 1);
      load_h(i + S);
    }
    __syncwarp();
  }

  // db: the 8 row groups of a warp by a fixed butterfly, then the four
  // warps of the column's warpgroup in order
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = dbp[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) sDB[warp][8 * j + 2 * t + e] = v;
    }
  __syncthreads();
  if (db != nullptr && tid < X_BV && v0 + tid < V) {
    const int w0 = 4 * (tid >> 5), c = tid & 31;
    db[v0 + tid] =
        ((sDB[w0][c] + sDB[w0 + 1][c]) + sDB[w0 + 2][c]) + sDB[w0 + 3][c];
  }

  // register 4j + e: vocab column v0 + 16 (warp & 3) + g + 8 (e >> 1),
  // dW row 64 c_lo + 8j + 2t + (e & 1)
#pragma unroll
  for (int j = 0; j < C0 * 8; ++j) {
    if (j >= nc * 8) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = v0 + 16 * (warp & 3) + g + 8 * (e >> 1);
      if (col < V)
        dw[(size_t)(64 * c_lo + 8 * j + 2 * t + (e & 1)) * V + col] =
            acc[4 * j + e];
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs. Every logit is one fmaf chain over k = 0..H-1 from
// 0, the same in all three kernels, so p is re-formed bit for bit.
// ---------------------------------------------------------------------------

constexpr int FF_BN = 64, FF_BV = 64, FF_KC = 32, FF_THREADS = 256;

__global__ void __launch_bounds__(FF_THREADS)
    ce_fwd_fma(const float* __restrict__ h, const float* __restrict__ w,
               const float* __restrict__ b, const int* __restrict__ labels,
               float* __restrict__ lse, float* __restrict__ ll, int N, int H,
               int V) {
  __shared__ float sH[FF_BN][FF_KC + 1];
  __shared__ float sW[FF_KC][FF_BV + 1];
  __shared__ float sB[FF_BV];
  const int tid = threadIdx.x;
  const int r = tid >> 2, q = tid & 3;  // row, and columns q + 4j
  const int n0 = blockIdx.x * FF_BN;
  const int grow = n0 + r;
  const int lab = grow < N ? labels[grow] : -1;
  float m = -INFINITY, l = 0.f, a = 0.f;

  for (int v0 = 0; v0 < V; v0 += FF_BV) {
    float acc[FF_BV / 4];
#pragma unroll
    for (int j = 0; j < FF_BV / 4; ++j) acc[j] = 0.f;
    for (int k0 = 0; k0 < H; k0 += FF_KC) {
      __syncthreads();
      for (int i = tid; i < FF_BN * FF_KC; i += FF_THREADS) {
        const int rr = i / FF_KC, c = i % FF_KC;
        sH[rr][c] = n0 + rr < N ? h[(size_t)(n0 + rr) * H + k0 + c] : 0.f;
      }
      for (int i = tid; i < FF_KC * FF_BV; i += FF_THREADS) {
        const int kk = i / FF_BV, c = i % FF_BV;
        sW[kk][c] = v0 + c < V ? w[(size_t)(k0 + kk) * V + v0 + c] : 0.f;
      }
      if (k0 == 0 && tid < FF_BV)
        sB[tid] = (b != nullptr && v0 + tid < V) ? b[v0 + tid] : 0.f;
      __syncthreads();
      for (int kk = 0; kk < FF_KC; ++kk) {
        const float hv = sH[r][kk];
#pragma unroll
        for (int j = 0; j < FF_BV / 4; ++j)
          acc[j] = fmaf(hv, sW[kk][q + 4 * j], acc[j]);
      }
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < FF_BV / 4; ++j) {
      const int col = v0 + q + 4 * j;
      float x = -INFINITY;
      if (col < V) {
        x = acc[j] + sB[q + 4 * j];
        if (col == lab) a += x;
      }
      acc[j] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float corr = m == -INFINITY ? 0.f : expf(m - m_safe);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < FF_BV / 4; ++j) ps += expf(acc[j] - m_safe);
    l = l * corr + ps;
    m = m_new;
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  a += __shfl_xor_sync(0xffffffffu, a, 1);
  a += __shfl_xor_sync(0xffffffffu, a, 2);
  if (q == 0 && grow < N) {
    lse[grow] = m + logf(l == 0.f ? 1.f : l);
    ll[grow] = a;
  }
}

// K5a, f32: 16 rows per block; grid y is the H slice of dh the block
// writes. The logits run over the full H from device memory; the dh carry
// (16 x slice f32) lives in dynamic shared memory, each element owned by
// one thread.
constexpr int FA_BN = 16, FA_BV = 64, FA_KC = 64, FA_THREADS = 256;

__global__ void __launch_bounds__(FA_THREADS)
    ce_bwd_dh_fma(const float* __restrict__ h, const float* __restrict__ w,
                  const float* __restrict__ b, const int* __restrict__ labels,
                  const float* __restrict__ lse,
                  const float* __restrict__ scale, void* __restrict__ dh,
                  int dh_bf16, int N, int H, int V, int KS) {
  extern __shared__ float sDH[];  // FA_BN x KS
  __shared__ float sH[FA_BN][FA_KC + 1];
  __shared__ float sW[FA_KC][FA_BV + 1];
  __shared__ float sDL[FA_BN][FA_BV + 1];
  __shared__ float sB[FA_BV];
  const int tid = threadIdx.x;
  const int r = tid >> 4, q = tid & 15;  // row, and columns q + 16j
  const int n0 = blockIdx.x * FA_BN;
  const int grow = n0 + r;
  const bool in = grow < N;
  const int lab = in ? labels[grow] : -1;
  const float row_lse = in ? lse[grow] : INFINITY;
  const float row_scale = in ? scale[grow] : 0.f;
  const int y0 = blockIdx.y * KS, dwid = min(KS, H - y0);
  for (int c = q; c < dwid; c += 16) sDH[r * KS + c] = 0.f;

  for (int v0 = 0; v0 < V; v0 += FA_BV) {
    float acc[FA_BV / 16];
#pragma unroll
    for (int j = 0; j < FA_BV / 16; ++j) acc[j] = 0.f;
    for (int k0 = 0; k0 < H; k0 += FA_KC) {
      __syncthreads();
      for (int i = tid; i < FA_BN * FA_KC; i += FA_THREADS) {
        const int rr = i / FA_KC, c = i % FA_KC;
        sH[rr][c] = n0 + rr < N ? h[(size_t)(n0 + rr) * H + k0 + c] : 0.f;
      }
      for (int i = tid; i < FA_KC * FA_BV; i += FA_THREADS) {
        const int kk = i / FA_BV, c = i % FA_BV;
        sW[kk][c] = v0 + c < V ? w[(size_t)(k0 + kk) * V + v0 + c] : 0.f;
      }
      if (k0 == 0 && tid < FA_BV)
        sB[tid] = (b != nullptr && v0 + tid < V) ? b[v0 + tid] : 0.f;
      __syncthreads();
      for (int kk = 0; kk < FA_KC; ++kk) {
        const float hv = sH[r][kk];
#pragma unroll
        for (int j = 0; j < FA_BV / 16; ++j)
          acc[j] = fmaf(hv, sW[kk][q + 16 * j], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < FA_BV / 16; ++j) {
      const int cl = q + 16 * j;
      const int col = v0 + cl;
      float p = 0.f, oh = 0.f;
      if (col < V) {
        p = expf(acc[j] + sB[cl] - row_lse);
        oh = col == lab ? 1.f : 0.f;
      }
      sDL[r][cl] = (p - oh) * row_scale;
    }
    for (int k0 = y0; k0 < y0 + dwid; k0 += FA_KC) {
      __syncthreads();  // dl complete; the W chunk is free
      for (int i = tid; i < FA_KC * FA_BV; i += FA_THREADS) {
        const int kk = i / FA_BV, c = i % FA_BV;
        sW[kk][c] = v0 + c < V ? w[(size_t)(k0 + kk) * V + v0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < FA_KC / 16; ++j) {
        const int kh = q + 16 * j;
        float s = sDH[r * KS + k0 - y0 + kh];
        for (int v = 0; v < FA_BV; ++v) s = fmaf(sDL[r][v], sW[kh][v], s);
        sDH[r * KS + k0 - y0 + kh] = s;
      }
    }
  }
  if (in) {
    for (int c = q; c < dwid; c += 16) {
      const size_t o = (size_t)grow * H + y0 + c;
      if (dh_bf16)
        static_cast<bf16*>(dh)[o] = __float2bfloat16(sDH[r * KS + c]);
      else
        static_cast<float*>(dh)[o] = sDH[r * KS + c];
    }
  }
}

// K5b, f32: 16 vocab columns per block, all rows in 64-row tiles; grid y
// is the H slice of dW the block writes. The dW carry (slice x 16 f32)
// lives in dynamic shared memory, each element owned by one thread; db is
// one thread's running sum per column (written by the slice-0 blocks).
constexpr int FB_BN = 64, FB_BV = 16, FB_KC = 64, FB_THREADS = 256;

__global__ void __launch_bounds__(FB_THREADS)
    ce_bwd_dw_fma(const float* __restrict__ h, const float* __restrict__ w,
                  const float* __restrict__ b, const int* __restrict__ labels,
                  const float* __restrict__ lse,
                  const float* __restrict__ scale, float* __restrict__ dw,
                  float* __restrict__ db, int N, int H, int V, int KS) {
  extern __shared__ float sDW[];  // KS x FB_BV
  __shared__ float sH[FB_BN][FB_KC + 1];
  __shared__ float sW[FB_KC][FB_BV + 1];
  __shared__ float sDL[FB_BN][FB_BV + 1];
  __shared__ float sB[FB_BV];
  __shared__ float sLse[FB_BN], sScale[FB_BN];
  __shared__ int sLab[FB_BN];
  const int tid = threadIdx.x;
  const int r = tid >> 2, q = tid & 3;       // logits: row, columns q + 4j
  const int c = tid & 15, kr = tid >> 4;     // dW: column, rows kr + 16i
  const int v0 = blockIdx.x * FB_BV;
  const int y0 = blockIdx.y * KS, dwid = min(KS, H - y0);
  for (int k = kr; k < dwid; k += 16) sDW[k * FB_BV + c] = 0.f;
  if (tid < FB_BV)
    sB[tid] = (b != nullptr && v0 + tid < V) ? b[v0 + tid] : 0.f;
  float db_acc = 0.f;

  for (int n0 = 0; n0 < N; n0 += FB_BN) {
    __syncthreads();
    if (tid < FB_BN) {
      const int gr = n0 + tid;
      const bool in = gr < N;
      sLab[tid] = in ? labels[gr] : -1;
      sLse[tid] = in ? lse[gr] : INFINITY;
      sScale[tid] = in ? scale[gr] : 0.f;
    }
    float acc[FB_BV / 4];
#pragma unroll
    for (int j = 0; j < FB_BV / 4; ++j) acc[j] = 0.f;
    for (int k0 = 0; k0 < H; k0 += FB_KC) {
      __syncthreads();
      for (int i = tid; i < FB_BN * FB_KC; i += FB_THREADS) {
        const int rr = i / FB_KC, cc = i % FB_KC;
        sH[rr][cc] = n0 + rr < N ? h[(size_t)(n0 + rr) * H + k0 + cc] : 0.f;
      }
      for (int i = tid; i < FB_KC * FB_BV; i += FB_THREADS) {
        const int kk = i / FB_BV, cc = i % FB_BV;
        sW[kk][cc] = v0 + cc < V ? w[(size_t)(k0 + kk) * V + v0 + cc] : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < FB_KC; ++kk) {
        const float hv = sH[r][kk];
#pragma unroll
        for (int j = 0; j < FB_BV / 4; ++j)
          acc[j] = fmaf(hv, sW[kk][q + 4 * j], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < FB_BV / 4; ++j) {
      const int cl = q + 4 * j;
      const int col = v0 + cl;
      float p = 0.f, oh = 0.f;
      if (col < V) {
        p = expf(acc[j] + sB[cl] - sLse[r]);
        oh = col == sLab[r] ? 1.f : 0.f;
      }
      sDL[r][cl] = (p - oh) * sScale[r];
    }
    __syncthreads();  // dl complete
    if (tid < FB_BV)
      for (int n = 0; n < FB_BN; ++n) db_acc += sDL[n][tid];
    for (int k0 = y0; k0 < y0 + dwid; k0 += FB_KC) {
      __syncthreads();  // the previous h chunk is consumed
      for (int i = tid; i < FB_BN * FB_KC; i += FB_THREADS) {
        const int rr = i / FB_KC, cc = i % FB_KC;
        sH[rr][cc] = n0 + rr < N ? h[(size_t)(n0 + rr) * H + k0 + cc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < FB_KC / 16; ++i) {
        const int kh = kr + 16 * i;
        float s = sDW[(k0 - y0 + kh) * FB_BV + c];
        for (int n = 0; n < FB_BN; ++n) s = fmaf(sH[n][kh], sDL[n][c], s);
        sDW[(k0 - y0 + kh) * FB_BV + c] = s;
      }
    }
  }
  if (v0 + c < V)
    for (int k = kr; k < dwid; k += 16)
      dw[(size_t)(y0 + k) * V + v0 + c] = sDW[k * FB_BV + c];
  if (db != nullptr && blockIdx.y == 0 && tid < FB_BV && v0 + tid < V)
    db[v0 + tid] = db_acc;
}

// H must be a positive multiple of 64 (the wrapper pads it)
bool bad_dims(int N, int H, int V, int dtype) {
  return N <= 0 || V <= 0 || H < 64 || H % 64 != 0 ||
         (dtype != 0 && dtype != 1);
}

int blocks(int n, int per) { return (n + per - 1) / per; }

// The slice width KS: H cut into S = ceil(H / 1024) slices of equal width,
// rounded up to a multiple of 64 (so KS <= 1024 and KS = H when H <= 1024).
int slice_width(int H) {
  const int S = (H + 1023) / 1024;
  const int m = H / 64;
  return 64 * ((m + S - 1) / S);
}

// the kernel each shape takes (reported to the caller)
enum Route { ROUTE_WGMMA = 0, ROUTE_MMA = 1, ROUTE_FMA = 2 };

// host: h (N, H) bf16 as 64 x 64 boxes, w (H, V) bf16 as boxes of 64
// columns x `rows` rows, both in the 128-byte swizzle; zeros past N and V
bool encode_ce_h(CUtensorMap* map, const void* h, int N, int H) {
  const cuuint64_t dims[2] = {(cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)H * 2};
  const cuuint32_t box[2] = {64, 64};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, h, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

bool encode_ce_w(CUtensorMap* map, const void* w, int H, int V, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)V, (cuuint64_t)H};
  const cuuint64_t strides[1] = {(cuuint64_t)V * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)rows};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
}

// calls f(std::integral_constant<int, H>{}) for a padded H <= 512 (the
// wgmma kernels' template argument)
template <typename F>
cudaError_t with_hidden(int H, F&& f) {
  switch (H) {
#define CE_HIDDEN_CASE(HH) \
  case HH:                 \
    return f(std::integral_constant<int, HH>{});
    CE_HIDDEN_CASE(64)
    CE_HIDDEN_CASE(128)
    CE_HIDDEN_CASE(192)
    CE_HIDDEN_CASE(256)
    CE_HIDDEN_CASE(320)
    CE_HIDDEN_CASE(384)
    CE_HIDDEN_CASE(448)
    CE_HIDDEN_CASE(512)
#undef CE_HIDDEN_CASE
  }
  return cudaErrorInvalidValue;
}

template <int H>
cudaError_t launch_fwd_wgmma(const void* h, const void* w, const float* b,
                             const int* labels, float* lse, float* ll, int N,
                             int V, cudaStream_t stream) {
  CUtensorMap mh, mw;
  if (!encode_ce_h(&mh, h, N, H) || !encode_ce_w(&mw, w, H, V, Y_KC))
    return cudaErrorInvalidValue;
  const size_t smem = fwd_wgmma_smem(H);
  cudaError_t err = set_smem(ce_fwd_wgmma<H>, smem);
  if (err != cudaSuccess) return err;
  ce_fwd_wgmma<H><<<blocks(N, Y_BN), Y_THREADS, smem, stream>>>(
      mh, mw, b, labels, lse, ll, N, V);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_dh_wgmma(const void* h, const void* w, const float* b,
                            const int* labels, const float* lse,
                            const float* scale, void* dh, int dh_bf16, int N,
                            int V, cudaStream_t stream) {
  CUtensorMap mh, mw;
  if (!encode_ce_h(&mh, h, N, H) ||
      !encode_ce_w(&mw, w, H, V, dh_box_rows(H)))
    return cudaErrorInvalidValue;
  const size_t smem = dh_wgmma_smem(H);
  cudaError_t err = set_smem(ce_bwd_dh_wgmma<H>, smem);
  if (err != cudaSuccess) return err;
  ce_bwd_dh_wgmma<H><<<blocks(N, X_BN), X_THREADS, smem, stream>>>(
      mh, mw, b, labels, lse, scale, dh, dh_bf16, N, V);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_dw_wgmma(const void* h, const void* w, const float* b,
                            const int* labels, const float* lse,
                            const float* scale, float* dw, float* db, int N,
                            int V, cudaStream_t stream) {
  CUtensorMap mh, mw;
  if (!encode_ce_h(&mh, h, N, H) ||
      !encode_ce_w(&mw, w, H, V, dh_box_rows(H)))
    return cudaErrorInvalidValue;
  const size_t smem = dh_wgmma_smem(H);  // the same tiles as K5a's
  cudaError_t err = set_smem(ce_bwd_dw_wgmma<H>, smem);
  if (err != cudaSuccess) return err;
  ce_bwd_dw_wgmma<H><<<blocks(V, X_BV), X_THREADS, smem, stream>>>(
      mh, mw, b, labels, lse, scale, dw, db, N, V);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the bf16 shapes TMA can address, which the wgmma kernels take
bool wgmma_shape(int H, int V, const void* h, const void* w) {
  return H <= 512 && V % 8 == 0 && aligned16(h) && aligned16(w);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h and w). b may be null; labels int32;
// lse/ll/scale f32 (N,). Each returns the launch's cudaError_t (0 on
// success); the kernel runs on `stream` and the call does not synchronise.
// h and w must be contiguous; in bf16 h's rows are read as 16-byte vectors,
// so h must be 16-byte aligned (w may be unaligned: `vec` is derived here).
// *route receives the kernel taken (Route): in bf16 the wgmma kernel where
// TMA can address the operands (H <= 512, V % 8 == 0, h and w 16-byte
// aligned), the mma.sync kernel elsewhere; f32 the FMA kernel.
extern "C" int fused_ce_fwd(const void* h, const void* w, const void* b,
                            const void* labels, void* lse, void* ll, int N,
                            int H, int V, int dtype, int* route,
                            void* stream) {
  if (bad_dims(N, H, V, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias = static_cast<const float*>(b);
  const int* lab = static_cast<const int*>(labels);
  float* lse_f = static_cast<float*>(lse);
  float* ll_f = static_cast<float*>(ll);
  if (dtype == 0) {
    *route = ROUTE_FMA;
    ce_fwd_fma<<<blocks(N, FF_BN), FF_THREADS, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), bias, lab,
        lse_f, ll_f, N, H, V);
  } else if (wgmma_shape(H, V, h, w)) {
    *route = ROUTE_WGMMA;
    return (int)with_hidden(H, [&](auto hc) {
      return launch_fwd_wgmma<decltype(hc)::value>(h, w, bias, lab, lse_f,
                                                   ll_f, N, V, s);
    });
  } else {
    *route = ROUTE_MMA;
    const int KS = slice_width(H);
    const size_t smem = fwd_mma_smem_bytes(KS);
    const auto kernel = KS < H ? ce_fwd_mma<true> : ce_fwd_mma<false>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const int vec = V % 8 == 0 && aligned16(w);
    kernel<<<blocks(N, F_BN), F_THREADS, smem, s>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(w), bias, lab,
        lse_f, ll_f, N, H, V, KS, vec);
  }
  return (int)cudaGetLastError();
}

// dh_dtype: 0 = float32, 1 = bfloat16. *route as fused_ce_fwd's.
extern "C" int fused_ce_bwd_dh(const void* h, const void* w, const void* b,
                               const void* labels, const void* lse,
                               const void* scale, void* dh, int N, int H,
                               int V, int dtype, int dh_dtype, int* route,
                               void* stream) {
  if (bad_dims(N, H, V, dtype) || (dh_dtype != 0 && dh_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias = static_cast<const float*>(b);
  const int* lab = static_cast<const int*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* sc = static_cast<const float*>(scale);
  const int KS = slice_width(H);
  cudaError_t err;
  if (dtype == 0) {
    *route = ROUTE_FMA;
    const dim3 grid(blocks(N, FA_BN), blocks(H, KS));
    const size_t smem = sizeof(float) * (size_t)FA_BN * KS;
    if ((err = set_smem(ce_bwd_dh_fma, smem)) != cudaSuccess) return (int)err;
    ce_bwd_dh_fma<<<grid, FA_THREADS, smem, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), bias, lab,
        l, sc, dh, dh_dtype, N, H, V, KS);
  } else if (wgmma_shape(H, V, h, w)) {
    *route = ROUTE_WGMMA;
    return (int)with_hidden(H, [&](auto hc) {
      return launch_dh_wgmma<decltype(hc)::value>(h, w, bias, lab, l, sc, dh,
                                                  dh_dtype, N, V, s);
    });
  } else {
    *route = ROUTE_MMA;
    const dim3 grid(blocks(N, A_BN), blocks(H, KS));
    const size_t smem = dh_mma_smem_bytes(KS);
    const int vec = V % 8 == 0 && aligned16(w);
    const bf16* hb = static_cast<const bf16*>(h);
    const bf16* wb = static_cast<const bf16*>(w);
    // the dh carry's register tiles by slice width; sliced or not
    const auto kernel =
        KS < H ? ce_bwd_dh_mma<32, true>
               : (KS <= 512 ? ce_bwd_dh_mma<16, false>
                            : ce_bwd_dh_mma<32, false>);
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<grid, A_THREADS, smem, s>>>(hb, wb, bias, lab, l, sc, dh,
                                         dh_dtype, N, H, V, KS, vec);
  }
  return (int)cudaGetLastError();
}

// dw f32 (H,V); db f32 (V,) or null (not written). *route as fused_ce_fwd's.
extern "C" int fused_ce_bwd_dw(const void* h, const void* w, const void* b,
                               const void* labels, const void* lse,
                               const void* scale, void* dw, void* db, int N,
                               int H, int V, int dtype, int* route,
                               void* stream) {
  if (bad_dims(N, H, V, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bias = static_cast<const float*>(b);
  const int* lab = static_cast<const int*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* sc = static_cast<const float*>(scale);
  float* dwf = static_cast<float*>(dw);
  float* dbf = static_cast<float*>(db);
  const int KS = slice_width(H);
  cudaError_t err;
  if (dtype == 0) {
    *route = ROUTE_FMA;
    const dim3 grid(blocks(V, FB_BV), blocks(H, KS));
    const size_t smem = sizeof(float) * (size_t)KS * FB_BV;
    if ((err = set_smem(ce_bwd_dw_fma, smem)) != cudaSuccess) return (int)err;
    ce_bwd_dw_fma<<<grid, FB_THREADS, smem, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), bias, lab,
        l, sc, dwf, dbf, N, H, V, KS);
  } else if (wgmma_shape(H, V, h, w)) {
    *route = ROUTE_WGMMA;
    return (int)with_hidden(H, [&](auto hc) {
      return launch_dw_wgmma<decltype(hc)::value>(h, w, bias, lab, l, sc, dwf,
                                                  dbf, N, V, s);
    });
  } else {
    *route = ROUTE_MMA;
    const dim3 grid(blocks(V, B_BV), blocks(H, KS));
    const size_t smem = dw_mma_smem_bytes(KS);
    const int vec = V % 8 == 0 && aligned16(w);
    const bf16* hb = static_cast<const bf16*>(h);
    const bf16* wb = static_cast<const bf16*>(w);
    // the dW carry's register tiles by slice width; sliced or not
    const auto kernel =
        KS < H ? ce_bwd_dw_mma<16, true>
               : (KS <= 512 ? ce_bwd_dw_mma<8, false>
                            : ce_bwd_dw_mma<16, false>);
    if ((err = set_smem(kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<grid, B_THREADS, smem, s>>>(hb, wb, bias, lab, l, sc, dwf, dbf,
                                         N, H, V, KS, vec);
  }
  return (int)cudaGetLastError();
}
