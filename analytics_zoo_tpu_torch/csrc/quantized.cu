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
// bytes bound it (0.0050 ms at 3.35 TB/s); at M = 32 in f32 the 2 M K N
// operations on the CUDA cores do (0.0160 ms at 67 TFLOP/s). At BERT's
// shapes (M = 16,384 rows of 32 x 512 tokens, K and N 768 to 3072, bf16)
// it does thousands of operations per byte and the products bound it.
// Four kernels:
//  * skinny (M <= 32, f32 or bf16 x): every int8 weight byte is read from
//    device memory once, whatever M is. The grid is (N / 128 column
//    panels) x (K slices): block (p, s) owns the 128 columns of panel p
//    for all M rows at once and the rows of slice s of K, a multiple of 64
//    chosen here (skinny_k_slice, from the card's SM count) so that the
//    grid fills the blocks the card holds at once (K = N = 4096 on 132 SMs:
//    32 panels x 16 slices of 256 rows = 512 blocks, or x 11 slices of 384
//    = 352 for f32 at more than 4 rows). Its weight
//    panel streams through a 3-stage ring in shared memory, 64 rows of 128
//    int8 a stage, filled by 16-byte cp.async (zeros past K and N; plain
//    byte loads where N % 16 or w's alignment rule them out, as for the
//    Dense(8) and Dense(2) heads); x, all M rows padded with zeros to MT
//    (1, 4, 8, 16 or 32 in f32; 8, 16 or 32 in bf16), is staged in shared
//    memory too (the block's K slice at once, or, in the f32 tile kernel,
//    with each weight stage) and read from there.
//    bf16: the product is taken transposed, out^T = w^T x^T, on the tensor
//    cores with mma.sync m16n8k16 (bf16 in, f32 accumulate): a warp owns
//    16 columns, the int8 weights are the A operand, loaded as 2-byte
//    column pairs and widened in registers with widen4 (in the
//    dequantize-first mode times the column's bf16 scale, one rounding),
//    x^T the B operand (MT / 8 tiles of 8 rows). f32: FMAs on the CUDA
//    cores (TF32 would round x), each weight widened exactly with a byte
//    permute and a subtraction. Up to 8 rows a thread owns 4 columns x all
//    rows, the 8 warps take 4-row groups of each stage in turn and their
//    sums are added in a fixed tree; from 16 rows each warp widens its 16
//    columns once into an f32 tile and its lanes own 4 columns x MT / 8
//    rows (register tiles; x streams through the ring, so three blocks fit
//    an SM; the FMAs run at about half the card's peak rate in that
//    loop at 32 rows). With one K slice the block applies the epilogue and
//    writes the output; with more it writes its f32 partial sums to a
//    workspace [slices, M, panels x 128], and a second kernel, launched as
//    its programmatic dependent, adds each output's slices in slice order
//    (no float atomics) and applies the epilogue: in the scale-after mode
//    the column scale, one rounding to x's dtype T, then, if asked,
//    round_T(y + round_T(bias)) and max(y, 0) -- what the port's dense
//    layer and its ReLU compute after the product.
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
// Beside K6, Q8 (int8_static_skinny + int8_static_reduce): the static int8
// dense layer for M <= 32, replacing no TPU kernel (the JAX package's
// Dense.quantized_call leaves its int8 x int8 product to XLA's
// dot_general; the port's had padded M to 17 for torch._int_mm and run
// the quantize and the rescale, bias and ReLU as about ten torch ops a
// layer). It fuses all of them: x is quantized by each block into shared
// memory, the products run as __dp4a on the CUDA cores with the int8
// weights transposed 4 x 4 bytes at a time by byte permutes on their way
// out of the skinny route's ring, and the exact int32 sums are finished
// as the static path finishes them. The bytes bound it (config A's M = 1,
// K = N = 4096: 16.8 MB of int8, 0.0050 ms at 3.35 TB/s): at M <= 32 a
// weight word feeds at most 128 dp4a, which the CUDA cores issue faster
// than the ring delivers it, so the tensor cores' s8 mma (whose fragments
// want the same transpose plus a shuffle between lanes) would buy nothing.
// No float atomics anywhere: every output (and every skinny partial sum)
// is written once by one thread, its sum taken in a fixed order, so the
// result is the same bits from run to run. Any M, K and N: edges are masked
// on load (zeros) and on store.

#include <stdint.h>

#include <algorithm>
#include <atomic>

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

// 16 bytes from global to shared memory, asynchronously; the bytes past
// `src_bytes` (all 16 when it is 0) are written as zeros
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

// ---------------------------------------------------------------------------
// skinny: M <= 32. Grid (panels, K slices); block (p, s) owns columns
// 128 p .. 128 p + 127 for all M rows and rows ks s .. ks (s + 1) - 1 of w.
// Shared memory: the weight ring (S_STAGES stages of S_BK rows of S_BN
// int8, rows S_LDW bytes apart), then the block's slice of x, [MT][ldx]
// (the f32 tile kernel lays out its own stages, x beside each).
// ---------------------------------------------------------------------------

constexpr int SKINNY_MAX_M = 32;
constexpr int S_THREADS = 256;
constexpr int S_BN = 128;                // columns per block (a panel)
constexpr int S_BK = 64;                 // rows of w per ring stage
constexpr int S_STAGES = 3;
// a stage row is 128 bytes padded to 144: the bf16 kernel's 2-byte A loads
// (rows 2t of a 16-row step, columns 2g) then fall on 32 distinct banks
constexpr int S_LDW = S_BN + 16;
constexpr int S_STAGE_BYTES = S_BK * S_LDW;
constexpr int S_RING_BYTES = S_STAGES * S_STAGE_BYTES;
constexpr int S_KS_MAX = 512;            // rows of a K slice at most

// x's row stride in shared memory, in elements: rows are padded by 16
// bytes, so that the bf16 B fragments' 32-bit loads (rows g, columns 2t)
// and the f32 tile kernel's 16-byte loads (rows 8 apart) fall on distinct
// banks
template <typename T>
__host__ __device__ constexpr int skinny_ldx(int ks) {
  return ks + 16 / (int)sizeof(T);
}

// blocks an SM each skinny kernel is built for (its register budget):
// four, so that the 512 blocks of K = N = 4096 run in one wave; three for
// f32 from 8 rows (32 sums a thread, and the tile kernel's shared memory),
// for which skinny_k_slice slices K so that the grid fills three an SM
template <typename T, int MT>
__host__ __device__ constexpr int skinny_min_blocks() {
  return sizeof(T) == 2 || MT <= 4 ? 4 : 3;
}

// rows k0 .. k0 + S_BK - 1 of the block's panel into the stage at `stage`,
// zeros past k_end (the slice's end, at most K) and past N: 16-byte
// cp.async where `vec` (N % 16 == 0 and w 16-byte aligned), else plain
// byte loads
__device__ __forceinline__ void skinny_load_w(
    unsigned char* stage, const int8_t* __restrict__ w, int k0, int k_end,
    int n0, int N, int vec, int tid) {
#pragma unroll
  for (int i = 0; i < S_BK * S_BN / 16 / S_THREADS; ++i) {
    const int chunk = tid + i * S_THREADS;
    const int r = chunk / (S_BN / 16), c = (chunk % (S_BN / 16)) * 16;
    const int k = k0 + r, col = n0 + c;
    unsigned char* dst = stage + r * S_LDW + c;
    if (vec) {
      const bool ok = k < k_end && col < N;
      cp_async16(smem_u32(dst), ok ? w + (size_t)k * N + col : w,
                 ok ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(dst) =
          k < k_end ? load16(w, k, col, N, 0) : uint4{};
    }
  }
}

// the block's slice of x, rows 0 .. MT - 1 (zeros from M) and columns
// k_beg .. k_beg + ks - 1 (zeros from k_end), into xs [MT][ldx]: 16-byte
// cp.async where `xvec` (K a multiple of 16 bytes' elements, x 16-byte
// aligned), else element by element
template <typename T, int MT>
__device__ __forceinline__ void skinny_stage_x(T* xs, const T* __restrict__ x,
                                               int M, int K, int k_beg,
                                               int k_end, int ks, int xvec,
                                               int tid) {
  constexpr int PER = 16 / sizeof(T);
  const int chunks = ks / PER, ldx = skinny_ldx<T>(ks);
  for (int idx = tid; idx < MT * chunks; idx += S_THREADS) {
    const int m = idx / chunks, k = k_beg + (idx - m * chunks) * PER;
    T* dst = xs + m * ldx + (k - k_beg);
    if (xvec) {
      const bool ok = m < M && k < k_end;
      cp_async16(smem_u32(dst), ok ? x + (size_t)m * K + k : x,
                 ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e)
        dst[e] = m < M && k + e < k_end ? x[(size_t)m * K + k + e]
                                        : from_f32<T>(0.f);
    }
  }
}

// the ring's first S_STAGES - 1 stages and x (in the first group)
template <typename T, int MT>
__device__ __forceinline__ void skinny_prologue(
    unsigned char* smem, T* xs, const T* __restrict__ x,
    const int8_t* __restrict__ w, int M, int K, int N, int n0, int k_beg,
    int k_end, int ks, int nk, int vec, int xvec, int tid) {
  skinny_stage_x<T, MT>(xs, x, M, K, k_beg, k_end, ks, xvec, tid);
#pragma unroll
  for (int st = 0; st < S_STAGES - 1; ++st) {
    if (st < nk)
      skinny_load_w(smem + st * S_STAGE_BYTES, w, k_beg + st * S_BK, k_end,
                    n0, N, vec, tid);
    cp_async_commit();
  }
}

// step i of the ring: stage i has landed for every thread, and the stage
// step i - 1 read is refilled with step i + S_STAGES - 1
__device__ __forceinline__ void skinny_advance(unsigned char* smem,
                                               const int8_t* __restrict__ w,
                                               int i, int nk, int k_beg,
                                               int k_end, int n0, int N,
                                               int vec, int tid) {
  cp_async_wait<S_STAGES - 2>();
  __syncthreads();
  const int j = i + S_STAGES - 1;
  if (j < nk)
    skinny_load_w(smem + (j % S_STAGES) * S_STAGE_BYTES, w, k_beg + j * S_BK,
                  k_end, n0, N, vec, tid);
  cp_async_commit();
}

// an output from its f32 sum: in the scale-after mode times the column's
// scale, rounded once to T; then, if asked, the bias added in T
// (round_T(y + round_T(b)), the dense layer's order) and max(y, 0) (NaN
// and -0 kept, as torch.relu keeps them on the CPU). __fmul_rn and
// __fadd_rn are never contracted into one FMA, which in f32 would round
// the scaled sum plus the bias once where the dense layer rounds twice.
template <typename T>
__device__ __forceinline__ T skinny_finish(float acc, int n,
                                           const float* __restrict__ scales,
                                           const float* __restrict__ bias,
                                           bool pre, int relu) {
  float y = round_to<T>(pre ? acc : __fmul_rn(acc, scales[n]));
  if (bias != nullptr) y = round_to<T>(__fadd_rn(y, round_to<T>(bias[n])));
  if (relu && y < 0.f) y = 0.f;
  return from_f32<T>(y);
}

// q of byte e of `u` (the int8 word XOR 0x80808080) as an exact f32: the
// byte becomes the low mantissa byte of 2^23 + 128 + q, one subtraction
// leaves q (a byte permute and an add, where a conversion instruction
// would run at a quarter of the FMA rate)
__device__ __forceinline__ float widen1(uint32_t u, int e) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | e)) -
         8388736.f;
}

// f32, MT <= 8 rows (bytes bound them). Lane l of every warp owns columns
// n0 + 4l .. 4l + 3 and all MT rows; warp v takes rows 4 (v + 8h) .. + 3
// of each stage (h < 2), reading its 4 x 4 weights once (widened exactly,
// in the dequantize-first mode times the f32 column scale) and x[m][k ..
// k + 3] as one broadcast 16-byte load per row. Then the 8 warps' sums
// meet in a fixed tree: 4-7 into 0-3, 2-3 into 0-1, 1 into 0.
template <int MT, bool PRE>
__global__ void __launch_bounds__(S_THREADS, skinny_min_blocks<float, MT>())
    int8_mm_skinny_f32(const float* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scales,
                       const float* __restrict__ bias,
                       float* __restrict__ out, float* __restrict__ ws,
                       int M, int K, int N, int ks, int vec, int xvec,
                       int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * S_BN, k_beg = blockIdx.y * ks;
  const int k_end = min(K, k_beg + ks);
  const int nk = k_end > k_beg ? (k_end - k_beg + S_BK - 1) / S_BK : 0;
  const int ldx = skinny_ldx<float>(ks);
  float* xs = reinterpret_cast<float*>(smem + S_RING_BYTES);
  skinny_prologue<float, MT>(smem, xs, x, w, M, K, N, n0, k_beg, k_end, ks,
                             nk, vec, xvec, tid);
  // the reduce kernel may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  float sc[4];  // dequantize-first: this lane's column scales (0 past N)
#pragma unroll
  for (int e = 0; e < 4; ++e)
    sc[e] = PRE ? col_scale<float>(scales, n0 + 4 * lane + e, N) : 1.f;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;

  for (int i = 0; i < nk; ++i) {
    skinny_advance(smem, w, i, nk, k_beg, k_end, n0, N, vec, tid);
    const unsigned char* st = smem + (i % S_STAGES) * S_STAGE_BYTES;
#pragma unroll
    for (int h = 0; h < S_BK / 32; ++h) {
      const int r = 4 * (warp + 8 * h);
      float wv[4][4];  // [row r + j][column 4 lane + e]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t u = *reinterpret_cast<const uint32_t*>(
                               st + (r + j) * S_LDW + 4 * lane) ^
                           0x80808080u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wv[j][e] = PRE ? widen1(u, e) * sc[e] : widen1(u, e);
      }
      const float* xr = xs + i * S_BK + r;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + m * ldx);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float a = acc[m][e];
          a = fmaf(xv.x, wv[0][e], a);
          a = fmaf(xv.y, wv[1][e], a);
          a = fmaf(xv.z, wv[2][e], a);
          a = fmaf(xv.w, wv[3][e], a);
          acc[m][e] = a;
        }
      }
    }
  }
  cp_async_wait<0>();

  float* red = reinterpret_cast<float*>(smem);  // [4][MT][S_BN]
#pragma unroll
  for (int half = 4; half >= 1; half >>= 1) {
    __syncthreads();
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
        *reinterpret_cast<float4*>(
            red + ((warp - half) * MT + m) * S_BN + 4 * lane) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 v = *reinterpret_cast<const float4*>(
            red + (warp * MT + m) * S_BN + 4 * lane);
        acc[m][0] += v.x, acc[m][1] += v.y, acc[m][2] += v.z,
            acc[m][3] += v.w;
      }
    }
  }
  if (warp != 0) return;
  const int n = n0 + 4 * lane;
  if (gridDim.y == 1) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (m < M && n + e < N)
          out[(size_t)m * N + n + e] =
              skinny_finish<float>(acc[m][e], n + e, scales, bias, PRE, relu);
  } else {
    const int np = gridDim.x * S_BN;
    float* p = ws + (size_t)blockIdx.y * M * np + n;
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m < M)
        *reinterpret_cast<float4*>(p + (size_t)m * np) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
}

// the tile kernel's stage: the weight rows (S_STAGE_BYTES), then x's MT
// rows over the same S_BK columns of K, rows XT_LD floats apart (a 16-byte
// pad puts rows 8 apart on distinct banks)
constexpr int XT_LD = S_BK + 4;

template <int MT>
__host__ __device__ constexpr int tile_stage_bytes() {
  return S_STAGE_BYTES + MT * XT_LD * 4;
}

// columns k0 .. k0 + S_BK - 1 of x's rows 0 .. MT - 1 (zeros from M and
// from k_end) into `dst`: 16-byte cp.async where `xvec`, else element by
// element
template <int MT>
__device__ __forceinline__ void skinny_load_xk(float* dst,
                                               const float* __restrict__ x,
                                               int M, int K, int k0,
                                               int k_end, int xvec, int tid) {
  constexpr int CH = S_BK / 4;  // 16-byte chunks a row
  for (int idx = tid; idx < MT * CH; idx += S_THREADS) {
    const int m = idx / CH, c = (idx % CH) * 4, k = k0 + c;
    float* d = dst + m * XT_LD + c;
    if (xvec) {
      const bool ok = m < M && k < k_end;
      cp_async16(smem_u32(d), ok ? x + (size_t)m * K + k : x, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = m < M && k + e < k_end ? x[(size_t)m * K + k + e] : 0.f;
    }
  }
}

// f32, MT = 16 or 32 rows (operations bound them at 32): a small SGEMM
// on each stage. x streams through the ring with the weights, S_BK columns
// a stage, so shared memory does not grow with the K slice and three
// blocks fit an SM. Warp v owns columns n0 + 16v .. + 15 and all MT
// rows. For each half stage (32 k rows) it first widens its 16 columns,
// once, into an f32 tile of its own (in the dequantize-first mode times
// the column scale), so that only the warp, not the block, waits for it;
// lane (g, c) = (lane % 8, lane / 8) then owns columns 16v + 4c .. + 3
// and rows g + 8q (q < MT / 8): per 4 k rows it loads MT / 8 x quads and
// 4 weight quads and runs 16 MT / 8 FMAs, each sum taking its k rows in
// order. No sums are split inside the block.
template <int MT, bool PRE>
__global__ void __launch_bounds__(S_THREADS, skinny_min_blocks<float, MT>())
    int8_mm_skinny_f32_tile(const float* __restrict__ x,
                            const int8_t* __restrict__ w,
                            const float* __restrict__ scales,
                            const float* __restrict__ bias,
                            float* __restrict__ out, float* __restrict__ ws,
                            int M, int K, int N, int ks, int vec, int xvec,
                            int relu) {
  constexpr int RT = MT / 8;  // rows a thread
  constexpr int TS = tile_stage_bytes<MT>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * S_BN, k_beg = blockIdx.y * ks;
  const int k_end = min(K, k_beg + ks);
  const int nk = k_end > k_beg ? (k_end - k_beg + S_BK - 1) / S_BK : 0;
  // this warp's widened half stage, [S_BK / 2][16]
  float* wf = reinterpret_cast<float*>(smem + S_STAGES * TS) +
              warp * (S_BK / 2) * 16;
  // step j's weights and x into its stage, then one commit
  auto fill = [&](int j) {
    if (j < nk) {
      unsigned char* stage = smem + (j % S_STAGES) * TS;
      const int k0 = k_beg + j * S_BK;
      skinny_load_w(stage, w, k0, k_end, n0, N, vec, tid);
      skinny_load_xk<MT>(reinterpret_cast<float*>(stage + S_STAGE_BYTES), x,
                         M, K, k0, k_end, xvec, tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < S_STAGES - 1; ++j) fill(j);
  // the reduce kernel may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // widening: lane (lane / 4 + 8j, quad lane % 4) of the warp's columns
  const int wq = lane & 3, wr = lane >> 2;
  float sc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    sc[e] = PRE ? col_scale<float>(scales, n0 + 16 * warp + 4 * wq + e, N)
                : 1.f;
  const int g = lane & 7, cg = lane >> 3;
  float acc[RT][4];
#pragma unroll
  for (int q = 0; q < RT; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;

  for (int i = 0; i < nk; ++i) {
    cp_async_wait<S_STAGES - 2>();
    __syncthreads();  // step i landed; step i - 1's stage is free
    fill(i + S_STAGES - 1);
    const unsigned char* st = smem + (i % S_STAGES) * TS;
    const float* xst = reinterpret_cast<const float*>(st + S_STAGE_BYTES);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int j = 0; j < S_BK / 16; ++j) {
        const int r = wr + 8 * j;
        const uint32_t u =
            *reinterpret_cast<const uint32_t*>(
                st + (32 * half + r) * S_LDW + 16 * warp + 4 * wq) ^
            0x80808080u;
        float4 v;
        v.x = PRE ? widen1(u, 0) * sc[0] : widen1(u, 0);
        v.y = PRE ? widen1(u, 1) * sc[1] : widen1(u, 1);
        v.z = PRE ? widen1(u, 2) * sc[2] : widen1(u, 2);
        v.w = PRE ? widen1(u, 3) * sc[3] : widen1(u, 3);
        *reinterpret_cast<float4*>(wf + r * 16 + 4 * wq) = v;
      }
      __syncwarp();
      const float* xr = xst + g * XT_LD + 32 * half;
#pragma unroll 4
      for (int k = 0; k < S_BK / 2; k += 4) {
        float xv[RT][4];  // [row g + 8q][k + j]
#pragma unroll
        for (int q = 0; q < RT; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(
              xr + 8 * q * XT_LD + k);
          xv[q][0] = v.x, xv[q][1] = v.y, xv[q][2] = v.z, xv[q][3] = v.w;
        }
        float wv[4][4];  // [k + j][column 16 warp + 4 cg + e]
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 v =
              *reinterpret_cast<const float4*>(wf + (k + j) * 16 + 4 * cg);
          wv[j][0] = v.x, wv[j][1] = v.y, wv[j][2] = v.z, wv[j][3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < RT; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[q][e] = fmaf(xv[q][j], wv[j][e], acc[q][e]);
      }
      __syncwarp();  // the tile is read before the next half widens into it
    }
  }
  cp_async_wait<0>();

  const int n = n0 + 16 * warp + 4 * cg;
  if (gridDim.y == 1) {
#pragma unroll
    for (int q = 0; q < RT; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (g + 8 * q < M && n + e < N)
          out[(size_t)(g + 8 * q) * N + n + e] =
              skinny_finish<float>(acc[q][e], n + e, scales, bias, PRE, relu);
  } else {
    const int np = gridDim.x * S_BN;
    float* p = ws + (size_t)blockIdx.y * M * np + n;
#pragma unroll
    for (int q = 0; q < RT; ++q)
      if (g + 8 * q < M)
        *reinterpret_cast<float4*>(p + (size_t)(g + 8 * q) * np) =
            make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
  }
}

// bf16. Warp v owns columns n0 + 16 v .. + 15 as the 16 rows of mma's A
// operand (w^T), ordered so that a thread's two rows g and g + 8 are the
// adjacent columns c = 16 v + 2g and c + 1: for each 16-row k step it
// loads the 2-byte column pair at rows 2t, 2t + 1, 2t + 8, 2t + 9 and
// widens them in registers. x^T is the B operand, MT / 8 tiles of 8 rows
// of x, read from the staged slice. Accumulator j holds out^T for rows
// 8j .. 8j + 7: register e at column c + (e >> 1), row 8j + 2t + (e & 1).
template <int MT, bool PRE>
__global__ void __launch_bounds__(S_THREADS, skinny_min_blocks<bf16, MT>())
    int8_mm_skinny_bf16(const bf16* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ scales,
                        const float* __restrict__ bias,
                        bf16* __restrict__ out, float* __restrict__ ws,
                        int M, int K, int N, int ks, int vec, int xvec,
                        int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * S_BN, k_beg = blockIdx.y * ks;
  const int k_end = min(K, k_beg + ks);
  const int nk = k_end > k_beg ? (k_end - k_beg + S_BK - 1) / S_BK : 0;
  const int ldx = skinny_ldx<bf16>(ks);
  bf16* xs = reinterpret_cast<bf16*>(smem + S_RING_BYTES);
  skinny_prologue<bf16, MT>(smem, xs, x, w, M, K, N, n0, k_beg, k_end, ks,
                            nk, vec, xvec, tid);
  // the reduce kernel may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int c = 16 * warp + 2 * g;  // this thread's column pair
  const bool active = n0 + 16 * warp < N;
  // dequantize-first: each column's scale rounded to bf16, in both halves
  __nv_bfloat162 s2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sv = PRE ? col_scale<bf16>(scales, n0 + c + h, N) : 1.f;
    s2[h] = __floats2bfloat162_rn(sv, sv);
  }
  float acc[MT / 8][4];
#pragma unroll
  for (int j = 0; j < MT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < nk; ++i) {
    skinny_advance(smem, w, i, nk, k_beg, k_end, n0, N, vec, tid);
    if (!active) continue;
    const unsigned char* st = smem + (i % S_STAGES) * S_STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < S_BK / 16; ++kk) {
      const int k = 16 * kk + 2 * t;
      uint32_t a[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const unsigned char* p = st + (k + 8 * half) * S_LDW + c;
        const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
        const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + S_LDW);
        uint32_t r0, r1;  // (k, k + 1) of column c, of column c + 1
        widen4(__byte_perm(lo, hi, 0x5140), r0, r1);
        if (PRE) {
          __nv_bfloat162 p0 =
              __hmul2(*reinterpret_cast<__nv_bfloat162*>(&r0), s2[0]);
          __nv_bfloat162 p1 =
              __hmul2(*reinterpret_cast<__nv_bfloat162*>(&r1), s2[1]);
          r0 = *reinterpret_cast<uint32_t*>(&p0);
          r1 = *reinterpret_cast<uint32_t*>(&p1);
        }
        a[2 * half] = r0;
        a[2 * half + 1] = r1;
      }
#pragma unroll
      for (int j = 0; j < MT / 8; ++j) {
        const bf16* xr = xs + (8 * j + g) * ldx + i * S_BK + k;
        mma_bf16(acc[j], a, ld32(xr), ld32(xr + 8));
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;

  const int n = n0 + c;
  const int np = gridDim.x * S_BN;
#pragma unroll
  for (int j = 0; j < MT / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 8 * j + 2 * t + h;
      if (m >= M) continue;
      if (gridDim.y == 1) {
        if (n < N)
          out[(size_t)m * N + n] =
              skinny_finish<bf16>(acc[j][h], n, scales, bias, PRE, relu);
        if (n + 1 < N)
          out[(size_t)m * N + n + 1] = skinny_finish<bf16>(
              acc[j][2 + h], n + 1, scales, bias, PRE, relu);
      } else {
        *reinterpret_cast<float2*>(ws + ((size_t)blockIdx.y * M + m) * np +
                                   n) = make_float2(acc[j][h], acc[j][2 + h]);
      }
    }
}

// the slices' partial sums of each output added in slice order, then the
// epilogue (skinny_finish). Launched as a programmatic dependent of the
// skinny kernel: its launch overlaps that kernel's tail, and
// griddepcontrol.wait holds it until the partial sums are all written.
template <typename T>
__global__ void __launch_bounds__(256)
    int8_mm_skinny_reduce(const float* __restrict__ ws,
                          const float* __restrict__ scales,
                          const float* __restrict__ bias, T* __restrict__ out,
                          int M, int N, int np, int slices, int pre,
                          int relu) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= M * N) return;
  const int m = i / N, n = i - m * N;
  const float* p = ws + (size_t)m * np + n;
  const size_t step = (size_t)M * np;
  float acc = 0.f;
  for (int s0 = 0; s0 < slices; s0 += 16) {
    float v[16];  // sixteen slices' loads in flight at once
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = s0 + j < slices ? p[(s0 + j) * step] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (s0 + j < slices) acc += v[j];
  }
  out[i] = skinny_finish<T>(acc, n, scales, bias, pre != 0, relu);
}

// ---------------------------------------------------------------------------
// Q8: static int8, M <= 32 (Dense.quantized_call). out = act(float(sum_k
// xq[m][k] w[k][n]) * (x_scale * w_scale[n]) + bias[n]) with xq =
// clamp(rint(x / x_scale), -127, 127), f32 x and out. The skinny route's
// grid, ring and split-K reduce: block (p, s) owns the 128 columns of panel
// p and the rows of K slice s; it quantizes its slice of x into shared
// memory (int8, [MT][ks + Q8_LDQ_PAD]) while the first weight stages are in
// flight, then each warp takes 4-row groups of each stage: a lane loads its
// 4 columns of 4 rows as four 32-bit words, transposes the 4 x 4 bytes so
// that each word holds one column's 4 k values (q8_transpose4x4), and adds
// them times x's 4 k values of each row with __dp4a (s8 x s8 -> s32). The
// warps' int32 sums meet in shared memory (integer atomics: exact, so any
// order gives the same bits), then one K slice finishes the output itself
// and more slices write int32 partials that int8_static_reduce, a PDL
// dependent, adds in slice order and finishes.
// ---------------------------------------------------------------------------

constexpr int Q8_LDQ_PAD = 16;  // bytes a quantized row of x is padded by

// blocks an SM each Q8 instance is built for: 4 * MT int32 sums a thread
template <int MT>
__host__ __device__ constexpr int q8_min_blocks() {
  return MT <= 8 ? 4 : MT <= 16 ? 2 : 1;
}

// v quantized as the static path does, as an int8 byte: the IEEE quotient
// (no reciprocal), rounded half to even (rintf, torch.round's rule),
// clamped to +-127
__device__ __forceinline__ uint32_t q8_quantize(float v, float xs) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, xs)), -127.f), 127.f);
  return static_cast<uint32_t>(
      static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(q))));
}

// the 4 x 4 int8 block of rows r0 .. r3 (4 columns each) transposed: word e
// of c holds column e's bytes of rows 0..3, the k-major quadruple __dp4a
// takes
__device__ __forceinline__ void q8_transpose4x4(uint32_t r0, uint32_t r1,
                                                uint32_t r2, uint32_t r3,
                                                uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// an output from its exact int32 sum, in the static path's order: the
// round-to-nearest float of the sum times the f32 product x_scale *
// w_scale[n], then the bias added, then max(y, 0) (NaN and -0 kept, as
// torch.relu keeps them); __fmul_rn and __fadd_rn are never contracted
__device__ __forceinline__ float q8_finish(int acc, int n, float xs,
                                           const float* __restrict__ w_scale,
                                           const float* __restrict__ bias,
                                           int relu) {
  float y = __fmul_rn(__int2float_rn(acc), __fmul_rn(xs, w_scale[n]));
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  if (relu && y < 0.f) y = 0.f;
  return y;
}

template <int MT>
__global__ void __launch_bounds__(S_THREADS, q8_min_blocks<MT>())
    int8_static_skinny(const float* __restrict__ x,
                       const float* __restrict__ x_scale,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ w_scale,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int* __restrict__ ws, int M, int K, int N, int ks,
                       int vec, int xvec, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * S_BN, k_beg = blockIdx.y * ks;
  const int k_end = min(K, k_beg + ks);
  const int nk = k_end > k_beg ? (k_end - k_beg + S_BK - 1) / S_BK : 0;
  const int ldq = ks + Q8_LDQ_PAD;
  unsigned char* xq = smem + S_RING_BYTES;
#pragma unroll
  for (int st = 0; st < S_STAGES - 1; ++st) {
    if (st < nk)
      skinny_load_w(smem + st * S_STAGE_BYTES, w, k_beg + st * S_BK, k_end,
                    n0, N, vec, tid);
    cp_async_commit();
  }
  // the reduce kernel may launch now; it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // x's slice quantized while the weights stream in: rows 0 .. MT - 1
  // (zeros from M), columns k_beg .. k_beg + ks - 1 (zeros from k_end), four
  // columns a word. With xvec K % 4 == 0, so k_end is a multiple of 4 too.
  const float xs = *x_scale;
  const int words = ks / 4;
  for (int idx = tid; idx < MT * words; idx += S_THREADS) {
    const int m = idx / words, k = k_beg + (idx - m * words) * 4;
    uint32_t word = 0u;
    if (m < M && k < k_end) {
      const float* p = x + (size_t)m * K + k;
      if (xvec) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        word = q8_quantize(v.x, xs) | q8_quantize(v.y, xs) << 8 |
               q8_quantize(v.z, xs) << 16 | q8_quantize(v.w, xs) << 24;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < k_end) word |= q8_quantize(p[e], xs) << (8 * e);
      }
    }
    *reinterpret_cast<uint32_t*>(xq + m * ldq + (k - k_beg)) = word;
  }

  int acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0;

  for (int i = 0; i < nk; ++i) {
    // (its first barrier also publishes the quantized x)
    skinny_advance(smem, w, i, nk, k_beg, k_end, n0, N, vec, tid);
    const unsigned char* st = smem + (i % S_STAGES) * S_STAGE_BYTES;
#pragma unroll
    for (int h = 0; h < S_BK / 32; ++h) {
      const int r = 4 * (warp + 8 * h);
      const unsigned char* wr = st + r * S_LDW + 4 * lane;
      uint32_t c[4];
      q8_transpose4x4(*reinterpret_cast<const uint32_t*>(wr),
                      *reinterpret_cast<const uint32_t*>(wr + S_LDW),
                      *reinterpret_cast<const uint32_t*>(wr + 2 * S_LDW),
                      *reinterpret_cast<const uint32_t*>(wr + 3 * S_LDW), c);
      const unsigned char* xr = xq + i * S_BK + r;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int xw = *reinterpret_cast<const int*>(xr + m * ldq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[m][e] = __dp4a(static_cast<int>(c[e]), xw, acc[m][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' sums, in the free ring: red[m][e][lane] is column 4 lane + e
  // of row m (a warp's 32 lanes on 32 banks)
  int* red = reinterpret_cast<int*>(smem);
  for (int idx = tid; idx < MT * S_BN; idx += S_THREADS) red[idx] = 0;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      atomicAdd(red + (m * 4 + e) * 32 + lane, acc[m][e]);
  __syncthreads();
  const int np = gridDim.x * S_BN;
  for (int idx = tid; idx < MT * S_BN; idx += S_THREADS) {
    const int m = idx / S_BN, c = idx - m * S_BN, n = n0 + c;
    if (m >= M || n >= N) continue;
    const int v = red[(m * 4 + (c & 3)) * 32 + (c >> 2)];
    if (gridDim.y == 1)
      out[(size_t)m * N + n] = q8_finish(v, n, xs, w_scale, bias, relu);
    else
      ws[((size_t)blockIdx.y * M + m) * np + n] = v;
  }
}

// the slices' int32 partial sums of each output added in slice order, then
// q8_finish. A programmatic dependent of int8_static_skinny, as
// int8_mm_skinny_reduce is of the K6 skinny kernels.
__global__ void __launch_bounds__(256)
    int8_static_reduce(const int* __restrict__ ws,
                       const float* __restrict__ x_scale,
                       const float* __restrict__ w_scale,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int M, int N, int np, int slices, int relu) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= M * N) return;
  const int m = i / N, n = i - m * N;
  const int* p = ws + (size_t)m * np + n;
  const size_t step = (size_t)M * np;
  int acc = 0;
  for (int s0 = 0; s0 < slices; s0 += 16) {
    int v[16];  // sixteen slices' loads in flight at once
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = s0 + j < slices ? p[(s0 + j) * step] : 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) acc += v[j];
  }
  out[i] = q8_finish(acc, n, *x_scale, w_scale, bias, relu);
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

// the SM count of device `dev` into *sms, read once a device
cudaError_t sm_count(int dev, int* sms) {
  static std::atomic<int> cached[64];
  if (dev >= 0 && dev < 64 && (*sms = cached[dev].load()) > 0)
    return cudaSuccess;
  const cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev >= 0 && dev < 64) cached[dev].store(*sms);
  return err;
}

// The skinny route's K slicing, its one owner: rows of K a block takes (a
// multiple of S_BK, at most S_KS_MAX), as many slices as let the grid of
// cdiv(N, S_BN) panels x slices fill one wave of the blocks `sms` SMs hold
// at once (skinny_min_blocks of the kernel M takes: three for f32 above 4
// rows, four for the others). K = N = 4096 on 132 SMs: 16 slices of 256
// rows (512 blocks), or 11 of 384 (352) for f32 above 4 rows.
int skinny_k_slice(int M, int K, int N, int dtype, int sms) {
  const int per_sm = dtype == 0 && M > 4 ? skinny_min_blocks<float, 8>()
                                         : skinny_min_blocks<bf16, 8>();
  const int slices =
      std::max({per_sm * sms / cdiv(N, S_BN), cdiv(K, S_KS_MAX), 1});
  return std::min(std::max(cdiv(cdiv(K, slices), S_BK) * S_BK, S_BK),
                  S_KS_MAX);
}

int skinny_slices(int K, int ks) { return K > 0 ? cdiv(K, ks) : 1; }

// f32 floats of the workspace the split-K partial sums take: [slices][M]
// [panels x S_BN], none for one slice
long long skinny_workspace(int M, int K, int N, int ks) {
  const int slices = skinny_slices(K, ks);
  return slices > 1 ? (long long)slices * M * cdiv(N, S_BN) * S_BN : 0;
}

// shared memory: the ring and the K slice of x; the f32 tile kernel
// instead streams x through its ring and adds the warps' widened half
// stages; the small f32 kernel reuses its space for the tree's first
// round, 4 x [MT][S_BN] floats
template <typename T, int MT>
constexpr size_t skinny_smem(int ks) {
  if (sizeof(T) == 4 && MT >= 16)
    return (size_t)S_STAGES * tile_stage_bytes<MT>() +
           (size_t)8 * (S_BK / 2) * 16 * 4;
  const size_t staged =
      S_RING_BYTES + (size_t)MT * skinny_ldx<T>(ks) * sizeof(T);
  const size_t tree = sizeof(T) == 4 ? (size_t)4 * MT * S_BN * 4 : 0;
  return staged > tree ? staged : tree;
}

// cudaFuncSetAttribute for `kernel`'s largest dynamic shared memory, once
// a device, not at every launch (`done` is the kernel's own mask of
// devices)
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, size_t bytes,
                            std::atomic<unsigned long long>& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  err = set_smem(kernel, bytes);
  if (err == cudaSuccess && bit) done.fetch_or(bit);
  return err;
}

template <typename T, int MT, bool PRE>
cudaError_t launch_skinny_mt(const T* x, const int8_t* w, const float* s,
                             const float* bias, int relu, T* out, float* ws,
                             int M, int K, int N, int ks, int vec, int xvec,
                             dim3 grid, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  auto kernel = [] {
    if constexpr (sizeof(T) == 2)
      return int8_mm_skinny_bf16<MT, PRE>;
    else if constexpr (MT >= 16)
      return int8_mm_skinny_f32_tile<MT, PRE>;
    else
      return int8_mm_skinny_f32<MT, PRE>;
  }();
  cudaError_t err =
      allow_smem_once(kernel, skinny_smem<T, MT>(S_KS_MAX), done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, S_THREADS, skinny_smem<T, MT>(ks), stream>>>(
      x, w, s, bias, out, ws, M, K, N, ks, vec, xvec, relu);
  return cudaGetLastError();
}

// M <= 32 on the current device: skinny_k_slice's rows of K a block,
// cdiv(K, ks) slices (into *splits); with more than one, `ws` (ws_floats
// long, at least skinny_workspace's) takes [slices][M][panels x S_BN] f32
// partial sums and a second kernel adds them
template <typename T, bool PRE>
cudaError_t launch_skinny(const T* x, const int8_t* w, const float* s,
                          const float* bias, int relu, T* out, float* ws,
                          long long ws_floats, int M, int K, int N,
                          cudaStream_t stream, int* splits) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  if (err != cudaSuccess) return err;
  const int ks = skinny_k_slice(M, K, N, sizeof(T) == 4 ? 0 : 1, sms);
  const int slices = skinny_slices(K, ks);
  if (slices > 1 && (ws == nullptr ||
                     ws_floats < skinny_workspace(M, K, N, ks)))
    return cudaErrorInvalidValue;
  *splits = slices;
  const dim3 grid(cdiv(N, S_BN), slices);
  const int vec = N % 16 == 0 && aligned(w, 16);
  const int xvec = K % (16 / (int)sizeof(T)) == 0 && aligned(x, 16);
#define SKINNY(MT)                                                        \
  launch_skinny_mt<T, MT, PRE>(x, w, s, bias, relu, out, ws, M, K, N, ks, \
                               vec, xvec, grid, stream)
  // rows padded to MT: f32 1, 4, 8, 16, 32; bf16 (8-row mma tiles) 8, 16, 32
  if constexpr (sizeof(T) == 4) {
    if (M <= 4) err = M == 1 ? SKINNY(1) : SKINNY(4);
    else err = M <= 8 ? SKINNY(8) : M <= 16 ? SKINNY(16) : SKINNY(32);
  } else {
    err = M <= 8 ? SKINNY(8) : M <= 16 ? SKINNY(16) : SKINNY(32);
  }
#undef SKINNY
  if (err != cudaSuccess || slices == 1) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(M * N, 256));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_mm_skinny_reduce<T>, (const float*)ws,
                            s, bias, out, M, N, (int)grid.x * S_BN, slices,
                            (int)PRE, relu);
}

// Q8's K slicing, as skinny_k_slice's: one wave of the blocks `sms` SMs
// hold at once (q8_min_blocks of the instance M takes)
int q8_k_slice(int M, int K, int N, int sms) {
  const int per_sm = M <= 8    ? q8_min_blocks<8>()
                     : M <= 16 ? q8_min_blocks<16>()
                               : q8_min_blocks<32>();
  const int slices =
      std::max({per_sm * sms / cdiv(N, S_BN), cdiv(K, S_KS_MAX), 1});
  return std::min(std::max(cdiv(cdiv(K, slices), S_BK) * S_BK, S_BK),
                  S_KS_MAX);
}

// the ring and the quantized K slice of x (the warps' sums reuse the ring:
// MT x S_BN int32 fit it); at most 44,544 bytes, under the 48 KB default
template <int MT>
constexpr size_t q8_smem(int ks) {
  return S_RING_BYTES + (size_t)MT * (ks + Q8_LDQ_PAD);
}

template <int MT>
cudaError_t launch_q8_mt(const float* x, const float* xs, const int8_t* w,
                         const float* s, const float* bias, int relu,
                         float* out, int* ws, int M, int K, int N, int ks,
                         int vec, int xvec, dim3 grid, cudaStream_t stream) {
  static_assert(q8_smem<MT>(S_KS_MAX) <= 48 * 1024, "Q8 shared memory");
  static_assert(MT * S_BN * 4 <= S_RING_BYTES, "Q8 sums outgrow the ring");
  int8_static_skinny<MT><<<grid, S_THREADS, q8_smem<MT>(ks), stream>>>(
      x, xs, w, s, bias, out, ws, M, K, N, ks, vec, xvec, relu);
  return cudaGetLastError();
}

// Q8 for M <= 32 on the current device: q8_k_slice's rows of K a block,
// cdiv(K, ks) slices (into *splits); with more than one, `ws` (ws_ints
// long, at least skinny_workspace's) takes [slices][M][panels x S_BN]
// int32 partial sums and int8_static_reduce adds them
cudaError_t launch_q8(const float* x, const float* xs, const int8_t* w,
                      const float* s, const float* bias, int relu, float* out,
                      int* ws, long long ws_ints, int M, int K, int N,
                      cudaStream_t stream, int* splits) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  if (err != cudaSuccess) return err;
  const int ks = q8_k_slice(M, K, N, sms);
  const int slices = skinny_slices(K, ks);
  if (slices > 1 &&
      (ws == nullptr || ws_ints < skinny_workspace(M, K, N, ks)))
    return cudaErrorInvalidValue;
  *splits = slices;
  const dim3 grid(cdiv(N, S_BN), slices);
  const int vec = N % 16 == 0 && aligned(w, 16);
  const int xvec = K % 4 == 0 && aligned(x, 16);
#define Q8(MT)                                                           \
  launch_q8_mt<MT>(x, xs, w, s, bias, relu, out, ws, M, K, N, ks, vec, xvec, \
                   grid, stream)
  // rows padded to MT: 1, 4, 8, 16, 32
  if (M <= 4) err = M == 1 ? Q8(1) : Q8(4);
  else err = M <= 8 ? Q8(8) : M <= 16 ? Q8(16) : Q8(32);
#undef Q8
  if (err != cudaSuccess || slices == 1) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(M * N, 256));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int8_static_reduce, (const int*)ws, xs, s,
                            bias, out, M, N, (int)grid.x * S_BN, slices,
                            relu);
}

// the kernel each shape takes (reported to the caller)
enum Route { ROUTE_WGMMA = 0, ROUTE_MMA = 1, ROUTE_SKINNY = 2, ROUTE_FMA = 3 };

// info[0] the route, info[1] the K slices (1 off the skinny route)
template <bool PRE>
cudaError_t launch(const void* x, const int8_t* wq, const float* sc,
                   const float* bias, int relu, float* ws,
                   long long ws_floats, void* out, int M, int K, int N,
                   int dtype, cudaStream_t s, int* info) {
  if (M <= SKINNY_MAX_M) {
    info[0] = ROUTE_SKINNY;
    if (dtype == 0)
      return launch_skinny<float, PRE>(static_cast<const float*>(x), wq, sc,
                                       bias, relu, static_cast<float*>(out),
                                       ws, ws_floats, M, K, N, s, info + 1);
    return launch_skinny<bf16, PRE>(static_cast<const bf16*>(x), wq, sc,
                                    bias, relu, static_cast<bf16*>(out), ws,
                                    ws_floats, M, K, N, s, info + 1);
  }
  info[1] = 1;
  if (dtype == 1 && K > 0 && K % 8 == 0 && N % 16 == 0 && aligned(x, 16) &&
      aligned(wq, 16)) {
    info[0] = ROUTE_WGMMA;
    CUtensorMap mx, mw;
    if (!encode_x(&mx, x, M, K) || !encode_w(&mw, wq, K, N))
      return cudaErrorInvalidValue;
    static std::atomic<unsigned long long> done{0};
    cudaError_t err = allow_smem_once(int8_mm_wgmma<PRE>, G_SMEM, done);
    if (err != cudaSuccess) return err;
    int8_mm_wgmma<PRE>
        <<<dim3(cdiv(N, G_BN), cdiv(M, G_BM)), G_THREADS, G_SMEM, s>>>(
            mx, mw, sc, static_cast<bf16*>(out), M, K, N);
  } else if (dtype == 1) {
    info[0] = ROUTE_MMA;
    const int xvec = K % 8 == 0 && aligned(x, 16);
    const int wvec = N % 16 == 0 && aligned(wq, 16);
    int8_mm_mma<PRE>
        <<<dim3(cdiv(N, T_BN), cdiv(M, T_BM)), T_THREADS, 0, s>>>(
        static_cast<const bf16*>(x), wq, sc, static_cast<bf16*>(out), M, K,
        N, xvec, wvec);
  } else {
    info[0] = ROUTE_FMA;
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

// The skinny route's plan for x (M, K) in `dtype` (0 f32, 1 bf16) times w
// (K, N) on CUDA device `device`: returns 1 when M <= 32 takes the skinny
// route (which applies bias and relu itself), 0 when another route does
// (the caller applies them after it), -1 when the device cannot be read;
// *workspace_floats receives the f32 workspace int8_matmul then needs (0
// for one K slice and off the skinny route).
extern "C" int int8_matmul_plan(int M, int K, int N, int dtype, int device,
                                long long* workspace_floats) {
  *workspace_floats = 0;
  if (M > SKINNY_MAX_M) return 0;
  int sms = 0;
  if (sm_count(device, &sms) != cudaSuccess) return -1;
  *workspace_floats =
      skinny_workspace(M, K, N, skinny_k_slice(M, K, N, dtype, sms));
  return 1;
}

// x (M, K) f32 (dtype 0) or bf16 (dtype 1), w (K, N) int8, scales (N,) f32,
// out (M, N) in x's dtype; all contiguous. dequantize_first: 0 applies the
// scale after the reduction (the Pallas contract), 1 forms each weight
// q * s in x's dtype before the product (the JAX weight-only predict).
// The skinny route (M <= 32) also takes the epilogue: bias (N,) f32 or
// null, added in x's dtype after the rounding, and relu (0 or 1); it
// slices K itself (skinny_k_slice) and, with more than one slice, needs
// `workspace`, workspace_floats f32 long (int8_matmul_plan's size). The
// other routes ignore the four (the caller applies bias and relu after
// them). info[0] receives the kernel taken (0 wgmma, 1 mma, 2 skinny,
// 3 fma), info[1] the K slices it ran (1 off the skinny route).
// Returns the launch's cudaError_t (0 on success; cudaErrorInvalidValue
// also where a tensor map cannot be built or the workspace is short); the
// kernels run on `stream` and the call does not synchronise.
extern "C" int int8_matmul(const void* x, const void* w, const void* scales,
                           const void* bias, int relu, void* workspace,
                           long long workspace_floats, void* out, int M, int K,
                           int N, int dtype, int dequantize_first, int* info,
                           void* stream) {
  info[0] = -1;
  info[1] = 0;
  if (M <= 0 || N <= 0 || K < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scales);
  const float* b = static_cast<const float*>(bias);
  float* ws = static_cast<float*>(workspace);
  return (int)(dequantize_first
                   ? launch<true>(x, wq, sc, b, relu, ws, workspace_floats,
                                  out, M, K, N, dtype, s, info)
                   : launch<false>(x, wq, sc, b, relu, ws, workspace_floats,
                                   out, M, K, N, dtype, s, info));
}

// Q8's plan for x (M, K) f32 times w (K, N) int8 on CUDA device `device`:
// *workspace_ints receives the int32 workspace int8_static_matmul then
// needs (0 for one K slice). Returns 0, or -1 when M is not in 1..32 or
// the device cannot be read.
extern "C" int int8_static_plan(int M, int K, int N, int device,
                                long long* workspace_ints) {
  *workspace_ints = 0;
  if (M < 1 || M > SKINNY_MAX_M) return -1;
  int sms = 0;
  if (sm_count(device, &sms) != cudaSuccess) return -1;
  *workspace_ints = skinny_workspace(M, K, N, q8_k_slice(M, K, N, sms));
  return 0;
}

// Q8, the static int8 dense layer for 1 <= M <= 32: x (M, K) f32,
// x_scale one f32 on the device (read there, so a captured graph replays
// whatever the buffer holds), w (K, N) int8, w_scale (N,) f32, bias (N,)
// f32 or null, relu 0 or 1, out (M, N) f32; all contiguous. out =
// relu(float(sum_k clamp(rint(x / x_scale), -127, 127) w) * (x_scale *
// w_scale) + bias), the static path's arithmetic bit for bit. With more
// than one K slice it needs `workspace`, workspace_ints int32 long
// (int8_static_plan's size). *splits receives the K slices it ran.
// Returns the launch's cudaError_t; the kernels run on `stream` and the
// call does not synchronise.
extern "C" int int8_static_matmul(const void* x, const void* x_scale,
                                  const void* w, const void* w_scale,
                                  const void* bias, int relu, void* workspace,
                                  long long workspace_ints, void* out, int M,
                                  int K, int N, int* splits, void* stream) {
  *splits = 0;
  if (M < 1 || M > SKINNY_MAX_M || N <= 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  return (int)launch_q8(
      static_cast<const float*>(x), static_cast<const float*>(x_scale),
      static_cast<const int8_t*>(w), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), relu, static_cast<float*>(out),
      static_cast<int*>(workspace), workspace_ints, M, K, N,
      static_cast<cudaStream_t>(stream), splits);
}
