// N1: the batched greedy NMS keep-mask of SSD's detection output.
//
// Replaces no Pallas kernel: the JAX package's nms_mask
// (models/image/objectdetection/bbox.py:70) is an XLA fori_loop over the
// IoU matrix under two vmaps. One block per row (an image's class): the
// row's K boxes, sorted by score descending, corner form (x1, y1, x2, y2).
// A box j is dropped when a kept box i < j overlaps it with IoU >
// threshold, i taken in order.
//
//   1. the row's boxes and their areas into shared memory;
//   2. the upper triangle's `iou > threshold` bits as 32 x 32 tiles, only
//      those on or above the diagonal, dealt to the warps in turn: lane l
//      owns row 32 bi + l and all lanes walk the same 32 columns of word
//      w, each column box a broadcast read. A diagonal tile takes 16 steps
//      instead of 31: in step s lane l tests the pair (l, (l + s) % 32),
//      keeps the bit where the column is above its row and hands it to the
//      other row's lane by a shuffle where it wrapped (the IoU is
//      symmetric bit for bit: min, max, * and + commute);
//   3. the greedy scan, one warp a word of 32 boxes, lane l holding row
//      32 c + l's bits of the diagonal tile: in rounds, a live box that no
//      live box before it overlaps is kept and what the kept boxes overlap
//      is dropped (two warp reductions a round, a few rounds a word, where
//      the earlier scan took one dependent step a box); then each kept row's
//      words past the diagonal are ORed into the removed set, one warp
//      reduction a word;
//   4. keep[j] = j was kept.
//
// The IoU takes the plain version's operations in its order, each rounded
// on its own (no FMA contraction), so a box at the threshold falls on the
// same side: inter = w * h, union = (area_i + area_j) - inter, iou = inter
// / union where union > 0, else 0. `iou > t` is decided without the
// division where that is exact (test_pair): the IEEE quotient is correctly
// rounded and monotone, so fl(inter / union) <= t when the exact inter -
// t * union is negative and fl(inter / union) > t when inter - t+ * union
// is positive (t+ the next float above t); one FMA rounds each exact
// difference once and keeps its sign. Only a quotient within an ulp of t
// (or a zero union) takes the division. For finite boxes with finite
// areas (SSD's are clipped to [0, 1]) the result is the division's bit for
// bit (tests/test_torch_port_objectdetection.py holds a model of the
// predicate to the division at and around the cut).
//
// What bounds it on this card: the pairs' arithmetic. SSD300's decode gives
// 672 rows of 400 boxes, 53.6 M pairs of about 13 f32 operations; counted
// at the f32 issue rate of the CUDA cores (33.5 T operations/s without FMA
// pairing; the division counted as one), 0.0208 ms, against 0.0004 ms for
// the boxes read and the mask written. The earlier kernel took 0.2298 ms,
// 89% of it the IoU phase (an IEEE division a pair, divergent bounds on
// the diagonal words, warps that straddled two words) and 10% the scan (K
// dependent steps a row); scripts/nms_phases.py times the phases. This one
// takes about 0.075 ms on the H100 (IoU phase 0.066, scan 0.005, load and
// output 0.004). A pair is about 23 instructions in the SASS, 12 or so of
// them min, max, compare and select, which issue on the integer pipe at
// half the f32 rate: the likely limit (a profiler's pipe counters were not
// at hand to confirm it).
//
// NMS_PHASES (a profiling switch, 3 unless the build defines it): bit 0
// runs step 2, bit 1 step 3 (the other steps always run; scripts/
// nms_phases.py times the phases from builds that leave one out).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef NMS_PHASES
#define NMS_PHASES 3
#endif

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 1024;
constexpr uint32_t FULL = 0xffffffffu;

__device__ __forceinline__ float area_of(float4 b) {
  // torch.clamp(v, min=0) for finite v: the sign of a zero width does not
  // reach the decision
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// inter and union of a pair, in the plain version's order
__device__ __forceinline__ float2 inter_union(float4 a, float area_a,
                                              float4 b, float area_b) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  return make_float2(inter, __fsub_rn(__fadd_rn(area_a, area_b), inter));
}

// iou > t decided without the division: bit c of `over` where inter - t+
// * union > 0 (the quotient above t+), of `open` where neither that nor
// inter - t * union < 0 (the quotient below t) holds; tp = the float after
// t. For finite boxes union >= inter >= 0 (each rounding is monotone: inter
// <= either area, so area_i + area_j >= 2 inter), so a union that is not
// positive is 0 with inter 0, which both tests leave open. Branch-free: a
// tile's few open pairs are settled after its columns.
__device__ __forceinline__ void test_pair(float4 a, float area_a, float4 b,
                                          float area_b, float t, float tp,
                                          int c, uint32_t& over,
                                          uint32_t& open) {
  const float2 iu = inter_union(a, area_a, b, area_b);
  const bool above = __fmaf_rn(-tp, iu.y, iu.x) > 0.f;
  const bool below = __fmaf_rn(-t, iu.y, iu.x) < 0.f;
  over |= (uint32_t)above << c;
  open |= (uint32_t)!(above | below) << c;
}

// the plain version's test, iou = inter / union where union > 0, else 0
__device__ __forceinline__ bool over_exact(float4 a, float area_a, float4 b,
                                           float area_b, float t) {
  const float2 iu = inter_union(a, area_a, b, area_b);
  return (iu.y > 0.f ? __fdiv_rn(iu.x, iu.y) : 0.f) > t;
}

// mask words a row: odd, so that a tile's 32 row stores (and the scan's
// loads) fall on 32 banks
__host__ __device__ __forceinline__ int mask_ld(int words) {
  return words | 1;
}

__global__ void __launch_bounds__(THREADS)
nms_keep_kernel(const float4* __restrict__ boxes, int k, float threshold,
                bool* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t kept_words[MAX_K / 32];
  const int words = (k + 31) / 32, ld = mask_ld(words);
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + k);
  uint32_t* mask = reinterpret_cast<uint32_t*>(sarea + k);  // [k][ld]
  const long long row = blockIdx.x;
  const float4* rb = boxes + row * k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float t = threshold;
  const float tp = nextafterf(threshold, __int_as_float(0x7f800000));

  for (int i = threadIdx.x; i < k; i += THREADS) {
    float4 b = rb[i];
    sbox[i] = b;
    sarea[i] = area_of(b);
  }
  __syncthreads();

  if (NMS_PHASES & 1) {
    // tile (bi, w), w >= bi, in row-major order of the upper triangle
    const int tiles = words * (words + 1) / 2;
    int bi = 0, w = 0;
    for (int s = 0; s < warp; ++s)
      if (++w == words) w = ++bi;
    for (int tile = warp; tile < tiles; tile += WARPS) {
      const int i = 32 * bi + lane;
      const float4 a = sbox[min(i, k - 1)];
      const float aa = sarea[min(i, k - 1)];
      uint32_t bits = 0;
      if (w > bi) {
        const int j0 = 32 * w, n = min(32, k - j0);
        uint32_t open = 0;
        if (n == 32) {
#pragma unroll
          for (int c = 0; c < 32; ++c)
            test_pair(a, aa, sbox[j0 + c], sarea[j0 + c], t, tp, c, bits,
                      open);
        } else {
          for (int c = 0; c < n; ++c)
            test_pair(a, aa, sbox[j0 + c], sarea[j0 + c], t, tp, c, bits,
                      open);
        }
        for (; open; open &= open - 1) {  // within an ulp of t: divide
          const int c = __ffs(open) - 1;
          if (over_exact(a, aa, sbox[j0 + c], sarea[j0 + c], t))
            bits |= 1u << c;
        }
      } else {
#pragma unroll 4
        for (int s = 1; s <= 16; ++s) {
          const int jl = (lane + s) & 31, j = 32 * bi + jl;
          uint32_t o = 0, open = 0;
          if (i < k && j < k) {
            test_pair(a, aa, sbox[j], sarea[j], t, tp, 0, o, open);
            if (open) o = over_exact(a, aa, sbox[j], sarea[j], t);
          }
          if (lane + s < 32) bits |= o << (lane + s);
          // lane (l - s) % 32 tested (l, its column) from the other end
          const uint32_t got = __shfl_sync(FULL, o, (lane - s) & 31);
          if (lane < s) bits |= got << (lane - s + 32);
        }
      }
      if (i < k) mask[i * ld + w] = bits;
      for (int s = 0; s < WARPS; ++s)
        if (++w == words) w = ++bi;
    }
  } else {
    for (int e = threadIdx.x; e < k * ld; e += THREADS) mask[e] = 0u;
  }
  __syncthreads();

  if (warp == 0) {
    uint32_t removed = 0;  // lane c: the removed boxes of word c
    for (int c = 0; c < words; ++c) {
      const int r = 32 * c + lane;
      const int n = min(32, k - 32 * c);
      const uint32_t valid = n == 32 ? FULL : (1u << n) - 1u;
      const uint32_t diag = r < k ? mask[r * ld + c] : 0u;
      uint32_t kept;
      if (NMS_PHASES & 2) {
        // in rounds: a live box that no live box before it overlaps is
        // kept, and what the kept boxes overlap is dropped
        uint32_t alive = ~__shfl_sync(FULL, removed, c) & valid;
        kept = 0;
        while (alive) {
          const uint32_t hit =
              __reduce_or_sync(FULL, (alive >> lane) & 1u ? diag : 0u);
          const uint32_t sure = alive & ~hit;
          const uint32_t gone =
              __reduce_or_sync(FULL, (sure >> lane) & 1u ? diag : 0u);
          kept |= sure;
          alive &= ~(sure | gone);
        }
        const bool mine = (kept >> lane) & 1u;
#pragma unroll 4
        for (int c2 = c + 1; c2 < words; ++c2) {
          const uint32_t all =
              __reduce_or_sync(FULL, mine ? mask[r * ld + c2] : 0u);
          if (lane == c2) removed |= all;
        }
      } else {
        kept = __reduce_or_sync(FULL, diag) & valid;  // keeps step 2 live
      }
      if (lane == 0) kept_words[c] = kept;
    }
  }
  __syncthreads();

  bool* out = keep + row * k;
  for (int j = threadIdx.x; j < k; j += THREADS)
    out[j] = (kept_words[j >> 5] >> (j & 31)) & 1u;
}

size_t smem_bytes(int k) {
  const int words = (k + 31) / 32;
  return static_cast<size_t>(k) * (sizeof(float4) + sizeof(float))
         + static_cast<size_t>(k) * mask_ld(words) * sizeof(uint32_t);
}

}  // namespace

extern "C" {

// keep (rows, k) bool <- boxes (rows, k, 4) f32; k in [1, MAX_K].
int nms_keep(const void* boxes, long long rows, int k, float threshold,
             void* keep, cudaStream_t stream) {
  if (k < 1 || k > MAX_K || rows < 1 || rows > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(k);
  if (bytes > 48 * 1024) {
    // above the default: opt in on this device (K > 560 or so; SSD's 400
    // takes 28.8 KB)
    cudaError_t err = cudaFuncSetAttribute(
        nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_keep_kernel<<<static_cast<unsigned>(rows), THREADS, bytes, stream>>>(
      static_cast<const float4*>(boxes), k, threshold,
      static_cast<bool*>(keep));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
