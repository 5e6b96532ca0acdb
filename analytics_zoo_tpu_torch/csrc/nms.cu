// N1: the batched greedy NMS keep-mask of SSD's detection output.
//
// One block per row (an image's class): the row's K boxes, sorted by score
// descending, corner form (x1, y1, x2, y2). A box j is dropped when a kept
// box i < j overlaps it with IoU > threshold, i taken in order -- the
// JAX package's ``nms_mask`` (an XLA fori_loop over the IoU matrix).
//
//   1. the row's boxes and their areas into shared memory;
//   2. the upper triangle's ``iou > threshold`` bits, a word of 32 columns
//      a thread at a time (K <= 1024: at most 32 words a row), a warp on
//      32 rows of one word;
//   3. the greedy scan in one warp, lane w holding word w of the removed
//      set: row i, unless removed, ORs its bits into it;
//   4. keep[j] = not removed.
//
// The IoU takes the plain version's operations in its order, each rounded
// on its own (no FMA contraction), so a box at the threshold falls on the
// same side: inter = w * h, union = (area_i + area_j) - inter,
// iou = inter / union where union > 0, else 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 1024;

__device__ __forceinline__ float clamp0(float v) {
  // torch.clamp(v, min=0) for finite v (boxes are clipped to [0, 1])
  return v > 0.0f ? v : 0.0f;
}

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(clamp0(__fsub_rn(b.z, b.x)), clamp0(__fsub_rn(b.w, b.y)));
}

__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, float threshold) {
  float w = clamp0(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)));
  float h = clamp0(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)));
  float inter = __fmul_rn(w, h);
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > threshold;
}

__global__ void __launch_bounds__(THREADS)
nms_keep_kernel(const float4* __restrict__ boxes, int k, float threshold,
                bool* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) / 32;
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + k);
  uint32_t* mask = reinterpret_cast<uint32_t*>(sarea + k);
  const long long row = blockIdx.x;
  const float4* rb = boxes + row * k;

  for (int i = threadIdx.x; i < k; i += THREADS) {
    float4 b = rb[i];
    sbox[i] = b;
    sarea[i] = area_of(b);
  }
  __syncthreads();

  // mask[w * k + i]: bit c set when column j = 32 w + c > i overlaps i.
  // A warp takes 32 rows of one word: every lane reads the same column
  // box (a broadcast) and its own row box (consecutive, no conflict).
  for (int t = threadIdx.x; t < k * words; t += THREADS) {
    const int w = t / k, i = t % k;
    uint32_t bits = 0;
    const int j0 = w * 32;
    if (j0 + 31 > i) {
      const float4 a = sbox[i];
      const float aa = sarea[i];
      const int j_end = min(j0 + 32, k);
      for (int j = max(j0, i + 1); j < j_end; ++j)
        if (overlaps(a, aa, sbox[j], sarea[j], threshold))
          bits |= 1u << (j - j0);
    }
    mask[t] = bits;
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint32_t removed = 0;
    for (int i = 0; i < k; ++i) {
      const uint32_t word = __shfl_sync(0xffffffffu, removed, i >> 5);
      if (!((word >> (i & 31)) & 1u) && lane < words)
        removed |= mask[lane * k + i];
    }
    __syncwarp();
    if (lane < words) mask[lane] = removed;   // read back below
  }
  __syncthreads();

  bool* out = keep + row * k;
  for (int j = threadIdx.x; j < k; j += THREADS)
    out[j] = !((mask[j >> 5] >> (j & 31)) & 1u);
}

size_t smem_bytes(int k) {
  const int words = (k + 31) / 32;
  return static_cast<size_t>(k) * (sizeof(float4) + sizeof(float))
         + static_cast<size_t>(k) * words * sizeof(uint32_t);
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
    // above the default: opt in on this device (K > 672 or so; SSD's 400
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
