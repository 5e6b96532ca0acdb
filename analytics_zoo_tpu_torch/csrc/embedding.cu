// Dedup'd-embedding kernels for Hopper (sm_90a): two kernels, bound through
// plain C entry points and loaded with ctypes.
//
// K1, embed_expand: out[i] = rows[inv[i]] for the (N,) inverse ids of the
// dedup'd lookup over its (capacity, D) block of unique rows.
// Replaces: analytics_zoo_tpu/ops/pallas/embedding.py, the Pallas kernel
// _expand_kernel (pl.pallas_call in embed_expand at :104). On the TPU the
// expansion is a one-hot MXU product, onehot(inv) @ rows, exact because
// every output sums a single nonzero term. Here it is what it computes, a
// row gather: no operation at all, so the bytes bound it (each output row
// written once, each referenced unique row and each id read once). Design:
// a warp owns consecutive output rows and copies each row with the widest
// unit (16, 8, 4 or 2 bytes) that divides the row's bytes and both base
// addresses; a row of U units takes min(U, 32) lanes, so a warp copies
// 32 / U rows at once when U < 32 (D = 20 f32 is five 16-byte units: six
// rows a warp) and loops over a longer row. Bits are copied, so the result
// is rows[inv] bit for bit in every dtype. An id outside [0, capacity)
// gives a row of zeros, as the one-hot product does.
//
// SA, dedup_scatter_add: out[c] = sum over positions i with inv[i] == c of
// g[i], in f32, in ascending i, from 0 — the sequential order in which the
// JAX package's CPU scatter (.at[inv].add, sharded_embedding.py:148-149 in
// _dedup_take_bwd) and the CPU index_add_ add. It has no Pallas
// counterpart; it replaces torch's index_add_ on CUDA, whose float atomics
// add in an order that changes from run to run. Design: the wrapper sorts
// the positions stably by inv (a fixed-shape sort, no host sync) and takes
// each slot's offsets into that order by a binary search; one warp owns a
// slot and its lanes own columns, each lane adding its column of the
// slot's rows in the sorted (= ascending position) order. Every output is
// written by one thread in a fixed order: the same bits on every run. The
// bytes bound it too (g read once, out written once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    expand_rows(const T* __restrict__ rows, const int* __restrict__ inv,
                T* __restrict__ out, int N, int C, int units) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lpr = units < 32 ? units : 32;  // lanes per row
  const int rpw = 32 / lpr;                 // rows per warp
  const int sub = lane / lpr;
  if (sub >= rpw) return;
  const long long i = warp * rpw + sub;
  if (i >= N) return;
  const int src = inv[i];
  T* dst = out + (size_t)i * units;
  if (src < 0 || src >= C) {
    for (int u = lane % lpr; u < units; u += lpr) dst[u] = T{};
    return;
  }
  const T* s = rows + (size_t)src * units;
  for (int u = lane % lpr; u < units; u += lpr) dst[u] = s[u];
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename G>
__global__ void __launch_bounds__(THREADS)
    segment_sum_rows(const G* __restrict__ g, const int* __restrict__ order,
                     const int* __restrict__ offsets, float* __restrict__ out,
                     int C, int D) {
  const int lane = threadIdx.x & 31;
  const long long c =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (c >= C) return;
  const int j0 = offsets[c], j1 = offsets[c + 1];
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int j = j0; j < j1; ++j) acc += to_f32(g[(size_t)order[j] * D + d]);
    out[(size_t)c * D + d] = acc;
  }
}

int grid_for_warps(long long warps) {
  return (int)((warps * 32 + THREADS - 1) / THREADS);
}

template <typename T>
void launch_expand(const void* rows, const int* inv, void* out, int N, int C,
                   int units, cudaStream_t s) {
  const int lpr = units < 32 ? units : 32;
  const long long warps = (N + 32 / lpr - 1) / (32 / lpr);
  expand_rows<T><<<grid_for_warps(warps), THREADS, 0, s>>>(
      static_cast<const T*>(rows), inv, static_cast<T*>(out), N, C, units);
}

}  // namespace

// rows (capacity, D) and out (N, D) contiguous, row_bytes = D * element
// size; inv (N,) int32. Returns the launch's cudaError_t (0 on success); the
// kernel runs on `stream` and the call does not synchronise.
extern "C" int embed_expand(const void* rows, const void* inv, void* out,
                            int N, int capacity, int row_bytes,
                            void* stream) {
  if (N <= 0 || capacity <= 0 || row_bytes <= 0 || row_bytes % 2 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(inv);
  const uintptr_t align = reinterpret_cast<uintptr_t>(rows) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0)
    launch_expand<uint4>(rows, ids, out, N, capacity, row_bytes / 16, s);
  else if (align % 8 == 0)
    launch_expand<uint2>(rows, ids, out, N, capacity, row_bytes / 8, s);
  else if (align % 4 == 0)
    launch_expand<uint32_t>(rows, ids, out, N, capacity, row_bytes / 4, s);
  else
    launch_expand<uint16_t>(rows, ids, out, N, capacity, row_bytes / 2, s);
  return (int)cudaGetLastError();
}

// g (N, D) f32 (g_dtype 0) or bf16 (1), contiguous; order (N,) int32, the
// positions sorted stably by inv; offsets (capacity + 1,) int32, slot c's
// range [offsets[c], offsets[c + 1]) of order; out (capacity, D) f32.
extern "C" int dedup_scatter_add(const void* g, const void* order,
                                 const void* offsets, void* out, int N,
                                 int capacity, int D, int g_dtype,
                                 void* stream) {
  if (N < 0 || capacity <= 0 || D <= 0 || (g_dtype != 0 && g_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ord = static_cast<const int*>(order);
  const int* off = static_cast<const int*>(offsets);
  float* o = static_cast<float*>(out);
  const int grid = grid_for_warps(capacity);
  if (g_dtype == 0)
    segment_sum_rows<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(g), ord, off, o, capacity, D);
  else
    segment_sum_rows<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), ord, off, o, capacity, D);
  return (int)cudaGetLastError();
}
