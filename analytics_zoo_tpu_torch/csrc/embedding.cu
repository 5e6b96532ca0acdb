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
// add in an order that changes from run to run. It reads the positions
// sorted stably by slot (`order`) and the slot of each sorted position
// (`sorted_slot`, ascending), both int64: the dedup'd lookup's
// forward already made them in its unique (its stable sort of the ids,
// whose slots rise with the id), so the backward is this one launch; the
// standalone op sorts inv itself first. Design: a slot's rows take min(U,
// 32) lanes, U the row's units of 4, 2 or 1 columns (the widest that
// divides D and keeps g's and out's units aligned), so a warp serves 32 /
// U slots at once when U < 32 (D = 20 f32: five 16-byte units, six slots
// a warp) and loops over a longer row. The warp finds its slots' ranges
// of the sorted positions itself: a 32-ary search over sorted_slot (one
// load a lane a round, three rounds at N = 8192) narrows the start of its
// first slot to 32 positions, whose slots the last round loads; ballots
// over them give every slot's [lo, hi) (more rounds of 32 only where the
// warp's positions run on). Then each lane adds its units of its slot's
// rows in sorted (= ascending position) order from 0.0f, bf16 widened to
// f32 on load, four rows' loads in flight at a time. A slot without
// positions writes zeros. Every output is written by one thread in a
// fixed order: the same bits on every run. The bytes bound it too (g read
// once, out written once); at the NCF shapes the chain of dependent loads
// (search, window, position, row) sets its time.

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

// VEC consecutive elements of g as one load
template <typename G, int VEC>
struct alignas(sizeof(G) * VEC) Unit {
  G v[VEC];
};

constexpr unsigned FULL = 0xffffffffu;

template <typename G, int VEC>
__global__ void __launch_bounds__(THREADS)
    segment_sum_sorted(const G* __restrict__ g,
                       const long long* __restrict__ order,
                       const long long* __restrict__ slot,
                       float* __restrict__ out, int N, int C, int units) {
  typedef Unit<G, VEC> In;
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lpr = units < 32 ? units : 32;  // lanes per slot
  const int spw = 32 / lpr;                 // slots per warp
  const int sub = lane / lpr;
  const long long c0 = warp * spw;          // the warp's slots c0 ..
  if (c0 >= C) return;
  // a 32-ary search over all lanes for a lower bound `lo` of the first
  // position whose slot is c0 or more, to within 32 positions
  int lo = 0, hi = N;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + (lane + 1) * step - 1;
    const bool below = p < hi && slot[p] < c0;
    const int n = __popc(__ballot_sync(FULL, below));
    hi = min(hi, lo + (n + 1) * step - 1);
    lo += n * step;
  }
  // then 32 positions a round from lo, one a lane (the last round of the
  // search is the first of these): each slot's range [lo + below(c),
  // lo + below(c + 1)), below(c) the positions from lo whose slot is
  // under c, one ballot a slot
  int n_lo = 0, n_hi = 0;
  for (int base = lo;; base += 32) {
    const int p = base + lane;
    const long long sv = p < N ? slot[p] : c0 + spw;
    int n_end = 0;
    for (int k = 0; k <= spw; ++k) {
      const int n = __popc(__ballot_sync(FULL, sv < c0 + k));
      if (k == sub) n_lo += n;
      if (k == sub + 1) n_hi += n;
      if (k == spw) n_end = n;
    }
    if (n_end < 32) break;  // the round reached the warp's last slot's end
  }
  const int lo_c = lo + n_lo, hi_c = lo + n_hi;
  const long long c = c0 + sub;
  if (sub >= spw || c >= C) return;
  const In* rows = reinterpret_cast<const In*>(g);
  for (int u = lane % lpr; u < units; u += lpr) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    int j = lo_c;
    for (; j + 4 <= hi_c; j += 4) {  // four rows' loads in flight
      In x[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        x[r] = rows[(size_t)order[j + r] * units + u];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += to_f32(x[r].v[e]);
    }
    for (; j < hi_c; ++j) {
      const In x = rows[(size_t)order[j] * units + u];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += to_f32(x.v[e]);
    }
    float* o = out + ((size_t)c * units + u) * VEC;
    if (VEC == 4)
      *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2],
                                                  acc[3]);
    else if (VEC == 2)
      *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
    else
      o[0] = acc[0];
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

template <typename G, int VEC>
void launch_segment_sum(const void* g, const long long* order,
                        const long long* slot, float* out, int N, int C,
                        int D, cudaStream_t s) {
  const int units = D / VEC;
  const int lpr = units < 32 ? units : 32;
  const long long warps = (C + 32 / lpr - 1) / (32 / lpr);
  segment_sum_sorted<G, VEC><<<grid_for_warps(warps), THREADS, 0, s>>>(
      static_cast<const G*>(g), order, slot, out, N, C, units);
}

template <typename G>
void launch_segment_sum(const void* g, const long long* order,
                        const long long* slot, float* out, int N, int C,
                        int D, cudaStream_t s) {
  // the widest unit of columns that divides D and keeps both g's and out's
  // units aligned (out is a fresh allocation)
  const uintptr_t gp = reinterpret_cast<uintptr_t>(g);
  if (D % 4 == 0 && gp % (4 * sizeof(G)) == 0)
    launch_segment_sum<G, 4>(g, order, slot, out, N, C, D, s);
  else if (D % 2 == 0 && gp % (2 * sizeof(G)) == 0)
    launch_segment_sum<G, 2>(g, order, slot, out, N, C, D, s);
  else
    launch_segment_sum<G, 1>(g, order, slot, out, N, C, D, s);
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

// g (N, D) f32 (g_dtype 0) or bf16 (1), contiguous; order (N,) int64, the
// positions sorted stably by slot; sorted_slot (N,) int64, ascending,
// the slot of each sorted position (slots outside [0, capacity) are
// summed nowhere); out (capacity, D) f32, 16-byte aligned. Both arrays
// are trusted: an order entry outside [0, N) reads outside g.
extern "C" int dedup_scatter_add(const void* g, const void* order,
                                 const void* sorted_slot, void* out, int N,
                                 int capacity, int D, int g_dtype,
                                 void* stream) {
  if (N < 0 || capacity <= 0 || D <= 0 || (g_dtype != 0 && g_dtype != 1) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* ord = static_cast<const long long*>(order);
  const long long* sl = static_cast<const long long*>(sorted_slot);
  float* o = static_cast<float*>(out);
  if (g_dtype == 0)
    launch_segment_sum<float>(g, ord, sl, o, N, capacity, D, s);
  else
    launch_segment_sum<__nv_bfloat16>(g, ord, sl, o, N, capacity, D, s);
  return (int)cudaGetLastError();
}
