// The guarded training step's kernels for Hopper (sm_90a), bound through
// plain C entry points and loaded with ctypes.
//
// Neither replaces a Pallas kernel. In the JAX package the guarded step
// (training.py's sentinel step, common/anomaly.py) is a few jnp ops that
// XLA fuses into the step: the discard of an anomalous update is a
// jnp.where over the parameter and optimizer-state trees, fused into the
// update itself, and the flag word, the EWMA and the clip scale are a
// fused scalar chain. Written as torch ops on the card they were about 80
// small kernels a step (one torch.where a state tensor, a dozen one-element
// kernels for the check), which at the NCF bench shape cost more than a
// quarter of the step's device time. Both kernels are bound by their
// launches, not by bytes or operations; their design is to be one launch
// each.
//
// G2, guard_check: one thread computes, from the step's loss and global
// gradient norm, everything anomaly.check and anomaly.clip_by_global_norm
// compute — the flag word (NAN_LOSS 1, NAN_GRAD 2, SPIKE 4, GRAD_CLIPPED
// 8), the new EWMA state, the clip scale — then `bad` (recover mode: any
// anomaly bit), the step's row of per-step optimizer values (the row of
// the device count, before it moves) and the count's advance. Every
// operation is the torch op's f32 operation in the same order, rounded the
// same way (__fmul_rn/__fadd_rn: no contraction into an FMA; the clip
// scale as torch's `clip / t`, which is reciprocal(t) * clip), so the
// outputs are the torch chain's bits. In recover mode it also takes the
// pre-step copies a discard needs (the keep), before the update, for a bad
// step only: its grid is then G1's, every block decides `bad` from the
// same inputs and, where bad, copies its chunks of the state into the
// copies (G1's table, source and destination swapped). Block 0 writes the
// EWMA state while other blocks may still read it; that cannot hide a bad
// step from them, because a bad step leaves the EWMA state as it was, and
// a block that reads a good step's new state and copies for nothing only
// rewrites the pre-step values. A good step moves no state bytes.
// Given the per-tensor norms (torch._foreach_norm's outputs, separate
// one-element tensors, whose addresses come as kernel arguments) instead
// of the global norm, every block first takes their norm itself, in the
// order of torch.linalg.vector_norm's CUDA reduction for a vector of at
// most 127 floats, as scripts/vector_norm_order.py found it on the H100
// (torch 2.11): a block of B = last_pow2(n) threads, thread t squaring
// elements t and t + B and adding the squares; a shared-memory halving
// tree down to 32 lanes; then the warp's shuffle-down tree at falling
// offsets (B/2 or 16, ..., 1); the square root correctly rounded. With
// B <= 64 one warp takes the same steps (lane t adds thread t + 32's
// term for the shared tree's one step), with no barrier. So the norm has
// vector_norm's bits, and block 0 writes it.
//
// G1, guard_commit: the commit of the step's state, in one launch for
// every tensor. It reads a device table of (dst, src, bytes, first chunk)
// entries — the state tensors and their pre-step copies, made once per set
// of tensors by the wrapper. Each block reads `bad` once: on a good step
// it returns at once (one launch, one byte read a block); on a bad step
// the blocks copy the pre-step bytes back over the state, chunk by chunk,
// 16 bytes a thread where both addresses allow, bytes otherwise. A byte
// copy is the select `torch.where(bad, prev, t)`'s result bit for bit in
// every dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COMMIT_THREADS = 256;
constexpr int MAX_NORMS = 127;  // ops/guard.py's NORMS_MAX

// the per-tensor norms' addresses, passed by value as a kernel argument
// (__grid_constant__: read in place, never copied to local memory)
struct NormPtrs {
  const float* p[MAX_NORMS];
};
constexpr long long CHUNK = 32768;  // bytes a block copies at a time

struct Entry {
  long long dst;
  long long src;
  long long nbytes;
  long long first_chunk;
};

__device__ __forceinline__ bool finite(float v) { return isfinite(v); }

// anomaly.check's anomaly bits (NAN_LOSS, NAN_GRAD, SPIKE)
__device__ __forceinline__ int anomaly_bits(float l, float g, float e,
                                            float c, float spike_factor) {
  const bool finite_loss = finite(l);
  const bool finite_norm = finite(g);
  const bool nan_loss = !finite_loss;
  const bool nan_grad = finite_loss && !finite_norm;
  const bool warmed = (c >= 5.0f) && (e >= 1e-8f);
  const bool spike = finite_loss && finite_norm && warmed &&
                     (g > __fmul_rn(spike_factor, e));
  return (nan_loss ? 1 : 0) | (nan_grad ? 2 : 0) | (spike ? 4 : 0);
}

// copies chunk `c` of entry table `entries` (dst <- src)
__device__ __forceinline__ void copy_chunk(const Entry* __restrict__ entries,
                                           int n, long long c) {
  int lo = 0, hi = n - 1;  // the last entry whose first chunk is <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (entries[mid].first_chunk <= c) lo = mid; else hi = mid - 1;
  }
  const Entry e = entries[lo];
  const long long off = (c - e.first_chunk) * CHUNK;
  const long long len = min(CHUNK, e.nbytes - off);
  char* dst = reinterpret_cast<char*>(e.dst) + off;
  const char* src = reinterpret_cast<const char*>(e.src) + off;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const long long vecs = len >> 4;
    for (long long i = threadIdx.x; i < vecs; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(src)[i];
    done = vecs << 4;
  }
  for (long long i = done + threadIdx.x; i < len; i += blockDim.x)
    dst[i] = src[i];
}

// thread t's term of the reduction: the squares of elements t and t + B
__device__ __forceinline__ float square_pair(const NormPtrs& norms, int n,
                                             int B, int t) {
  if (t >= B) return 0.0f;
  const float a = *norms.p[t];
  float v = __fmul_rn(a, a);
  if (t + B < n) {
    const float b = *norms.p[t + B];
    v = __fadd_rn(v, __fmul_rn(b, b));
  }
  return v;
}

// the norm of the n <= MAX_NORMS floats `norms` points to, as
// vector_norm's CUDA reduction rounds it (see above), taken by one warp:
// lane t holds thread t's term (B = 64: plus thread t + 32's, the shared
// tree's one step), then the shuffle-down tree; lane 0 returns the norm
// (call from all 32 lanes of a warp)
__device__ float norm_of_norms(const NormPtrs& norms, int n) {
  int B = 1;
  while (B * 2 <= n) B *= 2;
  const int t = threadIdx.x & 31;
  float v = square_pair(norms, n, B, t);
  if (B == 64) v = __fadd_rn(v, square_pair(norms, n, B, t + 32));
  for (int off = (B < 32 ? B : 32) / 2; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return __fsqrt_rn(v);
}

__device__ __forceinline__ float load_loss(const void* loss, int bf16) {
  return bf16 ? __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(loss))
              : *reinterpret_cast<const float*>(loss);
}

__global__ void __launch_bounds__(COMMIT_THREADS) guard_check_kernel(
    const void* __restrict__ loss, int loss_bf16,
    const __grid_constant__ NormPtrs norms, int n_norms,
    float* __restrict__ gnorm, float* __restrict__ ewma,
    float* __restrict__ obs, long long* __restrict__ count,
    const long long* __restrict__ base, const float* __restrict__ table,
    int rows, int n, float* __restrict__ row_out, int* __restrict__ flags_out,
    bool* __restrict__ bad_out, float* __restrict__ scale_out, int sentinel,
    float spike_factor, float grad_clip, int recover,
    const Entry* __restrict__ keep, int keep_n, long long keep_chunks) {
  // the global norm, in thread 0: given, or the norm of the per-tensor
  // norms (warp 0)
  float g = 0.0f;
  if (threadIdx.x < 32)
    g = n_norms > 0 ? norm_of_norms(norms, n_norms) : *gnorm;
  if (keep_n > 0) {  // recover mode's keep: every block, for a bad step
    __shared__ bool go;
    if (threadIdx.x == 0)
      go = anomaly_bits(load_loss(loss, loss_bf16), g, *ewma, *obs,
                        spike_factor) != 0;
    __syncthreads();
    if (go)
      for (long long c = blockIdx.x; c < keep_chunks; c += gridDim.x)
        copy_chunk(keep, keep_n, c);
  }
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  if (n_norms > 0) *gnorm = g;
  const float l = load_loss(loss, loss_bf16);
  const bool finite_norm = finite(g);
  int flags = 0;
  if (sentinel) {
    const float e = *ewma;
    const float c = *obs;
    flags = anomaly_bits(l, g, e, c, spike_factor);
    const bool anomalous = flags > 0;
    const float seeded =
        c > 0.0f ? __fadd_rn(__fmul_rn(0.9f, e), __fmul_rn(0.1f, g)) : g;
    *ewma = anomalous ? e : seeded;
    *obs = anomalous ? c : __fadd_rn(c, 1.0f);
  }
  if (grad_clip > 0.0f) {
    const float floor = fmaxf(g, 1e-16f);
    const float scale =
        finite_norm ? fminf(__fmul_rn(__frcp_rn(floor), grad_clip), 1.0f)
                    : 1.0f;
    *scale_out = scale;
    if (finite_norm && g > grad_clip) flags |= 8;
  }
  *flags_out = flags;
  const bool bad = recover && (flags & 7) > 0;
  *bad_out = bad;
  if (n > 0) {
    const long long at = *count - *base;
    const bool inside = at >= 0 && at < rows;
    for (int i = 0; i < n; ++i)
      row_out[i] = inside ? table[at * n + i] : __int_as_float(0x7fc00000);
  }
  *count += recover ? (bad ? 0 : 1) : 1;
}

__global__ void __launch_bounds__(COMMIT_THREADS)
    guard_commit_kernel(const Entry* __restrict__ entries, int n,
                        long long chunks, const bool* __restrict__ bad) {
  __shared__ bool go;
  if (threadIdx.x == 0) go = *bad;
  __syncthreads();
  if (!go) return;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x)
    copy_chunk(entries, n, c);
}

}  // namespace

extern "C" {

int guard_check(const void* loss, int loss_bf16,
                const void* const* norm_ptrs, int n_norms, float* gnorm,
                float* ewma, float* obs, long long* count,
                const long long* base, const float* table, int rows, int n,
                float* row_out, int* flags_out, bool* bad_out,
                float* scale_out, int sentinel, float spike_factor,
                float grad_clip, int recover, const void* keep, int keep_n,
                long long keep_chunks, int blocks, cudaStream_t stream) {
  if (n_norms > MAX_NORMS) return static_cast<int>(cudaErrorInvalidValue);
  NormPtrs norms = {};
  for (int i = 0; i < n_norms; ++i)
    norms.p[i] = static_cast<const float*>(norm_ptrs[i]);
  guard_check_kernel<<<keep_n > 0 ? blocks : 1, COMMIT_THREADS, 0, stream>>>(
      loss, loss_bf16, norms, n_norms, gnorm, ewma, obs, count, base, table,
      rows, n, row_out, flags_out, bad_out, scale_out, sentinel,
      spike_factor, grad_clip, recover, reinterpret_cast<const Entry*>(keep),
      keep_n, keep_chunks);
  return static_cast<int>(cudaGetLastError());
}

int guard_commit(const void* entries, int n, long long chunks,
                 const bool* bad, int blocks, cudaStream_t stream) {
  if (n == 0 || chunks == 0) return 0;
  guard_commit_kernel<<<blocks, COMMIT_THREADS, 0, stream>>>(
      reinterpret_cast<const Entry*>(entries), n, chunks, bad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
