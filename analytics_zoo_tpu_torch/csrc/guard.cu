// The guarded training step's kernels for Hopper (sm_90a), bound through
// plain C entry points and loaded with ctypes.
//
// Neither replaces a Pallas kernel. In the JAX package the guarded step
// (training.py's sentinel step, common/anomaly.py) is a few jnp ops that
// XLA fuses into the step: the global gradient norm, the discard of an
// anomalous update (a jnp.where over the parameter and optimizer-state
// trees, fused into the update itself), and the flag word, the EWMA and
// the clip scale (a fused scalar chain). Written as torch ops on the card
// they were about 80 small kernels a step (one torch.where a state tensor,
// a dozen one-element kernels for the check, the multi-tensor norm's three
// kernels), which at the NCF bench shape cost more than a quarter of the
// step's device time. G1 is bound by its launch on a good step and by the
// state's bytes on a bad one; G2 by the gradients' bytes plus one launch.
// Each call is one launch.
//
// G2, guard_check: from the step's gradient tensors (f32 or bf16, any
// number, their addresses passed by value as a kernel argument, or in a
// device table past PARAM_CAP of them), the loss, the guard's scalars and
// the loop's tickets,
// everything the torch chain computes: each gradient's L2 norm with
// torch._foreach_norm's bits, the norm of those norms with
// torch.linalg.vector_norm's bits (anomaly.tensor_norms, norm_of_norms),
// then in one thread the flag word (NAN_LOSS 1, NAN_GRAD 2, SPIKE 4,
// GRAD_CLIPPED 8), the new EWMA state, the clip scale (anomaly.check,
// clip_by_global_norm), `bad` (recover mode: any anomaly bit), the step's
// row of per-step optimizer values (the row of the device count, before it
// moves) and the count's advance. The scalar chain is the torch ops' f32
// operations in their order, rounded the same way (__fmul_rn/__fadd_rn: no
// contraction into an FMA; the clip scale as torch's `clip / t`, which is
// reciprocal(t) * clip).
//
// The orders it mirrors (upstream ATen's ForeachReduceOp.cu,
// MultiTensorApply.cuh, block_reduce.cuh and Reduce.cuh, confirmed on the
// H100 with torch 2.11 by scripts/vector_norm_order.py):
// - _foreach_norm cuts each tensor into chunks of 65,536 elements, one
//   512-thread block a chunk. On the vectorised path (a 16-byte aligned
//   f32 pointer and a length that is a multiple of 4; a bf16 gradient is
//   cast to a fresh, aligned f32 copy first) thread t adds the squares of
//   elements 4 (t + 512 k) + i into vals[i], k = 0, 1, ... in turn; else
//   element 2048 k + t + 512 i. Each addition is one FMA
//   (vals[i] += x * x, contracted). Then ((vals0 + vals1) + vals2) +
//   vals3, and BlockReduceSum: a shuffle-down tree (16, ..., 1) in each
//   warp, then warp 0 over the 16 warp sums, lanes 16-31 holding 0. The
//   cleanup block of a tensor (512 threads) takes chunk partials t, t +
//   512, ... in thread t, the same block reduce, and sqrtf.
// - vector_norm of the n stacked norms is one block of B threads. Below
//   128 norms B = last_pow2(n) (at most 512) and thread t takes elements
//   t, t + B, t + 2B, t + 3B into four accumulators; from 128 on it loads
//   four floats a thread: B = last_pow2(n / 4), thread t takes elements
//   4 (t + B k) + i into accumulator i, then the tail (n % 4 elements) in
//   threads 0.. into accumulator 0; each addition an FMA. The
//   accumulators are summed in order, the block halves its values in
//   shared memory down to 32, then a warp shuffle-down tree at falling
//   offsets, and a correctly rounded sqrt.
//
// Design for the card: the unit of work is one warp of one chunk's block
// (16 units a chunk): every thread keeps its own sequence of FMAs, so the
// bits stay _foreach_norm's while a chunk's 16 warps run on up to 16 SMs
// (NCF's 393k gradients are 16 chunks: 256 warps over the card, where
// _foreach_norm ran 16 blocks). The combining follows the data, by
// tickets: each warp writes its warp sum and takes a ticket of its
// tensor; the tensor's last warp takes its chunk partials in
// BlockReduceSum's order and its cleanup, then a ticket of the norms;
// the last norm's warp takes the norm of the norms and the scalar chain,
// from the loss and the guard's scalars that every warp read as the
// launch began. No block waits for another, and no ticket sees more
// arrivals than a tensor has warps, or the step tensors. A bf16 gradient
// is read as bf16 and widened in registers, which is exact, so no f32
// copy is made.
//
// The tickets are the caller's (n_grads + 1 zeroed unsigned ints, the
// training loop's own: dispatch.Guard.tickets), so launches of different
// loops never share one; each ticket's last taker resets it for the next
// launch (and the next replay of a captured step).
//
// G1, guard_commit: a copy of the step's state where `bad` is set, in one
// launch for every tensor. It reads a device table of (dst, src, bytes,
// first chunk) entries, made once per set of tensors by the wrapper. Each
// block reads `bad` once: on a good step it returns at once (one launch,
// one byte read a block); on a bad step the blocks copy src over dst,
// chunk by chunk, 16 bytes a thread where both addresses allow, bytes
// otherwise. A byte copy is the select `torch.where(bad, src, dst)`'s
// result bit for bit in every dtype. In recover mode it runs twice a
// step: after G2, before the update, the state into its pre-step copies
// (the keep: a bad step's only), and after the update, the copies back
// over the state (the discard).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COMMIT_THREADS = 256;
constexpr long long CHUNK = 32768;  // bytes a block copies at a time

constexpr int CHECK_THREADS = 64;   // G2's block: two warps, two units
constexpr int CHECK_WARPS = CHECK_THREADS / 32;
constexpr int NORM_CHUNK = 65536;   // multi_tensor_apply's kChunkSize
constexpr int NORM_BLOCK = 512;     // its block, and the cleanup's
constexpr int NORM_WARPS = NORM_BLOCK / 32;
constexpr int VNORM_VEC_MIN = 128;  // vector_norm loads float4 from here
constexpr int VNORM_MAX_BLOCK = 512;
constexpr unsigned FULL = 0xffffffffu;

// gradients whose descriptors G2 takes by value (ops/guard.py's
// param_cap): 24 KB of kernel arguments, which CUDA allows from 12.1
constexpr int PARAM_CAP = 1024;

struct Entry {
  long long dst;
  long long src;
  long long nbytes;
  long long first_chunk;
};

// a gradient: address, elements, its first chunk among all gradients'
// chunks, and GRAD_* flags (ops/guard.py's _grad_rows)
struct Grad {
  const void* p;
  long long n;
  int first_chunk;
  int flags;
};
constexpr int GRAD_BF16 = 1;     // bf16 elements (else f32)
constexpr int GRAD_ALIGNED = 2;  // _foreach_norm's vectorised path
constexpr int GRAD_VEC8 = 4;     // bf16 at an 8-byte aligned address

template <int CAP>
struct Grads {
  Grad d[CAP];
};
template <>
struct Grads<0> {};  // the descriptors come in a device table

// descriptor i: from the kernel argument (read through the constant
// cache) or, past PARAM_CAP gradients, from the device table
template <int CAP>
__device__ __forceinline__ Grad grad_at(const Grads<CAP>& g,
                                        const Grad* table, int i) {
  if constexpr (CAP == 0) {
    return table[i];
  } else {
    return g.d[i];
  }
}

// a ticket: the count before this arrival, with release order for this
// thread's writes before it and acquire order for its reads after (the
// warp's other lanes follow by __syncwarp)
__device__ __forceinline__ unsigned take_ticket(unsigned* p) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
               : "=r"(old) : "l"(p) : "memory");
  return old;
}

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
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long i = threadIdx.x; i < vecs; i += blockDim.x) d4[i] = s4[i];
    done = vecs << 4;
  }
  for (long long i = done + threadIdx.x; i < len; i += blockDim.x)
    dst[i] = src[i];
}

// vals += x * x, as the contracted `vals[ii] += next * next` rounds it
__device__ __forceinline__ float add_square(float acc, float x) {
  return __fmaf_rn(x, x, acc);
}

__device__ __forceinline__ float load1(const Grad& g, long long i) {
  if (g.flags & GRAD_BF16)
    return __bfloat162float(
        reinterpret_cast<const __nv_bfloat16*>(g.p)[i]);
  return __ldg(reinterpret_cast<const float*>(g.p) + i);
}

// elements 4 v .. 4 v + 3 (the vectorised path: 4 v + 3 < n)
__device__ __forceinline__ float4 load4(const Grad& g, long long v) {
  if (!(g.flags & GRAD_BF16))
    return __ldg(reinterpret_cast<const float4*>(g.p) + v);
  const __nv_bfloat16* p =
      reinterpret_cast<const __nv_bfloat16*>(g.p) + 4 * v;
  if (g.flags & GRAD_VEC8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    return make_float4(__low2float(a), __high2float(a), __low2float(b),
                       __high2float(b));
  }
  return make_float4(__bfloat162float(p[0]), __bfloat162float(p[1]),
                     __bfloat162float(p[2]), __bfloat162float(p[3]));
}

// the warp sum (lane 0) of warp `w` of the block _foreach_norm's
// LpNormFunctor runs for chunk `chunk` of gradient `g`
__device__ float unit_sum(const Grad& g, long long chunk, int w, int lane) {
  const long long start = chunk * NORM_CHUNK;
  const int lim = static_cast<int>(min(static_cast<long long>(NORM_CHUNK),
                                       g.n - start));
  const int t = w * 32 + lane;
  float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f;
  if (g.flags & GRAD_ALIGNED) {
    // thread t: float4 t + 512 k of the chunk, k = 0 .. 31 in turn
    constexpr int BATCH = 16;
    const long long base = start / 4;
    for (int k0 = 0; 4 * (t + NORM_BLOCK * k0) < lim; k0 += BATCH) {
      float4 r[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = t + NORM_BLOCK * (k0 + j);
        if (4 * i < lim) r[j] = load4(g, base + i);
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = t + NORM_BLOCK * (k0 + j);
        if (4 * i < lim) {
          v0 = add_square(v0, r[j].x);
          v1 = add_square(v1, r[j].y);
          v2 = add_square(v2, r[j].z);
          v3 = add_square(v3, r[j].w);
        }
      }
    }
  } else {
    // thread t: elements 2048 k + t + 512 i of the chunk into vals[i]
    constexpr int BATCH = 8;
    for (int k0 = 0; 2048 * k0 < lim; k0 += BATCH) {
      float r[BATCH][4];
#pragma unroll
      for (int j = 0; j < BATCH; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 2048 * (k0 + j) + t + NORM_BLOCK * i;
          r[j][i] = e < lim ? load1(g, start + e) : 0.0f;
        }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int e = 2048 * (k0 + j) + t;
        if (e < lim) v0 = add_square(v0, r[j][0]);
        if (e + NORM_BLOCK < lim) v1 = add_square(v1, r[j][1]);
        if (e + 2 * NORM_BLOCK < lim) v2 = add_square(v2, r[j][2]);
        if (e + 3 * NORM_BLOCK < lim) v3 = add_square(v3, r[j][3]);
      }
    }
  }
  float v = __fadd_rn(__fadd_rn(__fadd_rn(v0, v1), v2), v3);
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(FULL, v, off));
  return v;
}

// a chunk's partial from its 16 warp sums at `w`, in one lane:
// BlockReduceSum's warp 0 (lanes 16-31 zero, so their step adds nothing)
__device__ __forceinline__ float chunk_partial(const float* w) {
  float a[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) a[l] = __fadd_rn(__ldcg(w + l), __ldcg(w + l + 8));
#pragma unroll
  for (int l = 0; l < 4; ++l) a[l] = __fadd_rn(a[l], a[l + 4]);
  a[0] = __fadd_rn(a[0], a[2]);
  a[1] = __fadd_rn(a[1], a[3]);
  return __fadd_rn(a[0], a[1]);
}

// _foreach_norm's norm of one tensor of `chunks` chunks from its warp
// sums at `sums` (16 a chunk), by one warp (lane 0 returns it): the chunk
// partials, then the cleanup — thread t = 32 w + lane sums partials t,
// t + 512, ...; the warp sums go to lanes w of the last tree
__device__ float tensor_norm(const float* sums, int chunks, int lane) {
  float s = 0.0f;
  for (int w = 0; w < NORM_WARPS && 32 * w < chunks; ++w) {
    float v = 0.0f;
    for (int c = 32 * w + lane; c < chunks; c += NORM_BLOCK)
      v = __fadd_rn(v, chunk_partial(
          sums + static_cast<long long>(c) * NORM_WARPS));
    for (int off = 16; off > 0; off >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(FULL, v, off));
    v = __shfl_sync(FULL, v, 0);
    if (lane == w) s = v;
  }
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(FULL, s, off));
  return __fsqrt_rn(s);
}

__device__ __forceinline__ int last_pow2(int n) {
  int p = 1;
  while (p * 2 <= n) p *= 2;
  return p;
}

// vector_norm of the n norms at `x` (see above), by one warp, its
// block's threads played in turn by the lanes; lane 0 returns it. Each
// thread's loads go out before its sums. `sv` holds VNORM_MAX_BLOCK
// floats
__device__ float vector_norm(const float* x, int n, float* sv, int lane) {
  if (n == 0) return 0.0f;
  const bool vec = n >= VNORM_VEC_MIN;
  const int B = min(last_pow2(vec ? n / 4 : n), VNORM_MAX_BLOCK);
  for (int t = lane; t < B; t += 32) {
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float r[4];
    if (vec) {
      for (int v = t; 4 * v + 3 < n; v += B) {
#pragma unroll
        for (int i = 0; i < 4; ++i) r[i] = __ldcg(x + 4 * v + i);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = add_square(a[i], r[i]);
      }
      const int tail = (n & ~3) + t;
      if (tail < n) a[0] = add_square(a[0], __ldcg(x + tail));
    } else {
      int idx = t;
      for (; idx + 3 * B < n; idx += 4 * B) {
#pragma unroll
        for (int i = 0; i < 4; ++i) r[i] = __ldcg(x + idx + i * B);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = add_square(a[i], r[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = idx + i * B < n ? __ldcg(x + idx + i * B) : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (idx + i * B < n) a[i] = add_square(a[i], r[i]);
    }
    sv[t] = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
  }
  __syncwarp();
  for (int off = B / 2; off >= 32; off >>= 1) {
    for (int t = lane; t < off; t += 32)
      sv[t] = __fadd_rn(sv[t], sv[t + off]);
    __syncwarp();
  }
  const int width = min(B, 32);
  float v = lane < width ? sv[lane] : 0.0f;
  for (int off = width / 2; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(FULL, v, off));
  return __fsqrt_rn(v);
}

__device__ __forceinline__ float load_loss(const void* loss, int bf16) {
  return bf16 ? __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(loss))
              : *reinterpret_cast<const float*>(loss);
}

struct CheckArgs {
  const Grad* table;  // the descriptors past PARAM_CAP gradients
  int n_grads;        // -1: the global norm is given in *gnorm
  int units;          // 16 a chunk
  unsigned* tickets;  // warp sums taken, a gradient; then norms taken
  float* scratch;     // units warp sums (chunk c's partial then at 16 c),
                      // then n_grads norms
  const void* loss;
  int loss_bf16;
  float* gnorm;
  float* ewma;
  float* obs;
  long long* count;
  const long long* base;
  const float* table_rows;
  int rows;
  int n;
  float* row_out;
  int* flags_out;
  bool* bad_out;
  float* scale_out;
  int sentinel;
  float spike_factor;
  float grad_clip;
  int recover;
};

// the step's scalars as the launch found them (read before any unit's
// work, so the last warp need not wait for them; only it writes them)
struct Scalars {
  float loss, ewma, obs;
  long long count, base;
};

__device__ __forceinline__ Scalars read_scalars(const CheckArgs& a) {
  return Scalars{load_loss(a.loss, a.loss_bf16), *a.ewma, *a.obs, *a.count,
                 *a.base};
}

// the scalar chain in one thread, from the global norm g
__device__ void scalar_chain(float g, const Scalars& s, const CheckArgs& a) {
  const long long at = s.count - s.base;
  const bool inside = at >= 0 && at < a.rows;
  const bool finite_norm = finite(g);
  int flags = 0;
  if (a.sentinel) {
    const float e = s.ewma;
    const float c = s.obs;
    flags = anomaly_bits(s.loss, g, e, c, a.spike_factor);
    const bool anomalous = flags > 0;
    const float seeded =
        c > 0.0f ? __fadd_rn(__fmul_rn(0.9f, e), __fmul_rn(0.1f, g)) : g;
    *a.ewma = anomalous ? e : seeded;
    *a.obs = anomalous ? c : __fadd_rn(c, 1.0f);
  }
  if (a.grad_clip > 0.0f) {
    const float floor = fmaxf(g, 1e-16f);
    const float scale =
        finite_norm ? fminf(__fmul_rn(__frcp_rn(floor), a.grad_clip), 1.0f)
                    : 1.0f;
    *a.scale_out = scale;
    if (finite_norm && g > a.grad_clip) flags |= 8;
  }
  *a.flags_out = flags;
  const bool bad = a.recover && (flags & 7) > 0;
  *a.bad_out = bad;
  for (int i = 0; i < a.n; ++i)
    a.row_out[i] = inside ? a.table_rows[at * a.n + i]
                          : __int_as_float(0x7fc00000);
  *a.count = s.count + (a.recover ? (bad ? 0 : 1) : 1);
}

// the last step, by one warp: the norm of the norms (or the given norm)
// and the chain
__device__ void finish(const CheckArgs& a, const Scalars& s, float* sv,
                       int lane) {
  const float g = a.n_grads < 0
                      ? *a.gnorm
                      : vector_norm(a.scratch + a.units, a.n_grads, sv, lane);
  if (lane == 0) {
    if (a.n_grads >= 0) *a.gnorm = g;
    scalar_chain(g, s, a);
  }
}

template <int CAP>
__global__ void __launch_bounds__(CHECK_THREADS) guard_check_kernel(
    const __grid_constant__ Grads<CAP> grads,
    const __grid_constant__ CheckArgs a) {
  __shared__ float sv[VNORM_MAX_BLOCK];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Scalars s{};
  if (lane == 0) s = read_scalars(a);
  const int u = blockIdx.x * CHECK_WARPS + warp;
  if (u >= a.units) {
    // no gradient to read (none given, or the norm given): the block's
    // first warp finishes at once
    if (a.units == 0 && blockIdx.x == 0 && warp == 0) finish(a, s, sv, lane);
    return;
  }
  const int chunk = u / NORM_WARPS;
  int lo = 0, hi = a.n_grads - 1;  // the last gradient starting <= chunk
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (grad_at(grads, a.table, mid).first_chunk <= chunk) lo = mid;
    else hi = mid - 1;
  }
  const Grad g = grad_at(grads, a.table, lo);
  const float v = unit_sum(g, chunk - g.first_chunk, u % NORM_WARPS, lane);
  // the tensor's last warp sum takes its norm, the last norm the rest:
  // a ticket each, reset by the one that takes it last
  const int chunks = max(
      static_cast<int>((g.n + NORM_CHUNK - 1) / NORM_CHUNK), 1);
  unsigned last = 0;
  if (lane == 0) {
    a.scratch[u] = v;
    last = take_ticket(&a.tickets[lo]) ==
           static_cast<unsigned>(NORM_WARPS * chunks - 1);
  }
  if (!__shfl_sync(FULL, last, 0)) return;
  __syncwarp();
  const float norm = tensor_norm(
      a.scratch + static_cast<long long>(g.first_chunk) * NORM_WARPS, chunks,
      lane);
  if (lane == 0) {
    a.tickets[lo] = 0u;
    a.scratch[a.units + lo] = norm;
    unsigned* taken = &a.tickets[a.n_grads];
    last = take_ticket(taken) == static_cast<unsigned>(a.n_grads - 1);
    if (last) *taken = 0u;
  }
  if (!__shfl_sync(FULL, last, 0)) return;
  __syncwarp();
  finish(a, s, sv, lane);
}

template <int CAP>
cudaError_t launch_check(const Grad* host, int n_grads, const CheckArgs& a,
                         cudaStream_t stream) {
  Grads<CAP> grads;
  if constexpr (CAP > 0) {
    for (int i = 0; i < CAP; ++i)
      grads.d[i] = i < n_grads ? host[i] : Grad{nullptr, 0, 0, 0};
  }
  const int blocks = a.units > 0 ? (a.units + CHECK_WARPS - 1) / CHECK_WARPS
                                 : 1;
  guard_check_kernel<CAP><<<blocks, CHECK_THREADS, 0, stream>>>(grads, a);
  return cudaGetLastError();
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

int guard_param_cap() { return PARAM_CAP; }

// grads: n_grads host descriptors (ptr, elements, first chunk, flags), or
// with n_grads < 0 the global norm given in *gnorm; grad_table: their
// device copy, used past PARAM_CAP of them; tickets: n_grads + 1 zeros
// (left zero); scratch: units + n_grads floats
int guard_check(const void* grads, int n_grads, const void* grad_table,
                int units, unsigned* tickets, float* scratch,
                const void* loss, int loss_bf16, float* gnorm, float* ewma,
                float* obs, long long* count, const long long* base,
                const float* table, int rows, int n, float* row_out,
                int* flags_out, bool* bad_out, float* scale_out,
                int sentinel, float spike_factor, float grad_clip,
                int recover, cudaStream_t stream) {
  const Grad* host = static_cast<const Grad*>(grads);
  if ((n_grads > PARAM_CAP && grad_table == nullptr) ||
      (n_grads > 0 && tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CheckArgs a;
  a.table = n_grads > PARAM_CAP ? static_cast<const Grad*>(grad_table)
                                : nullptr;
  a.n_grads = n_grads;
  a.units = n_grads > 0 ? units : 0;
  a.tickets = tickets;
  a.scratch = scratch;
  a.loss = loss;
  a.loss_bf16 = loss_bf16;
  a.gnorm = gnorm;
  a.ewma = ewma;
  a.obs = obs;
  a.count = count;
  a.base = base;
  a.table_rows = table;
  a.rows = rows;
  a.n = n;
  a.row_out = row_out;
  a.flags_out = flags_out;
  a.bad_out = bad_out;
  a.scale_out = scale_out;
  a.sentinel = sentinel;
  a.spike_factor = spike_factor;
  a.grad_clip = grad_clip;
  a.recover = recover;
  const cudaError_t err =
      a.table != nullptr ? launch_check<0>(host, n_grads, a, stream)
                         : launch_check<PARAM_CAP>(host, n_grads, a, stream);
  return static_cast<int>(err);
}

int guard_commit(const void* entries, int n, long long chunks,
                 const bool* bad, int blocks, cudaStream_t stream) {
  if (n == 0 || chunks == 0) return 0;
  guard_commit_kernel<<<blocks, COMMIT_THREADS, 0, stream>>>(
      reinterpret_cast<const Entry*>(entries), n, chunks, bad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
