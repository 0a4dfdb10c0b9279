// K3 and K4: the fused Sinkhorn half-step, one read of the factor per call.
//
// Replaces nle_tpu/ops/pallas/sinkhorn_kernel.py:121 `_kernel_manual` (via
// sinkhorn_halfstep_manual): K3 is its packed-int16 branch (:162-242), K4
// its f32 branch (:243-266) — here two instantiations of one template.
//   x = safe_recip(Q t, eps)     (npad,)   |w| >= eps -> 1/w, else 0
//   s = Q^T x                    (mpad,)
// Q is the per-column-scaled int16 copy of the rest block (K3) or the f32
// factor (K4); t and x are f32. K3 converts each int16 exactly to f32 and
// takes plain fp32 products. The TPU splits the integers and t/x into bf16
// pieces and drops the lo*lo term (~2^-17 relative); this port does not,
// so it agrees tightly with its own plain version and differs from the
// TPU arithmetic by that 2^-17 class.
//
// Layout: each block owns a fixed range of SK_ROWS_PER_BLOCK rows, staged
// in shared memory tr rows at a time. One warp per row forms w (lanes stride
// the columns, a fixed shuffle tree sums them), x goes to device memory and
// shared memory, then each thread adds x_r * Q[r, j] for the columns it owns
// (j = tid + k * SK_THREADS) into the block's s partial, a shared-memory row
// of mpad floats, while the tile is still on chip. The row takes any width
// (a dense sampling grid's nearly full rank reaches mpad 2176 at p = 2112);
// at the 1 MP main path's mpad 640 it also ran ~9% faster on the H100 than
// 8 register columns a thread did (PERF.md). The per-block partial s
// goes to an (nblocks, mpad) scratch and a second kernel sums it in block
// order: the TPU accumulates s across its sequential grid in VMEM, CUDA
// blocks run in no order, and float atomics would make training
// non-repeatable. A width
// whose one-row tile no longer fits the shared memory (past ~17,000 f32
// columns) is refused; the wrapper's MAX_MPAD is the port's one limit.
//
// Bound on the H100: at the 1 MP main path (npad ~ 1.0 M, mpad = 640) each
// half-step streams 1.3 GB (int16) or 2.6 GB (f32) for 2.6 GFLOP: memory-
// bound; the floor is ~0.4 ms (int16) / ~0.8 ms (f32) at 3.35 TB/s. This
// first version stages tiles with plain element loads (no cp.async/TMA
// pipelining yet), so it sits well above that floor.

#include "common.cuh"

namespace {

constexpr int SK_THREADS = 256;
constexpr int SK_ROWS_PER_BLOCK = 1024;
constexpr int SK_MAX_TR = 32;         // rows staged per tile
constexpr int SK_SMEM_LIMIT = 200 * 1024;

template <typename T>
__global__ void __launch_bounds__(SK_THREADS)
    halfstep_kernel(const T* __restrict__ Q, const float* __restrict__ t,
                    float* __restrict__ x, float* __restrict__ partial,
                    int npad, int mpad, int tr, float eps) {
  extern __shared__ float smem[];
  float* t_s = smem;                                   // (mpad,)
  float* s_s = smem + mpad;                            // (mpad,)
  float* x_s = s_s + mpad;                             // (SK_MAX_TR,)
  T* tile = reinterpret_cast<T*>(x_s + SK_MAX_TR);     // (tr, mpad)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = tid; j < mpad; j += SK_THREADS) {
    t_s[j] = t[j];
    s_s[j] = 0.0f;
  }
  const int rbeg = blockIdx.x * SK_ROWS_PER_BLOCK;
  const int rend = min(rbeg + SK_ROWS_PER_BLOCK, npad);
  __syncthreads();
  for (int r0 = rbeg; r0 < rend; r0 += tr) {
    const int nr = min(tr, rend - r0);
    const T* src = Q + static_cast<size_t>(r0) * mpad;
    for (int e = tid; e < nr * mpad; e += SK_THREADS) tile[e] = src[e];
    __syncthreads();
    for (int r = warp; r < nr; r += SK_THREADS / 32) {
      const T* row = tile + r * mpad;
      float w = 0.0f;
      for (int j = lane; j < mpad; j += 32) {
        w = fmaf(static_cast<float>(row[j]), t_s[j], w);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        w += __shfl_xor_sync(0xffffffffu, w, off);
      }
      if (lane == 0) {
        const float xv = fabsf(w) >= eps ? 1.0f / w : 0.0f;
        x_s[r] = xv;
        x[r0 + r] = xv;
      }
    }
    __syncthreads();
    // Each column is read and written by its one owning thread.
    for (int j = tid; j < mpad; j += SK_THREADS) {
      float a = s_s[j];
      for (int r = 0; r < nr; ++r) {
        a = fmaf(x_s[r], static_cast<float>(tile[r * mpad + j]), a);
      }
      s_s[j] = a;
    }
    __syncthreads();
  }
  float* dst = partial + static_cast<size_t>(blockIdx.x) * mpad;
  for (int j = tid; j < mpad; j += SK_THREADS) dst[j] = s_s[j];
}

template <typename T>
int launch_halfstep(const T* Q, const float* t, float* x, float* partial,
                    float* s, int npad, int mpad, float eps, void* stream) {
  if (mpad < 1 || npad < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t fixed = sizeof(float) * (2 * mpad + SK_MAX_TR);
  if (fixed + sizeof(T) * mpad > SK_SMEM_LIMIT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int tr = static_cast<int>((SK_SMEM_LIMIT - fixed) / (sizeof(T) * mpad));
  tr = tr > SK_MAX_TR ? SK_MAX_TR : tr;
  const size_t smem = fixed + sizeof(T) * static_cast<size_t>(tr) * mpad;
  cudaError_t err = cudaFuncSetAttribute(
      halfstep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblocks = (npad + SK_ROWS_PER_BLOCK - 1) / SK_ROWS_PER_BLOCK;
  halfstep_kernel<T><<<nblocks, SK_THREADS, smem, st>>>(Q, t, x, partial,
                                                       npad, mpad, tr, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      nle::launch_reduce_partials(partial, s, nblocks, mpad, st));
}

}  // namespace

// Number of partial rows the caller's scratch must hold for npad rows.
extern "C" int nle_sinkhorn_nblocks(int npad) {
  return (npad + SK_ROWS_PER_BLOCK - 1) / SK_ROWS_PER_BLOCK;
}

// Q (npad, mpad) int16, t (mpad,) -> x (npad,), s (mpad,); partial is
// scratch of nle_sinkhorn_nblocks(npad) * mpad floats.
extern "C" int nle_sinkhorn_halfstep_i16(const int16_t* Q, const float* t,
                                         float* x, float* partial, float* s,
                                         int npad, int mpad, float eps,
                                         void* stream) {
  return launch_halfstep<int16_t>(Q, t, x, partial, s, npad, mpad, eps,
                                  stream);
}

// Q (npad, mpad) float32; otherwise as above.
extern "C" int nle_sinkhorn_halfstep_f32(const float* Q, const float* t,
                                         float* x, float* partial, float* s,
                                         int npad, int mpad, float eps,
                                         void* stream) {
  return launch_halfstep<float>(Q, t, x, partial, s, npad, mpad, eps, stream);
}
