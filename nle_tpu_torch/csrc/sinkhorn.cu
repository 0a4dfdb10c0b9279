// The fused Sinkhorn half-step, one read of the factor per call, in its
// four forms, and the streaming probe beside it:
//   x = safe_recip(Q t, eps)     (npad,)   |w| >= eps -> 1/w, else 0
//   s = Q^T x                    (mpad,)
//
// K3, K4, K14 replace nle_tpu/ops/pallas/sinkhorn_kernel.py:121
// `_kernel_manual` (via sinkhorn_halfstep_manual, call :312): K3 is its
// packed-int16 branch (:162-242), K4 its f32 branch (:243-266), K14 the
// same f32 branch on a bf16 buffer (the NLE_SINKHORN_BF16 preview mode) —
// three instantiations of one template. K3 converts each int16 exactly to
// f32 and takes plain fp32 products. The TPU splits the integers and t/x
// into bf16 pieces and drops the lo*lo term (~2^-17 relative); this port
// does not, so it agrees tightly with its own plain version and differs
// from the TPU arithmetic by that 2^-17 class. K14 rounds t to bf16 before
// the product (the wrapper's t.astype(bf16), :305) and x to bf16 before
// s (x.astype(phi.dtype), :262); a bf16 x bf16 product is exact in fp32,
// so w and s are exact products summed in fp32, as the MXU's bf16 pass
// with f32 accumulation; x itself is written in f32. K14 is the one
// sanctioned bf16 kernel of the port: an opt-in preview mode, not
// golden-safe (nle_tpu documents rock2 at 24 dB against golden).
//
// K13 replaces `_kernel` (:45, via sinkhorn_halfstep_pallas, call :95),
// the block-pipelined f32 half-step behind NLE_SINKHORN_KERNEL=auto. Same
// function as K4; its decomposition is the TPU kernel's: one block per
// TILE_N row tile (the caller's tile rule), each tile's s partial to a
// (ntiles, mpad) scratch, then tile i added to stripe i % 8 in increasing
// i and the 8 stripes summed in order, plain fp32 — the `s_ref[i % 8] +=
// part` accumulator (:70-71) and the final jnp.sum(s_parts, 0).
//
// K15 replaces the probe kernel of tools/bench_sk_dmaonly.py:68 (`make`):
// K4's sweep over the f32 factor with parts of its work dropped, to
// attribute a half-step's time. dmaonly stages every tile in shared memory
// and touches only the rows r % 32 == 0 (s = their column sum) so the
// reads stay live; wonly forms w = Q t (written as x) and no s; wpart
// forms w and s = Q^T w. Its bytes are K4's: the floor of this staging.
//
// Layout (K3/K4/K14/K15): each block owns a fixed range of
// SK_ROWS_PER_BLOCK rows, staged in shared memory tr rows at a time. One
// warp per row forms w (lanes stride the columns, a fixed shuffle tree sums
// them), x goes to device memory and shared memory, then each thread adds
// x_r * Q[r, j] for the columns it owns (j = tid + k * SK_THREADS) into the
// block's s partial, a shared-memory row of mpad floats, while the tile is
// still on chip. The row takes any width (a dense sampling grid's nearly
// full rank reaches mpad 2176 at p = 2112); at the 1 MP main path's mpad
// 640 it also ran ~9% faster on the H100 than 8 register columns a thread
// did (PERF.md). The per-block partial s goes to an (nblocks, mpad)
// scratch and a second kernel sums it in block order, compensated: the TPU
// accumulates s across its sequential grid in VMEM, CUDA blocks run in no
// order, and float atomics would make training non-repeatable. A width
// whose one-row tile no longer fits the shared memory (past ~17,000 f32
// columns) is refused; the wrapper's MAX_MPAD is the port's one limit.
//
// Bound on the H100: at the 1 MP main path (npad ~ 1.0 M, mpad = 640) each
// half-step streams 1.3 GB (int16, bf16) or 2.6 GB (f32) for 2.6 GFLOP:
// memory-bound; the floor is ~0.4 ms (int16, bf16) / ~0.8 ms (f32) at
// 3.35 TB/s. This first version stages tiles with plain element loads (no
// cp.async/TMA pipelining yet), so it sits well above that floor; K15
// measures how far the staging alone does.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int SK_THREADS = 256;
constexpr int SK_ROWS_PER_BLOCK = 1024;
constexpr int SK_MAX_TR = 32;         // rows staged per tile
constexpr int SK_SMEM_LIMIT = 200 * 1024;
constexpr int K13_STRIPES = 8;        // the TPU kernel's (8, mpad) s block
constexpr int K15_TOUCH = 32;         // dmaonly touches rows r % 32 == 0

// What a sweep computes: the half-step (K3/K4/K13/K14) or a K15 probe.
enum Mode { kHalfstep = 0, kDmaOnly = 1, kWOnly = 2, kWPart = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int16_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The vector operand as the factor's type takes it: rounded to bf16
// (round to nearest even, as astype) for K14, unchanged otherwise.
template <typename T>
__device__ __forceinline__ float operand(float v) {
  return v;
}
template <>
__device__ __forceinline__ float operand<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Rows [rbeg, rend) of Q through shared memory, tr rows at a time: w per
// row (one warp), x to device memory and x_s, then the block's s partial
// s_s[j] += x_r Q[r, j] (one thread per column). kMode drops parts of the
// work for the K15 probes. Every thread of the block calls it.
template <typename T, int kMode>
__device__ __forceinline__ void sweep_rows(const T* __restrict__ Q,
                                           const float* t_s, float* s_s,
                                           float* x_s, T* tile,
                                           float* __restrict__ x, int rbeg,
                                           int rend, int mpad, int tr,
                                           float eps) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int r0 = rbeg; r0 < rend; r0 += tr) {
    const int nr = min(tr, rend - r0);
    const T* src = Q + static_cast<size_t>(r0) * mpad;
    for (int e = tid; e < nr * mpad; e += SK_THREADS) tile[e] = src[e];
    __syncthreads();
    if (kMode != kDmaOnly) {
      for (int r = warp; r < nr; r += SK_THREADS / 32) {
        const T* row = tile + r * mpad;
        float w = 0.0f;
        for (int j = lane; j < mpad; j += 32) {
          w = fmaf(to_f32(row[j]), t_s[j], w);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          w += __shfl_xor_sync(0xffffffffu, w, off);
        }
        if (lane == 0) {
          const float xv =
              kMode == kHalfstep ? (fabsf(w) >= eps ? 1.0f / w : 0.0f) : w;
          x_s[r] = operand<T>(xv);
          x[r0 + r] = xv;
        }
      }
      __syncthreads();
    }
    if (kMode != kWOnly) {
      // Each column is read and written by its one owning thread.
      for (int j = tid; j < mpad; j += SK_THREADS) {
        float a = s_s[j];
        if (kMode == kDmaOnly) {
          for (int r = (K15_TOUCH - r0 % K15_TOUCH) % K15_TOUCH; r < nr;
               r += K15_TOUCH) {
            a += to_f32(tile[r * mpad + j]);
          }
        } else {
          for (int r = 0; r < nr; ++r) {
            a = fmaf(x_s[r], to_f32(tile[r * mpad + j]), a);
          }
        }
        s_s[j] = a;
      }
    }
    __syncthreads();
  }
}

// Shared memory of one block: t and s rows, x_s, and the (tr, mpad) tile.
template <typename T>
__device__ __forceinline__ void carve(float* smem, int mpad, float*& t_s,
                                      float*& s_s, float*& x_s, T*& tile) {
  t_s = smem;
  s_s = smem + mpad;
  x_s = s_s + mpad;
  tile = reinterpret_cast<T*>(x_s + SK_MAX_TR);
}

template <typename T>
__device__ __forceinline__ void stage_vectors(const float* __restrict__ t,
                                              float* t_s, float* s_s,
                                              int mpad) {
  for (int j = threadIdx.x; j < mpad; j += SK_THREADS) {
    t_s[j] = operand<T>(t[j]);
    s_s[j] = 0.0f;
  }
  __syncthreads();
}

// K3/K4/K14 (kHalfstep) and K15: SK_ROWS_PER_BLOCK rows per block.
template <typename T, int kMode>
__global__ void __launch_bounds__(SK_THREADS)
    halfstep_kernel(const T* __restrict__ Q, const float* __restrict__ t,
                    float* __restrict__ x, float* __restrict__ partial,
                    int npad, int mpad, int tr, float eps) {
  extern __shared__ float smem[];
  float *t_s, *s_s, *x_s;
  T* tile;
  carve(smem, mpad, t_s, s_s, x_s, tile);
  stage_vectors<T>(t, t_s, s_s, mpad);
  const int rbeg = blockIdx.x * SK_ROWS_PER_BLOCK;
  const int rend = min(rbeg + SK_ROWS_PER_BLOCK, npad);
  sweep_rows<T, kMode>(Q, t_s, s_s, x_s, tile, x, rbeg, rend, mpad, tr, eps);
  float* dst = partial + static_cast<size_t>(blockIdx.x) * mpad;
  for (int j = threadIdx.x; j < mpad; j += SK_THREADS) dst[j] = s_s[j];
}

// K13: one block per TPU row tile of `rows` rows, its partial to row
// blockIdx.x of the (ntiles, mpad) scratch.
__global__ void __launch_bounds__(SK_THREADS)
    tiled_halfstep_kernel(const float* __restrict__ Q,
                          const float* __restrict__ t, float* __restrict__ x,
                          float* __restrict__ partial, int mpad, int rows,
                          int tr, float eps) {
  extern __shared__ float smem[];
  float *t_s, *s_s, *x_s, *tile;
  carve(smem, mpad, t_s, s_s, x_s, tile);
  stage_vectors<float>(t, t_s, s_s, mpad);
  const int rbeg = blockIdx.x * rows;
  sweep_rows<float, kHalfstep>(Q, t_s, s_s, x_s, tile, x, rbeg, rbeg + rows,
                               mpad, tr, eps);
  float* dst = partial + static_cast<size_t>(blockIdx.x) * mpad;
  for (int j = threadIdx.x; j < mpad; j += SK_THREADS) dst[j] = s_s[j];
}

// K13's s: tile i into stripe i % 8 in increasing i, then the stripes in
// order, plain fp32 adds, one thread per column.
__global__ void stripe_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ s, int ntiles,
                                     int len) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= len) return;
  float total = 0.0f;
  for (int r = 0; r < K13_STRIPES; ++r) {
    float stripe = 0.0f;
    for (int i = r; i < ntiles; i += K13_STRIPES) {
      stripe = __fadd_rn(stripe, partial[static_cast<size_t>(i) * len + j]);
    }
    total = __fadd_rn(total, stripe);
  }
  s[j] = total;
}

// Rows of the shared-memory tile for an mpad-wide factor of T, and the
// block's shared-memory bytes; 0 rows when one row does not fit.
template <typename T>
int tile_rows(int mpad, size_t* smem) {
  const size_t fixed = sizeof(float) * (2 * static_cast<size_t>(mpad) +
                                        SK_MAX_TR);
  if (fixed + sizeof(T) * mpad > SK_SMEM_LIMIT) return 0;
  int tr = static_cast<int>((SK_SMEM_LIMIT - fixed) / (sizeof(T) * mpad));
  tr = tr > SK_MAX_TR ? SK_MAX_TR : tr;
  *smem = fixed + sizeof(T) * static_cast<size_t>(tr) * mpad;
  return tr;
}

template <typename T, int kMode>
int launch_halfstep(const T* Q, const float* t, float* x, float* partial,
                    float* s, int npad, int mpad, float eps, void* stream) {
  if (mpad < 1 || npad < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem = 0;
  const int tr = tile_rows<T>(mpad, &smem);
  if (tr < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      halfstep_kernel<T, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblocks = (npad + SK_ROWS_PER_BLOCK - 1) / SK_ROWS_PER_BLOCK;
  halfstep_kernel<T, kMode><<<nblocks, SK_THREADS, smem, st>>>(
      Q, t, x, partial, npad, mpad, tr, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      nle::launch_reduce_partials(partial, s, nblocks, mpad, st));
}

}  // namespace

// Number of partial rows the caller's scratch must hold for npad rows
// (K3, K4, K14, K15).
extern "C" int nle_sinkhorn_nblocks(int npad) {
  return (npad + SK_ROWS_PER_BLOCK - 1) / SK_ROWS_PER_BLOCK;
}

// K3: Q (npad, mpad) int16, t (mpad,) -> x (npad,), s (mpad,); partial is
// scratch of nle_sinkhorn_nblocks(npad) * mpad floats.
extern "C" int nle_sinkhorn_halfstep_i16(const int16_t* Q, const float* t,
                                         float* x, float* partial, float* s,
                                         int npad, int mpad, float eps,
                                         void* stream) {
  return launch_halfstep<int16_t, kHalfstep>(Q, t, x, partial, s, npad, mpad,
                                             eps, stream);
}

// K4: Q (npad, mpad) float32; otherwise as above.
extern "C" int nle_sinkhorn_halfstep_f32(const float* Q, const float* t,
                                         float* x, float* partial, float* s,
                                         int npad, int mpad, float eps,
                                         void* stream) {
  return launch_halfstep<float, kHalfstep>(Q, t, x, partial, s, npad, mpad,
                                           eps, stream);
}

// K14: Q (npad, mpad) bfloat16, t float32 (rounded to bf16 in the kernel);
// x and s float32; otherwise as above.
extern "C" int nle_sinkhorn_halfstep_bf16(const void* Q, const float* t,
                                          float* x, float* partial, float* s,
                                          int npad, int mpad, float eps,
                                          void* stream) {
  return launch_halfstep<__nv_bfloat16, kHalfstep>(
      static_cast<const __nv_bfloat16*>(Q), t, x, partial, s, npad, mpad,
      eps, stream);
}

// K13: Q (npad, mpad) float32 with npad a multiple of `rows`, the row tile;
// partial is scratch of (npad / rows) * mpad floats.
extern "C" int nle_sinkhorn_tiled_f32(const float* Q, const float* t,
                                      float* x, float* partial, float* s,
                                      int npad, int mpad, int rows, float eps,
                                      void* stream) {
  if (mpad < 1 || npad < 1 || rows < 1 || npad % rows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem = 0;
  const int tr = tile_rows<float>(mpad, &smem);
  if (tr < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      tiled_halfstep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = npad / rows;
  tiled_halfstep_kernel<<<ntiles, SK_THREADS, smem, st>>>(Q, t, x, partial,
                                                          mpad, rows, tr, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  stripe_reduce_kernel<<<(mpad + threads - 1) / threads, threads, 0, st>>>(
      partial, s, ntiles, mpad);
  return static_cast<int>(cudaGetLastError());
}

// K15: mode 1 dmaonly (s = the column sum of rows r % 32 == 0; x not
// written), 2 wonly (x = Q t; s = 0), 3 wpart (x = Q t, s = Q^T x); Q
// float32, buffers as for K4.
extern "C" int nle_sinkhorn_probe_f32(const float* Q, const float* t,
                                      float* x, float* partial, float* s,
                                      int npad, int mpad, int mode,
                                      void* stream) {
  switch (mode) {
    case kDmaOnly:
      return launch_halfstep<float, kDmaOnly>(Q, t, x, partial, s, npad, mpad,
                                              0.0f, stream);
    case kWOnly:
      return launch_halfstep<float, kWOnly>(Q, t, x, partial, s, npad, mpad,
                                            0.0f, stream);
    case kWPart:
      return launch_halfstep<float, kWPart>(Q, t, x, partial, s, npad, mpad,
                                            0.0f, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
