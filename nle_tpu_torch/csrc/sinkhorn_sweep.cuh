// The tiled Sinkhorn sweep shared by csrc/sinkhorn.cu (K13) and
// csrc/sinkhorn_ab.cu (K17/K18): one read of a row range of the factor
// through shared memory, forming
//   x = safe_recip(Q t, eps)     |w| >= eps -> 1/w, else 0
//   s = Q^T x                    the block's partial, a shared-memory row
// or x alone (K18's xonly); and the second pass that sums per-tile
// partials in a fixed order (also K3/K4/K14's and K15's).
//
// Layout: rows are staged in shared memory tr rows at a time with plain
// element loads. One warp per row forms w (lanes stride the columns, a
// fixed shuffle tree sums them), x goes to device memory and shared
// memory, then each thread adds x_r * Q[r, j] for the columns it owns
// (j = tid + k * SK_THREADS) into the block's s partial while the tile is
// still on chip. Each column is read and written by its one owning thread.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int SK_THREADS = 256;
constexpr int SK_MAX_TR = 32;         // rows staged per tile
constexpr int SK_SMEM_LIMIT = 200 * 1024;

// What a sweep computes: the half-step (K3/K4/K13/K14/K17), a K15 probe
// (csrc/sinkhorn.cu's bulk sweep), or K18's xonly (x, no s).
enum Mode { kHalfstep = 0, kDmaOnly = 1, kWOnly = 2, kWPart = 3, kXOnly = 4 };

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
// s_s[j] += x_r Q[r, j] (one thread per column); xonly forms no s. Every
// thread of the block calls it.
template <typename T, int kMode>
__device__ __forceinline__ void sweep_rows(const T* __restrict__ Q,
                                           const float* t_s, float* s_s,
                                           float* x_s, T* tile,
                                           float* __restrict__ x, int rbeg,
                                           int rend, int mpad, int tr,
                                           float eps) {
  static_assert(kMode == kHalfstep || kMode == kXOnly, "a tiled sweep");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr bool kSum = kMode == kHalfstep;
  for (int r0 = rbeg; r0 < rend; r0 += tr) {
    const int nr = min(tr, rend - r0);
    const T* src = Q + static_cast<size_t>(r0) * mpad;
    for (int e = tid; e < nr * mpad; e += SK_THREADS) tile[e] = src[e];
    __syncthreads();
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
        const float xv = fabsf(w) >= eps ? 1.0f / w : 0.0f;
        x_s[r] = operand<T>(xv);
        x[r0 + r] = xv;
      }
    }
    __syncthreads();
    if (kSum) {
      for (int j = tid; j < mpad; j += SK_THREADS) {
        float a = s_s[j];
        for (int r = 0; r < nr; ++r) {
          a = fmaf(x_s[r], to_f32(tile[r * mpad + j]), a);
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

// One block per tile of `rows` rows, its s partial to row blockIdx.x of
// the (ntiles, mpad) scratch: K13 and K17 (kHalfstep), and K18's xonly.
template <int kMode>
__global__ void __launch_bounds__(SK_THREADS)
    tiled_sweep_kernel(const float* __restrict__ Q,
                       const float* __restrict__ t, float* __restrict__ x,
                       float* __restrict__ partial, int mpad, int rows,
                       int tr, float eps) {
  extern __shared__ float smem[];
  float *t_s, *s_s, *x_s, *tile;
  carve(smem, mpad, t_s, s_s, x_s, tile);
  stage_vectors<float>(t, t_s, s_s, mpad);
  const int rbeg = blockIdx.x * rows;
  sweep_rows<float, kMode>(Q, t_s, s_s, x_s, tile, x, rbeg, rbeg + rows,
                           mpad, tr, eps);
  if (kMode == kHalfstep) {
    float* dst = partial + static_cast<size_t>(blockIdx.x) * mpad;
    for (int j = threadIdx.x; j < mpad; j += SK_THREADS) dst[j] = s_s[j];
  }
}

// The fixed-order second pass: part p (row p of an ld-strided scratch)
// goes to stripe p % kStripes in increasing p, then the stripes are added
// in order, plain fp32 adds, one thread per column. kStripes = 8 is the
// TPU kernels' (8, mpad) accumulator followed by jnp.sum over it (K13,
// K16, K18 vpu); kStripes = 1 is one accumulator in part order (K15, K17,
// K19). The launch writes the whole (out_rows, out_cols) output block:
// row 0, columns < len hold the sums, every other element is 0. The pass
// is bound by the latency of its loads, not their bytes (a few MB): one
// warp a block spreads the columns over many SMs, and each thread issues
// RED_BATCH loads ahead of their adds. A load waited on before the next is
// issued cost ~0.12-0.4 us a part on the H100 (0.12-0.39 ms over ~1000
// parts).
constexpr int RED_BATCH = 32;
constexpr int RED_THREADS = 32;

template <int kStripes>
__global__ void __launch_bounds__(RED_THREADS)
    ordered_reduce_kernel(const float* __restrict__ partial, int ld,
                          int nparts, int len, float* __restrict__ out,
                          int out_rows, int out_cols) {
  static_assert(RED_BATCH % kStripes == 0, "a batch holds whole stripes");
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= out_rows * out_cols) return;
  const int j = e % out_cols;
  float total = 0.0f;
  if (e < out_cols && j < len) {
    float acc[kStripes];
#pragma unroll
    for (int r = 0; r < kStripes; ++r) acc[r] = 0.0f;
    // i0 is a multiple of kStripes, so part i0 + b is in stripe b % kStripes.
    // The loads are unconditional (past the end they read the last part
    // again) so none waits on an add; only the adds are conditional.
    for (int i0 = 0; i0 < nparts; i0 += RED_BATCH) {
      float v[RED_BATCH];
#pragma unroll
      for (int b = 0; b < RED_BATCH; ++b) {
        const int i = min(i0 + b, nparts - 1);
        v[b] = partial[static_cast<size_t>(i) * ld + j];
      }
#pragma unroll
      for (int b = 0; b < RED_BATCH; ++b) {
        if (i0 + b < nparts) {
          acc[b % kStripes] = __fadd_rn(acc[b % kStripes], v[b]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kStripes; ++r) total = __fadd_rn(total, acc[r]);
  }
  out[e] = total;
}

// stripes: 1 or 8.
inline cudaError_t launch_ordered_reduce(const float* partial, int ld,
                                         int nparts, int len, int stripes,
                                         float* out, int out_rows,
                                         int out_cols, cudaStream_t st) {
  const int total = out_rows * out_cols;
  const int blocks = (total + RED_THREADS - 1) / RED_THREADS;
  if (stripes == 8) {
    ordered_reduce_kernel<8><<<blocks, RED_THREADS, 0, st>>>(
        partial, ld, nparts, len, out, out_rows, out_cols);
  } else if (stripes == 1) {
    ordered_reduce_kernel<1><<<blocks, RED_THREADS, 0, st>>>(
        partial, ld, nparts, len, out, out_rows, out_cols);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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

// Launch tiled_sweep_kernel<kMode> over npad / rows tiles.
template <int kMode>
cudaError_t launch_tiled(const float* Q, const float* t, float* x,
                         float* partial, int npad, int mpad, int rows,
                         float eps, cudaStream_t st) {
  if (mpad < 1 || npad < 1 || rows < 1 || npad % rows != 0) {
    return cudaErrorInvalidValue;
  }
  size_t smem = 0;
  const int tr = tile_rows<float>(mpad, &smem);
  if (tr < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tiled_sweep_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tiled_sweep_kernel<kMode><<<npad / rows, SK_THREADS, smem, st>>>(
      Q, t, x, partial, mpad, rows, tr, eps);
  return cudaGetLastError();
}

}  // namespace
