// The fused Sinkhorn half-step, one read of the factor per call, in its
// four forms, and the streaming probe beside it:
//   x = safe_recip(Q t, eps)     (npad,)   |w| >= eps -> 1/w, else 0
//   s = Q^T x                    (mpad,)
// The sweep they share is csrc/sinkhorn_sweep.cuh.
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
// K15 replaces the probe kernel of tools/bench_sk_dmaonly.py:68 (`make`)
// and returns what it returns: an (8, max(mpad, chunk)) block whose row 0
// holds, over the probe's chunks of `chunk` rows added in order, dmaonly
// sum_i Q[i chunk, :]; wonly the chunk-folded w, sum_c w_c[:L] with L =
// min(1024, chunk) (the probe's s[0, :1024] += w[:, :1024]); wpart
// sum_c w_c^T Q_c. Every other element is 0. It runs K13's tiled sweep
// with one block per chunk (the probe's unit of staging and of summation),
// each block's partial to a (nchunks, mpad) scratch, then one accumulator
// in chunk order, which is the probe's own order: dmaonly is exact against
// it. dmaonly stages every row and adds only the rows whose global index
// is a multiple of chunk, a runtime value, so every byte stays loaded; the
// probe's NSLOTS ring has no counterpart here (plain loads, no ring; K16
// and K19 in csrc/sinkhorn_ab.cu carry the async staging).
//
// Layout (K3/K4/K14): each block owns a fixed range of
// SK_ROWS_PER_BLOCK rows, staged in shared memory tr rows at a time by the
// shared sweep. The block's s partial is a shared-memory row of mpad
// floats: it takes any width (a dense sampling grid's nearly full rank
// reaches mpad 2176 at p = 2112); at the 1 MP main path's mpad 640 it also
// ran ~9% faster on the H100 than 8 register columns a thread did
// (PERF.md). The per-block partial s goes to an (nblocks, mpad) scratch
// and a second kernel sums it in block order, compensated: the TPU
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

#include "common.cuh"
#include "sinkhorn_sweep.cuh"

namespace {

constexpr int SK_ROWS_PER_BLOCK = 1024;
constexpr int K13_STRIPES = 8;        // the TPU kernel's (8, mpad) s block
constexpr int K15_OUT_ROWS = 8;       // the TPU probe's (8, width) output
constexpr int K15_WONLY_COLS = 1024;  // the probe's s[0, :1024] += w[:1024]

// K3/K4/K14: SK_ROWS_PER_BLOCK rows per block.
template <typename T>
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
  sweep_rows<T, kHalfstep>(Q, t_s, s_s, x_s, tile, x, rbeg, rend, mpad, tr,
                           eps, 1);
  float* dst = partial + static_cast<size_t>(blockIdx.x) * mpad;
  for (int j = threadIdx.x; j < mpad; j += SK_THREADS) dst[j] = s_s[j];
}

template <typename T>
int launch_halfstep(const T* Q, const float* t, float* x, float* partial,
                    float* s, int npad, int mpad, float eps, void* stream) {
  if (mpad < 1 || npad < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t smem = 0;
  const int tr = tile_rows<T>(mpad, &smem);
  if (tr < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      halfstep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblocks = (npad + SK_ROWS_PER_BLOCK - 1) / SK_ROWS_PER_BLOCK;
  halfstep_kernel<T><<<nblocks, SK_THREADS, smem, st>>>(
      Q, t, x, partial, npad, mpad, tr, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      nle::launch_reduce_partials(partial, s, nblocks, mpad, st));
}

}  // namespace

// Number of partial rows the caller's scratch must hold for npad rows
// (K3, K4, K14).
extern "C" int nle_sinkhorn_nblocks(int npad) {
  return (npad + SK_ROWS_PER_BLOCK - 1) / SK_ROWS_PER_BLOCK;
}

// K3: Q (npad, mpad) int16, t (mpad,) -> x (npad,), s (mpad,); partial is
// scratch of nle_sinkhorn_nblocks(npad) * mpad floats.
extern "C" int nle_sinkhorn_halfstep_i16(const int16_t* Q, const float* t,
                                         float* x, float* partial, float* s,
                                         int npad, int mpad, float eps,
                                         void* stream) {
  return launch_halfstep<int16_t>(Q, t, x, partial, s, npad, mpad,
                                             eps, stream);
}

// K4: Q (npad, mpad) float32; otherwise as above.
extern "C" int nle_sinkhorn_halfstep_f32(const float* Q, const float* t,
                                         float* x, float* partial, float* s,
                                         int npad, int mpad, float eps,
                                         void* stream) {
  return launch_halfstep<float>(Q, t, x, partial, s, npad, mpad,
                                           eps, stream);
}

// K14: Q (npad, mpad) bfloat16, t float32 (rounded to bf16 in the kernel);
// x and s float32; otherwise as above.
extern "C" int nle_sinkhorn_halfstep_bf16(const void* Q, const float* t,
                                          float* x, float* partial, float* s,
                                          int npad, int mpad, float eps,
                                          void* stream) {
  return launch_halfstep<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(Q), t, x, partial, s, npad, mpad,
      eps, stream);
}

// K13: Q (npad, mpad) float32 with npad a multiple of `rows`, the row tile;
// partial is scratch of (npad / rows) * mpad floats.
extern "C" int nle_sinkhorn_tiled_f32(const float* Q, const float* t,
                                      float* x, float* partial, float* s,
                                      int npad, int mpad, int rows, float eps,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_tiled<kHalfstep>(Q, t, x, partial, npad, mpad,
                                            rows, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ordered_reduce(
      partial, mpad, npad / rows, mpad, K13_STRIPES, s, 1, mpad, st));
}

// K15: the TPU probe's (8, max(mpad, chunk)) output `out` for mode 1
// dmaonly (row 0 = sum_i Q[i * chunk, :]), 2 wonly (row 0, columns < L =
// min(1024, chunk): sum_c w_c[:L], w_c = Q_c t) or 3 wpart (row 0 =
// sum_c w_c^T Q_c), the chunks added in order; every other element 0. Q
// float32 with npad a multiple of chunk; x (npad,) holds w (wonly, wpart);
// partial is scratch of (npad / chunk) * mpad floats. wonly needs
// min(1024, max(mpad, chunk)) == L, as the TPU probe traces only then.
extern "C" int nle_sinkhorn_probe_f32(const float* Q, const float* t,
                                      float* x, float* partial, float* out,
                                      int npad, int mpad, int chunk, int mode,
                                      void* stream) {
  if (chunk < 1 || npad % chunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int width = mpad > chunk ? mpad : chunk;
  const int fold = chunk < K15_WONLY_COLS ? chunk : K15_WONLY_COLS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case kDmaOnly:
      err = launch_tiled<kDmaOnly>(Q, t, x, partial, npad, mpad, chunk, 0.0f,
                                   st);
      break;
    case kWOnly:
      if ((width < K15_WONLY_COLS ? width : K15_WONLY_COLS) != fold) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      err = launch_tiled<kWOnly>(Q, t, x, partial, npad, mpad, chunk, 0.0f,
                                 st);
      if (err != cudaSuccess) return static_cast<int>(err);
      // w viewed as (npad / chunk, chunk): the first L entries of each
      // chunk, added in chunk order.
      return static_cast<int>(launch_ordered_reduce(
          x, chunk, npad / chunk, fold, 1, out, K15_OUT_ROWS, width, st));
    case kWPart:
      err = launch_tiled<kWPart>(Q, t, x, partial, npad, mpad, chunk, 0.0f,
                                 st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ordered_reduce(
      partial, mpad, npad / chunk, mpad, 1, out, K15_OUT_ROWS, width, st));
}
