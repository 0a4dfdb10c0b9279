// The Sinkhorn half-step's A/B staging probes: the port of the four TPU
// experiments under tools/ that shaped `_kernel_manual` (K3/K4). None is on
// the package's own path; nle_tpu_torch/tools/bench_sk_{unroll,variants,
// 2stream}.py time them against K15's dmaonly floor and torch.mv. Each
// computes the TPU kernel's function, including where its partials are
// summed:
//   x = safe_recip(Q t, eps)     (npad,)   |w| >= eps -> 1/w, else 0
//   s = Q^T x                    (mpad,)   per-chunk/tile partials, summed
//                                          in the TPU kernel's order
//
// K16 replaces `_kernel_unroll` (tools/bench_sk_unroll.py:20, call :99):
// four VMEM slots, two chunks DMA'd ahead, two independent dot pairs per
// loop body; chunk a's partial to stripe a % 8, then jnp.sum over the 8
// stripes. Here: a persistent grid (one CTA per SM: the ring takes most of
// its shared memory) walks contiguous ranges of the TPU's chunks. Each
// chunk is cut into sub-tiles of R rows that go through a 4-slot
// shared-memory ring filled with cp.async (__pipeline_memcpy_async, 16 B a
// copy where the rows allow, commit / wait_prior): while one pair of
// sub-tiles is consumed, the next pair is in flight. A step consumes two
// sub-tiles with independent chains, the TPU body's two dot pairs: one
// warp forms w for a row of each, then each thread adds both sub-tiles'
// x_r Q[r, j] into two separate partial rows. At a chunk's end the two
// rows are added into the chunk's partial in an (nchunks, mpad) scratch,
// summed by stripe a % 8, then the stripes in order (K13's second pass).
// x is stored directly: Hopper needs no async write-back.
//
// K17 replaces `kernel_parts3d` (tools/bench_sk_variants.py:89, call :106)
// and serves `kernel_mxu_row0` (:55, call :133): one block per tile of
// `tile` rows (K13's first pass at rows = tile), its partial to
// (ntiles, mpad), then one accumulator over the tiles in index order
// (parts3d's jnp.sum over tiles; mxu_row0's row 0, in order). `kernel_mxu`
// (:18) is nle_tpu's `_kernel` and runs on K13 (csrc/sinkhorn.cu).
//
// K18 replaces `kernel_vpu` (:38) and `kernel_xonly` (:74, call :133). vpu
// forms each product rounded on its own (__fmul_rn, no contraction into an
// fma) and reduces as trees: w per row lane-strided sums then a shuffle
// tree, each column's partial a pairwise tree over each staged 32-row
// group, added to the column's running sum; tile i to stripe i % 8, then
// the stripes in order. xonly writes x and s = 0, forming no partial.
//
// K19 replaces the kernel of tools/bench_sk_2stream.py (:21, call :56), a
// pure staging probe: each chunk's rows are copied as nstreams concurrent
// DMAs, and row 0 of the (8, mpad) output is sum_i Q[i chunk, :]; t is
// unused. Here: a persistent grid walks the factor's R-row sub-tiles, each
// copied into a double-buffered ring as nstreams 1D bulk copies
// (cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes, one
// thread issues them, completion on the slot's mbarrier). The alignment
// rule of a bulk copy: 16-byte addresses and 16-byte sizes. A piece is
// whole rows, so mpad % 4 == 0 and a 16-byte aligned factor satisfy it
// (mpad 640 is 2,560 B a row); the wrapper refuses anything else. The
// first sub-tile of each chunk copies its row 0 from shared memory into a
// (nchunks, mpad) scratch; one accumulator adds them in chunk order,
// exactly the TPU probe's sum.
//
// Bound on the H100 (every kernel here): bytes. Each reads the whole f32
// factor once and writes x: at the tools' 1 MP shape (npad ~1.0 M, mpad
// 640) 2.6 GB, 0.77 ms at 3.35 TB/s. What the designs do about it: K16 and
// K19 keep 80 KB (K16: two 16-row sub-tiles; K19: one 32-row sub-tile)
// in flight per SM with no register or instruction cost for the copy;
// K17 and K18 keep K13's plain staging and change the tile (1024 or 2048
// rows) or the arithmetic.

#include <cuda_pipeline.h>

#include "common.cuh"
#include "sinkhorn_sweep.cuh"

namespace {

constexpr int AB_THREADS = 256;
constexpr int U_SLOTS = 4;             // K16's ring
constexpr int S_SLOTS = 2;             // K19's ring
constexpr int AB_STRIPES = 8;          // the TPU kernels' (8, mpad) s block
constexpr int AB_OUT_ROWS = 8;         // K19's (8, mpad) output
constexpr int AB_SMEM_MAX = 227 * 1024;

// -- K16 ----------------------------------------------------------------

// Copy n floats from src to dst with cp.async: 16 B a copy when both are
// 16-byte aligned and n % 4 == 0, else 4 B. Every thread takes a share.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int n, bool vec) {
  if (vec) {
    for (int e = threadIdx.x * 4; e < n; e += AB_THREADS * 4) {
      __pipeline_memcpy_async(dst + e, src + e, 16);
    }
  } else {
    for (int e = threadIdx.x; e < n; e += AB_THREADS) {
      __pipeline_memcpy_async(dst + e, src + e, 4);
    }
  }
}

struct UnrollShape {
  int mpad, chunk, R, nsub, steps_per_chunk, c0;
};

// Rows [r0, r0 + nr) of sub-tile k of the chunk of step j (k = 2 (j %
// steps_per_chunk) + half); nr = 0 when the sub-tile does not exist.
__device__ __forceinline__ int sub_tile(const UnrollShape& u, int j,
                                        int half, int* r0) {
  const int c = u.c0 + j / u.steps_per_chunk;
  const int k = 2 * (j % u.steps_per_chunk) + half;
  *r0 = c * u.chunk + k * u.R;
  if (k >= u.nsub) return 0;
  return min(u.R, u.chunk - k * u.R);
}

__device__ __forceinline__ void issue_step(const float* Q, float* ring,
                                           const UnrollShape& u, int j,
                                           bool vec) {
  const size_t slot = static_cast<size_t>(u.R) * u.mpad;
  for (int half = 0; half < 2; ++half) {
    int r0;
    const int nr = sub_tile(u, j, half, &r0);
    if (nr == 0) continue;
    copy_async(ring + ((2 * j + half) % U_SLOTS) * slot,
               Q + static_cast<size_t>(r0) * u.mpad, nr * u.mpad, vec);
  }
}

__global__ void __launch_bounds__(AB_THREADS)
    unroll_kernel(const float* __restrict__ Q, const float* __restrict__ t,
                  float* __restrict__ x, float* __restrict__ partial,
                  int npad, int mpad, int chunk, int R, float eps) {
  extern __shared__ __align__(16) float smem[];
  const size_t slot = static_cast<size_t>(R) * mpad;
  float* ring = smem;                              // U_SLOTS x (R, mpad)
  float* t_s = ring + U_SLOTS * slot;
  float* sa = t_s + mpad;                          // the two chains' s rows
  float* sb = sa + mpad;
  float* xa = sb + mpad;
  float* xb = xa + R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = tid; j < mpad; j += AB_THREADS) {
    t_s[j] = t[j];
    sa[j] = 0.0f;
    sb[j] = 0.0f;
  }
  const int nchunks = npad / chunk;
  UnrollShape u;
  u.mpad = mpad;
  u.chunk = chunk;
  u.R = R;
  u.nsub = (chunk + R - 1) / R;
  u.steps_per_chunk = (u.nsub + 1) / 2;
  u.c0 = static_cast<int>(static_cast<long long>(blockIdx.x) * nchunks /
                          gridDim.x);
  const int c1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) *
                                  nchunks / gridDim.x);
  const int nsteps = (c1 - u.c0) * u.steps_per_chunk;
  const bool vec = mpad % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(Q) % 16 == 0;
  if (nsteps > 0) issue_step(Q, ring, u, 0, vec);
  __pipeline_commit();
  for (int j = 0; j < nsteps; ++j) {
    // The next pair goes into the slots the step before last used; every
    // thread passed that step's closing barrier.
    if (j + 1 < nsteps) issue_step(Q, ring, u, j + 1, vec);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    int ra, rb;
    const int na = sub_tile(u, j, 0, &ra);
    const int nb = sub_tile(u, j, 1, &rb);
    const float* A = ring + ((2 * j) % U_SLOTS) * slot;
    const float* B = ring + ((2 * j + 1) % U_SLOTS) * slot;
    // w for a row of each sub-tile per warp: two independent chains.
    for (int r = warp; r < na; r += AB_THREADS / 32) {
      const bool hb = r < nb;
      float wa = 0.0f, wb = 0.0f;
      for (int c = lane; c < mpad; c += 32) {
        wa = fmaf(A[r * mpad + c], t_s[c], wa);
        if (hb) wb = fmaf(B[r * mpad + c], t_s[c], wb);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        wa += __shfl_xor_sync(0xffffffffu, wa, off);
        wb += __shfl_xor_sync(0xffffffffu, wb, off);
      }
      if (lane == 0) {
        const float va = fabsf(wa) >= eps ? 1.0f / wa : 0.0f;
        xa[r] = va;
        x[ra + r] = va;
        if (hb) {
          const float vb = fabsf(wb) >= eps ? 1.0f / wb : 0.0f;
          xb[r] = vb;
          x[rb + r] = vb;
        }
      }
    }
    __syncthreads();
    const bool last = j % u.steps_per_chunk == u.steps_per_chunk - 1;
    const int c = u.c0 + j / u.steps_per_chunk;
    for (int col = tid; col < mpad; col += AB_THREADS) {
      float a = sa[col], b = sb[col];
      int r = 0;
      for (; r < nb; ++r) {
        a = fmaf(xa[r], A[r * mpad + col], a);
        b = fmaf(xb[r], B[r * mpad + col], b);
      }
      for (; r < na; ++r) a = fmaf(xa[r], A[r * mpad + col], a);
      if (last) {
        partial[static_cast<size_t>(c) * mpad + col] = __fadd_rn(a, b);
        a = 0.0f;
        b = 0.0f;
      }
      sa[col] = a;
      sb[col] = b;
    }
    __syncthreads();
  }
}

// -- K17 / K18 ----------------------------------------------------------

// K18 vpu: K13's sweep with each product rounded on its own and the sums
// as trees. One warp per row for w; each thread owns its columns for s.
__device__ __forceinline__ void sweep_rows_vpu(const float* __restrict__ Q,
                                               const float* t_s, float* s_s,
                                               float* x_s, float* tile,
                                               float* __restrict__ x,
                                               int rbeg, int rend, int mpad,
                                               int tr, float eps) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int r0 = rbeg; r0 < rend; r0 += tr) {
    const int nr = min(tr, rend - r0);
    const float* src = Q + static_cast<size_t>(r0) * mpad;
    for (int e = tid; e < nr * mpad; e += SK_THREADS) tile[e] = src[e];
    __syncthreads();
    for (int r = warp; r < nr; r += SK_THREADS / 32) {
      const float* row = tile + r * mpad;
      float w = 0.0f;
      for (int c = lane; c < mpad; c += 32) {
        w = __fadd_rn(w, __fmul_rn(row[c], t_s[c]));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        w = __fadd_rn(w, __shfl_xor_sync(0xffffffffu, w, off));
      }
      if (lane == 0) {
        const float xv = fabsf(w) >= eps ? 1.0f / w : 0.0f;
        x_s[r] = xv;
        x[r0 + r] = xv;
      }
    }
    __syncthreads();
    for (int c = tid; c < mpad; c += SK_THREADS) {
      float v[SK_MAX_TR];
#pragma unroll
      for (int r = 0; r < SK_MAX_TR; ++r) {
        v[r] = r < nr ? __fmul_rn(x_s[r], tile[r * mpad + c]) : 0.0f;
      }
      // Every index constant after unrolling, so v stays in registers.
#pragma unroll
      for (int h = SK_MAX_TR / 2; h > 0; h >>= 1) {
#pragma unroll
        for (int r = 0; r < SK_MAX_TR / 2; ++r) {
          if (r < h) v[r] = __fadd_rn(v[r], v[r + h]);
        }
      }
      s_s[c] = __fadd_rn(s_s[c], v[0]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(SK_THREADS)
    vpu_tiled_kernel(const float* __restrict__ Q, const float* __restrict__ t,
                     float* __restrict__ x, float* __restrict__ partial,
                     int mpad, int rows, int tr, float eps) {
  extern __shared__ float smem[];
  float *t_s, *s_s, *x_s, *tile;
  carve(smem, mpad, t_s, s_s, x_s, tile);
  stage_vectors<float>(t, t_s, s_s, mpad);
  const int rbeg = blockIdx.x * rows;
  sweep_rows_vpu(Q, t_s, s_s, x_s, tile, x, rbeg, rbeg + rows, mpad, tr, eps);
  float* dst = partial + static_cast<size_t>(blockIdx.x) * mpad;
  for (int j = threadIdx.x; j < mpad; j += SK_THREADS) dst[j] = s_s[j];
}

// -- K19 ----------------------------------------------------------------

using nle::bulk_copy;
using nle::mbar_expect_tx;
using nle::mbar_init;
using nle::mbar_wait;

// Issue sub-tile g (rows [g R, g R + R)) into `slot` as nstreams pieces;
// one thread calls it.
__device__ __forceinline__ void issue_stream(const float* Q, float* ring,
                                             uint64_t* bars, int slot, int g,
                                             int R, int mpad, int nstreams) {
  const size_t tile = static_cast<size_t>(R) * mpad;
  const int piece = R / nstreams * mpad;        // floats
  mbar_expect_tx(&bars[slot], static_cast<uint32_t>(tile * sizeof(float)));
  const float* src = Q + static_cast<size_t>(g) * tile;
  float* dst = ring + slot * tile;
  for (int st = 0; st < nstreams; ++st) {
    bulk_copy(dst + st * piece, src + st * piece,
              static_cast<uint32_t>(piece * sizeof(float)), &bars[slot]);
  }
}

__global__ void __launch_bounds__(AB_THREADS)
    stream_kernel(const float* __restrict__ Q, float* __restrict__ partial,
                  int npad, int mpad, int chunk, int R, int nstreams) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* ring = reinterpret_cast<float*>(smem_raw + 128);
  const int ntiles = npad / R;
  const int per_chunk = chunk / R;
  const int g0 = static_cast<int>(static_cast<long long>(blockIdx.x) *
                                  ntiles / gridDim.x);
  const int g1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) *
                                  ntiles / gridDim.x);
  if (threadIdx.x == 0) {
    for (int b = 0; b < S_SLOTS; ++b) mbar_init(&bars[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && g0 < g1) {
    issue_stream(Q, ring, bars, 0, g0, R, mpad, nstreams);
  }
  const size_t tile = static_cast<size_t>(R) * mpad;
  for (int g = g0; g < g1; ++g) {
    const int i = g - g0;
    // The slot of g + 1 was last read in step i - 1, before its barrier.
    if (threadIdx.x == 0 && g + 1 < g1) {
      issue_stream(Q, ring, bars, (i + 1) % S_SLOTS, g + 1, R, mpad,
                   nstreams);
    }
    mbar_wait(&bars[i % S_SLOTS], (i / S_SLOTS) & 1);
    if (g % per_chunk == 0) {
      const float* row = ring + (i % S_SLOTS) * tile;
      float* dst = partial + static_cast<size_t>(g / per_chunk) * mpad;
      for (int j = threadIdx.x; j < mpad; j += AB_THREADS) dst[j] = row[j];
    }
    __syncthreads();
  }
}

// A persistent grid: every CTA the card holds at once at this shared
// memory, capped at `units` (one CTA per unit of work at most).
template <typename K>
cudaError_t persistent_grid(K kernel, size_t smem, int units, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      AB_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = sms * per_sm < units ? sms * per_sm : units;
  return cudaSuccess;
}

}  // namespace

// K16: Q (npad, mpad) float32 with npad a multiple of 2 chunk, t (mpad,)
// -> x (npad,), s (mpad,); `rows` is R, the ring's sub-tile rows (the
// wrapper's rule); partial is scratch of (npad / chunk) * mpad floats.
extern "C" int nle_ab_unroll(const float* Q, const float* t, float* x,
                             float* partial, float* s, int npad, int mpad,
                             int chunk, int rows, float eps, void* stream) {
  if (mpad < 1 || chunk < 1 || rows < 1 || npad < 2 * chunk ||
      npad % (2 * chunk) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) *
                      (U_SLOTS * static_cast<size_t>(rows) * mpad +
                       3 * static_cast<size_t>(mpad) + 2 * rows);
  if (smem > AB_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      unroll_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nchunks = npad / chunk;
  int grid = 0;
  err = persistent_grid(unroll_kernel, smem, nchunks, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unroll_kernel<<<grid, AB_THREADS, smem, st>>>(Q, t, x, partial, npad, mpad,
                                                chunk, rows, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ordered_reduce(
      partial, mpad, nchunks, mpad, AB_STRIPES, s, 1, mpad, st));
}

// K17 (variant 0: parts3d / mxu_row0) and K18 (1: vpu, 2: xonly): Q
// (npad, mpad) float32 with npad a multiple of `tile`; partial is scratch
// of (npad / tile) * mpad floats (unused by xonly, whose s is 0).
extern "C" int nle_ab_tiles(const float* Q, const float* t, float* x,
                            float* partial, float* s, int npad, int mpad,
                            int tile, int variant, float eps, void* stream) {
  if (mpad < 1 || npad < 1 || tile < 1 || npad % tile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = npad / tile;
  cudaError_t err;
  switch (variant) {
    case 0:
      err = launch_tiled<kHalfstep>(Q, t, x, partial, npad, mpad, tile, eps,
                                    st);
      if (err != cudaSuccess) return static_cast<int>(err);
      return static_cast<int>(launch_ordered_reduce(
          partial, mpad, ntiles, mpad, 1, s, 1, mpad, st));
    case 1: {
      size_t smem = 0;
      const int tr = tile_rows<float>(mpad, &smem);
      if (tr < 1) return static_cast<int>(cudaErrorInvalidValue);
      err = cudaFuncSetAttribute(vpu_tiled_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      vpu_tiled_kernel<<<ntiles, SK_THREADS, smem, st>>>(Q, t, x, partial,
                                                         mpad, tile, tr, eps);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      return static_cast<int>(launch_ordered_reduce(
          partial, mpad, ntiles, mpad, AB_STRIPES, s, 1, mpad, st));
    }
    case 2:
      err = launch_tiled<kXOnly>(Q, t, x, partial, npad, mpad, tile, eps, st);
      if (err != cudaSuccess) return static_cast<int>(err);
      // s = 0: the reduce over no parts writes zeros.
      return static_cast<int>(
          launch_ordered_reduce(partial, mpad, 0, mpad, 1, s, 1, mpad, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K19: Q (npad, mpad) float32, 16-byte aligned, mpad % 4 == 0, npad a
// multiple of chunk, chunk of `rows` (R, the ring's sub-tile) and R of
// nstreams -> out (8, mpad); partial is scratch of (npad / chunk) * mpad
// floats.
extern "C" int nle_ab_2stream(const float* Q, float* partial, float* out,
                              int npad, int mpad, int chunk, int rows,
                              int nstreams, void* stream) {
  if (mpad < 1 || mpad % 4 != 0 || rows < 1 || nstreams < 1 ||
      chunk % rows != 0 || rows % nstreams != 0 || npad % chunk != 0 ||
      reinterpret_cast<uintptr_t>(Q) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      128 + sizeof(float) * S_SLOTS * static_cast<size_t>(rows) * mpad;
  if (smem > AB_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0;
  err = persistent_grid(stream_kernel, smem, npad / rows, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  stream_kernel<<<grid, AB_THREADS, smem, st>>>(Q, partial, npad, mpad, chunk,
                                                rows, nstreams);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ordered_reduce(
      partial, mpad, npad / chunk, mpad, 1, out, AB_OUT_ROWS, mpad, st));
}
