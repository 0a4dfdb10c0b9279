// K8, K10, K11 and K12: the phi-free (streaming) stage-2 kernels. Every
// pass recomputes the (rows, p) affinity between rest pixels and samples
// from the raw (3, qpad) / (3, ppad) feature rows with nle::affinity, the
// same entry K1 stores in phi, so no (N, m) array ever exists.
//
// K8 replaces nle_tpu/ops/pallas/streaming_kernel.py:105 `_halfstep_kernel`
// (call :163):  x = mask * safe_recip(K^T u, eps),  ap = K x   (one sweep,
// ppad <= 1792); with unit_x, x = mask (the s0 = phi^T 1 pass).
// K9 replaces :189 `_halfstep_ptiled_kernel` (call :263): K8's function at
// any ppad, in two passes (below).
// K10 replaces :299 `_ap_kernel` (call :345):  ap (R, ppad) = K x, x (R, qpad).
// K11 replaces :369 `_atb_kernel` (call :411):  out (R, qpad) = K^T b.
// K12 replaces :453 `_gram_kernel` (call :492), and past the TPU's VMEM
// limit `streaming_scaled_gram_xla` (:512):
//   Sb = (c phi_rest)^T (c phi_rest),  phi_rest = K^T Uinv.
// Here K is (qpad pixels, ppad samples), stored nowhere. K9-K12 take any
// ppad (a dense sampling grid: p = 48 x 44 = 2112 samples gives ppad 2176).
//
// Bound on the H100: K8, K10 and K11 do O(1) work per affinity entry — the
// IEEE expf and a dozen rounded adds and multiplies — against 16 B of
// features per pixel, so they are bound by instruction issue on the CUDA
// cores, not by bytes. Each keeps its sample-side operands on chip (the
// thread's own sample columns in registers, or the sample rows in shared
// memory), reads each pixel's features once per pass, and builds every
// entry exactly once per pass. K12 is fp32 FMA work (the phi build,
// 2 q p mpad, plus the gram, q mpad^2), compute-bound like K1 and K6.
//
// K9, dense sampling grids: K8 holds a thread's ST_MAXC sample columns in
// registers and a (tr, ppad) affinity tile in shared memory, both bounded
// by ppad. K9 builds each entry twice instead (2 expf per entry, as the
// TPU's two-pass kernel): pass 1 is K11's kernel with b = u, one thread
// per pixel row summing w over the samples staged through shared memory in
// chunks, with x = mask * safe_recip(w) as its epilogue; pass 2 is K10 on
// that x. Neither pass holds more than a chunk of samples on chip.
//
// Cross-block sums (K8's, K9's and K10's ap, K12's Sb) never use float atomics:
// a bounded number of blocks each own a fixed contiguous row range and
// write a partial, and a second kernel sums the partials in block order,
// so training stays bitwise repeatable. The TPU carries these sums across
// its sequential grid in VMEM, which CUDA blocks cannot do.
//
// Long fp32 chains are compensated (nle::kahan_add): the sums over rows
// (K10's group partials, every kernel's block partials) and over samples
// (K9 pass 1, K11). The streaming route turns ap into
// u = Uinv (lambda * Uinv^T ap) with eigenvalues down to 1e-10, so a
// chain's rounding reaches the Sinkhorn vectors amplified: plain chains
// put the card's c 3x further from float64 than the plain version's cuBLAS
// sums do, compensated ones 5.6x closer (PERF.md).

#include "common.cuh"

namespace {

constexpr int ST_THREADS = 256;
constexpr int ST_MAXC = 7;                          // sample columns per thread
constexpr int ST_MAX_PPAD = ST_THREADS * ST_MAXC;   // 1792: K8's regime, K10's p-tile
// K9-pass-1/K11 samples staged in shared memory at a time: (3 + R) * 2048
// floats is 48 KB at R = 3.
constexpr int ST_ATB_CHUNK = 2048;
constexpr int ST_MAX_TR = 32;                       // K8 rows per shared tile
// K8's shared tile: ~44 KB and at least 128 threads a block were the
// fastest of the tile sizes and block widths tried on the H100 at p = 600:
// more, smaller blocks per SM hide the latency of the tile's three phases.
constexpr int K8_SMEM_TARGET = 44 * 1024;
constexpr int K8_MIN_THREADS = 128;
// Blocks of K8/K10: at most 8 per SM of a 132-SM card, each walking a
// contiguous range of whole 32-row groups. A function of qpad alone, so the
// partial sums (and their order) do not depend on the card.
constexpr int ST_MAX_BLOCKS = 1056;
constexpr int ST_ROW_GRAIN = 32;

inline int rows_per_block(int qpad) {
  int per = (qpad + ST_MAX_BLOCKS - 1) / ST_MAX_BLOCKS;
  per = (per + ST_ROW_GRAIN - 1) / ST_ROW_GRAIN * ST_ROW_GRAIN;
  return per < ST_ROW_GRAIN ? ST_ROW_GRAIN : per;
}

inline int ap_blocks(int qpad) {
  const int per = rows_per_block(qpad);
  return (qpad + per - 1) / per;
}

// The thread's sample columns j = j0 + tid + c * blockDim.x, c < ST_MAXC,
// with their features in registers (zero from jend on; those columns are
// never read back).
struct SampleCols {
  float r[ST_MAXC], c[ST_MAXC], y[ST_MAXC];
  __device__ __forceinline__ void load(const float* fa, int ppad, int j0,
                                       int jend) {
#pragma unroll
    for (int k = 0; k < ST_MAXC; ++k) {
      const int j = j0 + threadIdx.x + k * blockDim.x;
      const bool in = j < jend;
      r[k] = in ? fa[j] : 0.0f;
      c[k] = in ? fa[ppad + j] : 0.0f;
      y[k] = in ? fa[2 * ppad + j] : 0.0f;
    }
  }
};

// K10, K8's unit_x pass (R = 1, x = mask) and K9's pass 2 (R = 1):
// ap[k, j] = sum_i x[k, i] K[i, j] over this block's rows, into
// partial[blockIdx.x, k, j]. Block (x, y) owns a row range and the p-tile
// of ptile samples from y * ptile (one tile, the whole ppad, up to 1792).
// Each thread owns its sample columns and walks the rows in increasing
// order; a row whose x entries are all zero (the pad rows) adds exact zeros
// and is skipped. The sum is two-level, each 32-row group's fp32 chain
// added to the block's with compensation (kahan_add): a block owns ~4,000
// rows at 4 MP and ~30,000 at 32 MP, and the streaming route divides ap's
// rounding by eigenvalues down to 1e-10 (PERF.md). A column's sum
// does not depend on the tiling of the samples.
template <int R>
__global__ void __launch_bounds__(ST_THREADS)
    stream_ap_kernel(const float* __restrict__ fb, const float* __restrict__ fa,
                     const float* __restrict__ X, float* __restrict__ partial,
                     int qpad, int ppad, int ptile, int per_block, float sw,
                     float pw) {
  const int j0 = blockIdx.y * ptile;
  // Columns of this tile: the thread's column c is live while
  // tid + c * blockDim.x < ntile, the same test as with one tile.
  const int ntile = min(ptile, ppad - j0);
  SampleCols s;
  s.load(fa, ppad, j0, j0 + ntile);
  float acc[R][ST_MAXC], comp[R][ST_MAXC];
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int c = 0; c < ST_MAXC; ++c) acc[k][c] = comp[k][c] = 0.0f;
  const int rbeg = blockIdx.x * per_block;
  const int rend = min(rbeg + per_block, qpad);
  for (int g = rbeg; g < rend; g += ST_ROW_GRAIN) {
    float part[R][ST_MAXC];
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int c = 0; c < ST_MAXC; ++c) part[k][c] = 0.0f;
    for (int i = g; i < g + ST_ROW_GRAIN; ++i) {
      float xv[R];
      bool live = false;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        xv[k] = X[static_cast<size_t>(k) * qpad + i];
        live |= xv[k] != 0.0f;
      }
      if (!live) continue;  // block-uniform
      const float br = fb[i], bc = fb[qpad + i], by = fb[2 * qpad + i];
#pragma unroll
      for (int c = 0; c < ST_MAXC; ++c) {
        if (threadIdx.x + c * blockDim.x < ntile) {
          const float a =
              nle::affinity(br, bc, by, s.r[c], s.c[c], s.y[c], sw, pw);
#pragma unroll
          for (int k = 0; k < R; ++k) part[k][c] = fmaf(xv[k], a, part[k][c]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int c = 0; c < ST_MAXC; ++c) nle::kahan_add(acc[k][c], comp[k][c], part[k][c]);
  }
  float* dst = partial + static_cast<size_t>(blockIdx.x) * R * ppad + j0;
#pragma unroll
  for (int c = 0; c < ST_MAXC; ++c) {
    const int j = threadIdx.x + c * blockDim.x;
    if (j < ntile) {
#pragma unroll
      for (int k = 0; k < R; ++k) dst[k * ppad + j] = __fsub_rn(acc[k][c], comp[k][c]);
    }
  }
}

// K8 proper: the row's w needs the whole affinity row before x exists, and
// ap needs x, so each tile of tr rows is built once into shared memory
// (one expf per entry per half-step, as on the TPU), then read twice:
// one warp per row forms w (lanes stride the samples, a fixed shuffle tree
// sums them), and each thread adds x_i K_ij into its own columns: the
// tile's sum first, then that into the block's (two-level). Compensating
// that add, as K10 does, made K8 11% slower on the H100 (PERF.md);
// K8 serves p <= 1792, where chip_smoke [8c] holds streaming vs dense at
// 71 dB.
__global__ void __launch_bounds__(ST_THREADS)
    stream_halfstep_kernel(const float* __restrict__ fb,
                           const float* __restrict__ fa,
                           const float* __restrict__ mask,
                           const float* __restrict__ u, float* __restrict__ x,
                           float* __restrict__ partial, int qpad, int ppad,
                           int per_block, int tr, float sw, float pw,
                           float eps) {
  extern __shared__ float smem[];
  float* u_s = smem;                        // (ppad,)
  float* x_s = smem + ppad;                 // (ST_MAX_TR,)
  float* tile = x_s + ST_MAX_TR;            // (tr, ppad)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  SampleCols s;
  s.load(fa, ppad, 0, ppad);
  const int nthreads = blockDim.x;
  for (int j = tid; j < ppad; j += nthreads) u_s[j] = u[j];
  float acc[ST_MAXC];
#pragma unroll
  for (int c = 0; c < ST_MAXC; ++c) acc[c] = 0.0f;
  const int rbeg = blockIdx.x * per_block;
  const int rend = min(rbeg + per_block, qpad);
  __syncthreads();
  for (int r0 = rbeg; r0 < rend; r0 += tr) {
    const int nr = min(tr, rend - r0);
    for (int r = 0; r < nr; ++r) {
      const int i = r0 + r;
      const float br = fb[i], bc = fb[qpad + i], by = fb[2 * qpad + i];
#pragma unroll
      for (int c = 0; c < ST_MAXC; ++c) {
        const int j = tid + c * nthreads;
        if (j < ppad) {
          tile[r * ppad + j] =
              nle::affinity(br, bc, by, s.r[c], s.c[c], s.y[c], sw, pw);
        }
      }
    }
    __syncthreads();
    for (int r = warp; r < nr; r += nthreads / 32) {
      const float* row = tile + r * ppad;
      float w = 0.0f;
      for (int j = lane; j < ppad; j += 32) w = fmaf(row[j], u_s[j], w);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        w += __shfl_xor_sync(0xffffffffu, w, off);
      }
      if (lane == 0) {
        // Pad rows have real affinities: the mask kills them here.
        const float xv = (fabsf(w) >= eps ? 1.0f / w : 0.0f) * mask[r0 + r];
        x_s[r] = xv;
        x[r0 + r] = xv;
      }
    }
    __syncthreads();
    float part[ST_MAXC];
#pragma unroll
    for (int c = 0; c < ST_MAXC; ++c) part[c] = 0.0f;
    for (int r = 0; r < nr; ++r) {
      const float xv = x_s[r];
#pragma unroll
      for (int c = 0; c < ST_MAXC; ++c) {
        const int j = tid + c * nthreads;
        if (j < ppad) part[c] = fmaf(xv, tile[r * ppad + j], part[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < ST_MAXC; ++c) acc[c] += part[c];
    __syncthreads();
  }
  float* dst = partial + static_cast<size_t>(blockIdx.x) * ppad;
#pragma unroll
  for (int c = 0; c < ST_MAXC; ++c) {
    const int j = tid + c * nthreads;
    if (j < ppad) dst[j] = acc[c];
  }
}

// K11, and K9's pass 1 (kRecip, R = 1, b = u): out[k, i] = sum_j K[i, j]
// b[k, j]. One thread per pixel row, the sample features and the b rows
// staged in shared memory pchunk samples at a time (read as broadcasts).
// Each row sums its samples in increasing j, two-level: a group of
// ST_ROW_GRAIN samples as one fp32 chain, each group's sum added to the
// row's with compensation (kahan_add). On the streaming route u = Uinv t
// carries 1/lambda up to 1e10 and w = K u cancels, so the rounding of a
// 2176-term chain would reach x at full weight. The row's sums stay in
// registers across chunks (pchunk does not change them) and a zero group
// sum is a no-op (pad samples do not change them), so they depend on
// neither pchunk nor ppad. kRecip ends with x = mask * safe_recip(w, eps).
// Rows are independent: no cross-block pass. Blocks stride over 256-row
// groups, restaging the chunks for each when there is more than one.
template <int R, bool kRecip>
__global__ void __launch_bounds__(ST_THREADS)
    stream_atb_kernel(const float* __restrict__ fb, const float* __restrict__ fa,
                      const float* __restrict__ b,
                      const float* __restrict__ mask, float* __restrict__ out,
                      int qpad, int ppad, int pchunk, float sw, float pw,
                      float eps) {
  extern __shared__ float smem[];
  float* fa_s = smem;                // (3, pchunk)
  float* b_s = smem + 3 * pchunk;    // (R, pchunk)
  const bool restage = pchunk < ppad;
  for (int i0 = blockIdx.x * ST_THREADS; i0 < qpad;
       i0 += gridDim.x * ST_THREADS) {
    const int i = i0 + threadIdx.x;
    const bool row = i < qpad;
    const float br = row ? fb[i] : 0.0f;
    const float bc = row ? fb[qpad + i] : 0.0f;
    const float by = row ? fb[2 * qpad + i] : 0.0f;
    float acc[R], comp[R];
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = comp[k] = 0.0f;
    for (int j0 = 0; j0 < ppad; j0 += pchunk) {
      const int nj = min(pchunk, ppad - j0);
      if (restage || i0 == blockIdx.x * ST_THREADS) {  // block-uniform
        __syncthreads();  // the previous chunk's readers are done
        for (int e = threadIdx.x; e < nj; e += ST_THREADS) {
#pragma unroll
          for (int d = 0; d < 3; ++d) fa_s[d * pchunk + e] = fa[d * ppad + j0 + e];
#pragma unroll
          for (int k = 0; k < R; ++k) b_s[k * pchunk + e] = b[k * ppad + j0 + e];
        }
        __syncthreads();
      }
      if (!row) continue;
      for (int g = 0; g < nj; g += ST_ROW_GRAIN) {
        const int gend = min(g + ST_ROW_GRAIN, nj);
        float part[R];
#pragma unroll
        for (int k = 0; k < R; ++k) part[k] = 0.0f;
        for (int j = g; j < gend; ++j) {
          const float a = nle::affinity(br, bc, by, fa_s[j], fa_s[pchunk + j],
                                        fa_s[2 * pchunk + j], sw, pw);
#pragma unroll
          for (int k = 0; k < R; ++k) part[k] = fmaf(a, b_s[k * pchunk + j], part[k]);
        }
#pragma unroll
        for (int k = 0; k < R; ++k) nle::kahan_add(acc[k], comp[k], part[k]);
      }
    }
    if (!row) continue;
    if (kRecip) {
      // Pad rows have real affinities: the mask kills them here.
      const float w = __fsub_rn(acc[0], comp[0]);
      out[i] = (fabsf(w) >= eps ? 1.0f / w : 0.0f) * mask[i];
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        out[static_cast<size_t>(k) * qpad + i] = __fsub_rn(acc[k], comp[k]);
      }
    }
  }
}

// K12, step 1 of a row chunk: phi rows [r0, r0 + rows) = K Uinv into a
// (chunk, mpad) scratch — the 64x64x16 tile of K1 (common.cuh) on the same
// affinity entries, so these rows are bitwise those K1 writes.
__global__ void __launch_bounds__(nle::GEMM_THREADS)
    gram_phi_chunk_kernel(nle::AffinityA a, nle::DenseB b,
                          float* __restrict__ phi, int r0, int mpad) {
  const int row0 = blockIdx.x * nle::BM;
  const int col0 = blockIdx.y * nle::BN;
  const int ty = threadIdx.x / (nle::BN / nle::TN);
  const int tx = threadIdx.x % (nle::BN / nle::TN);
  float acc[nle::TM][nle::TN] = {};
  nle::gemm_tile<true>(a, b, r0 + row0, col0, 0, a.ppad, acc);
#pragma unroll
  for (int i = 0; i < nle::TM; ++i) {
    float* dst = phi + static_cast<size_t>(row0 + ty * nle::TM + i) * mpad +
                 col0 + tx * nle::TN;
#pragma unroll
    for (int j = 0; j < nle::TN; ++j) dst[j] = acc[i][j];
  }
}

// K12, step 2: the chunk's rows cut into nsplit fixed splits; block
// (tile, split) adds its (diag(c) phi)^T (diag(c) phi) tile into
// partial[split]. Exactly one block owns each (split, tile) and chunks run
// in stream order, so the read-add-write is race-free and its order fixed.
__global__ void __launch_bounds__(nle::GEMM_THREADS)
    gram_accumulate_kernel(nle::ScaledColsA a, nle::ScaledRows b,
                           float* __restrict__ partial, int rows, int mpad,
                           int split_rows, int first) {
  const int row0 = blockIdx.x * nle::BM;
  const int col0 = blockIdx.y * nle::BN;
  const int k0 = min(static_cast<int>(blockIdx.z) * split_rows, rows);
  const int k1 = min(k0 + split_rows, rows);
  const int ty = threadIdx.x / (nle::BN / nle::TN);
  const int tx = threadIdx.x % (nle::BN / nle::TN);
  float acc[nle::TM][nle::TN] = {};
  nle::gemm_tile<false>(a, b, row0, col0, k0, k1, acc);
  float* base = partial + static_cast<size_t>(blockIdx.z) * mpad * mpad;
#pragma unroll
  for (int i = 0; i < nle::TM; ++i) {
    float* dst = base + static_cast<size_t>(row0 + ty * nle::TM + i) * mpad +
                 col0 + tx * nle::TN;
#pragma unroll
    for (int j = 0; j < nle::TN; ++j) dst[j] = first ? acc[i][j] : dst[j] + acc[i][j];
  }
}

bool bad_stream_shape(int qpad, int ppad) {
  return qpad < ST_ROW_GRAIN || qpad % ST_ROW_GRAIN || ppad < 1 ||
         ppad % nle::BK;
}

// Even split of n into the fewest pieces of at most `most`, each a
// multiple of 32 (the last may be shorter): n itself when n <= most and a
// multiple of 32, as every Ppad of pad_stream_operands is up to 1792.
inline int even_piece(int n, int most) {
  const int pieces = (n + most - 1) / most;
  const int per = (n + pieces - 1) / pieces;
  return (per + 31) / 32 * 32;
}

// Threads of a K10 block for a p-tile of ptile samples: just enough warps
// that each thread owns close to ST_MAXC sample columns, so the per-row
// loads and checks are shared by as many entries as the registers allow.
inline int ap_threads(int ptile) {
  const int per = (ptile + ST_MAXC - 1) / ST_MAXC;
  return (per + 31) / 32 * 32;
}

template <int R>
cudaError_t launch_ap(const float* fb, const float* fa, const float* X,
                      float* partial, float* ap, int qpad, int ppad, float sw,
                      float pw, cudaStream_t st) {
  const int nblocks = ap_blocks(qpad);
  const int ptile = even_piece(ppad, ST_MAX_PPAD);
  const dim3 grid(nblocks, (ppad + ptile - 1) / ptile);
  stream_ap_kernel<R><<<grid, ap_threads(ptile), 0, st>>>(
      fb, fa, X, partial, qpad, ppad, ptile, rows_per_block(qpad), sw, pw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return nle::launch_reduce_partials(partial, ap, nblocks, R * ppad, st);
}

template <int R, bool kRecip>
cudaError_t launch_atb(const float* fb, const float* fa, const float* b,
                       const float* mask, float* out, int qpad, int ppad,
                       float sw, float pw, float eps, cudaStream_t st) {
  const int pchunk = even_piece(ppad, ST_ATB_CHUNK);
  const int smem = static_cast<int>(sizeof(float)) * (3 + R) * pchunk;
  cudaError_t err = cudaFuncSetAttribute(
      stream_atb_kernel<R, kRecip>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  int groups = (qpad + ST_THREADS - 1) / ST_THREADS;
  groups = groups > ST_MAX_BLOCKS ? ST_MAX_BLOCKS : groups;
  stream_atb_kernel<R, kRecip><<<groups, ST_THREADS, smem, st>>>(
      fb, fa, b, mask, out, qpad, ppad, pchunk, sw, pw, eps);
  return cudaGetLastError();
}

}  // namespace

// Rows of the (nblocks, R * ppad) partial scratch K8/K10 need for qpad rows.
extern "C" int nle_stream_nblocks(int qpad) { return ap_blocks(qpad); }

// K8. fb (3, qpad), fa (3, ppad), mask (qpad,), u (ppad,) -> x (qpad,),
// ap (ppad,); partial is scratch of nle_stream_nblocks(qpad) * ppad floats.
// unit_x != 0: x is not written (it is the mask) and u is not read.
// ppad <= 1792 (past it: K9, or K10 with x = mask for unit_x).
extern "C" int nle_stream_halfstep(const float* fb, const float* fa,
                                   const float* mask, const float* u, float* x,
                                   float* partial, float* ap, int qpad,
                                   int ppad, float sw, float pw, float eps,
                                   int unit_x, void* stream) {
  if (bad_stream_shape(qpad, ppad) || ppad > ST_MAX_PPAD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (unit_x) {
    return static_cast<int>(
        launch_ap<1>(fb, fa, mask, partial, ap, qpad, ppad, sw, pw, st));
  }
  const size_t fixed = sizeof(float) * (ppad + ST_MAX_TR);
  int tr = static_cast<int>((K8_SMEM_TARGET - fixed) / (sizeof(float) * ppad));
  tr = tr > ST_MAX_TR ? ST_MAX_TR : tr;
  if (tr < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fixed + sizeof(float) * static_cast<size_t>(tr) * ppad;
  cudaError_t err = cudaFuncSetAttribute(
      stream_halfstep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblocks = ap_blocks(qpad);
  const int threads = max(K8_MIN_THREADS, ap_threads(ppad));
  stream_halfstep_kernel<<<nblocks, threads, smem, st>>>(
      fb, fa, mask, u, x, partial, qpad, ppad, rows_per_block(qpad), tr, sw,
      pw, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      nle::launch_reduce_partials(partial, ap, nblocks, ppad, st));
}

// K9. K8's contract without unit_x, at any ppad: pass 1 writes x, pass 2
// is K10 on it; partial as for K8.
extern "C" int nle_stream_halfstep_ptiled(const float* fb, const float* fa,
                                          const float* mask, const float* u,
                                          float* x, float* partial, float* ap,
                                          int qpad, int ppad, float sw,
                                          float pw, float eps, void* stream) {
  if (bad_stream_shape(qpad, ppad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_atb<1, true>(fb, fa, u, mask, x, qpad, ppad, sw, pw,
                                        eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_ap<1>(fb, fa, x, partial, ap, qpad, ppad, sw, pw, st));
}

// K10. X (R, qpad) -> ap (R, ppad), 1 <= R <= 3 (one channel, or the three
// of a colour frame); partial is scratch of
// nle_stream_nblocks(qpad) * R * ppad floats.
extern "C" int nle_stream_ap(const float* fb, const float* fa, const float* X,
                             float* partial, float* ap, int qpad, int ppad,
                             int R, float sw, float pw, void* stream) {
  if (bad_stream_shape(qpad, ppad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (R) {
    case 1: err = launch_ap<1>(fb, fa, X, partial, ap, qpad, ppad, sw, pw, st); break;
    case 2: err = launch_ap<2>(fb, fa, X, partial, ap, qpad, ppad, sw, pw, st); break;
    case 3: err = launch_ap<3>(fb, fa, X, partial, ap, qpad, ppad, sw, pw, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// K11. b (R, ppad) -> out (R, qpad), 1 <= R <= 3.
extern "C" int nle_stream_atb(const float* fb, const float* fa, const float* b,
                              float* out, int qpad, int ppad, int R, float sw,
                              float pw, void* stream) {
  if (bad_stream_shape(qpad, ppad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (R) {
    case 1: err = launch_atb<1, false>(fb, fa, b, nullptr, out, qpad, ppad, sw, pw, 0.0f, st); break;
    case 2: err = launch_atb<2, false>(fb, fa, b, nullptr, out, qpad, ppad, sw, pw, 0.0f, st); break;
    case 3: err = launch_atb<3, false>(fb, fa, b, nullptr, out, qpad, ppad, sw, pw, 0.0f, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// K12. fb (3, qpad), fa (3, ppad), c (qpad,) zero on pad rows,
// uinv (ppad, mpad) -> out (mpad, mpad). Caller-owned scratch: phi_chunk
// (chunk, mpad) and partial (nsplit, mpad, mpad). qpad and chunk are
// multiples of 64, chunk / nsplit of 16.
extern "C" int nle_stream_gram(const float* fb, const float* fa, const float* c,
                               const float* uinv, float* phi_chunk,
                               float* partial, float* out, int qpad, int ppad,
                               int mpad, int chunk, int nsplit, float sw,
                               float pw, void* stream) {
  if (qpad < nle::BM || qpad % nle::BM || ppad < 1 || ppad % nle::BK || mpad % nle::BN || chunk < nle::BM ||
      chunk % nle::BM || nsplit < 1 || (chunk / nsplit) % nle::BK ||
      chunk % nsplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int split_rows = chunk / nsplit;
  for (int r0 = 0; r0 < qpad; r0 += chunk) {
    const int rows = min(chunk, qpad - r0);
    nle::AffinityA a{fb, fa, qpad, ppad, sw, pw};
    nle::DenseB b{uinv, mpad};
    gram_phi_chunk_kernel<<<dim3(rows / nle::BM, mpad / nle::BN),
                            nle::GEMM_THREADS, 0, st>>>(a, b, phi_chunk, r0,
                                                        mpad);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    nle::ScaledColsA ga{phi_chunk, c + r0, mpad};
    nle::ScaledRows gb{phi_chunk, c + r0, mpad};
    gram_accumulate_kernel<<<dim3(mpad / nle::BM, mpad / nle::BN, nsplit),
                             nle::GEMM_THREADS, 0, st>>>(
        ga, gb, partial, rows, mpad, split_rows, r0 == 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(
      nle::launch_reduce_partials(partial, out, nsplit, mpad * mpad, st));
}
