// K8, K10, K11 and K12: the phi-free (streaming) stage-2 kernels. Every
// pass recomputes the (rows, p) affinity between rest pixels and samples
// from the raw (3, qpad) / (3, ppad) feature rows with nle::affinity, the
// same entry K1 stores in phi, so no (N, m) array ever exists.
//
// K8 replaces nle_tpu/ops/pallas/streaming_kernel.py:105 `_halfstep_kernel`
// (call :163):  x = mask * safe_recip(K^T u, eps),  ap = K x   (one sweep);
// with unit_x, x = mask (the s0 = phi^T 1 pass).
// K10 replaces :299 `_ap_kernel` (call :345):  ap (R, ppad) = K x, x (R, qpad).
// K11 replaces :369 `_atb_kernel` (call :411):  out (R, qpad) = K^T b.
// K12 replaces :453 `_gram_kernel` (call :492):
//   Sb = (c phi_rest)^T (c phi_rest),  phi_rest = K^T Uinv.
// Here K is (qpad pixels, ppad samples), stored nowhere.
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
// Cross-block sums (K8's and K10's ap, K12's Sb) never use float atomics:
// a bounded number of blocks each own a fixed contiguous row range and
// write a partial, and a second kernel sums the partials in block order,
// so training stays bitwise repeatable. The TPU carries these sums across
// its sequential grid in VMEM, which CUDA blocks cannot do.

#include "common.cuh"

namespace {

constexpr int ST_THREADS = 256;
constexpr int ST_MAXC = 7;                          // sample columns per thread
constexpr int ST_MAX_PPAD = ST_THREADS * ST_MAXC;   // 1792: the single-pass regime
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

// The thread's sample columns j = tid + c * blockDim.x, c < ST_MAXC, with
// their features in registers (zero beyond ppad; those columns are never
// read back).
struct SampleCols {
  float r[ST_MAXC], c[ST_MAXC], y[ST_MAXC];
  __device__ __forceinline__ void load(const float* fa, int ppad) {
#pragma unroll
    for (int k = 0; k < ST_MAXC; ++k) {
      const int j = threadIdx.x + k * blockDim.x;
      const bool in = j < ppad;
      r[k] = in ? fa[j] : 0.0f;
      c[k] = in ? fa[ppad + j] : 0.0f;
      y[k] = in ? fa[2 * ppad + j] : 0.0f;
    }
  }
};

// K10, and K8's unit_x pass (R = 1, x = mask): ap[k, j] = sum_i x[k, i] K[i, j]
// over this block's rows, into partial[blockIdx.x, k, j]. Each thread owns
// its sample columns and walks the rows in increasing order; a row whose x
// entries are all zero (the pad rows) adds exact zeros and is skipped. The
// sum is two-level, each 32-row group's sum added to the block's: at 32 MP
// a block owns ~30,000 rows, and one fp32 chain that long would round ~6x
// more than ~950 group sums do.
template <int R>
__global__ void __launch_bounds__(ST_THREADS)
    stream_ap_kernel(const float* __restrict__ fb, const float* __restrict__ fa,
                     const float* __restrict__ X, float* __restrict__ partial,
                     int qpad, int ppad, int per_block, float sw, float pw) {
  SampleCols s;
  s.load(fa, ppad);
  float acc[R][ST_MAXC];
#pragma unroll
  for (int k = 0; k < R; ++k)
#pragma unroll
    for (int c = 0; c < ST_MAXC; ++c) acc[k][c] = 0.0f;
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
        if (threadIdx.x + c * blockDim.x < ppad) {
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
      for (int c = 0; c < ST_MAXC; ++c) acc[k][c] += part[k][c];
  }
  float* dst = partial + static_cast<size_t>(blockIdx.x) * R * ppad;
#pragma unroll
  for (int c = 0; c < ST_MAXC; ++c) {
    const int j = threadIdx.x + c * blockDim.x;
    if (j < ppad) {
#pragma unroll
      for (int k = 0; k < R; ++k) dst[k * ppad + j] = acc[k][c];
    }
  }
}

// K8 proper: the row's w needs the whole affinity row before x exists, and
// ap needs x, so each tile of tr rows is built once into shared memory
// (one expf per entry per half-step, as on the TPU), then read twice:
// one warp per row forms w (lanes stride the samples, a fixed shuffle tree
// sums them), and each thread adds x_i K_ij into its own columns: the
// tile's sum first, then that into the block's (two-level, as in K10).
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
  s.load(fa, ppad);
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

// K11: out[k, i] = sum_j K[i, j] b[k, j]. One thread per pixel row, the
// sample features and the b rows in shared memory (read as broadcasts),
// the sum over samples in increasing j. Rows are independent: no
// cross-block pass. Blocks stride over 256-row groups.
template <int R>
__global__ void __launch_bounds__(ST_THREADS)
    stream_atb_kernel(const float* __restrict__ fb, const float* __restrict__ fa,
                      const float* __restrict__ b, float* __restrict__ out,
                      int qpad, int ppad, float sw, float pw) {
  extern __shared__ float smem[];
  float* fa_s = smem;            // (3, ppad)
  float* b_s = smem + 3 * ppad;  // (R, ppad)
  for (int e = threadIdx.x; e < 3 * ppad; e += ST_THREADS) fa_s[e] = fa[e];
  for (int e = threadIdx.x; e < R * ppad; e += ST_THREADS) b_s[e] = b[e];
  __syncthreads();
  for (int i = blockIdx.x * ST_THREADS + threadIdx.x; i < qpad;
       i += gridDim.x * ST_THREADS) {
    const float br = fb[i], bc = fb[qpad + i], by = fb[2 * qpad + i];
    float acc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = 0.0f;
    for (int j = 0; j < ppad; ++j) {
      const float a = nle::affinity(br, bc, by, fa_s[j], fa_s[ppad + j],
                                    fa_s[2 * ppad + j], sw, pw);
#pragma unroll
      for (int k = 0; k < R; ++k) acc[k] = fmaf(a, b_s[k * ppad + j], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) out[static_cast<size_t>(k) * qpad + i] = acc[k];
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
         ppad > ST_MAX_PPAD || ppad % nle::BK;
}

// Threads of a K10 block: just enough warps that each thread owns close to
// ST_MAXC sample columns, so the per-row loads and checks are shared by as
// many entries as the registers allow.
inline int ap_threads(int ppad) {
  const int per = (ppad + ST_MAXC - 1) / ST_MAXC;
  return (per + 31) / 32 * 32;
}

template <int R>
cudaError_t launch_ap(const float* fb, const float* fa, const float* X,
                      float* partial, float* ap, int qpad, int ppad, float sw,
                      float pw, cudaStream_t st) {
  const int nblocks = ap_blocks(qpad);
  stream_ap_kernel<R><<<nblocks, ap_threads(ppad), 0, st>>>(
      fb, fa, X, partial, qpad, ppad, rows_per_block(qpad), sw, pw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return nle::launch_reduce_partials(partial, ap, nblocks, R * ppad, st);
}

template <int R>
cudaError_t launch_atb(const float* fb, const float* fa, const float* b,
                       float* out, int qpad, int ppad, float sw, float pw,
                       cudaStream_t st) {
  const int smem = static_cast<int>(sizeof(float)) * (3 + R) * ppad;
  cudaError_t err = cudaFuncSetAttribute(
      stream_atb_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int groups = (qpad + ST_THREADS - 1) / ST_THREADS;
  groups = groups > ST_MAX_BLOCKS ? ST_MAX_BLOCKS : groups;
  stream_atb_kernel<R><<<groups, ST_THREADS, smem, st>>>(fb, fa, b, out, qpad,
                                                          ppad, sw, pw);
  return cudaGetLastError();
}

}  // namespace

// Rows of the (nblocks, R * ppad) partial scratch K8/K10 need for qpad rows.
extern "C" int nle_stream_nblocks(int qpad) { return ap_blocks(qpad); }

// K8. fb (3, qpad), fa (3, ppad), mask (qpad,), u (ppad,) -> x (qpad,),
// ap (ppad,); partial is scratch of nle_stream_nblocks(qpad) * ppad floats.
// unit_x != 0: x is not written (it is the mask) and u is not read.
extern "C" int nle_stream_halfstep(const float* fb, const float* fa,
                                   const float* mask, const float* u, float* x,
                                   float* partial, float* ap, int qpad,
                                   int ppad, float sw, float pw, float eps,
                                   int unit_x, void* stream) {
  if (bad_stream_shape(qpad, ppad)) {
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
    case 1: err = launch_atb<1>(fb, fa, b, out, qpad, ppad, sw, pw, st); break;
    case 2: err = launch_atb<2>(fb, fa, b, out, qpad, ppad, sw, pw, st); break;
    case 3: err = launch_atb<3>(fb, fa, b, out, qpad, ppad, sw, pw, st); break;
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
  if (qpad < nle::BM || qpad % nle::BM || ppad < 1 || ppad > ST_MAX_PPAD ||
      ppad % nle::BK || mpad % nle::BN || chunk < nle::BM ||
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
