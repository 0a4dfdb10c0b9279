// The port's one affinity-product core: rows of K B, with K the Gaussian
// affinity between pixel rows and samples built on the fly, never stored.
// It serves K1 and K2's contract (csrc/affinity.cu, the dense phi and the
// streaming stage 2b's V tail) and K12's phi step (csrc/streaming.cu, each
// chunk's phi rows = K Uinv) through the one C entry nle_affinity_matmul.
//
// Block (x, y) owns AC_ROWS consecutive pixel rows of the launch and the
// NC = 32 TN columns of column panel y (at most AC_MAX_COLS = 384). Each
// step of AC_K samples:
//   - every thread builds AC_K * ROWS / (4 ROWS) = 4 entries of the
//     block's (AC_K, ROWS) affinity tile into shared memory (one
//     nle::affinity each, for the step after the one being multiplied);
//   - the (AC_K, NC) slab of B arrives by 16-byte cp.async in a ring of
//     AC_STAGES slabs, AC_STAGES - 1 steps ahead;
//   - thread (warp ty, lane tx) adds the step into its 8 x TN outputs (rows
//     ty * 8 + i, columns g * 128 + tx * 4 + j): per sample 2 + TN / 4
//     shared float4 loads (the A pair a broadcast) for 8 TN FMAs.
// One barrier a step. So each entry is built once per column panel: once
// up to mpad 384, twice at 640 (384 + 256), four times at 1280 (3 x 384 +
// 128).
//
// Bits: every output is one fmaf chain in increasing sample index from 0
// over nle::affinity entries (no split over samples, no TF32, no tensor
// cores: the phi build is the pipeline's fidelity floor), so K1's output
// and K12's phi rows are the same bits whatever the panel plan, the rows a
// block or the ring depth, and the same bits as the first version's K1.
//
// K1's contract: rows whose pixel index is >= q_true come out as exact
// zeros (the out_rows direct-write layout: pad features are zeros, which
// give nonzero affinities): the launch runs only the blocks that hold a
// row below q_true and then zeroes the rows from q_true on, so whole pad
// row panels skip the product and the kernel carries no tail logic (a
// version with it compiled to a slower main loop on the H100, PERF.md).
// Columns past m come out zero from B's zero pad columns.
//
// Bound on the H100: fp32 FMA, 2 q ppad mpad flop (0.78 T at the 1 MP
// main path) against ~4 q mpad bytes of output: compute-bound at the
// CUDA cores' 67 TFLOP/s. One block an SM of AC_ROWS = 64 rows with a
// ring of AC_STAGES = 3 slabs: two blocks an SM of 32 rows (with a three-
// or four-slab ring) were slower at 1 MP, p = 1200 and the 16 and 32 MP
// phi steps (PERF.md).
#pragma once

#include "common.cuh"

namespace nle {

constexpr int AC_K = 16;            // samples a step
constexpr int AC_MAX_COLS = 384;    // columns of the widest panel (TN = 12)
constexpr int AC_ROWS = 64;         // pixel rows a block (4 threads each)
constexpr int AC_STAGES = 3;        // slabs of B in the ring
constexpr int AC_BUILD = 4;         // entries a thread builds a step

namespace {

template <int TN>
constexpr int ac_smem_bytes() {
  return 4 * (AC_STAGES * AC_K * 32 * TN + 2 * AC_K * AC_ROWS);
}

template <int TN>
__global__ void __launch_bounds__(4 * AC_ROWS, 1)
    affinity_panel_kernel(const float* __restrict__ fb,
                          const float* __restrict__ fa,
                          const float* __restrict__ B, float* __restrict__ out,
                          int qpad, int ppad, int mpad, int r0, int col_base,
                          float sw, float pw) {
  static_assert(TN % 4 == 0 && 32 * TN <= AC_MAX_COLS, "TN 4, 8 or 12");
  static_assert(AC_ROWS % 8 == 0 && AC_K == 4 * AC_BUILD,
                "4 threads a row, AC_BUILD entries each a step");
  constexpr int ROWS = AC_ROWS;
  constexpr int STAGES = AC_STAGES;
  constexpr int THREADS = 4 * ROWS;
  constexpr int NC = 32 * TN;
  constexpr int NG = TN / 4;          // float4 column groups a thread
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                                  // [stage][k][NC]
  float* as = smem + STAGES * AC_K * NC;             // [buf][k][row]
  const int tid = threadIdx.x;
  const int lrow0 = blockIdx.x * ROWS;               // row in the launch
  const int col0 = col_base + blockIdx.y * NC;
  const int nk = ppad / AC_K;

  // The entries this thread builds: pixel row br of the block, samples
  // bk .. bk + AC_BUILD of each step (a warp shares its samples).
  const int br = tid % ROWS;
  const int bk = tid / ROWS * AC_BUILD;
  const int pix = r0 + lrow0 + br;
  const float pr = fb[pix], pc = fb[qpad + pix], py = fb[2 * qpad + pix];
  auto build = [&](int step) {
    float* dst = as + (step & 1) * AC_K * ROWS;
#pragma unroll
    for (int e = 0; e < AC_BUILD; ++e) {
      const int j = step * AC_K + bk + e;
      dst[(bk + e) * ROWS + br] =
          affinity(pr, pc, py, __ldg(fa + j), __ldg(fa + ppad + j),
                   __ldg(fa + 2 * ppad + j), sw, pw);
    }
  };
  auto issue = [&](int step) {
    if (step < nk) {
      float* dst = bs + (step % STAGES) * AC_K * NC;
      const float* src = B + static_cast<size_t>(step) * AC_K * mpad + col0;
#pragma unroll
      for (int e = tid; e < AC_K * NC / 4; e += THREADS) {
        const int k = e / (NC / 4);
        const int q = (e % (NC / 4)) * 4;
        cp_async16(dst + k * NC + q, src + static_cast<size_t>(k) * mpad + q);
      }
    }
    cp_async_commit();
  };

  const int ty = tid / 32;
  const int tx = tid % 32;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  build(0);
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // slab it and tile it landed; step it - 1 is read
    issue(it + STAGES - 1);
    if (it + 1 < nk) build(it + 1);
    const float* A = as + (it & 1) * AC_K * ROWS + ty * 8;
    const float* Bt = bs + (it % STAGES) * AC_K * NC + tx * 4;
    // The shared loads of sample k + 1 are issued before the FMAs of
    // sample k (two register fragments), so their latency hides behind
    // 8 TN FMAs with only 8 warps an SM.
    float4 fa4[2][2], fb4[2][NG];
    auto load = [&](int f, int k) {
      fa4[f][0] = *reinterpret_cast<const float4*>(A + k * ROWS);
      fa4[f][1] = *reinterpret_cast<const float4*>(A + k * ROWS + 4);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        fb4[f][g] = *reinterpret_cast<const float4*>(Bt + k * NC + g * 128);
      }
    };
    load(0, 0);
#pragma unroll
    for (int k = 0; k < AC_K; ++k) {
      const int f = k & 1;
      if (k + 1 < AC_K) load(f ^ 1, k + 1);
      const float av[8] = {fa4[f][0].x, fa4[f][0].y, fa4[f][0].z, fa4[f][0].w,
                           fa4[f][1].x, fa4[f][1].y, fa4[f][1].z, fa4[f][1].w};
      float bv[TN];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        bv[4 * g] = fb4[f][g].x;
        bv[4 * g + 1] = fb4[f][g].y;
        bv[4 * g + 2] = fb4[f][g].z;
        bv[4 * g + 3] = fb4[f][g].w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  for (int i = 0; i < 8; ++i) {
    float* dst = out + static_cast<size_t>(lrow0 + ty * 8 + i) * mpad + col0 +
                 tx * 4;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      *reinterpret_cast<float4*>(dst + g * 128) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                      acc[i][4 * g + 3]);
    }
  }
}

template <int TN>
cudaError_t launch_panel(const float* fb, const float* fa, const float* B,
                         float* out, int qpad, int ppad, int mpad, int r0,
                         int rows, int col_base, int panels, float sw,
                         float pw, cudaStream_t st) {
  constexpr int bytes = ac_smem_bytes<TN>();
  cudaError_t err = cudaFuncSetAttribute(
      affinity_panel_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  affinity_panel_kernel<TN>
      <<<dim3(rows / AC_ROWS, panels), 4 * AC_ROWS, bytes, st>>>(
          fb, fa, B, out, qpad, ppad, mpad, r0, col_base, sw, pw);
  return cudaGetLastError();
}

// Rows [r0, r0 + rows) of K B into out (rows, mpad): the full AC_MAX_COLS
// panels (TN = 12), then one of the remaining 128 or 256 columns. Only
// the blocks that hold a row below q_true run the product; the rows from
// q_true on are then set to exact zeros (the out_rows contract), so the
// kernel itself has no tail logic.
cudaError_t launch_affinity_rows(const float* fb, const float* fa,
                                 const float* B, float* out, int qpad,
                                 int ppad, int mpad, int r0, int rows,
                                 int q_true, float sw, float pw,
                                 cudaStream_t st) {
  // Rows [r0, r0 + live_rows) hold every row below q_true, in whole blocks.
  const int below =
      q_true - r0 <= 0 ? 0 : (q_true - r0 + AC_ROWS - 1) / AC_ROWS * AC_ROWS;
  const int live_rows = below < rows ? below : rows;
  const int full = mpad / AC_MAX_COLS;
  const int rest = mpad % AC_MAX_COLS;
  cudaError_t err = cudaSuccess;
  if (live_rows && full) {
    err = launch_panel<12>(fb, fa, B, out, qpad, ppad, mpad, r0, live_rows,
                           0, full, sw, pw, st);
  }
  if (err == cudaSuccess && live_rows && rest == 256) {
    err = launch_panel<8>(fb, fa, B, out, qpad, ppad, mpad, r0, live_rows,
                          full * AC_MAX_COLS, 1, sw, pw, st);
  } else if (err == cudaSuccess && live_rows && rest == 128) {
    err = launch_panel<4>(fb, fa, B, out, qpad, ppad, mpad, r0, live_rows,
                          full * AC_MAX_COLS, 1, sw, pw, st);
  }
  const int zero_from = q_true - r0 > 0 ? q_true - r0 : 0;
  if (err == cudaSuccess && zero_from < rows) {
    err = cudaMemsetAsync(out + static_cast<size_t>(zero_from) * mpad, 0,
                          sizeof(float) * static_cast<size_t>(rows - zero_from) *
                              mpad,
                          st);
  }
  return err;
}

}  // namespace

}  // namespace nle
