// K1: fused Gaussian-affinity x matrix product on Hopper.
//
// Replaces nle_tpu/ops/pallas/affinity_kernel.py:113 `_kernel` (called via
// affinity_matmul_pallas). Computes
//   out[q, j] = sum_p exp(-(sw*(dr^2 + dc^2) + pw*dy^2)) * B[p, j]
// with dr, dc, dy the raw integer differences of the (row, col, y)
// features of pixel q and sample p. The (rows, p) affinity block is built
// tile by tile in shared memory and contracted at once: K_AB never reaches
// device memory. Rows >= q_true are written as exact zeros (the out_rows
// direct-write contract: pad features are zeros, which give NONZERO
// affinities against real samples).
//
// Accuracy (this product is the fidelity floor of the whole pipeline,
// nle_tpu DESIGN.md §2a): each entry is nle::affinity (common.cuh: explicit
// rounding, no FMA contraction in the argument, IEEE expf), the entry the
// streaming kernels of streaming.cu recompute, and the p contraction is
// fp32 FMA.
//
// Bound on the H100: at the 1 MP main path (q ~ 1.0 M, p = 600, mpad = 640)
// it is 0.77 TFLOP of fp32 FMA on the CUDA cores plus 0.6 G expf, against
// ~41 MB of traffic — compute-bound. This first version is a plain
// 64x64x16 register-tiled SGEMM (common.cuh) with the affinity generated
// in the A-tile load; each affinity is recomputed once per 64-column output
// tile (mpad/64 = 10 times), ~2% of the FMA work. Tensor cores are not
// used: TF32 would break the fp32 contract.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(nle::GEMM_THREADS)
    affinity_matmul_kernel(nle::AffinityA a, nle::DenseB b,
                           float* __restrict__ out,
                           int mpad, int q_true) {
  const int row0 = blockIdx.x * nle::BM;
  const int col0 = blockIdx.y * nle::BN;
  const int ty = threadIdx.x / (nle::BN / nle::TN);
  const int tx = threadIdx.x % (nle::BN / nle::TN);
  float acc[nle::TM][nle::TN] = {};
  if (row0 < q_true) {  // block-uniform: whole pad tiles skip the product
    nle::gemm_tile<true>(a, b, row0, col0, 0, a.ppad, acc);
  }
#pragma unroll
  for (int i = 0; i < nle::TM; ++i) {
    const int r = row0 + ty * nle::TM + i;
    float* dst = out + static_cast<size_t>(r) * mpad + col0 + tx * nle::TN;
#pragma unroll
    for (int j = 0; j < nle::TN; ++j) dst[j] = r < q_true ? acc[i][j] : 0.0f;
  }
}

}  // namespace

// fb (3, qpad), fa (3, ppad), B (ppad, mpad) -> out (qpad, mpad).
// qpad % 64 == 0, ppad % 16 == 0, mpad % 64 == 0; pad samples must carry
// zero rows of B.
extern "C" int nle_affinity_matmul(const float* fb, const float* fa,
                                   const float* B, float* out, int qpad,
                                   int q_true, int ppad, int mpad, float sw,
                                   float pw, void* stream) {
  if (qpad % nle::BM || ppad % nle::BK || mpad % nle::BN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nle::AffinityA a{fb, fa, qpad, ppad, sw, pw};
  nle::DenseB b{B, mpad};
  dim3 grid(qpad / nle::BM, mpad / nle::BN);
  affinity_matmul_kernel<<<grid, nle::GEMM_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(a, b, out, mpad,
                                                                q_true);
  return static_cast<int>(cudaGetLastError());
}
