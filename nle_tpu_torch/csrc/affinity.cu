// K1: fused Gaussian-affinity x matrix product on Hopper, and the C entry
// of the affinity core (csrc/affinity_core.cuh) that K12's phi step calls
// too.
//
// Replaces nle_tpu/ops/pallas/affinity_kernel.py:113 `_kernel` (called via
// affinity_matmul_pallas) and, past p = 1024, `_kernel_ptiled` (K2, :128).
// Computes
//   out[q, j] = sum_p exp(-(sw*(dr^2 + dc^2) + pw*dy^2)) * B[p, j]
// with dr, dc, dy the raw integer differences of the (row, col, y)
// features of pixel q and sample p. The affinity block is built in shared
// memory step by step and contracted at once: K_AB never reaches device
// memory. Rows >= q_true are written as exact zeros (the out_rows
// direct-write contract: pad features are zeros, which give NONZERO
// affinities against real samples).
//
// Accuracy (this product is the fidelity floor of the whole pipeline,
// nle_tpu DESIGN.md §2a): each entry is nle::affinity (common.cuh: explicit
// rounding, no FMA contraction in the argument, IEEE expf), the entry the
// streaming kernels of streaming.cu recompute, and each output is one fp32
// FMA chain over the samples in increasing order.
//
// Bound on the H100: at the 1 MP main path (q ~ 1.0 M, p = 600, mpad = 640)
// it is 0.77 TFLOP of fp32 FMA on the CUDA cores plus 0.6 G expf, against
// ~41 MB of traffic — compute-bound. The core builds each entry once per
// column panel of up to 384 columns (twice at mpad 640) and multiplies it
// into 8 x 12 outputs a thread fed by a cp.async ring of B slabs
// (affinity_core.cuh). The TPU needs K2 once a whole (p, m) B block no
// longer fits its VMEM; here B streams through shared memory 16 samples at
// a time at any p, so one kernel serves both contracts.

#include "affinity_core.cuh"

// Rows [r0, r0 + rows) of K B into out (rows, mpad), with fb (3, qpad), fa
// (3, ppad), B (ppad, mpad): K1 (r0 = 0, rows = qpad, the tail from q_true
// on exact zero) and K12's phi step (a chunk, q_true = qpad). qpad, r0 and
// rows are multiples of AC_ROWS, ppad of AC_K, mpad of 128 (the plan,
// affinity_kernel.affinity_plan, mirrors these constants); pad samples
// must carry zero rows of B.
extern "C" int nle_affinity_matmul(const float* fb, const float* fa,
                                   const float* B, float* out, int qpad,
                                   int ppad, int mpad, int r0, int rows,
                                   int q_true, float sw, float pw,
                                   void* stream) {
  if (qpad < 1 || rows < 1 || r0 < 0 || r0 + rows > qpad ||
      qpad % nle::AC_ROWS || rows % nle::AC_ROWS || r0 % nle::AC_ROWS ||
      ppad < nle::AC_K || ppad % nle::AC_K || mpad < 128 || mpad % 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(nle::launch_affinity_rows(
      fb, fa, B, out, qpad, ppad, mpad, r0, rows, q_true, sw, pw,
      static_cast<cudaStream_t>(stream)));
}
