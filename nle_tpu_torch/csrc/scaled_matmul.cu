// K6 and K7: products of the row-scaled factor diag(c) phi with the scaling
// fused into the operand load, so c*phi never exists in device memory.
//
// K6 replaces nle_tpu/ops/pallas/scaled_matmul_kernel.py:56 `_gram_kernel`
// (via scaled_gram_pallas):  Sb = (diag(c) phi)^T (diag(c) phi), (mpad, mpad)
// over npad rows. The TPU carries the (mpad, mpad) sum in VMEM across its
// sequential grid; CUDA blocks run in no order, so the rows are cut into
// nsplit fixed chunks, each block writes the partial gram of one
// (64x64 tile, chunk) pair to an (nsplit, mpad, mpad) scratch, and a second
// kernel sums the chunks in increasing order. No float atomics: the result
// is bitwise repeatable.
//
// K7 replaces scaled_matmul_kernel.py:111 `_matmul_kernel` (via
// scaled_matmul_pallas): V = (diag(c) phi) B, (npad, kpad) from (npad, mpad)
// x (mpad, kpad).
//
// Bound on the H100 at the 1 MP main path (npad ~ 1.0 M, mpad = 640,
// kpad = 128): K6 is 0.86 TFLOP of fp32 FMA over a 2.6 GB read — compute-
// bound on the CUDA cores (fp32 tensor-core paths are TF32 and off limits);
// K7 is 0.17 TFLOP over 2.6 GB, near the balance point. Both use the plain
// 64x64x16 register-tiled tile of common.cuh; the gram computes both
// triangles (halving it is later work).

#include "common.cuh"

namespace {

using nle::ScaledColsA;
using nle::ScaledRows;

__global__ void __launch_bounds__(nle::GEMM_THREADS)
    scaled_gram_partial_kernel(ScaledColsA a, ScaledRows b,
                               float* __restrict__ partial, int npad, int mpad,
                               int chunk) {
  const int row0 = blockIdx.x * nle::BM;
  const int col0 = blockIdx.y * nle::BN;
  const int k0 = blockIdx.z * chunk;
  const int k1 = min(k0 + chunk, npad);
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
    for (int j = 0; j < nle::TN; ++j) dst[j] = acc[i][j];
  }
}

__global__ void __launch_bounds__(nle::GEMM_THREADS)
    scaled_matmul_kernel(ScaledRows a, nle::DenseB b, float* __restrict__ out,
                         int mpad, int kpad) {
  const int row0 = blockIdx.x * nle::BM;
  const int col0 = blockIdx.y * nle::BN;
  const int ty = threadIdx.x / (nle::BN / nle::TN);
  const int tx = threadIdx.x % (nle::BN / nle::TN);
  float acc[nle::TM][nle::TN] = {};
  nle::gemm_tile<true>(a, b, row0, col0, 0, mpad, acc);
#pragma unroll
  for (int i = 0; i < nle::TM; ++i) {
    float* dst = out + static_cast<size_t>(row0 + ty * nle::TM + i) * kpad +
                 col0 + tx * nle::TN;
#pragma unroll
    for (int j = 0; j < nle::TN; ++j) dst[j] = acc[i][j];
  }
}

}  // namespace

// phi (npad, mpad), c (npad,) -> out (mpad, mpad); partial is caller-owned
// scratch of nsplit * mpad * mpad floats. Rows are cut into nsplit chunks
// of `chunk` rows (chunk % 16 == 0, nsplit * chunk >= npad).
extern "C" int nle_scaled_gram(const float* phi, const float* c,
                               float* partial, float* out, int npad, int mpad,
                               int nsplit, int chunk, void* stream) {
  if (npad % nle::BK || mpad % nle::BM || chunk % nle::BK || nsplit < 1 ||
      static_cast<long long>(nsplit) * chunk < npad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ScaledColsA a{phi, c, mpad};
  ScaledRows b{phi, c, mpad};
  dim3 grid(mpad / nle::BM, mpad / nle::BN, nsplit);
  scaled_gram_partial_kernel<<<grid, nle::GEMM_THREADS, 0, s>>>(
      a, b, partial, npad, mpad, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      nle::launch_reduce_partials(partial, out, nsplit, mpad * mpad, s));
}

// phi (npad, mpad), c (npad,), B (mpad, kpad) -> out (npad, kpad).
extern "C" int nle_scaled_matmul(const float* phi, const float* c,
                                 const float* B, float* out, int npad,
                                 int mpad, int kpad, void* stream) {
  if (npad % nle::BM || mpad % nle::BK || kpad % nle::BN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ScaledRows a{phi, c, mpad};
  nle::DenseB b{B, kpad};
  dim3 grid(npad / nle::BM, kpad / nle::BN);
  scaled_matmul_kernel<<<grid, nle::GEMM_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(a, b, out, mpad,
                                                              kpad);
  return static_cast<int>(cudaGetLastError());
}
