// Shared device code of the port's kernels: one register-tiled fp32 GEMM
// tile whose operand elements come from functors (so the affinity build
// and the row scaling fuse into the operand load), the one affinity entry
// every kernel that recomputes K uses, and the fixed-order reduction of
// per-block partial sums.
//
// Every contraction here is plain IEEE fp32 FMA on the CUDA cores: no
// TF32, no fast-math intrinsics, and no bf16 except in the one sanctioned
// preview kernel, K14 (csrc/sinkhorn.cu, opt-in through NLE_SINKHORN_BF16,
// documented as not golden-safe), whose bf16 products are exact in fp32
// and summed in fp32. Every output element is summed
// by one thread in increasing k, and cross-block sums go through an
// (nparts, len) scratch reduced in a fixed order, never through float
// atomics, so a result is a function of its inputs alone (training must be
// bitwise repeatable).
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace nle {

constexpr int BM = 64;   // output tile rows
constexpr int BN = 64;   // output tile columns
constexpr int BK = 16;   // contraction step staged in shared memory
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int GEMM_THREADS = (BM / TM) * (BN / TN);  // 256

// acc[i][j] += sum_{k0 <= k < k1} a(row0 + ty*TM + i, k) * b(k, col0 + tx*TN + j)
// with (k1 - k0) % BK == 0. kFastA picks the thread order of the A load:
// true walks k fastest (A stored row-major by output row), false walks the
// output row fastest (A stored row-major by k, as for a transposed operand)
// — whichever keeps neighbouring threads on neighbouring addresses.
template <bool kFastA, class AFn, class BFn>
__device__ __forceinline__ void gemm_tile(const AFn& a, const BFn& b, int row0,
                                          int col0, int k0, int k1,
                                          float (&acc)[TM][TN]) {
  // +4 pads the A tile so the k-fastest store pattern spreads over banks.
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  for (int kk = k0; kk < k1; kk += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += GEMM_THREADS) {
      const int r = kFastA ? e / BK : e % BM;
      const int k = kFastA ? e % BK : e / BM;
      As[k][r] = a(row0 + r, kk + k);
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += GEMM_THREADS) {
      const int k = e / BN;
      const int c = e % BN;
      Bs[k][c] = b(kk + k, col0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM];
      float bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Dense row-major operand element B[k, c].
struct DenseB {
  const float* B;
  int ld;
  __device__ __forceinline__ float operator()(int k, int c) const {
    return B[static_cast<size_t>(k) * ld + c];
  }
};

// The ONE Gaussian affinity entry of the port, shared by K1 and the
// streaming kernels K8-K12, so the streaming passes recompute exactly the
// entries the dense path stores in phi. (br, bc, by) are the raw (row,
// col, y) features of a pixel, (ar, ac, ay) those of a sample. The
// argument is formed in the reference's op order with explicitly rounded
// multiplies and adds (no FMA contraction), from squares of exact integer
// differences before any scaling, and exponentiated by the IEEE expf
// (never __expf: the build never passes --use_fast_math).
__device__ __forceinline__ float affinity(float br, float bc, float by,
                                          float ar, float ac, float ay,
                                          float sw, float pw) {
  const float dr = br - ar;
  const float dc = bc - ac;
  const float dy = by - ay;
  const float d2s = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dc, dc));
  const float arg =
      __fadd_rn(__fmul_rn(sw, d2s), __fmul_rn(pw, __fmul_rn(dy, dy)));
  return expf(-arg);
}

// Affinity operand element K[r, k] from (3, qpad) pixel features and
// (3, ppad) sample features, both stored as rows (row, col, y).
struct AffinityA {
  const float* fb;
  const float* fa;
  int qpad;
  int ppad;
  float sw;
  float pw;
  __device__ __forceinline__ float operator()(int r, int k) const {
    return affinity(fb[r], fb[qpad + r], fb[2 * qpad + r], fa[k],
                    fa[ppad + k], fa[2 * ppad + k], sw, pw);
  }
};

// Element (i, r) of (diag(c) phi)^T: phi row-major (rows, ld).
struct ScaledColsA {
  const float* phi;
  const float* c;
  int ld;
  __device__ __forceinline__ float operator()(int i, int r) const {
    return __fmul_rn(phi[static_cast<size_t>(r) * ld + i], c[r]);
  }
};

// Element (r, j) of diag(c) phi.
struct ScaledRows {
  const float* phi;
  const float* c;
  int ld;
  __device__ __forceinline__ float operator()(int r, int j) const {
    return __fmul_rn(phi[static_cast<size_t>(r) * ld + j], c[r]);
  }
};

// sum += v with Kahan's compensation: comp carries the low part the last
// add rounded away, so a chain of n adds rounds like O(1) adds, not O(n).
// Explicitly rounded ops: nothing may fuse or reassociate them. A zero v
// returns at once, so zero terms (pad samples, pad rows) change nothing.
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float v) {
  if (v == 0.0f) return;
  const float y = __fsub_rn(v, comp);
  const float t = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

namespace {

// out[j] = sum_{b < nparts} partial[b * len + j], summed in increasing b
// with compensation: ~1000 block partials of one sign would otherwise
// round like a ~1000-term chain, which the streaming route amplifies.
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int nparts,
                                       int len) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= len) return;
  float s = 0.0f, comp = 0.0f;
  for (int b = 0; b < nparts; ++b) {
    kahan_add(s, comp, partial[static_cast<size_t>(b) * len + j]);
  }
  out[j] = __fsub_rn(s, comp);
}

inline cudaError_t launch_reduce_partials(const float* partial, float* out,
                                          int nparts, int len,
                                          cudaStream_t stream) {
  const int threads = 256;
  const int blocks = (len + threads - 1) / threads;
  reduce_partials_kernel<<<blocks, threads, 0, stream>>>(partial, out, nparts,
                                                         len);
  return cudaGetLastError();
}

}  // namespace

}  // namespace nle
