// Shared device code of the port's kernels: the one affinity entry every
// kernel that builds K uses, Kahan's compensated add, the asynchronous
// copies into shared memory (cp.async, and bulk copies completing on an
// mbarrier), and the fixed-order reduction of per-block partial sums.
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

// -- asynchronous copies into shared memory ---------------------------------

// 16 bytes from global to shared with cp.async; with valid false the
// destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid = true) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// 4 bytes from global to shared with cp.async (through L1): scatters a
// row layout into an interleaved one, which 16-byte copies cannot.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// 8 bytes from global to shared with cp.async (through L1): a double.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier in shared memory that completes a phase when its one
// arrival (the issuing thread's expect_tx) and the bulk copies' bytes
// have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One 1D bulk copy global -> shared, completing on `bar`'s transaction
// count. dst, src and bytes are multiples of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
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
