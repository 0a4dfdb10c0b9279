// K6 and K7: products of the row-scaled factor diag(c) phi, with c applied
// once to each element as it lands in shared memory, so c*phi never exists
// in device memory.
//
// K6 replaces nle_tpu/ops/pallas/scaled_matmul_kernel.py:56 `_gram_kernel`
// (via scaled_gram_pallas): Sb = (diag(c) phi)^T (diag(c) phi), (mpad, mpad)
// over npad rows. K7 replaces :111 `_matmul_kernel` (via
// scaled_matmul_pallas): V = (diag(c) phi) B, (npad, kpad) from
// (npad, mpad) x (mpad, kpad).
//
// Bound on the H100: fp32 FMA on the CUDA cores (the numerical contract
// bars TF32, bf16 and every tensor-core path, so there is no mma/wgmma
// here). At the 1 MP main path (npad ~ 1.0 M, mpad = 640) K6's lower
// triangle is 0.50 TFLOP over a 2.6 GB read, compute-bound; K7 at
// kpad = 64 is 0.08 TFLOP over 2.85 GB, near the balance point. Both are
// register-blocked SGEMM tiles: 256 threads, 8 x 8 (K7: 8 x TN) outputs a
// thread, shared memory read as 16-byte vectors (4 vector loads for 64
// FFMAs a k-step), and the operands staged through a ring of 32-row slabs
// filled by 16-byte cp.async while the slab before them is consumed.
//
// K6 (the TPU carries the (mpad, mpad) sum in VMEM across its sequential
// grid; CUDA blocks run in no order):
//  - only the lower triangle of 128 x 128 tiles is computed (tile (I, J),
//    I >= J, over column panels I and J of phi; a diagonal tile stages one
//    panel);
//  - the rows are cut into nsplit equal splits (the last ragged), chosen
//    from the shapes alone (scaled_matmul_kernel.gram_plan) so that
//    tiles x splits fills whole waves of the card;
//  - no fp32 register chain runs longer than chain_rows rows: a block
//    adds its accumulator into its own (split, tile) scratch slot after
//    every chain_rows rows, in row order;
//  - a second kernel sums each element's splits in order (compensated)
//    and writes Sb[i][j] and Sb[j][i] from the one value: the result is
//    bitwise symmetric and bitwise repeatable. No float atomics.
// The scratch is nsplit x tiles x 128^2 floats: it does not grow with npad.
//
// K7: each block owns 256 rows and 8 * TN of B's columns (all of kpad at
// the path's kpad = 64, so phi is read once), walks mpad in 32-row slabs
// of B and 32-column slabs of phi (a 2-slot ring, 112 KB: two blocks an
// SM), and every output element is summed by one thread in increasing k.
// The staged phi slab is scaled by c and transposed into a k-major tile in
// one pass.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

using nle::cp_async16;
using nle::cp_async_commit;
using nle::cp_async_wait;

__device__ __forceinline__ float4 scale4(float4 v, float c) {
  return make_float4(__fmul_rn(v.x, c), __fmul_rn(v.y, c), __fmul_rn(v.z, c),
                     __fmul_rn(v.w, c));
}

// -- K6 -------------------------------------------------------------------

constexpr int GT = 128;      // output tile edge = column panel width
constexpr int G_SLAB = 32;   // rows staged a step
constexpr int G_STAGES = 3;  // slabs in the ring
// One stage: the two panels' slabs (G_SLAB x GT each) and the slab's c.
constexpr int G_STAGE_FLOATS = 2 * G_SLAB * GT + G_SLAB;
constexpr int G_SMEM_BYTES = G_STAGES * G_STAGE_FLOATS * 4;

// Tile t of the lower triangle, row-major: (0,0), (1,0), (1,1), (2,0), ...
__device__ __forceinline__ void tri_tile(int t, int& I, int& J) {
  int i = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  I = i;
  J = t - i * (i + 1) / 2;
}

// Block (t, split): the partial gram of tile t over the split's rows,
// added into partial[split][t] every chain_rows rows.
__global__ void __launch_bounds__(THREADS, 2)
    gram_tri_kernel(const float* __restrict__ phi, const float* __restrict__ c,
                    float* __restrict__ partial, int npad, int mpad,
                    int split_rows, int chain_rows) {
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.x;
  const int ntiles = gridDim.x;
  int I, J;
  tri_tile(t, I, J);
  const bool diag = I == J;
  const int r0 = blockIdx.y * split_rows;
  const int nslab = (min(r0 + split_rows, npad) - r0) / G_SLAB;
  const int chain_slabs = chain_rows / G_SLAB;
  const int tid = threadIdx.x;

  // Copy share: chunk (row tid / 32 + 8 h, 16-byte column tid % 32) of
  // each panel's slab, h < G_SLAB / 8; threads 0-7 also copy the slab's c.
  const int cp_row = tid / 32;
  const int cp_col = (tid % 32) * 4;
  const float* srcA = phi + static_cast<size_t>(r0 + cp_row) * mpad +
                      I * GT + cp_col;
  const float* srcB = phi + static_cast<size_t>(r0 + cp_row) * mpad +
                      J * GT + cp_col;
  auto stageA = [&](int s) { return smem + s * G_STAGE_FLOATS; };
  auto stageB = [&](int s) {
    return smem + s * G_STAGE_FLOATS + (diag ? 0 : G_SLAB * GT);
  };
  auto stageC = [&](int s) {
    return smem + s * G_STAGE_FLOATS + 2 * G_SLAB * GT;
  };

  auto issue = [&](int slab) {
    if (slab < nslab) {
      const int s = slab % G_STAGES;
      const size_t off = static_cast<size_t>(slab) * G_SLAB * mpad;
#pragma unroll
      for (int h = 0; h < G_SLAB / 8; ++h) {
        const size_t roff = off + static_cast<size_t>(8 * h) * mpad;
        cp_async16(stageA(s) + (cp_row + 8 * h) * GT + cp_col, srcA + roff,
                   true);
        if (!diag) {
          cp_async16(stageB(s) + (cp_row + 8 * h) * GT + cp_col, srcB + roff,
                     true);
        }
      }
      if (tid < G_SLAB / 4) {
        cp_async16(stageC(s) + tid * 4, c + r0 + slab * G_SLAB + tid * 4,
                   true);
      }
    }
    cp_async_commit();
  };

  // Scale this thread's own chunks of a landed slab by c, in place.
  auto scale = [&](int s) {
    const float* cs = stageC(s);
#pragma unroll
    for (int h = 0; h < G_SLAB / 8; ++h) {
      const int r = cp_row + 8 * h;
      const float cr = cs[r];
      float4* a = reinterpret_cast<float4*>(stageA(s) + r * GT + cp_col);
      *a = scale4(*a, cr);
      if (!diag) {
        float4* b = reinterpret_cast<float4*>(stageB(s) + r * GT + cp_col);
        *b = scale4(*b, cr);
      }
    }
  };

  // Outputs: rows ty*4 + i and 64 + ty*4 + i of panel I, columns tx*4 + j
  // and 64 + tx*4 + j of panel J.
  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  float* slot = partial + (static_cast<size_t>(blockIdx.y) * ntiles + t) *
                              (GT * GT);
  bool first_flush = true;
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int a = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4* dst = reinterpret_cast<float4*>(slot + a * GT + h * 64 +
                                                tx * 4);
        float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                               acc[i][4 * h + 2], acc[i][4 * h + 3]);
        if (!first_flush) {
          const float4 o = *dst;
          v = make_float4(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y),
                          __fadd_rn(o.z, v.z), __fadd_rn(o.w, v.w));
        }
        *dst = v;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
    first_flush = false;
  };

#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) issue(s);

  for (int it = 0; it < nslab; ++it) {
    const int s = it % G_STAGES;
    cp_async_wait<G_STAGES - 2>();
    __syncthreads();
    scale(s);
    issue(it + G_STAGES - 1);
    __syncthreads();
    const float* As = stageA(s);
    const float* Bs = stageB(s);
#pragma unroll
    for (int k = 0; k < G_SLAB; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * GT + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + k * GT + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * GT + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + k * GT + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if ((it + 1) % chain_slabs == 0 || it + 1 == nslab) flush();
  }
  cp_async_wait<0>();
}

// out = sum over splits of partial[split][t], in split order, compensated;
// tile (I, J) element (a, b) goes to Sb[I*128 + a][J*128 + b] and to its
// mirror. A diagonal tile writes only its lower triangle's values, to both.
__global__ void __launch_bounds__(THREADS)
    gram_tri_reduce_kernel(const float* __restrict__ partial,
                           float* __restrict__ out, int nsplit, int mpad) {
  const int t = blockIdx.y;
  const int ntiles = gridDim.y;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int a = e / GT;
  const int b = e % GT;
  int I, J;
  tri_tile(t, I, J);
  if (I == J && a < b) return;
  float s = 0.0f, comp = 0.0f;
  for (int k = 0; k < nsplit; ++k) {
    nle::kahan_add(
        s, comp,
        partial[(static_cast<size_t>(k) * ntiles + t) * (GT * GT) + e]);
  }
  const float v = __fsub_rn(s, comp);
  const int i = I * GT + a;
  const int j = J * GT + b;
  out[static_cast<size_t>(i) * mpad + j] = v;
  out[static_cast<size_t>(j) * mpad + i] = v;
}

// -- K7 -------------------------------------------------------------------

constexpr int MB_ROWS = 256;  // output rows a block
constexpr int SLAB = 32;      // contraction columns staged a step
constexpr int M_STAGES = 2;   // slabs in the ring

constexpr int m_smem_bytes(int width) {
  // Ring: phi slab (MB_ROWS x SLAB) + B slab (SLAB x width); then the
  // scaled, transposed phi tile (SLAB x MB_ROWS). 112 KB at width 64: two
  // blocks an SM.
  return 4 * (M_STAGES * (MB_ROWS * SLAB + SLAB * width) + SLAB * MB_ROWS);
}

// Float offset of 16-byte chunk q / 4 of row r in the staged phi slab:
// the chunk index XOR r % 8, so the 8 rows that one phase of a warp reads
// at the same k fall on 8 different bank quads (no padding needed).
__device__ __forceinline__ int swz(int r, int q) {
  return ((q / 4) ^ (r & 7)) * 4;
}

// Outputs a thread: rows ty*4 + i and 128 + ty*4 + i (ty = tid / 8), and
// TN columns g*32 + tx*4 + j (tx = tid % 8, g < TN / 4): 8 x TN; the block
// covers MB_ROWS x 8*TN.
template <int TN>
__global__ void __launch_bounds__(THREADS, TN <= 8 ? 2 : 1)
    scaled_matmul_kernel(const float* __restrict__ phi,
                         const float* __restrict__ c,
                         const float* __restrict__ B, float* __restrict__ out,
                         int npad, int mpad, int kpad) {
  constexpr int W = 8 * TN;
  constexpr int G = TN / 4;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                                  // [stage][row][k]
  float* bsl = smem + M_STAGES * MB_ROWS * SLAB;      // [stage][k][col]
  float* at = bsl + M_STAGES * SLAB * W;              // [k][row]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * MB_ROWS;
  const int col0 = blockIdx.y * W;
  const int nslab = mpad / SLAB;

  // The scale pass owns row tid of every slab: its c is read once.
  const float crow = row0 + tid < npad ? c[row0 + tid] : 0.0f;

  auto issue = [&](int slab) {
    if (slab < nslab) {
      const int s = slab % M_STAGES;
      const int k0 = slab * SLAB;
      // phi: 8 chunks a row (128 B contiguous), rows past npad
      // zero-filled.
#pragma unroll
      for (int h = 0; h < SLAB / 4; ++h) {
        const int e = tid + h * THREADS;
        const int r = e / (SLAB / 4);
        const int q = (e % (SLAB / 4)) * 4;
        const bool ok = row0 + r < npad;
        const float* src =
            ok ? phi + static_cast<size_t>(row0 + r) * mpad + k0 + q : phi;
        cp_async16(raw + (s * MB_ROWS + r) * SLAB + swz(r, q), src, ok);
      }
      for (int e = tid; e < SLAB * W / 4; e += THREADS) {
        const int k = e / (W / 4);
        const int q = (e % (W / 4)) * 4;
        cp_async16(bsl + (s * SLAB + k) * W + q,
                   B + static_cast<size_t>(k0 + k) * kpad + col0 + q, true);
      }
    }
    cp_async_commit();
  };

  const int ty = tid / 8;
  const int tx = tid % 8;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < M_STAGES - 1; ++s) issue(s);

  for (int it = 0; it < nslab; ++it) {
    const int s = it % M_STAGES;
    cp_async_wait<M_STAGES - 2>();
    __syncthreads();
    // Scale row tid of the landed slab by c and store it k-major.
    const float* src = raw + (s * MB_ROWS + tid) * SLAB;
#pragma unroll
    for (int q = 0; q < SLAB; q += 4) {
      const float4 v =
          scale4(*reinterpret_cast<const float4*>(src + swz(tid, q)), crow);
      at[(q + 0) * MB_ROWS + tid] = v.x;
      at[(q + 1) * MB_ROWS + tid] = v.y;
      at[(q + 2) * MB_ROWS + tid] = v.z;
      at[(q + 3) * MB_ROWS + tid] = v.w;
    }
    issue(it + M_STAGES - 1);
    __syncthreads();
    const float* Bs = bsl + s * SLAB * W;
#pragma unroll
    for (int k = 0; k < SLAB; ++k) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(at + k * MB_ROWS + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(at + k * MB_ROWS + 128 + ty * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[TN];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 b =
            *reinterpret_cast<const float4*>(Bs + k * W + g * 32 + tx * 4);
        bv[4 * g] = b.x;
        bv[4 * g + 1] = b.y;
        bv[4 * g + 2] = b.z;
        bv[4 * g + 3] = b.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? 0 : 128) + ty * 4 + (i & 3);
    if (r >= npad) continue;
    float* dst = out + static_cast<size_t>(r) * kpad + col0 + tx * 4;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      *reinterpret_cast<float4*>(dst + g * 32) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                      acc[i][4 * g + 3]);
    }
  }
}

template <int TN>
cudaError_t launch_matmul(const float* phi, const float* c, const float* B,
                          float* out, int npad, int mpad, int kpad,
                          cudaStream_t s) {
  constexpr int bytes = m_smem_bytes(8 * TN);
  cudaError_t err = cudaFuncSetAttribute(
      scaled_matmul_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((npad + MB_ROWS - 1) / MB_ROWS, kpad / (8 * TN));
  scaled_matmul_kernel<TN><<<grid, THREADS, bytes, s>>>(phi, c, B, out, npad,
                                                        mpad, kpad);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// phi (npad, mpad), c (npad,) -> out (mpad, mpad). partial is caller-owned
// scratch of nsplit * ntiles * 128 * 128 floats, ntiles = P (P + 1) / 2 for
// P = mpad / 128. Split k covers rows [k split_rows, min((k + 1)
// split_rows, npad)); every split is non-empty.
extern "C" int nle_scaled_gram(const float* phi, const float* c,
                               float* partial, float* out, int npad, int mpad,
                               int nsplit, int split_rows, int chain_rows,
                               void* stream) {
  if (npad < G_SLAB || npad % G_SLAB || mpad < GT || mpad % GT ||
      nsplit < 1 || split_rows < G_SLAB || split_rows % G_SLAB ||
      chain_rows < G_SLAB || chain_rows % G_SLAB ||
      static_cast<long long>(nsplit) * split_rows < npad ||
      static_cast<long long>(nsplit - 1) * split_rows >= npad ||
      !aligned16(phi) || !aligned16(c) || !aligned16(partial)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int panels = mpad / GT;
  const int ntiles = panels * (panels + 1) / 2;
  cudaError_t err = cudaFuncSetAttribute(
      gram_tri_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_tri_kernel<<<dim3(ntiles, nsplit), THREADS, G_SMEM_BYTES, s>>>(
      phi, c, partial, npad, mpad, split_rows, chain_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_tri_reduce_kernel<<<dim3(GT * GT / THREADS, ntiles), THREADS, 0, s>>>(
      partial, out, nsplit, mpad);
  return static_cast<int>(cudaGetLastError());
}

// phi (npad, mpad), c (npad,), B (mpad, kpad) -> out (npad, kpad);
// mpad % 32 == 0, kpad a multiple of 32 up to 256.
extern "C" int nle_scaled_matmul(const float* phi, const float* c,
                                 const float* B, float* out, int npad,
                                 int mpad, int kpad, void* stream) {
  if (npad < 1 || mpad < SLAB || mpad % SLAB || kpad < 32 || kpad % 32 ||
      kpad > 256 || !aligned16(phi) || !aligned16(B) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kpad % 128 == 0) {
    err = launch_matmul<16>(phi, c, B, out, npad, mpad, kpad, s);
  } else if (kpad % 96 == 0) {
    err = launch_matmul<12>(phi, c, B, out, npad, mpad, kpad, s);
  } else if (kpad % 64 == 0) {
    err = launch_matmul<8>(phi, c, B, out, npad, mpad, kpad, s);
  } else {
    err = launch_matmul<4>(phi, c, B, out, npad, mpad, kpad, s);
  }
  return static_cast<int>(err);
}
