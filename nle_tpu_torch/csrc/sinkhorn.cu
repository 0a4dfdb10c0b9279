// The fused Sinkhorn half-step, one read of the factor per call, in its
// four forms, and the streaming probe beside it:
//   x = safe_recip(Q t, eps)     (npad,)   |w| >= eps -> 1/w, else 0
//   s = Q^T x                    (mpad,)
// The sweep they share is csrc/sinkhorn_sweep.cuh.
//
// K3, K4, K14 replace nle_tpu/ops/pallas/sinkhorn_kernel.py:121
// `_kernel_manual` (via sinkhorn_halfstep_manual, call :312): K3 is its
// packed-int16 branch (:162-242), K4 its f32 branch (:243-266), K14 the
// same f32 branch on a bf16 buffer (the NLE_SINKHORN_BF16 preview mode) —
// three instantiations of one template. K3 converts each int16 exactly to
// f32 and takes plain fp32 products. The TPU splits the integers and t/x
// into bf16 pieces and drops the lo*lo term (~2^-17 relative); this port
// does not, so it agrees tightly with its own plain version and differs
// from the TPU arithmetic by that 2^-17 class. K14 rounds t to bf16 before
// the product (the wrapper's t.astype(bf16), :305) and x to bf16 before
// s (x.astype(phi.dtype), :262); a bf16 x bf16 product is exact in fp32,
// so w and s are exact products summed in fp32, as the MXU's bf16 pass
// with f32 accumulation; x itself is written in f32. K14 is the one
// sanctioned bf16 kernel of the port: an opt-in preview mode, not
// golden-safe (nle_tpu documents rock2 at 24 dB against golden).
//
// K13 replaces `_kernel` (:45, via sinkhorn_halfstep_pallas, call :95),
// the block-pipelined f32 half-step behind NLE_SINKHORN_KERNEL=auto. Same
// function as K4; its decomposition is the TPU kernel's: one block per
// TILE_N row tile (the caller's tile rule), each tile's s partial to a
// (ntiles, mpad) scratch, then tile i added to stripe i % 8 in increasing
// i and the 8 stripes summed in order, plain fp32 — the `s_ref[i % 8] +=
// part` accumulator (:70-71) and the final jnp.sum(s_parts, 0).
//
// K15 replaces the probe kernel of tools/bench_sk_dmaonly.py:68 (`make`)
// and returns what it returns: an (8, max(mpad, chunk)) block whose row 0
// holds, over the probe's chunks of `chunk` rows added in order, dmaonly
// sum_i Q[i chunk, :]; wonly the chunk-folded w, sum_c w_c[:L] with L =
// min(1024, chunk) (the probe's s[0, :1024] += w[:, :1024]); wpart
// sum_c w_c^T Q_c. Every other element is 0. It runs on K3/K4/K14's bulk
// sweep below, the staging K4's half-step uses, with the plan's CTA row
// ranges rounded to whole chunks (sinkhorn_plan's chunk): each chunk's
// partial (the probe's unit of summation) goes to a (nchunks, mpad)
// scratch, then one accumulator in chunk order, which is the probe's own
// order: dmaonly is exact against it. dmaonly stages every row by bulk
// copy and adds each chunk's row 0, wonly forms w and no s, wpart both:
// so the three time the half-step's staging, its w pass and its s pass.
// The probe's NSLOTS (its DMA ring depth) is the plan's ring of slots.
//
// Layout (K3/K4/K14), redesigned for Hopper: a persistent grid of `ctas`
// CTAs (two an SM of a 132-SM card), CTA b owning the contiguous row range
// [b per_cta, min((b + 1) per_cta, npad)); sinkhorn_kernel.sinkhorn_plan
// fixes (R, S, ctas, per_cta) from (npad, mpad, dtype) alone, so s and its
// order do not depend on the card. The CTA walks its range in sub-tiles of
// R rows; one thread copies each into a ring of S shared-memory slots with
// cp.async.bulk, completing on the slot's mbarrier (K19's staging, csrc/
// sinkhorn_ab.cu), S sub-tiles ahead. Per sub-tile: one warp a row forms
// w (lanes take the row's 16-byte chunks in turn; a fixed shuffle tree),
// x to device memory and to shared memory; one barrier (which also frees
// the slot of the sub-tile before, re-issued at once); then each thread
// adds its own 16-byte column chunks' chain over the R rows into the
// CTA's s row in shared memory. x alternates two shared buffers, so that
// is the only barrier a sub-tile. Where a row has fewer 16-byte chunks than
// the block has threads, the s pass splits the rows among `groups` copies
// of the chunks (row r to group r % groups), each with its partial s row,
// added in group order at the CTA's end. The CTA's s row goes to a (ctas,
// mpad) scratch, summed in CTA order with compensation
// (launch_reduce_partials):
// the TPU accumulates s across its sequential grid in VMEM, CUDA blocks
// run in no order, and float atomics would make training non-repeatable.
// A row must be a 16-byte multiple (the bulk copy's unit); int16 converts
// exactly through the float bits of 2^23 + 2^15 + q (one PRMT and one add,
// not the 16-a-clock I2F), bf16 by a shift. For 16-bit factors t sits in
// shared memory (rounded to bf16 for K14); for f32 it is read through the
// L1 cache, which keeps the ring at two one-row slots at MAX_MPAD.
//
// Bound on the H100: at the 1 MP main path (npad ~ 1.0 M, mpad = 640) each
// half-step streams 1.3 GB (int16, bf16) or 2.6 GB (f32) for 2.6 GFLOP:
// memory-bound; the floor is ~0.4 ms (int16, bf16) / ~0.8 ms (f32) at
// 3.35 TB/s. The bulk-copy ring keeps ~80 KB of the factor in flight per
// SM with no register or instruction cost for the copy (the staging A/B
// of csrc/sinkhorn_ab.cu on the same factor: bulk copies 1.01-1.03x
// torch.mv, a cp.async ring 1.25-1.31x, plain loads 1.40-1.49x); K15
// splits this sweep's time into staging, w and s.

#include "common.cuh"
#include "sinkhorn_sweep.cuh"

namespace {

constexpr int K13_STRIPES = 8;        // the TPU kernel's (8, mpad) s block
constexpr int K15_OUT_ROWS = 8;       // the TPU probe's (8, width) output
constexpr int K15_WONLY_COLS = 1024;  // the probe's s[0, :1024] += w[:1024]

// K3/K4/K14's bulk-copy sweep.
constexpr int HB_THREADS = 256;
constexpr int HB_MAX_ROWS = 32;       // rows a sub-tile (x's shared buffers)
constexpr int HB_MAX_SLOTS = 16;      // mbarriers in the first 128 bytes
constexpr int HB_BARRIER_BYTES = 128;

// A 16-byte chunk of a factor row as float32 values, exactly.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int kValues = 4;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct Chunk<int16_t> {
  static constexpr int kValues = 8;
  // The float with bits 0x4B000000 | u16 is 2^23 + u16; u16 = q ^ 0x8000 is
  // q + 2^15, so subtracting 2^23 + 2^15 gives q exactly.
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float (&v)[8]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t b = w[k] ^ 0x80008000u;
      v[2 * k] = __fsub_rn(__uint_as_float(__byte_perm(b, 0x4B00u, 0x5410)),
                           8421376.0f);
      v[2 * k + 1] = __fsub_rn(
          __uint_as_float(__byte_perm(b, 0x4B00u, 0x5432)), 8421376.0f);
    }
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kValues = 8;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float (&v)[8]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
};

// Row groups of the s pass: as many as whole copies of a row's 16-byte
// chunks fit the block's threads (1 from 4,096-byte rows on).
__host__ __device__ inline int bulk_groups(int nchunks) {
  return nchunks >= HB_THREADS ? 1 : HB_THREADS / nchunks;
}

// Shared bytes of the bulk sweep: the barriers, the ring, a partial s row
// for each row group, t (16-bit factors) and x's two buffers.
// sinkhorn_kernel.sinkhorn_plan computes the same.
template <typename T>
size_t bulk_smem_bytes(int mpad, int R, int S) {
  const int nchunks = mpad * static_cast<int>(sizeof(T)) / 16;
  const size_t vectors = bulk_groups(nchunks) + (sizeof(T) == 2 ? 1 : 0);
  return HB_BARRIER_BYTES + static_cast<size_t>(S) * R * mpad * sizeof(T) +
         4 * (vectors * mpad + 2 * HB_MAX_ROWS);
}

// The bulk sweep over CTA b's rows [b per_cta, min((b + 1) per_cta,
// npad)) in sub-tiles of R rows (layout above). kMode: the half-step
// (K3/K4/K14: x = safe_recip(w), s partial from x, one partial the CTA:
// chunk = per_cta) or a K15 probe mode on f32 (one partial a chunk of
// `chunk` rows, to row (its last row) / chunk of the scratch: dmaonly
// stages every row and adds each chunk's row 0, forming no w; wonly
// writes w = Q t itself as x and forms no s; wpart forms s from w).
template <typename T, int kMode>
__global__ void __launch_bounds__(HB_THREADS)
    halfstep_bulk_kernel(const T* __restrict__ Q, const float* __restrict__ t,
                         float* __restrict__ x, float* __restrict__ partial,
                         int npad, int mpad, int R, int S, int per_cta,
                         int chunk, float eps) {
  constexpr int V = Chunk<T>::kValues;
  constexpr bool kTShared = sizeof(T) == 2;
  constexpr bool kW = kMode != kDmaOnly;    // the w pass
  constexpr bool kS = kMode != kWOnly;      // the s pass and its partials
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  unsigned char* ring = smem_raw + HB_BARRIER_BYTES;
  const int row_bytes = mpad * static_cast<int>(sizeof(T));
  const int slot_bytes = R * row_bytes;
  const int nchunks = row_bytes / 16;
  const int groups = bulk_groups(nchunks);
  // s_s: [groups][mpad]
  float* s_s = reinterpret_cast<float*>(ring + static_cast<size_t>(S) *
                                                   slot_bytes);
  float* t_s = s_s + groups * mpad;              // 16-bit factors only
  float* x_s = t_s + (kTShared ? mpad : 0);      // [2][HB_MAX_ROWS]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rbeg = blockIdx.x * per_cta;
  const int rend = min(rbeg + per_cta, npad);
  const int ntiles = (rend - rbeg + R - 1) / R;

  for (int j = tid; j < groups * mpad; j += HB_THREADS) s_s[j] = 0.0f;
  if (kTShared) {
    for (int j = tid; j < mpad; j += HB_THREADS) t_s[j] = operand<T>(t[j]);
  }
  if (tid == 0) {
    for (int b = 0; b < S; ++b) nle::mbar_init(&bars[b]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Sub-tile i into slot i % S; one thread.
  auto issue = [&](int i) {
    const int r0 = rbeg + i * R;
    const uint32_t bytes = static_cast<uint32_t>(min(R, rend - r0)) *
                           static_cast<uint32_t>(row_bytes);
    uint64_t* bar = &bars[i % S];
    nle::mbar_expect_tx(bar, bytes);
    nle::bulk_copy(ring + static_cast<size_t>(i % S) * slot_bytes,
                   Q + static_cast<size_t>(r0) * mpad, bytes, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < S && i < ntiles; ++i) issue(i);
  }
  for (int i = 0; i < ntiles; ++i) {
    const int r0 = rbeg + i * R;
    const int nr = min(R, rend - r0);
    const unsigned char* slot = ring + static_cast<size_t>(i % S) * slot_bytes;
    float* xb = x_s + (i & 1) * HB_MAX_ROWS;
    nle::mbar_wait(&bars[i % S], static_cast<uint32_t>((i / S) & 1));
    for (int r = warp; kW && r < nr; r += HB_THREADS / 32) {
      const unsigned char* row = slot + r * row_bytes;
      float w = 0.0f;
      for (int c = lane; c < nchunks; c += 32) {
        float q[V], tv[V];
        Chunk<T>::load(row + c * 16, q);
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          const float4 t4 =
              kTShared ? *reinterpret_cast<const float4*>(t_s + c * V + e)
                       : __ldg(reinterpret_cast<const float4*>(t + c * V + e));
          tv[e] = t4.x;
          tv[e + 1] = t4.y;
          tv[e + 2] = t4.z;
          tv[e + 3] = t4.w;
        }
#pragma unroll
        for (int e = 0; e < V; ++e) w = fmaf(q[e], tv[e], w);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        w = __fadd_rn(w, __shfl_xor_sync(0xffffffffu, w, off));
      }
      if (lane == 0) {
        const float xv = kMode != kHalfstep ? w
                         : fabsf(w) >= eps ? 1.0f / w : 0.0f;
        xb[r] = operand<T>(xv);
        x[r0 + r] = xv;
      }
    }
    // x of this sub-tile is in xb; every thread is past sub-tile i - 1.
    __syncthreads();
    if (tid == 0 && i >= 1 && i - 1 + S < ntiles) issue(i - 1 + S);
    if (!kS) continue;
    // Item k: chunk k % nchunks of the rows k / nchunks + groups i.
    for (int k = tid; k < groups * nchunks; k += HB_THREADS) {
      const int g = k / nchunks;
      const int c = k - g * nchunks;
      float a[V];
#pragma unroll
      for (int e = 0; e < V; ++e) a[e] = 0.0f;
      if (kMode == kDmaOnly) {
        // A chunk's row 0 starts a sub-tile (chunk is a multiple of R).
        if (g == 0 && r0 % chunk == 0) Chunk<T>::load(slot + c * 16, a);
      } else {
#pragma unroll 4
        for (int r = g; r < nr; r += groups) {
          const float xr = xb[r];
          float q[V];
          Chunk<T>::load(slot + r * row_bytes + c * 16, q);
#pragma unroll
          for (int e = 0; e < V; ++e) a[e] = fmaf(xr, q[e], a[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        float4* sp = reinterpret_cast<float4*>(s_s + g * mpad + c * V + e);
        const float4 o = *sp;
        *sp = make_float4(__fadd_rn(o.x, a[e]), __fadd_rn(o.y, a[e + 1]),
                          __fadd_rn(o.z, a[e + 2]), __fadd_rn(o.w, a[e + 3]));
      }
    }
    if ((r0 + nr - rbeg) % chunk == 0 || r0 + nr == rend) {
      // The partial's last sub-tile: its s row, the groups' partials added
      // in group order, to row (r0 + nr - 1) / chunk, and a fresh start.
      __syncthreads();
      float* dst = partial + static_cast<size_t>((r0 + nr - 1) / chunk) * mpad;
      for (int j = tid; j < mpad; j += HB_THREADS) {
        float v = s_s[j];
        s_s[j] = 0.0f;
        for (int g = 1; g < groups; ++g) {
          v = __fadd_rn(v, s_s[g * mpad + j]);
          s_s[g * mpad + j] = 0.0f;
        }
        dst[j] = v;
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether (R, S, ctas, per_cta, smem) is sinkhorn_plan's for the shape:
// every row covered once by whole sub-tiles, the ring and the vectors in
// the shared bytes it names, 16-byte rows and operands.
template <typename T>
bool plan_ok(const T* Q, const float* t, int npad, int mpad, int R, int S,
             int ctas, int per_cta, int smem) {
  return npad >= 1 && mpad >= 1 && (mpad * sizeof(T)) % 16 == 0 && R >= 1 &&
         R <= HB_MAX_ROWS && S >= 2 && S <= HB_MAX_SLOTS && ctas >= 1 &&
         per_cta >= 1 && per_cta % R == 0 &&
         static_cast<long long>(ctas - 1) * per_cta < npad &&
         static_cast<long long>(ctas) * per_cta >= npad &&
         static_cast<size_t>(smem) == bulk_smem_bytes<T>(mpad, R, S) &&
         aligned16(Q) && aligned16(t);
}

template <typename T, int kMode>
cudaError_t launch_bulk(const T* Q, const float* t, float* x, float* partial,
                        int npad, int mpad, int R, int S, int ctas,
                        int per_cta, int chunk, int smem, float eps,
                        cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      halfstep_bulk_kernel<T, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  halfstep_bulk_kernel<T, kMode><<<ctas, HB_THREADS, smem, st>>>(
      Q, t, x, partial, npad, mpad, R, S, per_cta, chunk, eps);
  return cudaGetLastError();
}

// The launch of sinkhorn_plan's (rows, slots, ctas, per_cta, smem); any
// other plan, or a row that is not a 16-byte multiple, is refused.
template <typename T>
int launch_halfstep(const T* Q, const float* t, float* x, float* partial,
                    float* s, int npad, int mpad, int R, int S, int ctas,
                    int per_cta, int smem, float eps, void* stream) {
  if (!plan_ok(Q, t, npad, mpad, R, S, ctas, per_cta, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_bulk<T, kHalfstep>(Q, t, x, partial, npad, mpad, R,
                                              S, ctas, per_cta, per_cta, smem,
                                              eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      nle::launch_reduce_partials(partial, s, ctas, mpad, st));
}

}  // namespace

// K3: Q (npad, mpad) int16, t (mpad,) -> x (npad,), s (mpad,) on
// sinkhorn_plan(npad, mpad, int16) = (rows, slots, ctas, per_cta, smem);
// partial is scratch of ctas * mpad floats.
#define NLE_HALFSTEP_ARGS                                                  \
  float *x, float *partial, float *s, int npad, int mpad, int rows,        \
      int slots, int ctas, int per_cta, int smem, float eps, void *stream
extern "C" int nle_sinkhorn_halfstep_i16(const int16_t* Q, const float* t,
                                         NLE_HALFSTEP_ARGS) {
  return launch_halfstep<int16_t>(Q, t, x, partial, s, npad, mpad, rows,
                                  slots, ctas, per_cta, smem, eps, stream);
}

// K4: Q (npad, mpad) float32; otherwise as above.
extern "C" int nle_sinkhorn_halfstep_f32(const float* Q, const float* t,
                                         NLE_HALFSTEP_ARGS) {
  return launch_halfstep<float>(Q, t, x, partial, s, npad, mpad, rows, slots,
                                ctas, per_cta, smem, eps, stream);
}

// K14: Q (npad, mpad) bfloat16, t float32 (rounded to bf16 in the kernel);
// x and s float32; otherwise as above.
extern "C" int nle_sinkhorn_halfstep_bf16(const void* Q, const float* t,
                                          NLE_HALFSTEP_ARGS) {
  return launch_halfstep<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(Q), t, x, partial, s, npad, mpad,
      rows, slots, ctas, per_cta, smem, eps, stream);
}
#undef NLE_HALFSTEP_ARGS

// K13: Q (npad, mpad) float32 with npad a multiple of `rows`, the row tile;
// partial is scratch of (npad / rows) * mpad floats.
extern "C" int nle_sinkhorn_tiled_f32(const float* Q, const float* t,
                                      float* x, float* partial, float* s,
                                      int npad, int mpad, int rows, float eps,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_tiled<kHalfstep>(Q, t, x, partial, npad, mpad,
                                            rows, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ordered_reduce(
      partial, mpad, npad / rows, mpad, K13_STRIPES, s, 1, mpad, st));
}

// K15: the TPU probe's (8, max(mpad, chunk)) output `out` for mode 1
// dmaonly (row 0 = sum_i Q[i * chunk, :]), 2 wonly (row 0, columns < L =
// min(1024, chunk): sum_c w_c[:L], w_c = Q_c t) or 3 wpart (row 0 =
// sum_c w_c^T Q_c), the chunks added in order; every other element 0. Q
// float32 with npad a multiple of chunk, on the bulk sweep of
// sinkhorn_plan(npad, mpad, float32, chunk) = (rows, slots, ctas, per_cta,
// smem), whose per_cta is a whole number of chunks; x (npad,) holds w
// (wonly, wpart); partial is scratch of (npad / chunk) * mpad floats.
// wonly needs min(1024, max(mpad, chunk)) == L, as the TPU probe traces
// only then.
extern "C" int nle_sinkhorn_probe_f32(const float* Q, const float* t,
                                      float* x, float* partial, float* out,
                                      int npad, int mpad, int chunk, int mode,
                                      int rows, int slots, int ctas,
                                      int per_cta, int smem, void* stream) {
  if (chunk < 1 || npad % chunk != 0 || chunk % rows != 0 ||
      per_cta % chunk != 0 ||
      !plan_ok(Q, t, npad, mpad, rows, slots, ctas, per_cta, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int width = mpad > chunk ? mpad : chunk;
  const int fold = chunk < K15_WONLY_COLS ? chunk : K15_WONLY_COLS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case kDmaOnly:
      err = launch_bulk<float, kDmaOnly>(Q, t, x, partial, npad, mpad, rows,
                                         slots, ctas, per_cta, chunk, smem,
                                         0.0f, st);
      break;
    case kWOnly:
      if ((width < K15_WONLY_COLS ? width : K15_WONLY_COLS) != fold) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      err = launch_bulk<float, kWOnly>(Q, t, x, partial, npad, mpad, rows,
                                       slots, ctas, per_cta, chunk, smem,
                                       0.0f, st);
      if (err != cudaSuccess) return static_cast<int>(err);
      // w viewed as (npad / chunk, chunk): the first L entries of each
      // chunk, added in chunk order.
      return static_cast<int>(launch_ordered_reduce(
          x, chunk, npad / chunk, fold, 1, out, K15_OUT_ROWS, width, st));
    case kWPart:
      err = launch_bulk<float, kWPart>(Q, t, x, partial, npad, mpad, rows,
                                       slots, ctas, per_cta, chunk, smem,
                                       0.0f, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ordered_reduce(
      partial, mpad, npad / chunk, mpad, 1, out, K15_OUT_ROWS, width, st));
}
