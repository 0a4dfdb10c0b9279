// K8, K10, K11 and K12: the phi-free (streaming) stage-2 kernels. Every
// pass recomputes the (rows, p) affinity between rest pixels and samples
// from the raw (3, qpad) / (3, ppad) feature rows with nle::affinity, the
// same entry K1 stores in phi, so no (N, m) array ever exists.
//
// K8 replaces nle_tpu/ops/pallas/streaming_kernel.py:105 `_halfstep_kernel`
// (call :163):  x = mask * safe_recip(K^T u, eps),  ap = K x   (one sweep);
// with unit_x, x = mask (the s0 = phi^T 1 pass, K10's kernel on the mask).
// K9 replaces :189 `_halfstep_ptiled_kernel` (call :263): K8's function at
// any ppad. It is served by K8's kernel up to ppad 4096 (the TPU split it
// in two passes because a (TILE_Q, Ppad) tile did not fit VMEM; a Hopper
// block holds its columns in registers), and by two passes past it.
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
// cores, not by bytes. Each keeps its sample-side operands on chip (K8
// and K10: the thread's own consecutive sample columns in registers and
// the pixel rows staged in shared memory a few 32-row chunks ahead; K11:
// its own pixel rows in registers and the samples staged interleaved in
// shared memory), so the entry loops hold no device load and every shared
// load is a broadcast that feeds several entries. Each reads each pixel's
// features once per pass (per p-tile) and builds every entry exactly once
// per pass. K12 is fp32 FMA work (the phi build, 2 q p mpad, plus the
// gram, q mpad^2), compute-bound like K1 and K6.
//
// K8/K9: each entry is built once per half-step (one expf). A block
// keeps all ppad sample columns in its threads' registers (4 or 8 a
// thread), so a row's w = K u is complete inside the block, x follows, and
// the entries still in registers take x into ap: no entry goes to shared
// or device memory. Past ppad 4096 the block's registers no longer hold
// the columns and the entries; there K9 runs two passes, building each
// entry twice: pass 1 is K11's kernel with b = u and x = mask *
// safe_recip(w) as its epilogue, pass 2 is K10 on that x.
//
// Cross-block sums (K8's, K9's and K10's ap, K12's Sb) never use float atomics:
// a bounded number of blocks each own a fixed contiguous row range and
// write a partial, and a second kernel sums the partials in block order
// (K12: K6's row splits of each chunk, then the chunks in order), so
// training stays bitwise repeatable. The TPU carries these sums across its
// sequential grid in VMEM, which CUDA blocks cannot do.
//
// K12 per row chunk (streaming_kernel.stream_gram_plan): the chunk's phi
// rows into a scratch by the affinity core K1 runs on (csrc/
// affinity_core.cuh: each entry built once per column panel of up to 384
// columns, once at the capacity paths' mpad 384, and multiplied by an
// 8 x 12-a-thread fp32 core fed by a cp.async ring of Uinv slabs); then
// K6's lower-triangle gram of diag(c) phi over its planned splits
// (csrc/scaled_matmul.cu), mirrored; then that chunk's gram added into Sb
// with compensation.
//
// Long fp32 chains are compensated (nle::kahan_add): the sums over rows
// (K8's and K10's 32-row chains, every kernel's block partials) and over
// samples (K8's sum of w over 256-sample segments, the two-pass K9's pass
// 1, K11). The streaming route turns ap into
// u = Uinv (lambda * Uinv^T ap) with eigenvalues down to 1e-10, so a
// chain's rounding reaches the Sinkhorn vectors amplified: plain chains
// put the card's c 3x further from float64 than the plain version's cuBLAS
// sums do, compensated ones 5.6x closer (PERF.md).

#include "common.cuh"

// K12, step 1 of a row chunk: its phi rows = K Uinv, by the affinity core
// (csrc/affinity_core.cuh through K1's C entry, csrc/affinity.cu): each
// entry built once per column panel of up to 384 columns (once at the
// capacity paths' mpad 384), one fmaf chain an output in increasing
// sample index, so these rows are bitwise K1's for the same pixels.
extern "C" int nle_affinity_matmul(const float* fb, const float* fa,
                                   const float* B, float* out, int qpad,
                                   int ppad, int mpad, int r0, int rows,
                                   int q_true, float sw, float pw,
                                   void* stream);

namespace {

// Blocks of K8/K10: at most 8 per SM of a 132-SM card, each walking a
// contiguous range of whole 32-row groups. A function of qpad alone, so the
// partial sums (and their order) do not depend on the card.
constexpr int ST_MAX_BLOCKS = 1056;
constexpr int ST_ROW_GRAIN = 32;
constexpr int ST_P_GRAIN = 16;   // Ppad's grain (the affinity core's step)

inline int rows_per_block(int qpad) {
  int per = (qpad + ST_MAX_BLOCKS - 1) / ST_MAX_BLOCKS;
  per = (per + ST_ROW_GRAIN - 1) / ST_ROW_GRAIN * ST_ROW_GRAIN;
  return per < ST_ROW_GRAIN ? ST_ROW_GRAIN : per;
}

inline int ap_blocks(int qpad) {
  const int per = rows_per_block(qpad);
  return (qpad + per - 1) / per;
}

// G consecutive floats of a staged row array, as one shared load (the
// step's first row is a multiple of G).
template <int G>
__device__ __forceinline__ void load_rows(const float* src, float (&v)[G]) {
  if constexpr (G == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (G == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = src[g];
  }
}

// K10, K8's unit_x pass (R = 1, x = mask) and K9's pass 2 (R = 1):
// ap[k, j] = sum_i x[k, i] K[i, j] over this block's rows, into
// partial[blockIdx.x, k, j]. Block (x, y) owns the row range of
// rows_per_block(qpad) from x * per_block and the p-tile of ptile samples
// from y * ptile (streaming_kernel.ap_plan: one tile up to C x most
// threads). Thread t owns the C consecutive columns j0 + t C + c, with
// their features in registers (zero past the tile: those columns are built
// and never written, so no entry pays a bounds test). Warp 0 stages the
// pixel rows' (r, c, y, x_0 .. x_{R-1}) into a ring of AP_RING 32-row
// chunks in shared memory with cp.async, two chunks ahead (one barrier a
// chunk); every warp reads G rows of each array as one broadcast load, so
// a row's loads are shared by its C entries a thread and no device load
// sits in the entry loop. Each column sums its rows in increasing order,
// two-level: a 32-row chunk as one fp32 fmaf chain, each chain added into
// the block's sum with compensation (kahan_add): a block owns ~4,000 rows
// at 4 MP and ~30,000 at 32 MP, and the streaming route divides ap's
// rounding by eigenvalues down to 1e-10 (PERF.md). Rows whose x entries
// are zero (the pad rows) add exact zeros (fmaf(0, a, s) is s: a is finite
// and a chain never holds -0), so the sums are bitwise those of a loop that
// skips them, and a column's sum depends on neither the tiling of the
// samples nor the plan's C and G.
constexpr int AP_RING = 3;

// The instantiations K10's kernel has, one per R: (R, C columns a thread,
// G rows a step, most threads a block), streaming_kernel.AP_TILES. The
// launch bound caps the registers: 64 at R = 1 (eight 128-thread blocks
// an SM at Ppad 640, 32 warps), 128 at R = 2, 3.
#define AP_TILES(X) X(1, 5, 4, 1024) X(2, 4, 4, 512) X(3, 4, 2, 512)

template <int R>
struct ApTile;
#define AP_TILE_BOUND(RR, CC, GG, MT)     \
  template <>                             \
  struct ApTile<RR> {                     \
    static constexpr int kCols = CC;      \
    static constexpr int kRows = GG;      \
    static constexpr int kMaxThreads = MT; \
  };
AP_TILES(AP_TILE_BOUND)
#undef AP_TILE_BOUND

template <int R>
__global__ void __launch_bounds__(ApTile<R>::kMaxThreads)
    stream_ap_kernel(const float* __restrict__ fb, const float* __restrict__ fa,
                     const float* __restrict__ X, float* __restrict__ partial,
                     int qpad, int ppad, int ptile, int per_block, float sw,
                     float pw) {
  constexpr int C = ApTile<R>::kCols;
  constexpr int G = ApTile<R>::kRows;
  constexpr int kArrays = 3 + R;                    // r, c, y, x_0 ..
  constexpr int kChunk = kArrays * ST_ROW_GRAIN;    // floats a chunk
  extern __shared__ float4 ap_smem4[];
  float* ring = reinterpret_cast<float*>(ap_smem4);  // [AP_RING][kArrays][32]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j0 = blockIdx.y * ptile;
  const int jend = min(j0 + ptile, ppad);
  float sr[C], sc[C], sy[C];
  float acc[R][C], comp[R][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + tid * C + c;
    const bool in = j < jend;
    sr[c] = in ? fa[j] : 0.0f;
    sc[c] = in ? fa[ppad + j] : 0.0f;
    sy[c] = in ? fa[2 * ppad + j] : 0.0f;
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k][c] = comp[k][c] = 0.0f;
  }
  const int rbeg = blockIdx.x * per_block;
  // Whole chunks: qpad and per_block are multiples of ST_ROW_GRAIN.
  const int nchunks = (min(rbeg + per_block, qpad) - rbeg) / ST_ROW_GRAIN;
  // Chunk k into its ring slot: lane l copies 16-byte pieces of the
  // chunk's kArrays row arrays (8 a row array).
  auto stage = [&](int k) {
    float* dst = ring + (k % AP_RING) * kChunk;
    const size_t r0 = static_cast<size_t>(rbeg) + k * ST_ROW_GRAIN;
    for (int e = lane; e < kArrays * 8; e += 32) {
      const int a = e >> 3;
      const int off = (e & 7) * 4;
      const float* src = a < 3 ? fb + static_cast<size_t>(a) * qpad
                               : X + static_cast<size_t>(a - 3) * qpad;
      nle::cp_async16(dst + a * ST_ROW_GRAIN + off, src + r0 + off);
    }
  };
  if (tid < 32) {
#pragma unroll
    for (int k = 0; k < AP_RING - 1; ++k) {
      if (k < nchunks) stage(k);
      nle::cp_async_commit();
    }
  }
  for (int k = 0; k < nchunks; ++k) {
    if (tid < 32) nle::cp_async_wait<AP_RING - 2>();
    __syncthreads();   // chunk k landed; every warp is done with chunk k - 1
    if (tid < 32) {    // into chunk k - 1's slot
      if (k + AP_RING - 1 < nchunks) stage(k + AP_RING - 1);
      nle::cp_async_commit();
    }
    const float* rows = ring + (k % AP_RING) * kChunk;
    float part[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) part[r][c] = 0.0f;
#pragma unroll 1
    for (int i = 0; i < ST_ROW_GRAIN; i += G) {
      float br[G], bc[G], by[G], xv[R][G];
      load_rows<G>(rows + i, br);
      load_rows<G>(rows + ST_ROW_GRAIN + i, bc);
      load_rows<G>(rows + 2 * ST_ROW_GRAIN + i, by);
#pragma unroll
      for (int r = 0; r < R; ++r) load_rows<G>(rows + (3 + r) * ST_ROW_GRAIN + i, xv[r]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float a =
              nle::affinity(br[g], bc[g], by[g], sr[c], sc[c], sy[c], sw, pw);
#pragma unroll
          for (int r = 0; r < R; ++r) part[r][c] = fmaf(xv[r][g], a, part[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) nle::kahan_add(acc[r][c], comp[r][c], part[r][c]);
  }
  float* dst = partial + static_cast<size_t>(blockIdx.x) * R * ppad;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + tid * C + c;
    if (j < jend) {
#pragma unroll
      for (int r = 0; r < R; ++r) dst[r * ppad + j] = __fsub_rn(acc[r][c], comp[r][c]);
    }
  }
}

// K8 and K9 (the redesigned half-step, one build of each entry): x =
// mask * safe_recip(K u, eps) and the block's partial of ap = K^T x.
// Thread t owns the C consecutive sample columns j = t * C + c, with
// their features and u in registers (zero past ppad). A block walks its
// row range in 32-row chunks, each in groups of G rows:
//   1. each thread builds the group's G x C entries into registers and
//      sums its columns' terms of w = K u per row (cols_sum);
//   2. a transposing butterfly sums the G rows over the warp's lanes at
//      once (warp_rows_sum); one lane per row writes the warp's sum to
//      ws[buf][g][warp];
//   3. one barrier; then lane g of the finalizing warp adds row g's
//      HS_SEGMENT-sample segments in sample order with compensation
//      (kahan_add: u carries 1/lambda up to 1e10 and w cancels) and
//      writes x = mask * safe_recip(w) to xs[buf] and to x;
//   4. the entries of the previous group, still in registers, take their
//      x (written before this step's barrier) into ap's column chains.
// The x of a group is read one step after it is formed and the shared
// buffers alternate, so one barrier a group suffices and no entry is ever
// stored. The pixel rows' features and mask are staged in shared memory
// two chunks ahead by the finalizing warp (a three-chunk ring; every warp
// reads a row as one broadcast), so no step waits on device memory. ap is
// two-level as in K10: a chain per chunk, added into the block's sum with
// compensation, written as the block's partial. The plan (threads, C, G,
// blocks, rows a block, shared bytes) is streaming_kernel.halfstep_plan, a
// function of (qpad, ppad) alone.
//
// w's order of adds is one fixed tree over the sample index j, whatever
// the plan (C, G, threads) and the padding: pairs of consecutive samples
// fmaf(K[2k+1], u[2k+1], K[2k] u[2k]), then aligned pairs of nodes up to
// HS_SEGMENT samples (within a thread, across the warp's lanes, across
// the segment's warps; float adds commute, so which side holds a node
// does not matter), then the segments in increasing order with
// compensation. Pad samples (u = 0) add exact zeros to their segment and
// make all-pad segments zero, which kahan_add skips: x, and with it ap,
// is bitwise the same at every Ppad and every plan.
constexpr int HS_SUM_ROWS = 32;   // rows of a chunk: one fp32 chain of ap
constexpr int HS_RING = 3;        // chunks of staged pixel rows
constexpr int HS_SEGMENT = 256;   // samples of w's tree below the Kahan sum

__host__ __device__ constexpr int hs_log2(int g) {
  return g <= 1 ? 0 : 1 + hs_log2(g / 2);
}

// The thread's part of w's tree: its C consecutive columns (an aligned
// subtree, C a power of two) in pairs, then pairwise.
template <int C>
__device__ __forceinline__ float cols_sum(const float (&e)[C],
                                          const float (&u)[C]) {
  static_assert(C >= 2 && C == 1 << hs_log2(C), "C is a power of two");
  float n[C / 2];
#pragma unroll
  for (int k = 0; k < C / 2; ++k) {
    n[k] = fmaf(e[2 * k + 1], u[2 * k + 1], __fmul_rn(e[2 * k], u[2 * k]));
  }
#pragma unroll
  for (int w = C / 2; w > 1; w /= 2) {
#pragma unroll
    for (int k = 0; k < w / 2; ++k) n[k] = __fadd_rn(n[2 * k], n[2 * k + 1]);
  }
  return n[0];
}

// Sum over the warp's lanes of G rows' values at once, the aligned tree
// over lanes: the first log2(G) steps swap half the rows with the partner
// lane and add the other half (a transpose), the others add all-to-all.
// Lane l < G ends with the total of row hs_lane_row<G>(l).
template <int G>
__device__ __forceinline__ int hs_lane_row(int lane) {
  int row = 0;
#pragma unroll
  for (int s = 0; s < hs_log2(G); ++s) {
    if (lane & (1 << s)) row += G >> (s + 1);
  }
  return row;
}

template <int G>
__device__ __forceinline__ float warp_rows_sum(float (&v)[G], int lane) {
  constexpr int kSteps = hs_log2(G);
  static_assert(G == 1 << kSteps && G <= 8, "G is 1, 2, 4 or 8");
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int half = G >> (s + 1);
    const int off = 1 << s;
    const bool hi = lane & off;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = hi ? v[k] : v[k + half];
      const float keep = hi ? v[k + half] : v[k];
      v[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, off));
    }
  }
  float t = v[0];
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
    t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, off));
  }
  return t;
}

template <int C, int G>
struct HalfstepState {
  float sr[C], sc[C], sy[C], su[C];   // the thread's sample columns
  float part[C], acc[C], comp[C];     // ap: the chunk's chain, the block's sum
};

// Pixel row i as the ring holds it: (row, col, y, mask).
__device__ __forceinline__ float4 pixel_row(const float* __restrict__ fb,
                                            const float* __restrict__ mask,
                                            int qpad, int i) {
  return make_float4(fb[i], fb[qpad + i], fb[2 * qpad + i], mask[i]);
}

// The warp that finalizes x and stages the ring: warp 1, or warp 0 alone.
__device__ __forceinline__ int finalizing_warp() {
  return blockDim.x > 32 ? 1 : 0;
}

// A 32-row chunk's chain of ap into the block's sum.
template <int C, int G>
__device__ __forceinline__ void halfstep_flush(HalfstepState<C, G>& st) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    nle::kahan_add(st.acc[c], st.comp[c], st.part[c]);
    st.part[c] = 0.0f;
  }
}

// One step: build the group of rows r0..r0 + G (features `rows`) into
// `cur` and publish its warp sums; after the barrier, finalize its x into
// xs[buf] and, if has_prev, add the previous group (`prev`, x in
// xs[buf ^ 1]) into ap, then, if it was the last group of a chunk
// (close_prev), flush the chunk's chain: every chain is one whole 32-row
// chunk whatever G is.
template <int C, int G>
__device__ __forceinline__ void halfstep_step(
    HalfstepState<C, G>& st, float (&cur)[G][C], const float (&prev)[G][C],
    const float4* rows, float* __restrict__ x, float* xs, float* ws, int buf,
    int r0, bool has_prev, bool close_prev, float sw, float pw, float eps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float w[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float4 f = rows[g];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      cur[g][c] = nle::affinity(f.x, f.y, f.z, st.sr[c], st.sc[c], st.sy[c],
                                sw, pw);
    }
    w[g] = cols_sum<C>(cur[g], st.su);
  }
  const float wsum = warp_rows_sum<G>(w, lane);
  if (lane < G) ws[(buf * G + hs_lane_row<G>(lane)) * nwarps + warp] = wsum;
  __syncthreads();
  if (warp == finalizing_warp() && lane < G) {
    // A segment is one warp's sum (C = 8) or an aligned pair's (C = 4; a
    // missing second warp is all pad, a zero).
    constexpr int kSegWarps = HS_SEGMENT / (32 * C);
    static_assert(kSegWarps == 1 || kSegWarps == 2, "C is 4 or 8");
    const float* row = ws + (buf * G + lane) * nwarps;
    float s = 0.0f, comp = 0.0f;
    for (int k = 0; k < nwarps; k += kSegWarps) {
      const float seg = kSegWarps == 2 && k + 1 < nwarps
                            ? __fadd_rn(row[k], row[k + 1]) : row[k];
      nle::kahan_add(s, comp, seg);
    }
    const float wv = __fsub_rn(s, comp);
    // Pad rows have real affinities: the mask kills them here.
    const float xv = (fabsf(wv) >= eps ? 1.0f / wv : 0.0f) * rows[lane].w;
    xs[buf * G + lane] = xv;
    x[r0 + lane] = xv;
  }
  if (has_prev) {
    const float* xp = xs + (buf ^ 1) * G;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float xv = xp[g];
#pragma unroll
      for (int c = 0; c < C; ++c) st.part[c] = fmaf(xv, prev[g][c], st.part[c]);
    }
    if (close_prev) halfstep_flush(st);
  }
}

// The instantiations K8's kernel has: (C columns a thread, G rows a
// group, most threads a block), streaming_kernel.HS_TILES, which the plan
// takes in this order, the first that holds Ppad. The launch bound caps
// the registers at 65,536 / most threads: 102 at 640 (C = 4, G = 4, Ppad
// up to 2560), 170 at 384 (C = 8, G = 4, to 3072), 128 at 512 (C = 8,
// G = 2, to 4096). C = 4 with G = 4 was the fastest instantiation on the
// H100 at Ppad 640 and 2176 alike (PERF.md).
#define HS_TILES(X) X(4, 4, 640) X(8, 4, 384) X(8, 2, 512)

template <int C, int G>
struct HsTile;
#define HS_TILE_BOUND(CC, GG, MT) \
  template <>                     \
  struct HsTile<CC, GG> {         \
    static constexpr int kMaxThreads = MT; \
  };
HS_TILES(HS_TILE_BOUND)
#undef HS_TILE_BOUND

template <int C, int G>
__global__ void __launch_bounds__(HsTile<C, G>::kMaxThreads)
    stream_halfstep_kernel(const float* __restrict__ fb,
                           const float* __restrict__ fa,
                           const float* __restrict__ mask,
                           const float* __restrict__ u, float* __restrict__ x,
                           float* __restrict__ partial, int qpad, int ppad,
                           int per_block, float sw, float pw, float eps) {
  extern __shared__ float4 smem4[];
  float4* ring = smem4;                                   // [3][32] rows
  float* xs = reinterpret_cast<float*>(smem4 + HS_RING * HS_SUM_ROWS);
  float* ws = xs + 2 * G;          // xs: [2][G]; ws: [2][G][warps]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  HalfstepState<C, G> st;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = tid * C + c;
    const bool in = j < ppad;
    st.sr[c] = in ? fa[j] : 0.0f;
    st.sc[c] = in ? fa[ppad + j] : 0.0f;
    st.sy[c] = in ? fa[2 * ppad + j] : 0.0f;
    st.su[c] = in ? u[j] : 0.0f;
    st.part[c] = st.acc[c] = st.comp[c] = 0.0f;
  }
  const int rbeg = blockIdx.x * per_block;
  // Whole chunks: qpad and per_block are multiples of HS_SUM_ROWS.
  const int nchunks = (min(rbeg + per_block, qpad) - rbeg) / HS_SUM_ROWS;
  for (int e = tid; e < 2 * HS_SUM_ROWS && e < nchunks * HS_SUM_ROWS;
       e += nthreads) {
    ring[e] = pixel_row(fb, mask, qpad, rbeg + e);
  }
  __syncthreads();
  const bool stager = (tid >> 5) == finalizing_warp();
  float e0[G][C], e1[G][C];
  for (int k = 0; k < nchunks; ++k) {
    const bool stage = stager && k + 2 < nchunks;
    float4 next;
    if (stage) next = pixel_row(fb, mask, qpad, rbeg + (k + 2) * HS_SUM_ROWS + lane);
    const float4* rows = ring + (k % HS_RING) * HS_SUM_ROWS;
    const int c0 = rbeg + k * HS_SUM_ROWS;
    for (int i = 0; i < HS_SUM_ROWS; i += 2 * G) {
      // The adds lag the build by one group: the first step of a chunk
      // adds, and closes, the previous chunk's last group.
      halfstep_step<C, G>(st, e0, e1, rows + i, x, xs, ws, 0, c0 + i,
                          k > 0 || i > 0, k > 0 && i == 0, sw, pw, eps);
      halfstep_step<C, G>(st, e1, e0, rows + i + G, x, xs, ws, 1, c0 + i + G,
                          true, false, sw, pw, eps);
    }
    // The ring slot chunk k - 1 used takes chunk k + 2.
    if (stage) ring[((k + 2) % HS_RING) * HS_SUM_ROWS + lane] = next;
  }
  __syncthreads();   // the last group's x
  {
    const float* xp = xs + G;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float xv = xp[g];
#pragma unroll
      for (int c = 0; c < C; ++c) st.part[c] = fmaf(xv, e1[g][c], st.part[c]);
    }
  }
  halfstep_flush(st);
  float* dst = partial + static_cast<size_t>(blockIdx.x) * ppad;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = tid * C + c;
    if (j < ppad) dst[j] = __fsub_rn(st.acc[c], st.comp[c]);
  }
}

// K11, and K9's pass 1 (kRecip, R = 1, b = u): out[k, i] = sum_j K[i, j]
// b[k, j]. Thread t of a block owns G pixel rows of each step of AT_THREADS
// x G rows (rows step * span + g * AT_THREADS + t), their features in
// registers (zero past qpad: those rows are built and never written).
// The samples go to shared memory interleaved, one float4 (r, c, y, b_0)
// per sample and a float2 (b_1, b_2) for R > 1, so one broadcast load
// feeds G entries. They are staged pchunk samples at a time
// (streaming_kernel.atb_plan: all of ppad at once up to ST_ATB_CHUNK) by
// 4-byte cp.async copies from every thread, which scatter the feature
// rows into the interleaved layout; past one chunk a double-buffered ring
// copies the next chunk while the block builds this one (one barrier a
// chunk). Blocks stride over the steps. Each row sums its samples in
// increasing j, two-level: a group of ST_ROW_GRAIN samples (at multiples
// of 32 from sample 0) as one fp32 chain, each group's sum added to the
// row's with compensation (kahan_add). On the streaming route u = Uinv t
// carries 1/lambda up to 1e10 and w = K u cancels, so the rounding of a
// 2176-term chain would reach x at full weight. The row's sums stay in
// registers across chunks (pchunk does not change them) and a zero group
// sum is a no-op (pad samples do not change them), so they depend on
// neither pchunk, nor ppad, nor the plan. kRecip ends with x = mask *
// safe_recip(w, eps). Rows are independent: no cross-block pass.
constexpr int AT_THREADS = 256;
constexpr int AT_MIN_BLOCKS = 4;    // an SM's blocks the registers hold
constexpr int ST_ATB_CHUNK = 1536;  // samples a chunk at most

// The rows a thread owns, by R (streaming_kernel.AT_TILES): the launch
// bound caps the registers at 64.
#define AT_TILES(X) X(1, 4) X(2, 2) X(3, 2)

template <int R>
struct AtTile;
#define AT_TILE_ROWS(RR, GG) \
  template <>                \
  struct AtTile<RR> {        \
    static constexpr int kRows = GG; \
  };
AT_TILES(AT_TILE_ROWS)
#undef AT_TILE_ROWS

template <int R, bool kRecip>
__global__ void __launch_bounds__(AT_THREADS, AT_MIN_BLOCKS)
    stream_atb_kernel(const float* __restrict__ fb, const float* __restrict__ fa,
                      const float* __restrict__ b,
                      const float* __restrict__ mask, float* __restrict__ out,
                      int qpad, int ppad, int pchunk, float sw, float pw,
                      float eps) {
  constexpr int G = AtTile<R>::kRows;
  constexpr int span = AT_THREADS * G;
  extern __shared__ float4 atb_smem4[];
  const int tid = threadIdx.x;
  const int nchunks = (ppad + pchunk - 1) / pchunk;
  const int nbuf = nchunks > 1 ? 2 : 1;
  float4* s4 = atb_smem4;                                  // [nbuf][pchunk]
  float2* s2 = reinterpret_cast<float2*>(s4 + nbuf * pchunk);
  const int nsteps = (qpad + span - 1) / span;
  const int bid = blockIdx.x;
  const int nblocks = gridDim.x;
  const int mine = bid < nsteps ? (nsteps - 1 - bid) / nblocks + 1 : 0;
  const int total = mine * nchunks;   // (step, chunk) pairs, chunk fastest
  if (total == 0) return;             // block-uniform
  auto stage = [&](int ch, int buf) {
    const int jb = ch * pchunk;
    const int nj = min(pchunk, ppad - jb);
    float* d4 = reinterpret_cast<float*>(s4 + buf * pchunk);
    float* d2 = reinterpret_cast<float*>(s2 + buf * pchunk);
    for (int e = tid; e < nj; e += AT_THREADS) {
      const int j = jb + e;
      nle::cp_async4(d4 + 4 * e, fa + j);
      nle::cp_async4(d4 + 4 * e + 1, fa + ppad + j);
      nle::cp_async4(d4 + 4 * e + 2, fa + 2 * ppad + j);
      nle::cp_async4(d4 + 4 * e + 3, b + j);
#pragma unroll
      for (int k = 1; k < R; ++k) {
        nle::cp_async4(d2 + 2 * e + k - 1, b + static_cast<size_t>(k) * ppad + j);
      }
    }
  };
  stage(0, 0);
  nle::cp_async_commit();
  float br[G], bc[G], by[G], acc[R][G], comp[R][G];
  int i0 = 0;
  for (int s = 0; s < total; ++s) {
    const int ch = s % nchunks;
    const int buf = nchunks > 1 ? (s & 1) : 0;
    if (nchunks > 1 || s == 0) {
      nle::cp_async_wait<0>();
      __syncthreads();   // this chunk landed; the other buffer is free
      if (nchunks > 1 && s + 1 < total) {
        stage((s + 1) % nchunks, (s + 1) & 1);
        nle::cp_async_commit();
      }
    }
    if (ch == 0) {
      i0 = (bid + (s / nchunks) * nblocks) * span + tid;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int i = i0 + g * AT_THREADS;
        const bool row = i < qpad;
        br[g] = row ? fb[i] : 0.0f;
        bc[g] = row ? fb[qpad + i] : 0.0f;
        by[g] = row ? fb[2 * qpad + i] : 0.0f;
#pragma unroll
        for (int k = 0; k < R; ++k) acc[k][g] = comp[k][g] = 0.0f;
      }
    }
    const int nj = min(pchunk, ppad - ch * pchunk);
    const float4* c4 = s4 + buf * pchunk;
    const float2* c2 = s2 + buf * pchunk;
    for (int g0 = 0; g0 < nj; g0 += ST_ROW_GRAIN) {
      const int gend = min(g0 + ST_ROW_GRAIN, nj);
      float part[R][G];
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int g = 0; g < G; ++g) part[k][g] = 0.0f;
      // ST_P_GRAIN samples a step: chunks and ppad are whole steps.
      for (int j = g0; j < gend; j += ST_P_GRAIN) {
#pragma unroll
        for (int t = 0; t < ST_P_GRAIN; ++t) {
          const float4 sv = c4[j + t];
          float bv[R];
          bv[0] = sv.w;
          if constexpr (R > 1) {
            const float2 b12 = c2[j + t];
            bv[1] = b12.x;
            if constexpr (R > 2) bv[2] = b12.y;
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float a = nle::affinity(br[g], bc[g], by[g], sv.x, sv.y,
                                          sv.z, sw, pw);
#pragma unroll
            for (int k = 0; k < R; ++k) part[k][g] = fmaf(a, bv[k], part[k][g]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int g = 0; g < G; ++g) nle::kahan_add(acc[k][g], comp[k][g], part[k][g]);
    }
    if (ch == nchunks - 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int i = i0 + g * AT_THREADS;
        if (i >= qpad) continue;
        if constexpr (kRecip) {
          // Pad rows have real affinities: the mask kills them here.
          const float w = __fsub_rn(acc[0][g], comp[0][g]);
          out[i] = (fabsf(w) >= eps ? 1.0f / w : 0.0f) * mask[i];
        } else {
#pragma unroll
          for (int k = 0; k < R; ++k) {
            out[static_cast<size_t>(k) * qpad + i] = __fsub_rn(acc[k][g], comp[k][g]);
          }
        }
      }
    }
  }
}

// K12, step 3 of a chunk: Sb += the chunk's gram, with compensation (comp
// holds each element's carried low part), in chunk order. The first chunk
// starts both from zero, the last writes Sb = sum - comp.
__global__ void gram_chunk_add_kernel(const float* __restrict__ part,
                                      float* __restrict__ sb,
                                      float* __restrict__ comp, int n,
                                      int first, int last) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = first ? 0.0f : sb[e];
  float c = first ? 0.0f : comp[e];
  nle::kahan_add(s, c, part[e]);
  if (last) {
    sb[e] = __fsub_rn(s, c);
  } else {
    sb[e] = s;
    comp[e] = c;
  }
}

bool bad_stream_shape(int qpad, int ppad) {
  return qpad < ST_ROW_GRAIN || qpad % ST_ROW_GRAIN || ppad < 1 ||
         ppad % ST_P_GRAIN;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Even split of n into the fewest pieces of at most `most`, each a
// multiple of 32 (the last may be shorter).
inline int even_piece(int n, int most) {
  const int pieces = (n + most - 1) / most;
  const int per = (n + pieces - 1) / pieces;
  return (per + 31) / 32 * 32;
}

// K10's launch as streaming_kernel.ap_plan(qpad, ppad, R) gives it
// (threads, cols, rows, ptile, tiles, blocks, per_block, shared bytes),
// refused unless it is the instantiation's and covers every column once
// with the fewest threads a tile and every row in rows_per_block(qpad)'s
// ranges (the sum order); X and fb 16-byte aligned (cp.async).
template <int R>
cudaError_t launch_ap(const float* fb, const float* fa, const float* X,
                      float* partial, float* ap, int qpad, int ppad,
                      int threads, int cols, int rows, int ptile, int tiles,
                      int blocks, int per_block, int smem, float sw, float pw,
                      cudaStream_t st) {
  using T = ApTile<R>;
  if (bad_stream_shape(qpad, ppad) || cols != T::kCols || rows != T::kRows ||
      ptile < cols || ptile % cols || tiles != (ppad + ptile - 1) / ptile ||
      threads != (ptile / cols + 31) / 32 * 32 || threads > T::kMaxThreads ||
      per_block != rows_per_block(qpad) || blocks != ap_blocks(qpad) ||
      smem != static_cast<int>(sizeof(float)) * AP_RING * (3 + R) *
                  ST_ROW_GRAIN ||
      !aligned16(fb) || !aligned16(X)) {
    return cudaErrorInvalidValue;
  }
  stream_ap_kernel<R><<<dim3(blocks, tiles), threads, smem, st>>>(
      fb, fa, X, partial, qpad, ppad, ptile, per_block, sw, pw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return nle::launch_reduce_partials(partial, ap, blocks, R * ppad, st);
}

// K11's launch as streaming_kernel.atb_plan(qpad, ppad, R) gives it
// (threads, rows, blocks, pchunk, shared bytes), refused unless it is the
// instantiation's with ppad in even ST_ATB_CHUNK pieces.
template <int R, bool kRecip>
cudaError_t launch_atb(const float* fb, const float* fa, const float* b,
                       const float* mask, float* out, int qpad, int ppad,
                       int threads, int rows, int blocks, int pchunk,
                       int smem, float sw, float pw, float eps,
                       cudaStream_t st) {
  const int nbuf = pchunk < ppad ? 2 : 1;
  if (bad_stream_shape(qpad, ppad) || threads != AT_THREADS ||
      rows != AtTile<R>::kRows || blocks < 1 ||
      pchunk != even_piece(ppad, ST_ATB_CHUNK) ||
      smem != nbuf * pchunk *
                  static_cast<int>(sizeof(float4) + (R > 1 ? sizeof(float2) : 0))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      stream_atb_kernel<R, kRecip>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  stream_atb_kernel<R, kRecip><<<blocks, threads, smem, st>>>(
      fb, fa, b, mask, out, qpad, ppad, pchunk, sw, pw, eps);
  return cudaGetLastError();
}

}  // namespace

// K8 and K9 (one build of each entry; K8's unit_x pass is K10 with X =
// mask). fb (3, qpad), fa (3, ppad), mask (qpad,), u (ppad,) -> x
// (qpad,), ap (ppad,); partial is scratch of blocks * ppad floats. The
// launch takes streaming_kernel.halfstep_plan(qpad, ppad) as it is
// (threads, cols, rows, blocks, per_block, shared bytes) and refuses one
// that does not cover every row and column exactly once with the fewest
// threads for its cols.
extern "C" int nle_stream_halfstep_onebuild(
    const float* fb, const float* fa, const float* mask, const float* u,
    float* x, float* partial, float* ap, int qpad, int ppad, int threads,
    int cols, int rows, int blocks, int per_block, int smem, float sw,
    float pw, float eps, void* stream) {
  const bool shape_ok =
      !bad_stream_shape(qpad, ppad) && cols > 0 &&
      threads == ((ppad + cols - 1) / cols + 31) / 32 * 32 &&
      per_block >= HS_SUM_ROWS && per_block % HS_SUM_ROWS == 0 &&
      (blocks - 1) * per_block < qpad && qpad <= blocks * per_block &&
      smem == static_cast<int>(sizeof(float4)) * HS_RING * HS_SUM_ROWS +
                  static_cast<int>(sizeof(float)) * 2 * rows *
                      (1 + threads / 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define HS_LAUNCH(CC, GG, MT)                                            \
  if (shape_ok && cols == CC && rows == GG && threads <= MT) {           \
    stream_halfstep_kernel<CC, GG><<<blocks, threads, smem, st>>>(       \
        fb, fa, mask, u, x, partial, qpad, ppad, per_block, sw, pw, eps); \
    err = cudaGetLastError();                                            \
  }
  HS_TILES(HS_LAUNCH)
#undef HS_LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      nle::launch_reduce_partials(partial, ap, blocks, ppad, st));
}

// K9's two passes, for ppad past the one-build kernel's 4096 (the
// wrapper's dispatch by shape): K8's contract without unit_x, at any
// ppad; pass 1 (K11's kernel, atb_plan(qpad, ppad, 1)) writes x, pass 2
// is K10's (ap_plan(qpad, ppad, 1)) on it; partial is scratch of the ap
// plan's blocks * ppad floats.
extern "C" int nle_stream_halfstep_ptiled(
    const float* fb, const float* fa, const float* mask, const float* u,
    float* x, float* partial, float* ap, int qpad, int ppad, int at_threads,
    int at_rows, int at_blocks, int pchunk, int at_smem, int threads,
    int cols, int rows, int ptile, int tiles, int blocks, int per_block,
    int smem, float sw, float pw, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_atb<1, true>(fb, fa, u, mask, x, qpad, ppad,
                                        at_threads, at_rows, at_blocks,
                                        pchunk, at_smem, sw, pw, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_ap<1>(fb, fa, x, partial, ap, qpad, ppad,
                                       threads, cols, rows, ptile, tiles,
                                       blocks, per_block, smem, sw, pw, st));
}

// K10. X (R, qpad) -> ap (R, ppad), 1 <= R <= 3 (one channel, or the three
// of a colour frame), on ap_plan(qpad, ppad, R); partial is scratch of its
// blocks * R * ppad floats.
extern "C" int nle_stream_ap(const float* fb, const float* fa, const float* X,
                             float* partial, float* ap, int qpad, int ppad,
                             int R, int threads, int cols, int rows,
                             int ptile, int tiles, int blocks, int per_block,
                             int smem, float sw, float pw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define AP_LAUNCH(RR, CC, GG, MT)                                          \
  if (R == RR) {                                                          \
    err = launch_ap<RR>(fb, fa, X, partial, ap, qpad, ppad, threads, cols, \
                        rows, ptile, tiles, blocks, per_block, smem, sw, pw, \
                        st);                                              \
  }
  AP_TILES(AP_LAUNCH)
#undef AP_LAUNCH
  return static_cast<int>(err);
}

// K11. b (R, ppad) -> out (R, qpad), 1 <= R <= 3, on atb_plan(qpad, ppad,
// R).
extern "C" int nle_stream_atb(const float* fb, const float* fa, const float* b,
                              float* out, int qpad, int ppad, int R,
                              int threads, int rows, int blocks, int pchunk,
                              int smem, float sw, float pw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define AT_LAUNCH(RR, GG)                                                  \
  if (R == RR) {                                                          \
    err = launch_atb<RR, false>(fb, fa, b, nullptr, out, qpad, ppad,       \
                                threads, rows, blocks, pchunk, smem, sw,  \
                                pw, 0.0f, st);                            \
  }
  AT_TILES(AT_LAUNCH)
#undef AT_LAUNCH
  return static_cast<int>(err);
}

// K6 (csrc/scaled_matmul.cu): K12's gram step on each chunk's phi rows.
extern "C" int nle_scaled_gram(const float* phi, const float* c,
                               float* partial, float* out, int npad, int mpad,
                               int nsplit, int split_rows, int chain_rows,
                               void* stream);

// K12. fb (3, qpad), fa (3, ppad), c (qpad,) zero on pad rows, uinv (ppad,
// mpad) -> out (mpad, mpad). The launch takes
// streaming_kernel.stream_gram_plan(qpad, ppad, mpad) as it is: chunks of
// `chunk` rows (the last `last` rows) and K6's split plan (nsplit, split_rows; chain_rows) for a
// full chunk and for the last one. Per chunk: phi rows into phi_chunk
// (chunk, mpad); K6's lower-triangle gram of diag(c) phi over the plan's
// splits, summed in split order and mirrored, into part (mpad, mpad)
// (K6's scratch: gram_scratch); part added into out in chunk order with
// compensation (comp, mpad * mpad floats).
extern "C" int nle_stream_gram(
    const float* fb, const float* fa, const float* c, const float* uinv,
    float* phi_chunk, float* gram_scratch, float* part, float* comp,
    float* out, int qpad, int ppad, int mpad, int chunk, int last,
    int nsplit, int split_rows, int last_nsplit, int last_split_rows,
    int chain_rows, float sw, float pw, void* stream) {
  // The core's C entry refuses Qpad and a chunk that are not whole blocks
  // of its rows at the first chunk, before anything is launched (the last
  // chunk is then whole blocks too).
  if (qpad < 1 || ppad < ST_P_GRAIN || ppad % ST_P_GRAIN || mpad < 128 ||
      mpad % 128 || chunk < 1 || last < 1 || last > chunk ||
      (qpad - last) % chunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = mpad * mpad;
  for (int r0 = 0; r0 < qpad; r0 += chunk) {
    const bool is_last = r0 + last == qpad;
    const int rows = is_last ? last : chunk;
    int status = nle_affinity_matmul(fb, fa, uinv, phi_chunk, qpad, ppad,
                                     mpad, r0, rows, qpad, sw, pw, stream);
    if (status != 0) return status;
    status = nle_scaled_gram(
        phi_chunk, c + r0, gram_scratch, part, rows, mpad,
        is_last ? last_nsplit : nsplit, is_last ? last_split_rows : split_rows,
        chain_rows, stream);
    if (status != 0) return status;
    gram_chunk_add_kernel<<<(n + 255) / 256, 256, 0, st>>>(
        part, out, comp, n, r0 == 0, is_last);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (is_last) break;
  }
  return 0;
}
