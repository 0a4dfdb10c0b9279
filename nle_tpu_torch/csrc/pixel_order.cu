// The edit's pixel order on the card: rows of C bytes (C = 1, 2, 3, the
// u8 channels of one edit) permuted by an int32 index, as a gather
// (out[i] = in[idx[i]], pixel order to the filter's packed [selected;
// rest] order) or a scatter (out[idx[i]] = in[i], back again).
//
// It replaces no TPU kernel: nle_tpu permutes on the host
// (nle_tpu/models/filter.py), where an (N, k) device scatter cost more
// than the filter application on the TPU. On the H100 a permutation moves
// N (4 + 2C) bytes and computes nothing: at 8 MP and C = 2 that is 64 MB,
// ~19 us at 3.35 TB/s, so the kernel is bound by device memory alone and
// its design is about moving bytes in wide, coalesced transactions:
//  - a block owns a tile of PO_TILE consecutive index entries (4096 rows,
//    16 a thread) and stages the tile's index into shared memory with
//    16-byte loads, consecutive threads on consecutive vectors;
//  - the scatter stages its input rows the same way; the gather stages
//    its output rows and writes them out the same way, in 16-byte stores;
//  - the indexed side then walks the tile one row a thread, consecutive
//    threads on consecutive rows. The edit's index is [selected; rest]
//    with the rest in row-major order, so consecutive rows land on nearly
//    consecutive addresses and those accesses coalesce too;
//  - a thread starts all 16 of its indexed loads before its first
//    store, so each thread keeps 16 reads in flight.
// The index is a permutation, so every output row is written once and no
// atomics are needed. An entry outside [0, n) is never dereferenced: the
// gather writes a zero row for it and the scatter skips it. The last tile
// may be ragged; it moves its bytes one at a time.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int PO_THREADS = 256;
constexpr int PO_ROWS = 16;                    // rows a thread in a tile
constexpr int PO_TILE = PO_THREADS * PO_ROWS;  // rows a block

// A row of C bytes as one value: a 2-byte row is one 16-bit access.
template <int C>
struct RowOf {
  struct type {
    uint8_t b[C];
  };
};
template <>
struct RowOf<1> {
  using type = uint8_t;
};
template <>
struct RowOf<2> {
  using type = uint16_t;
};

// nvec 16-byte vectors from src to dst, consecutive threads on
// consecutive vectors.
__device__ __forceinline__ void copy_vectors(int4* __restrict__ dst,
                                             const int4* __restrict__ src,
                                             int nvec) {
  for (int v = threadIdx.x; v < nvec; v += PO_THREADS) dst[v] = src[v];
}

template <int C, bool SCATTER>
__global__ void __launch_bounds__(PO_THREADS)
    permute_rows_kernel(const uint8_t* __restrict__ in,
                        const int32_t* __restrict__ idx,
                        uint8_t* __restrict__ out, int n) {
  using Row = typename RowOf<C>::type;
  __shared__ int4 s_idx[PO_TILE / 4];
  __shared__ int4 s_rows[PO_TILE * C / 16];
  const int32_t* sidx = reinterpret_cast<const int32_t*>(s_idx);
  Row* srow = reinterpret_cast<Row*>(s_rows);
  uint8_t* sbyte = reinterpret_cast<uint8_t*>(s_rows);
  const Row* in_rows = reinterpret_cast<const Row*>(in);
  Row* out_rows = reinterpret_cast<Row*>(out);

  const long long row0 = static_cast<long long>(blockIdx.x) * PO_TILE;
  const long long left = static_cast<long long>(n) - row0;
  const int rows = left < PO_TILE ? static_cast<int>(left) : PO_TILE;
  const unsigned un = static_cast<unsigned>(n);

  if (rows == PO_TILE) {
    copy_vectors(s_idx, reinterpret_cast<const int4*>(idx + row0),
                 PO_TILE / 4);
    if constexpr (SCATTER) {
      copy_vectors(s_rows, reinterpret_cast<const int4*>(in + row0 * C),
                   PO_TILE * C / 16);
    }
    __syncthreads();
    int j[PO_ROWS];
    Row v[PO_ROWS];
#pragma unroll
    for (int k = 0; k < PO_ROWS; ++k) {
      const int r = threadIdx.x + k * PO_THREADS;
      j[k] = sidx[r];
      if constexpr (SCATTER) {
        v[k] = srow[r];
      } else {
        v[k] = static_cast<unsigned>(j[k]) < un ? in_rows[j[k]] : Row{};
      }
    }
#pragma unroll
    for (int k = 0; k < PO_ROWS; ++k) {
      const int r = threadIdx.x + k * PO_THREADS;
      if constexpr (SCATTER) {
        if (static_cast<unsigned>(j[k]) < un) out_rows[j[k]] = v[k];
      } else {
        srow[r] = v[k];
      }
    }
    if constexpr (!SCATTER) {
      __syncthreads();
      copy_vectors(reinterpret_cast<int4*>(out + row0 * C), s_rows,
                   PO_TILE * C / 16);
    }
    return;
  }

  // The ragged last tile.
  int32_t* sidx_w = reinterpret_cast<int32_t*>(s_idx);
  for (int r = threadIdx.x; r < rows; r += PO_THREADS) {
    sidx_w[r] = idx[row0 + r];
  }
  if constexpr (SCATTER) {
    for (int b = threadIdx.x; b < rows * C; b += PO_THREADS) {
      sbyte[b] = in[row0 * C + b];
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += PO_THREADS) {
    const int jr = sidx[r];
    const bool ok = static_cast<unsigned>(jr) < un;
    if constexpr (SCATTER) {
      if (ok) out_rows[jr] = srow[r];
    } else {
      srow[r] = ok ? in_rows[jr] : Row{};
    }
  }
  if constexpr (!SCATTER) {
    __syncthreads();
    for (int b = threadIdx.x; b < rows * C; b += PO_THREADS) {
      out[row0 * C + b] = sbyte[b];
    }
  }
}

template <int C, bool SCATTER>
cudaError_t launch_permute(const uint8_t* in, const int32_t* idx,
                           uint8_t* out, int n, cudaStream_t stream) {
  const long long blocks =
      (static_cast<long long>(n) + PO_TILE - 1) / PO_TILE;
  permute_rows_kernel<C, SCATTER>
      <<<static_cast<unsigned>(blocks), PO_THREADS, 0, stream>>>(in, idx,
                                                                 out, n);
  return cudaGetLastError();
}

template <bool SCATTER>
cudaError_t launch_rows(const uint8_t* in, const int32_t* idx, uint8_t* out,
                        int n, int c, cudaStream_t stream) {
  switch (c) {
    case 1:
      return launch_permute<1, SCATTER>(in, idx, out, n, stream);
    case 2:
      return launch_permute<2, SCATTER>(in, idx, out, n, stream);
    default:
      return launch_permute<3, SCATTER>(in, idx, out, n, stream);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// in (n, c) and out (n, c) u8 rows, idx (n,) int32; scatter 0 gathers
// (out[i] = in[idx[i]]), 1 scatters (out[idx[i]] = in[i]).
extern "C" int nle_permute_rows_u8(const void* in, const void* idx, void* out,
                                   int n, int c, int scatter, void* stream) {
  if (n < 1 || c < 1 || c > 3 || !aligned16(in) || !aligned16(idx) ||
      !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* src = static_cast<const uint8_t*>(in);
  const auto* index = static_cast<const int32_t*>(idx);
  auto* dst = static_cast<uint8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      scatter ? launch_rows<true>(src, index, dst, n, c, s)
              : launch_rows<false>(src, index, dst, n, c, s);
  return static_cast<int>(err);
}
