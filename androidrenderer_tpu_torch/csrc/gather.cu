// Hopper gather-sum for the port's ops/gather.py::gather_tile_sums.
//
// Replaces the TPU kernel tools/microbench_pallas_gather.py (the inner `kernel`
// of pallas_gather): rows of an (M, C) f32 table, picked by (P,) i32 indices,
// summed per tile of 2048 indices into row 0 of a (P/2048, 8, C) output whose
// rows 1-7 are 0. It ports that kernel's function, not its schedule: the K-deep
// ring of row DMAs, their semaphores and the SMEM index block existed to hide
// the latency of single-row copies on the TPU; here every thread issues its own
// loads and the warps in flight hide the latency.
//
// Layout: one block per 2048-index tile. The block first stages the tile's
// indices in shared memory. Its threads then split into groups of `width`
// consecutive lanes (width = C, or 256 columns at a time when C > 256); lane j
// of a group reads column j, so a group reads one table row in one coalesced
// sweep (for C = 32 one warp reads the whole 128 B row). Group g sums rows g,
// g + groups, g + 2 * groups, ... into a register; the groups' partial sums
// are then added in shared memory in group order. Every sum is taken in the
// same order on every run, so the result is deterministic; it is not the
// index order of the TPU kernel's loop, and the two agree to float32
// rounding (the tool's own check holds rtol 2e-5).
//
// What bounds it on this card: bytes. Each lookup moves one C * 4 B row and
// 4 B of index; a sum is one add per element. At the tool's shape (M = 2^18,
// C = 32: a 33.5 MB table, within the 50 MB L2) most repeated rows can come
// from L2, so device memory need supply each distinct row once. The design
// keeps 2048 * C loads per block independent of each other (the partial sum is
// the only carried value), so a warp has many loads in flight.
//
// An index outside [0, M) reads nothing: its row adds NaN to its tile's sums
// (the plain version raises).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 2048;
constexpr int kThreads = 256;
constexpr int kOutRows = 8;

__global__ void __launch_bounds__(kThreads) gather_tile_sums_kernel(
    const float* __restrict__ table, long long m, int c, const int* __restrict__ idx,
    float* __restrict__ out) {
  __shared__ int rows[kTile];
  __shared__ float partial[kThreads];
  const int* tile_idx = idx + static_cast<size_t>(blockIdx.x) * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) rows[i] = tile_idx[i];
  float* o = out + static_cast<size_t>(blockIdx.x) * kOutRows * c;
  for (int i = c + threadIdx.x; i < kOutRows * c; i += kThreads) o[i] = 0.0f;
  __syncthreads();

  const float kNaN = __int_as_float(0x7fc00000);
  for (int col0 = 0; col0 < c; col0 += kThreads) {
    const int width = min(kThreads, c - col0);
    const int groups = kThreads / width;
    const int g = threadIdx.x / width;
    const int col = col0 + (threadIdx.x - g * width);
    float acc = 0.0f;
    if (g < groups) {
#pragma unroll 8
      for (int i = g; i < kTile; i += groups) {
        const int r = rows[i];
        acc += (r >= 0 && r < m) ? __ldg(table + static_cast<size_t>(r) * c + col) : kNaN;
      }
    }
    partial[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x < width) {
      float s = 0.0f;
      for (int k = 0; k < groups; ++k) s += partial[k * width + threadIdx.x];
      o[col0 + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

}  // namespace

// Sum the rows of ``table`` (m, c) f32 picked by ``idx`` (p,) i32, 2048 indices
// to a tile, into ``out`` (p / 2048, 8, c) f32 on ``stream``: row 0 of each tile
// holds the sum, rows 1-7 zeros. p must be a multiple of 2048. Allocates
// nothing; returns the first CUDA error (0 on success).
extern "C" int gather_tile_sums_launch(const float* table, long long m, int c, const int* idx,
                                       long long p, float* out, void* stream) {
  const long long tiles = p / kTile;
  if (tiles == 0 || c <= 0) return 0;
  gather_tile_sums_kernel<<<static_cast<unsigned int>(tiles), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(table, m, c, idx, out);
  return static_cast<int>(cudaGetLastError());
}
