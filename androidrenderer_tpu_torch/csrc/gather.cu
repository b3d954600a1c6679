// Hopper gather-sum for the port's ops/gather.py::gather_tile_sums.
//
// Replaces the TPU kernel tools/microbench_pallas_gather.py (the inner `kernel`
// of pallas_gather): rows of an (M, C) f32 table, picked by (P,) i32 indices,
// summed per tile of 2048 indices into row 0 of a (P/2048, 8, C) output whose
// rows 1-7 are 0. It ports that kernel's function, not its schedule: the K-deep
// ring of row DMAs, their semaphores and the SMEM index block existed to hide
// the latency of single-row copies on the TPU; here every lane keeps several
// row loads of its own in flight and many blocks per SM hide the rest.
//
// What bounds it on this card: bytes. Each lookup moves one C * 4 B row and
// 4 B of index; a sum is one add per element. At the tool's shape (M = 2^18,
// C = 32: a 33.5 MB table, within the 50 MB L2) most repeated rows can come
// from L2, so device memory need supply each distinct row once, and the rest is
// L2 bandwidth and load latency.
//
// Layout, two passes on the caller's stream:
//   1. partial sums: each 2048-index tile is split over kSplit = 8 blocks of
//      256 indices (3,680 blocks at the tool's shape, not 460). A block stages
//      its indices in shared memory; its lanes read 16 bytes (4 columns, a
//      float4) each where C % 4 == 0 and the table is 16-byte aligned, else 4
//      bytes, so for C = 32 eight lanes read one 128 B row and a warp reads 4
//      rows per instruction. Each lane first issues kInFlight = 8 independent
//      row loads, then adds them in order; the block's groups of lanes are
//      summed in shared memory in group order, and the block writes its
//      partial row to scratch.
//   2. finish: one thread per output element sums the tile's kSplit partials in
//      part order, and writes rows 1-7 as zeros.
// Every sum is taken in the same order on every run, so the result is
// deterministic, bit-equal from run to run; it is not the index order of the
// TPU kernel's loop, and the two agree to float32 rounding (the tool's own
// check holds rtol 2e-5).
//
// An index outside [0, M) reads nothing: its row adds NaN to its tile's sums
// (the plain version raises).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 2048;
constexpr int kSplit = 8;
constexpr int kChunk = kTile / kSplit;  // indices per block
constexpr int kThreads = 256;
constexpr int kInFlight = 8;
constexpr int kOutRows = 8;
static_assert(kChunk == kThreads, "a block stages one index per thread");

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ void fill(float4& v, float x) { v = make_float4(x, x, x, x); }
__device__ __forceinline__ void fill(float& v, float x) { v = x; }

// T is float4 (``cv`` = C / 4 vectors per row) or float (cv = C).
template <typename T>
__global__ void __launch_bounds__(kThreads) gather_partial_kernel(
    const T* __restrict__ table, long long m, int cv, const int* __restrict__ idx,
    T* __restrict__ partial) {
  __shared__ int rows[kChunk];
  __shared__ T part[kThreads];
  rows[threadIdx.x] = idx[static_cast<size_t>(blockIdx.x) * kChunk + threadIdx.x];
  __syncthreads();

  T zero, nan;
  fill(zero, 0.0f);
  fill(nan, __int_as_float(0x7fc00000));
  for (int col0 = 0; col0 < cv; col0 += kThreads) {
    const int width = min(kThreads, cv - col0);
    const int groups = kThreads / width;
    const int g = threadIdx.x / width;
    const int col = col0 + (threadIdx.x - g * width);
    T acc = zero;
    if (g < groups) {
      for (int i0 = g; i0 < kChunk; i0 += kInFlight * groups) {
        T v[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int i = i0 + u * groups;
          const int r = i < kChunk ? rows[i] : 0;
          v[u] = i >= kChunk ? zero
                 : (r >= 0 && r < m) ? __ldg(table + static_cast<size_t>(r) * cv + col) : nan;
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) acc = add(acc, v[u]);
      }
    }
    part[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x < width) {
      T s = zero;
      for (int k = 0; k < groups; ++k) s = add(s, part[k * width + threadIdx.x]);
      partial[static_cast<size_t>(blockIdx.x) * cv + col0 + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

__global__ void gather_finish_kernel(const float* __restrict__ partial, int c, long long n_out,
                                     float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const long long per_tile = static_cast<long long>(kOutRows) * c;
  const long long tile = i / per_tile;
  const int e = static_cast<int>(i - tile * per_tile);
  float s = 0.0f;
  if (e < c) {
    const float* p = partial + static_cast<size_t>(tile) * kSplit * c + e;
    for (int k = 0; k < kSplit; ++k) s += p[static_cast<size_t>(k) * c];
  }
  out[i] = s;
}

}  // namespace

// Sum the rows of ``table`` (m, c) f32 picked by ``idx`` (p,) i32, 2048 indices
// to a tile, into ``out`` (p / 2048, 8, c) f32 on ``stream``: row 0 of each tile
// holds the sum, rows 1-7 zeros. p must be a multiple of 2048; ``partial`` is
// scratch of (p / 2048) * 8 * c f32. Allocates nothing; returns the first CUDA
// error (0 on success).
extern "C" int gather_tile_sums_launch(const float* table, long long m, int c, const int* idx,
                                       long long p, float* out, float* partial, void* stream) {
  const long long tiles = p / kTile;
  if (tiles == 0 || c <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = static_cast<unsigned int>(tiles * kSplit);
  const bool vec = c % 4 == 0 && reinterpret_cast<size_t>(table) % 16 == 0 &&
                   reinterpret_cast<size_t>(partial) % 16 == 0;
  if (vec) {
    gather_partial_kernel<float4><<<blocks, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(table), m, c / 4, idx, reinterpret_cast<float4*>(partial));
  } else {
    gather_partial_kernel<float><<<blocks, kThreads, 0, s>>>(table, m, c, idx, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_out = tiles * kOutRows * c;
  const int threads = 256;
  gather_finish_kernel<<<static_cast<unsigned int>((n_out + threads - 1) / threads), threads, 0, s>>>(
      partial, c, n_out, out);
  return static_cast<int>(cudaGetLastError());
}
