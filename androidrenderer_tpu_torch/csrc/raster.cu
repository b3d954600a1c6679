// Hopper rasterizer for the port's raster records (ops/raster/setup.py::pack_fused_records).
//
// Replaces the TPU kernel androidrenderer_tpu/ops/raster/raster_bitmask.py
// (_bitmask_kernel, reached through rasterize_bitmask): depth + visibility of a
// triangle set with reversed-Z, ties to the higher triangle id, and the
// depth_only / affine_z / z_limit / alpha_grid variants. It ports that kernel's
// contract, not its schedule: the window bitmasks, ctz scans, slabs and chunks
// existed to feed the TPU's scalar core and have no counterpart here.
//
// Contract, per pixel (x, y) at integer coordinates and per triangle t:
//   d_i = A_i*x + B_i*y + C_i; covered when all d_i <= 0 and sid != 0, or all
//   d_i >= 0 and sid < 0; z = (r . [x,y,1]) / (q . [x,y,1]), or the plane in
//   slots 12:15 with affine_z; accepted when 0 < z <= 1 (and z < z_limit); with
//   an alpha grid, bit (vi*16 + ui) of the triangle's 256-bit bitmap, where
//   ui, vi = clamp(d_{1,2} / (d0+d1+d2) * 16, 0, 15) truncated.
//
// Combine: every accepted z is > 0, so its float bits order like the floats.
// One 64-bit atomicMax of (bits(z) << 32 | t) into a buffer cleared to 0 keeps
// the greatest depth and, among equal depths, the highest id — exactly, in any
// order. A resolve pass unpacks depth and vis (vis = -1 where the key is 0).
// depth_only uses a 32-bit atomicMax on the float bits.
//
// What bounds it on this card: the per-triangle bbox walk (one block per
// triangle, threads striding over its clipped bounding box, so a large or
// screen-wide triangle serialises on one block while small ones leave most
// threads idle) and the atomic throughput on pixels many triangles cover. What
// the design does about it: dead triangles (sid == 0) leave at once; the
// depth/id key makes the combine a single atomic per fragment; a plain read of
// the current key skips the atomic when the fragment cannot win, which turns
// most occluded fragments into loads. Tile binning and load balancing for
// large triangles are later work.
//
// Floating point: every edge, z and barycentric term is __fmul_rn/__fadd_rn/
// __fdiv_rn (and the file is built with -fmad=false), so no a*b+c contracts to
// an FMA and the kernel matches the plain PyTorch version
// (ops/raster/raster.py::rasterize_reference) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kRec = 24;
constexpr int kThreads = 128;

__device__ __forceinline__ float plane(float a, float x, float b, float y, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

template <bool kDepthOnly, bool kAffineZ, bool kZLimit, bool kAlpha>
__global__ void __launch_bounds__(kThreads) raster_kernel(
    const float* __restrict__ recs, int height, int width,
    const float* __restrict__ zlim, const int* __restrict__ alpha,
    unsigned long long* __restrict__ keys, unsigned int* __restrict__ depth_bits) {
  const int t = blockIdx.x;
  const float* r = recs + static_cast<size_t>(t) * kRec;
  const float sid = r[18];
  if (sid == 0.0f) return;
  const int x0 = max(0, static_cast<int>(floorf(r[19])));
  const int y0 = max(0, static_cast<int>(floorf(r[20])));
  const int x1 = min(width - 1, static_cast<int>(ceilf(r[21])));
  const int y1 = min(height - 1, static_cast<int>(ceilf(r[22])));
  const int bw = x1 - x0 + 1;
  const int bh = y1 - y0 + 1;
  if (bw <= 0 || bh <= 0) return;

  const float a0 = r[0], b0 = r[1], c0 = r[2];
  const float a1 = r[3], b1 = r[4], c1 = r[5];
  const float a2 = r[6], b2 = r[7], c2 = r[8];
  const float qa = r[12], qb = r[13], qc = r[14];
  const float ra = r[15], rb = r[16], rc = r[17];
  const bool two_sided = sid < 0.0f;

  const int npx = bw * bh;
  for (int i = threadIdx.x; i < npx; i += kThreads) {
    const int row = i / bw;
    const int py = y0 + row;
    const int px = x0 + (i - row * bw);
    const float fx = static_cast<float>(px);
    const float fy = static_cast<float>(py);
    const float d0 = plane(a0, fx, b0, fy, c0);
    const float d1 = plane(a1, fx, b1, fy, c1);
    const float d2 = plane(a2, fx, b2, fy, c2);
    const bool front = d0 <= 0.0f && d1 <= 0.0f && d2 <= 0.0f;
    const bool back = two_sided && d0 >= 0.0f && d1 >= 0.0f && d2 >= 0.0f;
    if (!(front || back)) continue;
    float z;
    if (kAffineZ) {
      z = plane(qa, fx, qb, fy, qc);
    } else {
      z = __fdiv_rn(plane(ra, fx, rb, fy, rc), plane(qa, fx, qb, fy, qc));
    }
    if (!(z > 0.0f && z <= 1.0f)) continue;
    const size_t pix = static_cast<size_t>(py) * width + px;
    if (kZLimit && !(z < zlim[pix])) continue;
    if (kAlpha) {
      const float sv = __fadd_rn(__fadd_rn(d0, d1), d2);
      const float inv = __fdiv_rn(1.0f, sv == 0.0f ? 1.0f : sv);
      // fmaxf maps NaN to the bound, as the plain version's nan_to_num does.
      const int ui = static_cast<int>(fminf(fmaxf(__fmul_rn(__fmul_rn(d1, inv), 16.0f), 0.0f), 15.0f));
      const int vi = static_cast<int>(fminf(fmaxf(__fmul_rn(__fmul_rn(d2, inv), 16.0f), 0.0f), 15.0f));
      const int idx = vi * 16 + ui;
      const unsigned int word = static_cast<unsigned int>(alpha[static_cast<size_t>(t) * 8 + (idx >> 5)]);
      if (((word >> (idx & 31)) & 1u) == 0u) continue;
    }
    const unsigned int zb = __float_as_uint(z);
    if (kDepthOnly) {
      if (zb > __ldcg(depth_bits + pix)) atomicMax(depth_bits + pix, zb);
    } else {
      const unsigned long long key =
          (static_cast<unsigned long long>(zb) << 32) | static_cast<unsigned int>(t);
      if (key > __ldcg(keys + pix)) atomicMax(keys + pix, key);
    }
  }
}

__global__ void resolve_kernel(const unsigned long long* __restrict__ keys, int npix,
                               float* __restrict__ depth, int* __restrict__ vis) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= npix) return;
  const unsigned long long k = keys[i];
  depth[i] = __uint_as_float(static_cast<unsigned int>(k >> 32));
  vis[i] = k == 0ull ? -1 : static_cast<int>(static_cast<unsigned int>(k & 0xffffffffull));
}

template <bool kDepthOnly, bool kAffineZ>
void launch_raster(bool has_zlim, bool has_alpha, dim3 grid, cudaStream_t s,
                   const float* recs, int height, int width, const float* zlim,
                   const int* alpha, unsigned long long* keys, unsigned int* depth_bits) {
  if (has_zlim && has_alpha) {
    raster_kernel<kDepthOnly, kAffineZ, true, true><<<grid, kThreads, 0, s>>>(
        recs, height, width, zlim, alpha, keys, depth_bits);
  } else if (has_zlim) {
    raster_kernel<kDepthOnly, kAffineZ, true, false><<<grid, kThreads, 0, s>>>(
        recs, height, width, zlim, alpha, keys, depth_bits);
  } else if (has_alpha) {
    raster_kernel<kDepthOnly, kAffineZ, false, true><<<grid, kThreads, 0, s>>>(
        recs, height, width, zlim, alpha, keys, depth_bits);
  } else {
    raster_kernel<kDepthOnly, kAffineZ, false, false><<<grid, kThreads, 0, s>>>(
        recs, height, width, zlim, alpha, keys, depth_bits);
  }
}

}  // namespace

// Rasterize ``n`` records (n, 24) f32 into a height x width target on ``stream``.
// zlim (height*width f32) and alpha (n*8 i32) may be null. depth_only writes
// ``depth`` only; otherwise ``keys`` (height*width u64 scratch) is combined into
// and resolved into ``depth`` and ``vis``. Allocates nothing; returns the first
// CUDA error (0 on success).
extern "C" int raster_launch(const float* recs, int n, int height, int width,
                             const float* zlim, const int* alpha, int depth_only,
                             int affine_z, void* keys, float* depth, int* vis,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t npix = static_cast<size_t>(height) * width;
  cudaError_t err;
  if (depth_only) {
    err = cudaMemsetAsync(depth, 0, npix * sizeof(float), s);
  } else {
    err = cudaMemsetAsync(keys, 0, npix * sizeof(unsigned long long), s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const dim3 grid(static_cast<unsigned int>(n));
    auto* k = static_cast<unsigned long long*>(keys);
    auto* db = reinterpret_cast<unsigned int*>(depth);
    const bool hz = zlim != nullptr, ha = alpha != nullptr;
    if (depth_only && affine_z) {
      launch_raster<true, true>(hz, ha, grid, s, recs, height, width, zlim, alpha, k, db);
    } else if (depth_only) {
      launch_raster<true, false>(hz, ha, grid, s, recs, height, width, zlim, alpha, k, db);
    } else if (affine_z) {
      launch_raster<false, true>(hz, ha, grid, s, recs, height, width, zlim, alpha, k, db);
    } else {
      launch_raster<false, false>(hz, ha, grid, s, recs, height, width, zlim, alpha, k, db);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!depth_only) {
    const int threads = 256;
    const int blocks = static_cast<int>((npix + threads - 1) / threads);
    resolve_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const unsigned long long*>(keys), static_cast<int>(npix), depth, vis);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
