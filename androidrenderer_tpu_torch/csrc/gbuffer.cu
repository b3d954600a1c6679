// Hopper gbuffer resolve for the port's ops/gbuffer.py::resolve_gbuffer.
//
// Replaces no TPU kernel: the JAX package's resolve (androidrenderer_tpu/
// ops/gbuffer.py::resolve_gbuffer) is left to XLA, which fuses it. Ported op for
// op to PyTorch, it became ~400 elementwise kernels a call, nearly each writing a
// full-frame (H, W, C) float32 temporary (the plane gather alone 87 floats a
// pixel), and the frame calls it three times: the opaque frame and each
// translucent peel layer. This kernel computes the same function in one launch.
//
// What bounds it on this card: bytes. A shaded sample reads its vis (4 B), its
// triangle's row of attribute planes (87 floats, 348 B) and one 117 B texel row
// per texture slot it samples (slot 0: base, normal and metal-rough; slot 3:
// emission), and writes 57 B. Neighbouring samples share triangles and texel
// rows, so device memory need supply each distinct row once; an invalid sample
// (vis < 0) is its 4 B in and 57 B out.
//
// Design: one thread per sample, every intermediate in registers.
//   - The plane channels are read with __ldg as each is needed: the samples of a
//     warp mostly share a triangle, so a warp's load of one channel is one or
//     two L1 lines.
//   - Pool rows are 117 B and start at any byte, so no thread can read one with
//     aligned vector loads. The warp stages the rows its lanes sample instead:
//     for each lane that samples, the whole warp reads the 30 aligned words
//     that cover that row (one coalesced 120 B load) into shared memory, rows
//     33 words apart so that the lanes' byte reads fall in different banks.
//     Each lane then reads its row's texels from shared memory. A slot's rows
//     are staged once, and a warp in which no lane samples a slot stages
//     nothing: a translucent layer costs about its covered samples.
//   - An invalid sample gathers nothing and writes the plain version's invalid
//     values: base, normal, emission and world position 0, roughness 1,
//     metalness 0, valid false. An id past the last row of planes, which the
//     plain version refuses with an IndexError, is written so too: the kernel
//     never reads outside the table.
//
// Floating point: the file is built with -fmad=false, and every product, sum
// and quotient is rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn) in the plain version's order, so the kernel matches
// resolve_gbuffer_reference run on the card bit for bit. Where one of PyTorch's
// CUDA kernels fixes an order or a contraction itself, this file copies it:
//   - a 3-wide sum(dim=-1) splits over two lanes ({x0, x2} and {x1}), so it
//     adds (x0 + x2) + x1 (ATen's Reduce.cuh);
//   - torch.linalg.cross computes a*b - c*d in one kernel built with FMA
//     contraction: fma(a, b, -(c*d));
//   - division by a Python scalar multiplies by the scalar's reciprocal, taken
//     in double and rounded to float32 (div_true_kernel_cuda), and `1.0 / t`
//     is reciprocal(t) * 1.0;
//   - log2 and pow are log2f and powf, and round is rintf, as ATen calls them;
//   - Python scalars are doubles, rounded to float32 as PyTorch rounds them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// ops/gbuffer.py's plane layout: [fa | fb | fc] blocks of 29 channels each.
constexpr int kPlaneChannels = 29;  // ATTR_CHANNELS + 1 + CONST_CHANNELS
constexpr int kPlaneRow = 3 * kPlaneChannels;
constexpr int kS = 16;  // the s-plane channel (ATTR_CHANNELS)
constexpr int kC0 = kS + 1;  // the first material constant
constexpr int kStartAlign = 1024;  // scene/material_storage.py::START_ALIGN

// A pool row (scene/material_storage.py: POOL_CHANNELS) and its staging.
constexpr int kPoolRow = 117;
constexpr int kRowWords = 30;  // aligned words that cover 117 B at any byte offset
constexpr int kStageWords = 33;  // a staged row's stride: 33 words, an odd bank step
constexpr int kStageBatch = 8;  // rows a lane loads before it stores them

// The wrapper's use_* arguments.
constexpr int kUseBase = 1, kUseNormalMaps = 2, kUseMetalRough = 4, kUseEmission = 8;

// A Python float as PyTorch hands it to a float32 kernel.
__host__ __device__ constexpr float f32(double x) { return static_cast<float>(x); }

constexpr float kInv255 = f32(1.0 / 255.0);  // texture.py::_fetch
constexpr float kInv1292 = f32(1.0 / 12.92);  // post.py::srgb_to_linear: c / 12.92
constexpr float kInv1055 = f32(1.0 / 1.055);  // (c + 0.055) / 1.055

struct Args {
  const int* vis;
  const float* px;  // null: the (H, W) grid, py = row + row_offset
  const float* py;
  long long n;
  int width;
  int row_offset;
  const float* planes;  // (plane_rows, 87)
  long long plane_rows;
  const unsigned char* pool;  // (pool_rows, 117), 4-byte aligned
  long long pool_rows;
  float mip_bias;
  int flags;
  float* base;  // (n, 3)
  float* normal;  // (n, 3)
  float* roughness;  // (n,)
  float* metalness;  // (n,)
  float* emission;  // (n, 3)
  float* world_position;  // (n, 3)
  bool* valid;  // (n,)
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.maximum / minimum / clamp on the card: NaN propagates.
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// Integer ops as int32 tensors do them: wrapping.
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
__device__ __forceinline__ int floor_div(int a, int b) {  // rounding_mode="floor"
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return add(add(x0, x2), x1);
}

__device__ __forceinline__ V3 normalize(V3 v) {  // ops/gbuffer.py::_normalize
  const float d =
      __fsqrt_rn(clamp_min(sum3(mul(v.x, v.x), mul(v.y, v.y), mul(v.z, v.z)), f32(1e-12)));
  return {div(v.x, d), div(v.y, d), div(v.z, d)};
}

__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -mul(c, d));
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {  // torch.linalg.cross
  return {cross_term(a.y, b.z, a.z, b.y), cross_term(a.z, b.x, a.x, b.z),
          cross_term(a.x, b.y, a.y, b.x)};
}

__device__ __forceinline__ float srgb_to_linear(float c) {  // ops/post.py
  c = clamp(c, 0.0f, 1.0f);
  return c <= f32(0.04045) ? mul(c, kInv1292) : powf(mul(add(c, f32(0.055)), kInv1055), f32(2.4));
}

__device__ __forceinline__ float lerp(float a, float b, float t) { return add(a, mul(sub(b, a), t)); }

// texture.py::_trilinear_setup for one slot: the pool row and the weights.
struct Footprint {
  long long row;
  float fx, fy, fl, fxc, fyc;
  int ox1, oy1;  // the next level's 2x2 within the row's 3x3 block
};

__device__ Footprint footprint(int start, int log2b, float uv_u, float uv_v, float lod,
                               long long pool_rows) {
  Footprint f;
  const float lodc = minimum(clamp_min(lod, 0.0f), static_cast<float>(log2b));
  const int level = static_cast<int>(floorf(lodc));
  f.fl = sub(lodc, static_cast<float>(level));
  // _level_geometry
  const int b = static_cast<int>(1u << log2b);
  const int size = b >> level;
  const float sizef = static_cast<float>(size);
  const int mip_off = floor_div(wrap_mul(wrap_add(wrap_mul(b, b), -wrap_mul(size, size)), 4), 3);
  // _footprint
  const float u = sub(uv_u, floorf(uv_u));
  const float v = sub(uv_v, floorf(uv_v));
  const float x = sub(mul(u, sizef), 0.5f);
  const float y = sub(mul(v, sizef), 0.5f);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  f.fx = sub(x, x0);
  f.fy = sub(y, y0);
  const int x0i = static_cast<int>(x0) & (size - 1);
  const int y0i = static_cast<int>(y0) & (size - 1);
  const int row = wrap_add(wrap_add(wrap_add(start, mip_off), wrap_mul(y0i, size)), x0i);
  f.row = min(max(static_cast<long long>(row), 0LL), pool_rows - 1);
  // _Coarse
  const int s1 = max(size >> 1, 1);
  const float s1f = static_cast<float>(s1);
  const float xc = sub(mul(u, s1f), 0.5f);
  const float yc = sub(mul(v, s1f), 0.5f);
  const float xc0 = floorf(xc);
  const float yc0 = floorf(yc);
  f.fxc = sub(xc, xc0);
  f.fyc = sub(yc, yc0);
  const bool last = level >= log2b;
  const int kx = last ? x0i : x0i >> 1;
  const int ky = last ? y0i : y0i >> 1;
  const int sc = last ? size : s1;
  const int xc0i = static_cast<int>(xc0) & (sc - 1);
  const int yc0i = static_cast<int>(yc0) & (sc - 1);
  f.ox1 = ((xc0i - kx + 1) & (sc - 1)) == 1;
  f.oy1 = ((yc0i - ky + 1) & (sc - 1)) == 1;
  return f;
}

__device__ __forceinline__ float tap(const unsigned char* row, int k) {
  return mul(static_cast<float>(row[k]), kInv255);
}

// Channel c of a trilinear sample: the level's 2x2 at ``fine`` (cells ``ch``
// apart) blended with the next level's 2x2 picked from the 3x3 at ``coarse``
// (texture.py::_bilerp, _Coarse.bilerp).
__device__ __forceinline__ float trilinear(const unsigned char* row, const Footprint& f, int fine,
                                           int coarse, int ch, int c) {
  const float top = lerp(tap(row, fine + c), tap(row, fine + ch + c), f.fx);
  const float bot = lerp(tap(row, fine + 2 * ch + c), tap(row, fine + 3 * ch + c), f.fx);
  const float fine_v = lerp(top, bot, f.fy);
  const int cell = coarse + (f.oy1 * 3 + f.ox1) * ch + c;  // cell (oy1, ox1)
  const float ctop = lerp(tap(row, cell), tap(row, cell + ch), f.fxc);
  const float cbot = lerp(tap(row, cell + 3 * ch), tap(row, cell + 4 * ch), f.fxc);
  return lerp(fine_v, lerp(ctop, cbot, f.fyc), f.fl);
}

__device__ __forceinline__ unsigned pool_word(const Args& a, unsigned long long w) {
  const unsigned long long bytes = static_cast<unsigned long long>(a.pool_rows) * kPoolRow;
  if (4 * w + 4 <= bytes) return __ldg(reinterpret_cast<const unsigned*>(a.pool) + w);
  unsigned v = 0;  // the pool's last word, past its end
  for (int k = 0; k < 4; ++k) {
    if (4 * w + k < bytes) v |= static_cast<unsigned>(a.pool[4 * w + k]) << (8 * k);
  }
  return v;
}

// Stage the pool row of each lane that has ``want`` into the warp's buffer
// ``stage`` (32 rows of kStageWords words); returns this lane's row.
__device__ const unsigned char* stage_rows(const Args& a, unsigned* stage, bool want,
                                           long long row, int lane) {
  const unsigned need = __ballot_sync(kFull, want);
  const unsigned long long byte0 = static_cast<unsigned long long>(row) * kPoolRow;
  const unsigned long long word0 = byte0 >> 2;
  __syncwarp();  // the buffer's previous rows are read
  if (need != 0) {
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += kStageBatch) {
      unsigned v[kStageBatch];
#pragma unroll
      for (int k = 0; k < kStageBatch; ++k) {
        const unsigned long long w = __shfl_sync(kFull, word0, j0 + k);
        v[k] = ((need >> (j0 + k)) & 1u) && lane < kRowWords ? pool_word(a, w + lane) : 0u;
      }
#pragma unroll
      for (int k = 0; k < kStageBatch; ++k) {
        if (lane < kRowWords) stage[(j0 + k) * kStageWords + lane] = v[k];
      }
    }
  }
  __syncwarp();
  return reinterpret_cast<const unsigned char*>(stage + lane * kStageWords) + (byte0 & 3);
}

// The plain version's values where vis < 0.
__device__ __forceinline__ void write_invalid(const Args& a, long long i) {
  for (int c = 0; c < 3; ++c) {
    a.base[3 * i + c] = 0.0f;
    a.normal[3 * i + c] = 0.0f;
    a.emission[3 * i + c] = 0.0f;
    a.world_position[3 * i + c] = 0.0f;
  }
  a.roughness[i] = 1.0f;
  a.metalness[i] = 0.0f;
  a.valid[i] = false;
}

__global__ void __launch_bounds__(kThreads) gbuffer_kernel(const Args a) {
  __shared__ unsigned staged[kWarps][32 * kStageWords];
  const int lane = threadIdx.x & 31;
  unsigned* stage = staged[threadIdx.x >> 5];
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool in = i < a.n;
  const int t = in ? a.vis[i] : -1;
  const bool ok = t >= 0 && t < a.plane_rows;  // a row of planes, or shaded as vis < 0
  if (__ballot_sync(kFull, ok) == 0) {  // no lane shades: only invalid writes
    if (in) write_invalid(a, i);
    return;
  }

  float px = 0.0f, py = 0.0f;
  if (in) {
    if (a.px != nullptr) {
      px = a.px[i];
      py = a.py[i];
    } else {
      const long long y = i / a.width;
      px = static_cast<float>(i - y * a.width);
      py = add(static_cast<float>(y), static_cast<float>(a.row_offset));
    }
  }
  const float* pa = a.planes + static_cast<long long>(ok ? t : 0) * kPlaneRow;
  const float* pb = pa + kPlaneChannels;
  const float* pc = pb + kPlaneChannels;
  // f = pa * px + pb * py + pc; a = f * inv_s.
  auto plane = [&](int c) { return add(add(mul(__ldg(pa + c), px), mul(__ldg(pb + c), py)), __ldg(pc + c)); };
  float inv_s = 1.0f;
  if (ok) {
    const float s = plane(kS);
    inv_s = div(1.0f, s == 0.0f ? 1.0f : s);
  }
  auto attr = [&](int c) { return mul(plane(c), inv_s); };

  // Texture coordinates, the analytic LOD (texture.py::compute_lod_uv) and the
  // two slots' footprints.
  const bool want0 = ok && (a.flags & (kUseBase | kUseNormalMaps | kUseMetalRough));
  const bool want3 = ok && (a.flags & kUseEmission);
  float uv_u = 0.0f, uv_v = 0.0f, lod_uv = 0.0f;
  if (ok) {
    uv_u = attr(0);
    uv_v = attr(1);
    const float sa = __ldg(pa + kS), sb = __ldg(pb + kS);
    const float dxu = mul(sub(__ldg(pa + 0), mul(uv_u, sa)), inv_s);
    const float dxv = mul(sub(__ldg(pa + 1), mul(uv_v, sa)), inv_s);
    const float dyu = mul(sub(__ldg(pb + 0), mul(uv_u, sb)), inv_s);
    const float dyv = mul(sub(__ldg(pb + 1), mul(uv_v, sb)), inv_s);
    const float rho2 = maximum(maximum(add(mul(dxu, dxu), mul(dxv, dxv)),
                                       add(mul(dyu, dyu), mul(dyv, dyv))), f32(1e-24));
    lod_uv = add(mul(0.5f, log2f(rho2)), a.mip_bias);
  }
  auto slot = [&](bool want, int k) {
    Footprint f{};
    if (want) {
      const int packed = static_cast<int>(rintf(attr(kC0 + 8 + k)));
      const int log2b = packed & 15;
      f = footprint(wrap_mul(packed >> 4, kStartAlign), log2b, uv_u, uv_v,
                    add(lod_uv, static_cast<float>(log2b)), a.pool_rows);
    }
    return f;
  };

  // Slot 0: base, normal map and metal-rough from one row.
  float base_s[3] = {0.0f, 0.0f, 0.0f}, nrm_s[3] = {0.0f, 0.0f, 0.0f}, mr_s[2] = {0.0f, 0.0f};
  {
    const Footprint f0 = slot(want0, 0);
    const unsigned char* row = stage_rows(a, stage, want0, f0.row, lane);
    if (want0) {
      for (int c = 0; c < 3; ++c) base_s[c] = trilinear(row, f0, 0, 16, 4, c);
      for (int c = 0; c < 3; ++c) nrm_s[c] = trilinear(row, f0, 52, 64, 3, c);
      for (int c = 0; c < 2; ++c) mr_s[c] = trilinear(row, f0, 91, 99, 2, c);
    }
  }
  // Slot 3: emission, through the base channels.
  float em_s[3] = {0.0f, 0.0f, 0.0f};
  {
    const Footprint f3 = slot(want3, 3);
    const unsigned char* row = stage_rows(a, stage, want3, f3.row, lane);
    if (want3) {
      for (int c = 0; c < 3; ++c) em_s[c] = trilinear(row, f3, 0, 16, 4, c);
    }
  }
  if (!in) return;
  if (!ok) {
    write_invalid(a, i);
    return;
  }

  for (int c = 0; c < 3; ++c) {  // (texel * base factor) * vertex colour
    const float factor = attr(kC0 + c);
    const float texel = (a.flags & kUseBase) ? mul(srgb_to_linear(base_s[c]), factor) : factor;
    a.base[3 * i + c] = mul(texel, attr(9 + c));
  }

  const V3 geo_n = normalize({attr(2), attr(3), attr(4)});
  V3 normal = geo_n;
  if (a.flags & kUseNormalMaps) {
    const float n0 = sub(mul(nrm_s[0], 2.0f), 1.0f);
    const float n1 = sub(mul(nrm_s[1], 2.0f), 1.0f);
    const float n2 = sub(mul(nrm_s[2], 2.0f), 1.0f);
    V3 tg = {attr(5), attr(6), attr(7)};
    const float t_len2 = sum3(mul(tg.x, tg.x), mul(tg.y, tg.y), mul(tg.z, tg.z));
    if (t_len2 > f32(1e-8)) {
      const float d = __fsqrt_rn(clamp_min(t_len2, f32(1e-12)));
      tg = {div(tg.x, d), div(tg.y, d), div(tg.z, d)};
      const float w = attr(8);
      const V3 bc = cross(geo_n, tg);
      const V3 bt = {mul(bc.x, w), mul(bc.y, w), mul(bc.z, w)};
      normal = normalize({add(add(mul(tg.x, n0), mul(bt.x, n1)), mul(geo_n.x, n2)),
                          add(add(mul(tg.y, n0), mul(bt.y, n1)), mul(geo_n.y, n2)),
                          add(add(mul(tg.z, n0), mul(bt.z, n1)), mul(geo_n.z, n2))});
    }
  }
  a.normal[3 * i + 0] = normal.x;
  a.normal[3 * i + 1] = normal.y;
  a.normal[3 * i + 2] = normal.z;

  const float metal_f = attr(kC0 + 3);
  const float rough_f = attr(kC0 + 4);
  const bool mr = a.flags & kUseMetalRough;
  a.roughness[i] = clamp(mr ? mul(mr_s[0], rough_f) : rough_f, f32(0.045), 1.0f);
  a.metalness[i] = clamp(mr ? mul(mr_s[1], metal_f) : metal_f, 0.0f, 1.0f);

  for (int c = 0; c < 3; ++c) {
    a.emission[3 * i + c] =
        (a.flags & kUseEmission) ? mul(srgb_to_linear(em_s[c]), attr(kC0 + 5 + c)) : 0.0f;
    a.world_position[3 * i + c] = attr(12 + c);
  }
  a.valid[i] = true;
}

}  // namespace

// Resolve ``n`` samples of the visibility buffer ``vis`` (i32, -1: none) into
// the gbuffer planes on ``stream``. ``px``/``py`` (n,) f32 give each sample's
// pixel coordinates, or are null for the (n / width, width) grid whose row y is
// frame row y + row_offset. ``planes`` is pack_attribute_planes' (plane_rows,
// 87) table (an id outside it shades as -1), ``pool`` the (pool_rows, 117) u8
// texel pool (4-byte aligned); ``flags`` ORs 1 base textures, 2 normal maps, 4
// metal-rough textures, 8 emission. Outputs:
// base, normal, emission, world_position (n, 3) f32; roughness, metalness (n,)
// f32; valid (n,) bool. Allocates nothing; returns the first CUDA error (0 on
// success).
extern "C" int gbuffer_launch(const int* vis, const float* px, const float* py, long long n,
                              int width, int row_offset, const float* planes,
                              long long plane_rows, const unsigned char* pool,
                              long long pool_rows, float mip_bias, int flags, float* base,
                              float* normal, float* roughness, float* metalness,
                              float* emission, float* world_position, bool* valid,
                              void* stream) {
  if (n <= 0) return 0;
  const Args a{vis, px, py, n, width, row_offset, planes, plane_rows, pool, pool_rows, mip_bias,
               flags, base, normal, roughness, metalness, emission, world_position, valid};
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  gbuffer_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
