// Hopper BVH traversal for the port's ops/rt/traverse.py::trace_rays.
//
// Replaces androidrenderer_tpu/ops/rt/traverse.py::_phase, the JAX package's
// lockstep walk (a lax.while_loop over all rays, not a Pallas kernel) and the
// ray-compaction schedule trace_rays wraps around it. It computes what
// trace_rays computes, closest-hit or any-hit (with the masked any-hit park
// rule of the exact alpha peel), with the in-traversal alpha bitmap test,
// scalar or per-ray tmin and tmax, an active mask and a step cap.
// The compaction schedule is not carried over: it exists because the TPU runs
// every ray in lockstep, and JAX's result does not depend on it.
//
// Design: one thread per ray walks the preorder skip links (scene/bvh.py) with
// one integer of state, its node index. At each node it reads from that node's
// packed row (109 f32, ops/rt/traverse.py's layout) only what the step needs:
// the box and links (9 floats); at a leaf whose box the ray hits, the 4 slots'
// Moller-Trumbore data, their alpha words where the bitmap test is on, and the
// slot count; at an inner node whose box it hits, the 4 lookahead slots and
// boxes. It parks at idx >= m, at its first committed hit when any_hit is set
// (with masked_any_hit only when the nearest hit so far is on an opaque slot:
// a masked slot's hit is kept as the nearest and the walk goes on, so that
// the caller can alpha-test it and re-trace past it), or after max_steps steps; then it writes t, slot, u, v and its step count,
// and its warp folds the longest walk and whether the cap stopped a ray into
// two words (one atomic per warp).
//
// What bounds it on this card: at the bench's call sites (2,088,960 rays over
// the 262,143-node BVH of the bench scene, 114 MB of rows) the least time is set
// by operations, ~25 per step and ~55 per triangle test, each counted where
// this walk makes it (chip_smoke.py, traverse_bound); the rows a trace reads are
// a part of the BVH (29k-114k distinct rows), so bytes bound it below that. A per-thread walk
// pays instead the latency of dependent row reads (each step's row address
// comes from the last step's row) and divergence between the rays of a warp.
// The design keeps a warp on 32 neighbouring pixels' rays, which walk similar
// paths, so their rows mostly come from L1/L2, and reads only the fields a step
// needs. Wavefront queues, treelet caching or a row re-layout are for a later
// change, with a profile.
//
// Rounding: JAX's arithmetic op for op, each product, sum and quotient rounded
// on its own (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, built with
// -fmad=false), 3-term dot products summed (x + y) + z, and min/max that
// propagate NaN as jnp.minimum / jnp.maximum do (fminf / fmaxf would drop it).
// The plain version (trace_rays_reference) rounds the same way, so the two
// agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLeaf = 4;
constexpr int kSlot0 = 9;
constexpr int kOpq0 = kSlot0 + kLeaf * 9;
constexpr int kGrid0 = kOpq0 + kLeaf;
constexpr int kLook0 = kGrid0 + kLeaf * 8;
constexpr int kRow = kLook0 + 4 + 4 * 6;
static_assert(kRow == 109, "node_rows layout of ops/rt/traverse.py");
constexpr int kThreads = 128;
constexpr int kWork = 6;  // work counts per ray (ops/rt/traverse.py::WORK_COUNTS)
constexpr float kFltMin = 1.17549435e-38f;  // 2^-126

__device__ __forceinline__ bool is_nan(float x) { return x != x; }
__device__ __forceinline__ float min_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (b < a ? b : a));
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (b > a ? b : a));
}
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p) {
  return V3{__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
            sub(mul(a.x, b.y), mul(a.y, b.x))};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}

// Slab test of the box at p (min xyz, max xyz): true when hit.
__device__ __forceinline__ bool slab(const float* p, V3 o, V3 inv, float t_lo, float t_hi) {
  const float t0x = mul(sub(__ldg(p + 0), o.x), inv.x);
  const float t0y = mul(sub(__ldg(p + 1), o.y), inv.y);
  const float t0z = mul(sub(__ldg(p + 2), o.z), inv.z);
  const float t1x = mul(sub(__ldg(p + 3), o.x), inv.x);
  const float t1y = mul(sub(__ldg(p + 4), o.y), inv.y);
  const float t1z = mul(sub(__ldg(p + 5), o.z), inv.z);
  const float tn = max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)), min_nan(t0z, t1z));
  const float tf = min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)), max_nan(t0z, t1z));
  return (tn <= tf) && (tf >= t_lo) && (tn <= t_hi);
}

// JAX's arithmetic (XLA's CPU backend, the TPU) reads a subnormal as zero:
// the rays' components are flushed to signed zero as they are read.
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < kFltMin ? copysignf(0.0f, x) : x;
}
__device__ __forceinline__ V3 load_ray(const float* p) {
  return V3{flush(p[0]), flush(p[1]), flush(p[2])};
}
__device__ __forceinline__ float inv_component(float d) {
  return __fdiv_rn(1.0f, d == 0.0f ? 1e-30f : d);
}

template <bool kAnyHit, bool kMasked, bool kBitmap>
__global__ void __launch_bounds__(kThreads) traverse_kernel(
    const float* __restrict__ rows, int m, const float* __restrict__ origins,
    const float* __restrict__ dirs, int r, const float* __restrict__ tmin_ray, float tmin_all,
    const float* __restrict__ tmax_ray, float tmax_all, const uint8_t* __restrict__ active,
    int max_steps, float* __restrict__ t_out, int* __restrict__ slot_out,
    float* __restrict__ u_out, float* __restrict__ v_out, int* __restrict__ steps_out,
    int* __restrict__ steps_max, bool* __restrict__ overflow, int* __restrict__ work,
    uint8_t* __restrict__ touched) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool ray = i < r;
  int steps = 0;
  int idx = m;
  if (ray) {
    const V3 o = load_ray(origins + 3 * static_cast<size_t>(i));
    const V3 d = load_ray(dirs + 3 * static_cast<size_t>(i));
    const V3 inv = V3{inv_component(d.x), inv_component(d.y), inv_component(d.z)};
    const float t_lo = tmin_ray ? tmin_ray[i] : tmin_all;
    float best_t = tmax_ray ? tmax_ray[i] : tmax_all;
    float best_u = 0.0f, best_v = 0.0f;
    int best_slot = -1;
    bool best_opq = false;  // the nearest hit's slot is opaque (masked any-hit)
    // Work counts (scratch `work`): the tests this walk makes, for the bound.
    int leaves = 0, inners = 0, targets = 0, target_slabs = 0, lookups = 0;
    idx = (active == nullptr || active[i]) ? 0 : m;
    while (idx < m && steps < max_steps) {
      ++steps;
      const float* row = rows + static_cast<size_t>(idx) * kRow;
      if (touched) touched[idx] = 1;
      const int miss = static_cast<int>(__ldg(row + 6));
      const float first_f = __ldg(row + 7);
      int nxt = miss;
      if (slab(row, o, inv, t_lo, best_t)) {
        if (first_f >= 0.0f) {
          ++leaves;
          const float count = __ldg(row + 8);
          int k_best = -1;
          float t_near = __int_as_float(0x7f800000);  // +inf
          float u_near = 0.0f, v_near = 0.0f;
#pragma unroll
          for (int k = 0; k < kLeaf; ++k) {
            const float* s = row + kSlot0 + 9 * k;
            const V3 v0 = load3(s), e1 = load3(s + 3), e2 = load3(s + 6);
            const V3 pvec = cross(d, e2);
            const float det = dot(e1, pvec);
            const float inv_det = __fdiv_rn(1.0f, fabsf(det) < 1e-12f ? 1e-12f : det);
            const V3 tvec = V3{sub(o.x, v0.x), sub(o.y, v0.y), sub(o.z, v0.z)};
            const float u = mul(dot(tvec, pvec), inv_det);
            const V3 qvec = cross(tvec, e1);
            const float v = mul(dot(d, qvec), inv_det);
            const float t = mul(dot(e2, qvec), inv_det);
            bool ok = (static_cast<float>(k) < count) && (fabsf(det) > 1e-12f) && (u >= 0.0f) &&
                      (v >= 0.0f) && (add(u, v) <= 1.0f) && (t > t_lo) && (t < best_t);
            if (kBitmap && ok) {
              ++lookups;
              // MT's u = lambda1, v = lambda2: the bake's (ui, vi) convention.
              const int ui = static_cast<int>(fminf(fmaxf(mul(u, 16.0f), 0.0f), 15.0f));
              const int vi = static_cast<int>(fminf(fmaxf(mul(v, 16.0f), 0.0f), 15.0f));
              const int b = vi * 16 + ui;
              const int word = __float_as_int(__ldg(row + kGrid0 + 8 * k + (b >> 5)));
              ok = ((word >> (b & 31)) & 1) == 1;
            }
            // The nearest passing slot, the lowest k on ties.
            if (ok && t < t_near) {
              k_best = k;
              t_near = t;
              u_near = u;
              v_near = v;
            }
          }
          if (k_best >= 0) {
            best_slot = static_cast<int>(first_f) + k_best;
            best_t = t_near;
            best_u = u_near;
            best_v = v_near;
            if (kMasked) best_opq = __ldg(row + kOpq0 + k_best) != 0.0f;
          }
        } else {
          ++inners;
          // Jump to the first lookahead target hit, in preorder; none => miss.
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            ++targets;
            const float target = __ldg(row + kLook0 + k);
            if (target < 0.0f) continue;
            ++target_slabs;
            if (slab(row + kLook0 + 4 + 6 * k, o, inv, t_lo, best_t)) {
              nxt = static_cast<int>(target);
              break;
            }
          }
        }
      }
      idx = (kAnyHit && best_slot >= 0 && (!kMasked || best_opq)) ? m : nxt;
    }
    t_out[i] = best_t;
    slot_out[i] = best_slot;
    u_out[i] = best_u;
    v_out[i] = best_v;
    steps_out[i] = steps;
    if (work) {
      int* w = work + kWork * static_cast<size_t>(i);
      w[0] = steps;
      w[1] = leaves;
      w[2] = inners;
      w[3] = targets;
      w[4] = target_slabs;
      w[5] = lookups;
    }
  }
  // Every lane of the warp takes part, rays or not.
  const int warp_max = __reduce_max_sync(0xffffffffu, steps);
  const unsigned stopped = __ballot_sync(0xffffffffu, ray && idx < m);
  if ((threadIdx.x & 31) == 0) {
    if (warp_max > 0) atomicMax(steps_max, warp_max);
    if (stopped) *overflow = true;
  }
}

struct Args {
  const float* rows;
  int m;
  const float* origins;
  const float* dirs;
  int r;
  const float* tmin_ray;
  float tmin_all;
  const float* tmax_ray;
  float tmax_all;
  const uint8_t* active;
  int max_steps;
  float* t;
  int* slot;
  float* u;
  float* v;
  int* steps;
  int* steps_max;
  bool* overflow;
  int* work;
  uint8_t* touched;
};

template <bool kAnyHit, bool kMasked, bool kBitmap>
void launch(dim3 grid, cudaStream_t stream, const Args& a) {
  traverse_kernel<kAnyHit, kMasked, kBitmap><<<grid, kThreads, 0, stream>>>(
      a.rows, a.m, a.origins, a.dirs, a.r, a.tmin_ray, a.tmin_all, a.tmax_ray, a.tmax_all,
      a.active, a.max_steps, a.t, a.slot, a.u, a.v, a.steps, a.steps_max, a.overflow, a.work,
      a.touched);
}

template <bool kAnyHit, bool kMasked>
void launch_bitmap(dim3 grid, cudaStream_t stream, const Args& a, int bitmap) {
  if (bitmap) {
    launch<kAnyHit, kMasked, true>(grid, stream, a);
  } else {
    launch<kAnyHit, kMasked, false>(grid, stream, a);
  }
}

}  // namespace

extern "C" {

// Trace r rays through the m-node BVH on `stream`: t, slot, u, v and each
// ray's step count per ray; the longest walk into steps_max[0] and whether the
// cap stopped a ray into overflow[0] (both cleared here first). tmin_ray /
// tmax_ray may be null (the scalar applies), active may be null (all rays),
// work ((r, 6) i32: steps, leaf visits, inner visits, lookahead targets
// examined, lookahead slab tests, bitmap lookups) and touched ((m,) u8, zeroed
// by the caller) may be null. masked_any_hit applies with any_hit only: a ray
// then parks on its nearest hit only when that hit's slot is opaque. Returns
// the first CUDA error, or 0.
int traverse_launch(const float* rows, int m, const float* origins, const float* dirs, int r,
                    const float* tmin_ray, float tmin_all, const float* tmax_ray,
                    float tmax_all, const uint8_t* active, int any_hit, int masked_any_hit,
                    int bitmap, int max_steps, float* t, int* slot, float* u, float* v,
                    int* steps, int* steps_max, bool* overflow, int* work, uint8_t* touched,
                    cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(steps_max, 0, sizeof(int), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(overflow, 0, sizeof(bool), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (r > 0) {
    const dim3 grid((r + kThreads - 1) / kThreads);
    const Args a{rows, m, origins, dirs, r, tmin_ray, tmin_all, tmax_ray, tmax_all, active,
                 max_steps, t, slot, u, v, steps, steps_max, overflow, work, touched};
    if (any_hit && masked_any_hit) {
      launch_bitmap<true, true>(grid, stream, a, bitmap);
    } else if (any_hit) {
      launch_bitmap<true, false>(grid, stream, a, bitmap);
    } else {
      launch_bitmap<false, false>(grid, stream, a, bitmap);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
