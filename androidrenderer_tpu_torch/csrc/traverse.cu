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
// The walk: each ray follows the preorder skip links (scene/bvh.py) with one
// integer of state, its node index. A step slab-tests the node's box; at a leaf
// whose box it hits it Moller-Trumbore-tests the leaf's slots (with the alpha
// bitmap test where it is on), at an inner node whose box it hits it slab-tests
// the 4 lookahead targets in preorder and jumps to the first one hit, else it
// takes the miss link. It parks at idx >= m, at its first committed hit when
// any_hit is set (with masked_any_hit only when the nearest hit so far is on an
// opaque slot: a masked slot's hit is kept as the nearest and the walk goes on,
// so that the caller can alpha-test it and re-trace past it), or after
// max_steps steps. Which node a ray reads at step n is the JAX walk's.
//
// What bounds it on this card: at the bench's call sites (2,088,960 rays over
// the 262,143-node BVH of the bench scene) the least time is set by
// operations, ~25 per step and ~55 per triangle test, each counted where the
// walk makes it (chip_smoke.py, traverse_bound); the rows a trace reads are a
// part of the BVH, so bytes bound it below that. A walk pays instead the
// instructions it issues beyond those operations (the select-based NaN-
// propagating min/max cost a third of the time at the coherent sites), the
// latency of dependent reads (each step's address comes from the last step),
// the lanes of a warp that have no ray to walk, and, where a warp's rays go
// different ways, reads of rows that its other rays do not share. The design:
//
// - An aligned split layout (ops/rt/traverse.py::kernel_layout, exact copies
//   of node_rows' words): a 32-byte header per node (box, miss, first: one
//   sector, two 16-byte loads), a 128-byte lookahead line per node (target ids
//   and their boxes coordinate-major: 7 16-byte loads, read at an inner node
//   whose box was hit), and slot-indexed leaf data (a leaf owns slots first ..
//   first + 3: 48 bytes each of v0, e1, e2 with the leaf's count and the slot's
//   opaque flag in the spare words, and 32 bytes of alpha words, read one word
//   per bitmap lookup). A slot past the leaf's count is not tested (its test
//   could not pass).
// - Persistent warps (Aila & Laine, "Understanding the Efficiency of Ray
//   Traversal on GPUs", HPG 2009): about as many blocks as the card keeps
//   resident; each warp claims the next 32 consecutive ray indices from a
//   global counter (cleared by the launch), writes the inactive ones' misses
//   and hands the active ones to its idle lanes, lowest to lowest. Consecutive
//   indices keep neighbouring pixels' rays in one warp. How a warp refills is
//   the caller's choice (scattered), because it depends on how the rays
//   scatter: coherent rays (shadow rays from the camera's pixels, primary
//   rays) walk the same nodes in step, and a lane refilled while the others
//   walk would walk out of step and cost more than its idle time, so a warp
//   takes a new batch only when all its lanes are idle; a scattered batch's
//   walks (AO, GI and probe rays, rays from scattered hit points) end far
//   apart, so a warp refills as soon as kRefillAt lanes are idle, with the
//   next active rays of as many batches as it takes. The grid's size is
//   asked of the runtime once per instantiation and device.
// - The slab test's NaN-propagating min/max are PTX's min.NaN / max.NaN, one
//   instruction each.
// - Counting (the work counts and the rows read, for the bound) is a template
//   parameter: the frames launch the instantiation that does not count.
//
// Rounding: JAX's arithmetic op for op, each product, sum and quotient rounded
// on its own (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, built with
// -fmad=false), 3-term dot products summed (x + y) + z, and min/max that
// propagate NaN as jnp.minimum / jnp.maximum do (fminf / fmaxf would drop it;
// min.NaN / max.NaN keep it).
// The plain version (trace_rays_reference) rounds the same way, so the two
// agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kLeaf = 4;
constexpr int kThreads = 128;
constexpr int kWarp = 32;
// Resident blocks per SM that __launch_bounds__ asks for (ptxas -v: the
// instantiations need at most 64 registers a thread at 8 blocks of 128).
constexpr int kMinBlocks = 8;
// Idle lanes at which a warp tracing scattered rays refills them
// (ops/rt/traverse.py::REFILL_AT).
constexpr int kRefillAt = 8;
constexpr int kWork = 6;  // work counts per ray (ops/rt/traverse.py::WORK_COUNTS)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFltMin = 1.17549435e-38f;  // 2^-126

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
            sub(mul(a.x, b.y), mul(a.y, b.x))};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
__device__ __forceinline__ float lane_of(float4 q, int k) {
  return k == 0 ? q.x : (k == 1 ? q.y : (k == 2 ? q.z : q.w));
}
__device__ __forceinline__ int word(float x) { return __float_as_int(x); }

// NaN-propagating min and max in one instruction each (PTX min.NaN/max.NaN,
// sm_80+). They may return another NaN payload, or another sign of zero on
// ties, than jnp.minimum / jnp.maximum: the slab test only compares their
// results, so its answer is the same.
__device__ __forceinline__ float min_nan_op(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan_op(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Slab test of the box [lo, hi]: true when hit.
__device__ __forceinline__ bool slab(V3 lo, V3 hi, V3 o, V3 inv, float t_lo, float t_hi) {
  const float t0x = mul(sub(lo.x, o.x), inv.x);
  const float t0y = mul(sub(lo.y, o.y), inv.y);
  const float t0z = mul(sub(lo.z, o.z), inv.z);
  const float t1x = mul(sub(hi.x, o.x), inv.x);
  const float t1y = mul(sub(hi.y, o.y), inv.y);
  const float t1z = mul(sub(hi.z, o.z), inv.z);
  const float tn = max_nan_op(max_nan_op(min_nan_op(t0x, t1x), min_nan_op(t0y, t1y)),
                              min_nan_op(t0z, t1z));
  const float tf = min_nan_op(min_nan_op(max_nan_op(t0x, t1x), max_nan_op(t0y, t1y)),
                              max_nan_op(t0z, t1z));
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
// The position of the (k + 1)-th set bit of mask (k < popc(mask)).
__device__ __forceinline__ int nth_set_bit(unsigned mask, int k) {
  for (int q = 0; q < k; ++q) mask &= mask - 1u;
  return __ffs(mask) - 1;
}

struct Params {
  const float4* header;     // (m, 8) words: 2 float4 per node
  const float4* lookahead;  // (m, 32) words: 8 float4 per node
  const float4* slots;      // (s, 12) words: 3 float4 per slot
  const int* alpha;         // (s, 8) words
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
  bool scattered;
  float* t;
  int* slot;
  float* u;
  float* v;
  int* steps;
  int* steps_max;
  bool* overflow;
  int* counter;
  int* work;
  uint8_t* touched;
};

// One lane's ray.
struct Ray {
  V3 o, d, inv;
  float t_lo, best_t, best_u, best_v;
  int best_slot;
  bool best_opq;  // the nearest hit's slot is opaque (masked any-hit)
  int id, idx, steps;
  // Work counts (the counting instantiation): the tests this walk makes.
  int leaves, inners, targets, target_slabs, lookups;
};

template <bool kCount>
__device__ __forceinline__ void write_miss(const Params& p, int i) {
  p.t[i] = p.tmax_ray ? p.tmax_ray[i] : p.tmax_all;
  p.slot[i] = -1;
  p.u[i] = 0.0f;
  p.v[i] = 0.0f;
  p.steps[i] = 0;
  if (kCount) {
    int* w = p.work + kWork * static_cast<size_t>(i);
#pragma unroll
    for (int k = 0; k < kWork; ++k) w[k] = 0;
  }
}

// A ray's state at its first step, from its (flushed) origin and direction
// and its bounds.
__device__ __forceinline__ void start(Ray& ray, int i, V3 o, V3 d, float t_lo, float t_hi) {
  ray.o = o;
  ray.d = d;
  ray.inv = V3{inv_component(d.x), inv_component(d.y), inv_component(d.z)};
  ray.t_lo = t_lo;
  ray.best_t = t_hi;
  ray.best_u = ray.best_v = 0.0f;
  ray.best_slot = -1;
  ray.best_opq = false;
  ray.id = i;
  ray.idx = 0;
  ray.steps = 0;
  ray.leaves = ray.inners = ray.targets = ray.target_slabs = ray.lookups = 0;
}

template <bool kCount>
__device__ __forceinline__ void finish(const Params& p, const Ray& ray) {
  const int i = ray.id;
  p.t[i] = ray.best_t;
  p.slot[i] = ray.best_slot;
  p.u[i] = ray.best_u;
  p.v[i] = ray.best_v;
  p.steps[i] = ray.steps;
  if (kCount) {
    int* w = p.work + kWork * static_cast<size_t>(i);
    w[0] = ray.steps;
    w[1] = ray.leaves;
    w[2] = ray.inners;
    w[3] = ray.targets;
    w[4] = ray.target_slabs;
    w[5] = ray.lookups;
  }
}

// One step of the walk at ray.idx (< m).
template <bool kAnyHit, bool kMasked, bool kBitmap, bool kCount>
__device__ __forceinline__ void step(const Params& p, Ray& ray) {
  ++ray.steps;
  if (kCount) p.touched[ray.idx] = 1;
  const float4* h = p.header + 2 * static_cast<size_t>(ray.idx);
  const float4 ha = __ldg(h), hb = __ldg(h + 1);  // min xyz, max x | max y, max z, miss, first
  const bool hit =
      slab(V3{ha.x, ha.y, ha.z}, V3{ha.w, hb.x, hb.y}, ray.o, ray.inv, ray.t_lo, ray.best_t);
  const int first = word(hb.w);
  int nxt = word(hb.z);
  if (hit) {
    if (first >= 0) {
      if (kCount) ++ray.leaves;
      const float4* s = p.slots + 3 * static_cast<size_t>(first);
      const int count = word(__ldg(s).w);
      int k_best = -1;
      float t_near = __int_as_float(0x7f800000);  // +inf
      float u_near = 0.0f, v_near = 0.0f;
      bool opq_near = false;
#pragma unroll
      for (int k = 0; k < kLeaf; ++k) {
        // The leaf's 4 slots are all there: the loads issue together, the
        // tests stop at the count (a slot past it cannot pass).
        const float4 a = __ldg(s + 3 * k), b = __ldg(s + 3 * k + 1), c = __ldg(s + 3 * k + 2);
        if (k >= count) continue;
        const V3 v0{a.x, a.y, a.z}, e1{b.x, b.y, b.z}, e2{c.x, c.y, c.z};
        const V3 pvec = cross(ray.d, e2);
        const float det = dot(e1, pvec);
        const float inv_det = __fdiv_rn(1.0f, fabsf(det) < 1e-12f ? 1e-12f : det);
        const V3 tvec = V3{sub(ray.o.x, v0.x), sub(ray.o.y, v0.y), sub(ray.o.z, v0.z)};
        const float u = mul(dot(tvec, pvec), inv_det);
        const V3 qvec = cross(tvec, e1);
        const float v = mul(dot(ray.d, qvec), inv_det);
        const float t = mul(dot(e2, qvec), inv_det);
        bool ok = (fabsf(det) > 1e-12f) && (u >= 0.0f) && (v >= 0.0f) && (add(u, v) <= 1.0f) &&
                  (t > ray.t_lo) && (t < ray.best_t);
        if (kBitmap && ok) {
          if (kCount) ++ray.lookups;
          // MT's u = lambda1, v = lambda2: the bake's (ui, vi) convention.
          const int ui = static_cast<int>(fminf(fmaxf(mul(u, 16.0f), 0.0f), 15.0f));
          const int vi = static_cast<int>(fminf(fmaxf(mul(v, 16.0f), 0.0f), 15.0f));
          const int bit = vi * 16 + ui;
          const int w = __ldg(p.alpha + 8 * (static_cast<size_t>(first) + k) + (bit >> 5));
          ok = ((w >> (bit & 31)) & 1) == 1;
        }
        // The nearest passing slot, the lowest k on ties.
        if (ok && t < t_near) {
          k_best = k;
          t_near = t;
          u_near = u;
          v_near = v;
          opq_near = b.w != 0.0f;
        }
      }
      if (k_best >= 0) {
        ray.best_slot = first + k_best;
        ray.best_t = t_near;
        ray.best_u = u_near;
        ray.best_v = v_near;
        if (kMasked) ray.best_opq = opq_near;
      }
    } else {
      if (kCount) ++ray.inners;
      const float4* l = p.lookahead + 8 * static_cast<size_t>(ray.idx);
      const float4 ids = __ldg(l), lx = __ldg(l + 1), ly = __ldg(l + 2), lz = __ldg(l + 3);
      const float4 hx = __ldg(l + 4), hy = __ldg(l + 5), hz = __ldg(l + 6);
      // Jump to the first lookahead target hit, in preorder; none => miss.
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (kCount) ++ray.targets;
        const int target = word(lane_of(ids, k));
        if (target < 0) continue;
        if (kCount) ++ray.target_slabs;
        if (slab(V3{lane_of(lx, k), lane_of(ly, k), lane_of(lz, k)},
                 V3{lane_of(hx, k), lane_of(hy, k), lane_of(hz, k)}, ray.o, ray.inv, ray.t_lo,
                 ray.best_t)) {
          nxt = target;
          break;
        }
      }
    }
  }
  ray.idx = (kAnyHit && ray.best_slot >= 0 && (!kMasked || ray.best_opq)) ? p.m : nxt;
}

template <bool kAnyHit, bool kMasked, bool kBitmap, bool kCount>
__global__ void __launch_bounds__(kThreads, kMinBlocks) traverse_kernel(const Params p) {
  const int lane = threadIdx.x & (kWarp - 1);
  const unsigned below = (1u << lane) - 1u;
  // The warp's batch, the same in every lane: rays batch .. batch + 31, and
  // `pending`, its active rays not yet handed out; whether rays are left to
  // claim.
  int batch = 0;
  unsigned pending = 0;
  bool open = true;
  // This lane's ray, and what it folds over every ray it carried.
  Ray ray;
  bool busy = false;
  int lane_max = 0;
  bool lane_over = false;

  // Claim the next 32 rays: write the inactive ones' misses, mark the active
  // ones pending.
  auto claim = [&]() {
    int base = 0;
    if (lane == 0) base = atomicAdd(p.counter, kWarp);
    base = __shfl_sync(kFull, base, 0);
    if (base >= p.r) {
      open = false;
      return;
    }
    batch = base;
    const int i = base + lane;
    const bool in = i < p.r;
    const bool act = in && (p.active == nullptr || p.active[i]);
    pending = __ballot_sync(kFull, act);
    if (in && !act) write_miss<kCount>(p, i);
  };

  for (;;) {
    unsigned idle = __ballot_sync(kFull, !busy);
    if (idle == kFull || (p.scattered && __popc(idle) >= kRefillAt)) {
      while (idle != 0) {
        if (pending == 0) {
          if (!open) break;
          claim();
          continue;
        }
        // Hand the pending rays to the idle lanes, lowest to lowest.
        const int n_idle = __popc(idle), n_pending = __popc(pending);
        const int k = __popc(idle & below);
        if (!busy && k < n_pending) {
          const int i = batch + nth_set_bit(pending, k);
          start(ray, i, load_ray(p.origins + 3 * static_cast<size_t>(i)),
                load_ray(p.dirs + 3 * static_cast<size_t>(i)),
                p.tmin_ray ? p.tmin_ray[i] : p.tmin_all, p.tmax_ray ? p.tmax_ray[i] : p.tmax_all);
          busy = true;
        }
        pending = (n_pending <= n_idle) ? 0u
                                        : pending & ~((1u << nth_set_bit(pending, n_idle)) - 1u);
        if (!p.scattered) break;  // coherent rays: one batch at a time
        idle = __ballot_sync(kFull, !busy);
      }
    }
    if (!__any_sync(kFull, busy)) break;
    if (busy) {
      if (ray.steps < p.max_steps) step<kAnyHit, kMasked, kBitmap, kCount>(p, ray);
      if (ray.idx >= p.m || ray.steps >= p.max_steps) {
        finish<kCount>(p, ray);
        lane_max = max(lane_max, ray.steps);
        lane_over = lane_over || ray.idx < p.m;
        busy = false;
      }
    }
  }
  const int warp_max = __reduce_max_sync(kFull, lane_max);
  const unsigned stopped = __ballot_sync(kFull, lane_over);
  if (lane == 0) {
    if (warp_max > 0) atomicMax(p.steps_max, warp_max);
    if (stopped) *p.overflow = true;
  }
}

using Kernel = void (*)(Params);

// The instantiations: closest-hit, any-hit, masked any-hit; without and with
// the bitmap test; the frame's and the counting one.
constexpr int kKernels = 12;
int kernel_index(int any_hit, int masked_any_hit, int bitmap, int counts) {
  const int mode = any_hit ? (masked_any_hit ? 2 : 1) : 0;
  return (mode * 2 + (bitmap ? 1 : 0)) * 2 + (counts ? 1 : 0);
}

template <bool kAnyHit, bool kMasked>
Kernel pick_bitmap(int bitmap, int counts) {
  if (bitmap) {
    return counts ? traverse_kernel<kAnyHit, kMasked, true, true>
                  : traverse_kernel<kAnyHit, kMasked, true, false>;
  }
  return counts ? traverse_kernel<kAnyHit, kMasked, false, true>
                : traverse_kernel<kAnyHit, kMasked, false, false>;
}

Kernel pick(int any_hit, int masked_any_hit, int bitmap, int counts) {
  if (any_hit && masked_any_hit) return pick_bitmap<true, true>(bitmap, counts);
  if (any_hit) return pick_bitmap<true, false>(bitmap, counts);
  return pick_bitmap<false, false>(bitmap, counts);
}

// Resident blocks per SM of `kernel`, and the current device's SM count.
cudaError_t residency(Kernel kernel, int* blocks_per_sm, int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, reinterpret_cast<const void*>(kernel), kThreads, 0);
  }
  return err;
}

// The blocks the card keeps resident of `kernel`, instantiation `which`
// (kernel_index), on the current device (resident blocks per SM x SMs), asked
// of the runtime once per instantiation and device: the answer does not change.
constexpr int kMaxDevices = 64;
std::atomic<int> g_resident[kMaxDevices][kKernels];

cudaError_t resident_blocks(Kernel kernel, int which, int* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kMaxDevices;
  if (cached && (*blocks = g_resident[device][which].load(std::memory_order_relaxed)) > 0) {
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = residency(kernel, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  *blocks = max(1, per_sm * sms);
  if (cached) g_resident[device][which].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Trace r rays through the m-node BVH (its kernel layout: header, lookahead,
// slot block, slot alpha) on `stream`: t, slot, u, v and each ray's step count
// per ray; the longest walk into steps_max[0] and whether the cap stopped a ray
// into overflow[0]; counter[0] is the warps' claim counter (all three cleared
// here first). tmin_ray / tmax_ray may be null (the scalar applies), active may
// be null (all rays). With work ((r, 6) i32: steps, leaf visits, inner visits,
// lookahead targets examined, lookahead slab tests, bitmap lookups) and touched
// ((m,) u8, zeroed by the caller) the counting instantiation runs; both are
// null on the frame path. masked_any_hit applies with any_hit only: a ray then
// parks on its nearest hit only when that hit's slot is opaque. With scattered
// a warp refills its idle lanes once kRefillAt of them are idle, else it takes
// a new batch only when all are idle. Returns the first CUDA error, or 0.
int traverse_launch(const float* header, const float* lookahead, const float* slots,
                    const int* alpha, int m, const float* origins, const float* dirs, int r,
                    const float* tmin_ray, float tmin_all, const float* tmax_ray, float tmax_all,
                    const uint8_t* active, int any_hit, int masked_any_hit, int bitmap,
                    int max_steps, int scattered, float* t, int* slot, float* u, float* v,
                    int* steps, int* steps_max, bool* overflow, int* counter, int* work,
                    uint8_t* touched, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(steps_max, 0, sizeof(int), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(overflow, 0, sizeof(bool), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (r > 0) {
    const int counts = work != nullptr;
    const Kernel kernel = pick(any_hit, masked_any_hit, bitmap, counts);
    int resident = 0;
    err = resident_blocks(kernel, kernel_index(any_hit, masked_any_hit, bitmap, counts),
                          &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = min((r + kThreads - 1) / kThreads, resident);
    Params p{reinterpret_cast<const float4*>(header), reinterpret_cast<const float4*>(lookahead),
             reinterpret_cast<const float4*>(slots), alpha, m, origins, dirs, r, tmin_ray,
             tmin_all, tmax_ray, tmax_all, active, max_steps, scattered != 0, t,
             slot, u, v, steps, steps_max, overflow, counter, work, touched};
    void* args[] = {&p};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(kThreads),
                           args, 0, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The registers per thread and resident blocks per SM of the instantiation
// that traverse_launch picks for these switches, and the device's SM count.
int traverse_occupancy(int any_hit, int masked_any_hit, int bitmap, int counts, int* registers,
                       int* blocks_per_sm, int* sms) {
  const Kernel kernel = pick(any_hit, masked_any_hit, bitmap, counts);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  if (err == cudaSuccess) {
    *registers = attr.numRegs;
    err = residency(kernel, blocks_per_sm, sms);
  }
  return static_cast<int>(err);
}

}  // extern "C"
