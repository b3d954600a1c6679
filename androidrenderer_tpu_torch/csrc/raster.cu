// Hopper rasterizer for the port's raster records (ops/raster/setup.py::pack_fused_records).
//
// Replaces the TPU kernel androidrenderer_tpu/ops/raster/raster_bitmask.py
// (_bitmask_kernel, reached through rasterize_bitmask): depth + visibility of a
// triangle set with reversed-Z, ties to the higher triangle id, and the
// depth_only / affine_z / z_limit / alpha_grid variants. It ports that kernel's
// contract, not its schedule: the window bitmasks, ctz scans, slabs and chunks
// existed to feed the TPU's scalar core and have no counterpart here. The same
// contract is computed by three more TPU schedules, which this kernel replaces
// too, each through its own entry point: raster_binned.py (_binned_kernel),
// raster_fused.py (_fused_kernel) and raster_pallas.py (_raster_kernel).
//
// Band mode: the target holds rows [row_off, row_off + height) of a taller
// frame; records stay in full-frame pixel space, every bbox clips to the band,
// and a fragment at frame row y writes target row y - row_off, so a band is
// bit-equal to those rows of the full raster.
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
// order, so any split of the work gives the same bits. A resolve pass unpacks
// depth and vis (vis = -1 where the key is 0). depth_only uses a 32-bit
// atomicMax on the float bits.
//
// What bounds it on this card: bytes at the 1088x1920 calls (the 16.7 MB key
// buffer cleared, combined into and resolved, the records read once), and the
// atomics on pixels that many triangles cover. The work a call needs is its
// covered pixels; what a naive schedule pays instead is one block per record
// (most of them dead) and a walk of every bbox pixel (86 walked per covered on a
// 1024^2 cascade of long thin triangles). The design, in four passes on the
// caller's stream, with no host synchronisation:
//   1. prep: one thread per record clears the target (16-byte stores) and
//      appends each live record (sid != 0, non-empty clipped bbox) to a work
//      list, with one atomic per list per block of 1024 records (the warps'
//      ballots scanned in shared memory): to the small list when its bbox
//      fits one 32-row x 128-column tile, else to the large list with its
//      tile count. A dead record costs one thread.
//   2. scan: one block takes an exclusive prefix sum of the large records'
//      tile counts, so that tile u of the large set maps to its record by a
//      search of the whole warp (32 probes a round). All counts stay in
//      device memory.
//   3. raster: a persistent grid (4 blocks of 8 warps per SM) walks the work
//      units, one warp per unit: a small record, or one tile of a large one,
//      so a full-screen box spreads over hundreds of warps. Lane k takes row k
//      of the unit and intersects the three edges' half-lines
//      x <= or >= -(B*y + C) / A, widened by a rounding margin, for the front
//      span (all d <= 0) and, for double-sided records, the back span (all
//      d >= 0); a warp scan of the spans' lengths lets the 32 lanes walk the
//      unit's span pixels together. Only span pixels are evaluated, with the
//      unchanged rounded test. A plain read of the current key skips the
//      atomic when the fragment cannot win; each lane evaluates two pixels
//      before it reads their keys, so the two reads are in flight together.
//   4. resolve (depth + vis only).
// Measured on an H100 (PERF.md), the passes around the raster cost ~30 us at
// 1088x1920 and the raster pass is bound by issue and latency: the per-pixel
// test with its divisions, and each unit's prologue (record, spans, scan), not
// bytes or atomics.
//
// Span exactness: the per-pixel test rounds three times, so a pixel it accepts
// may lie off the exact half-line by up to ~2u(|A x| + |B y|), and the computed
// crossing -(B*y + C) * inv_A is off by up to ~4u(|B y| + |C|) / |A| (u = 2^-24).
// Each bound is widened by 1 pixel + 2^-19 * (max |x| + (|B y| + |C|) / |A|),
// more than 5x what these need, so no accepted pixel falls outside its span. An
// edge with |A| < 1e-12 (where the record's inv_A is pack_fused_records' stand-in)
// bounds nothing, and a NaN bound (an overflowed coefficient) bounds nothing.
// ops/raster/raster.py::rasterize_spans is the plain PyTorch mirror of the
// work split and the spans.
//
// Floating point: every edge, z and barycentric term is __fmul_rn/__fadd_rn/
// __fdiv_rn (and the file is built with -fmad=false), so no a*b+c contracts to
// an FMA and the kernel matches the plain PyTorch version
// (ops/raster/raster.py::rasterize_reference) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kRec = 24;
constexpr int kTileRows = 32;  // rows of a work unit: one lane per row
constexpr int kTileCols = 128;  // columns of a work unit
constexpr int kPrepThreads = 1024;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 16;
constexpr int kRasterThreads = 256;
constexpr int kRasterWarps = kRasterThreads / 32;
constexpr int kRasterBlocksPerSM = 4;
constexpr int kPerLane = 2;  // pixels a lane evaluates before it reads their keys
constexpr float kMinA = 1e-12f;
constexpr float kSpanRel = 1.9073486328125e-06f;  // 2^-19
constexpr unsigned kFull = 0xffffffffu;

// The counters (u64) the wrapper passes in ``counts``.
enum Count { kSmall = 0, kLarge, kLargeUnits, kEvaluated, kBboxPixels, kNumCounts = 8 };

struct Box {
  int x0, y0, x1, y1;
};

// The record's bbox clipped to the target's rows [row_off, row_off + height)
// of the frame; false for a dead record or an empty clipped bbox
// (ops/raster/raster.py::record_bboxes).
__device__ __forceinline__ bool live_box(float sid, float x0, float y0, float x1, float y1,
                                         int row_off, int height, int width, Box& b) {
  b.x0 = max(0, static_cast<int>(floorf(x0)));
  b.y0 = max(row_off, static_cast<int>(floorf(y0)));
  b.x1 = min(width - 1, static_cast<int>(ceilf(x1)));
  b.y1 = min(row_off + height - 1, static_cast<int>(ceilf(y1)));
  return sid != 0.0f && b.x1 >= b.x0 && b.y1 >= b.y0;
}

__device__ __forceinline__ float plane(float a, float x, float b, float y, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// Slots of this thread in the small and the large list (-1 where it appends
// nothing), with one atomic per list per block: the warps' ballots are scanned
// in shared memory. The whole block must call it.
__device__ __forceinline__ int2 block_append(bool small, bool large,
                                             unsigned long long* __restrict__ counts) {
  __shared__ int warp_base[2][kPrepThreads / 32];
  __shared__ int block_base[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ms = __ballot_sync(kFull, small), ml = __ballot_sync(kFull, large);
  if (lane == 0) {
    warp_base[0][warp] = __popc(ms);
    warp_base[1][warp] = __popc(ml);
  }
  __syncthreads();
  if (warp == 0) {
    const int a = lane < kPrepThreads / 32 ? warp_base[0][lane] : 0;
    const int b = lane < kPrepThreads / 32 ? warp_base[1][lane] : 0;
    int ia = a, ib = b;
    for (int d = 1; d < 32; d <<= 1) {
      const int ya = __shfl_up_sync(kFull, ia, d), yb = __shfl_up_sync(kFull, ib, d);
      if (lane >= d) {
        ia += ya;
        ib += yb;
      }
    }
    if (lane < kPrepThreads / 32) {
      warp_base[0][lane] = ia - a;
      warp_base[1][lane] = ib - b;
    }
    if (lane == 31) {
      block_base[0] = ia ? static_cast<int>(atomicAdd(counts + kSmall, static_cast<unsigned long long>(ia))) : 0;
      block_base[1] = ib ? static_cast<int>(atomicAdd(counts + kLarge, static_cast<unsigned long long>(ib))) : 0;
    }
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  return make_int2(small ? block_base[0] + warp_base[0][warp] + __popc(ms & below) : -1,
                   large ? block_base[1] + warp_base[1][warp] + __popc(ml & below) : -1);
}

__global__ void __launch_bounds__(kPrepThreads) prep_kernel(
    const float* __restrict__ recs, int n, int row_off, int height, int width,
    uint4* __restrict__ clear,
    long long clear_vec, unsigned int* __restrict__ clear_tail, int tail_words,
    int* __restrict__ small_ids, int* __restrict__ large_ids, int* __restrict__ large_units,
    unsigned long long* __restrict__ counts) {
  __shared__ unsigned long long warp_area[kPrepThreads / 32];
  const long long i = static_cast<long long>(blockIdx.x) * kPrepThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  if (i < clear_vec) clear[i] = make_uint4(0u, 0u, 0u, 0u);
  if (i < tail_words) clear_tail[i] = 0u;
  if (static_cast<long long>(blockIdx.x) * kPrepThreads >= n) return;  // the whole block

  bool small = false, large = false;
  int units = 0;
  unsigned long long area = 0;
  if (i < n) {
    const float* r = recs + i * kRec;
    Box b;
    if (live_box(r[18], r[19], r[20], r[21], r[22], row_off, height, width, b)) {
      const int bw = b.x1 - b.x0 + 1, bh = b.y1 - b.y0 + 1;
      units = ((bw + kTileCols - 1) / kTileCols) * ((bh + kTileRows - 1) / kTileRows);
      area = static_cast<unsigned long long>(bw) * static_cast<unsigned long long>(bh);
      small = units == 1;
      large = !small;
    }
  }
  const int2 slot = block_append(small, large, counts);
  if (small) small_ids[slot.x] = static_cast<int>(i);
  if (large) {
    large_ids[slot.y] = static_cast<int>(i);
    large_units[slot.y] = units;
  }
  // Bbox pixels, for the work counts: one atomic per block.
  for (int d = 16; d > 0; d >>= 1) area += __shfl_down_sync(kFull, area, d);
  if (lane == 0) warp_area[threadIdx.x >> 5] = area;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < kPrepThreads / 32; ++w) sum += warp_area[w];
    if (sum) atomicAdd(counts + kBboxPixels, sum);
  }
}

// Exclusive prefix sum of the large records' tile counts into ``offs``, and
// their total into counts[kLargeUnits]: one block, each thread loading
// kScanItems consecutive counts at once, so a pass covers 16,384 records.
__global__ void __launch_bounds__(kScanThreads) scan_kernel(
    const int* __restrict__ large_units, unsigned long long* __restrict__ offs,
    unsigned long long* __restrict__ counts) {
  __shared__ unsigned long long warp_sum[kScanThreads / 32];
  __shared__ unsigned long long carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long m = static_cast<long long>(counts[kLarge]);
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < m; base += static_cast<long long>(kScanThreads) * kScanItems) {
    const long long k0 = base + static_cast<long long>(threadIdx.x) * kScanItems;
    int v[kScanItems];
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) v[q] = k0 + q < m ? large_units[k0 + q] : 0;
    unsigned long long own = 0;
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) own += static_cast<unsigned long long>(v[q]);
    unsigned long long x = own;
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      unsigned long long t = warp_sum[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned long long y = __shfl_up_sync(kFull, t, d);
        if (lane >= d) t += y;
      }
      warp_sum[lane] = t;
    }
    __syncthreads();
    const unsigned long long incl = carry + (warp > 0 ? warp_sum[warp - 1] : 0ull) + x;
    unsigned long long run = incl - own;
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      if (k0 + q < m) offs[k0 + q] = run;
      run += static_cast<unsigned long long>(v[q]);
    }
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[kLargeUnits] = carry;
}

// One edge's bound on the front span [lo_f, hi_f] (all d <= 0) and the back
// span [lo_b, hi_b] (all d >= 0) of row fy, widened by the rounding margin.
// fminf/fmaxf drop a NaN bound, so an overflowed edge bounds nothing.
__device__ __forceinline__ void edge_bounds(float a, float b, float c, float inv_a, float fy,
                                            float xmag, float& lo_f, float& hi_f, float& lo_b,
                                            float& hi_b) {
  if (!(fabsf(a) >= kMinA)) return;
  const float by = __fmul_rn(b, fy);
  const float xe = __fmul_rn(-__fadd_rn(by, c), inv_a);
  const float m = __fmul_rn(__fadd_rn(fabsf(by), fabsf(c)), fabsf(inv_a));
  const float margin = __fadd_rn(1.0f, __fmul_rn(kSpanRel, __fadd_rn(xmag, m)));
  const float up = __fadd_rn(xe, margin), down = __fadd_rn(xe, -margin);
  if (a > 0.0f) {
    hi_f = fminf(hi_f, up);
    lo_b = fmaxf(lo_b, down);
  } else {
    lo_f = fmaxf(lo_f, down);
    hi_b = fminf(hi_b, up);
  }
}

// First pixel and length of the span [lo, hi] within [cx0, cx1].
__device__ __forceinline__ void span_pixels(float lo, float hi, int cx0, int cx1, int& x, int& len) {
  lo = fminf(lo, static_cast<float>(cx1 + 1));
  hi = fmaxf(hi, static_cast<float>(cx0 - 1));
  x = static_cast<int>(ceilf(lo));
  len = max(0, static_cast<int>(floorf(hi)) - x + 1);
}

struct Tri {
  float a0, b0, c0, a1, b1, c1, a2, b2, c2, qa, qb, qc, ra, rb, rc;
  bool two_sided;
};

// The contract at one pixel of triangle t: true when the fragment is accepted,
// with its combine key (bits(z) << 32 | t, or bits(z) with kDepthOnly) and
// target pixel (frame row py is target row py - row_off).
// ``words`` is the triangle's 256-bit alpha bitmap (kAlpha).
template <bool kDepthOnly, bool kAffineZ, bool kZLimit, bool kAlpha>
__device__ __forceinline__ bool fragment(const Tri& T, int t, int px, int py, int row_off,
                                         int width,
                                         const float* __restrict__ zlim,
                                         const unsigned int* words,
                                         unsigned long long& key, size_t& pix) {
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const float d0 = plane(T.a0, fx, T.b0, fy, T.c0);
  const float d1 = plane(T.a1, fx, T.b1, fy, T.c1);
  const float d2 = plane(T.a2, fx, T.b2, fy, T.c2);
  const bool front = d0 <= 0.0f && d1 <= 0.0f && d2 <= 0.0f;
  const bool back = T.two_sided && d0 >= 0.0f && d1 >= 0.0f && d2 >= 0.0f;
  if (!(front || back)) return false;
  float z;
  if (kAffineZ) {
    z = plane(T.qa, fx, T.qb, fy, T.qc);
  } else {
    z = __fdiv_rn(plane(T.ra, fx, T.rb, fy, T.rc), plane(T.qa, fx, T.qb, fy, T.qc));
  }
  if (!(z > 0.0f && z <= 1.0f)) return false;
  pix = static_cast<size_t>(py - row_off) * width + px;
  if (kZLimit && !(z < zlim[pix])) return false;
  if (kAlpha) {
    const float sv = __fadd_rn(__fadd_rn(d0, d1), d2);
    const float inv = __fdiv_rn(1.0f, sv == 0.0f ? 1.0f : sv);
    // fmaxf maps NaN to the bound, as the plain version's nan_to_num does.
    const int ui = static_cast<int>(fminf(fmaxf(__fmul_rn(__fmul_rn(d1, inv), 16.0f), 0.0f), 15.0f));
    const int vi = static_cast<int>(fminf(fmaxf(__fmul_rn(__fmul_rn(d2, inv), 16.0f), 0.0f), 15.0f));
    const int idx = vi * 16 + ui;
    if (((words[idx >> 5] >> (idx & 31)) & 1u) == 0u) return false;
  }
  const unsigned int zb = __float_as_uint(z);
  key = kDepthOnly ? zb : (static_cast<unsigned long long>(zb) << 32) | static_cast<unsigned int>(t);
  return true;
}

// The last k in [0, n) with offs[k] <= v (offs[0] = 0 <= v), found by the whole
// warp in rounds of 32 probes: ceil(log32 n) dependent loads.
__device__ __forceinline__ int warp_search(const unsigned long long* __restrict__ offs, int n,
                                           unsigned long long v, int lane) {
  int lo = 0, len = n;
  while (len > 1) {
    const int step = (len + 31) / 32;
    const int probe = lo + lane * step;
    const bool ok = lane * step < len && offs[probe] <= v;
    const int last = 31 - __clz(__ballot_sync(kFull, ok));
    lo += last * step;
    len = min(step, len - last * step);
  }
  return lo;
}

template <bool kDepthOnly, bool kAffineZ, bool kZLimit, bool kAlpha>
__global__ void __launch_bounds__(kRasterThreads, kRasterBlocksPerSM) raster_kernel(
    const float* __restrict__ recs, int row_off, int height, int width,
    const float* __restrict__ zlim,
    const int* __restrict__ alpha, const int* __restrict__ small_ids,
    const int* __restrict__ large_ids, const unsigned long long* __restrict__ offs,
    unsigned long long* counts, unsigned long long* __restrict__ keys,
    unsigned int* __restrict__ depth_bits) {
  // Per warp, per row of its unit: end of the row's pixels in the unit's walk
  // (inclusive prefix), and the row's front and back spans.
  __shared__ int s_end[kRasterWarps][32];
  __shared__ int s_fx[kRasterWarps][32];
  __shared__ int s_fn[kRasterWarps][32];
  __shared__ int s_bx[kRasterWarps][32];
  __shared__ unsigned int s_alpha[kRasterWarps][8];  // the unit's alpha bitmap
  __shared__ unsigned long long s_eval[kRasterWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n_small = static_cast<long long>(counts[kSmall]);
  const int n_large = static_cast<int>(counts[kLarge]);
  const long long total = n_small + static_cast<long long>(counts[kLargeUnits]);
  const long long stride = static_cast<long long>(gridDim.x) * kRasterWarps;
  unsigned long long evaluated = 0;

  const long long u0 = static_cast<long long>(blockIdx.x) * kRasterWarps + warp;
  int next_small = u0 < n_small ? small_ids[u0] : 0;  // read one unit ahead
  for (long long u = u0; u < total; u += stride) {
    int t, j = 0;
    if (u < n_small) {
      t = next_small;
      if (u + stride < n_small) next_small = small_ids[u + stride];
    } else {
      // The large record whose tiles hold unit u, and which of its tiles.
      const unsigned long long v = static_cast<unsigned long long>(u - n_small);
      const int k = warp_search(offs, n_large, v, lane);
      t = large_ids[k];
      j = static_cast<int>(v - offs[k]);
    }
    const float* r = recs + static_cast<size_t>(t) * kRec;
    const float4 r0 = __ldg(reinterpret_cast<const float4*>(r));
    const float4 r1 = __ldg(reinterpret_cast<const float4*>(r) + 1);
    const float4 r2 = __ldg(reinterpret_cast<const float4*>(r) + 2);
    const float4 r3 = __ldg(reinterpret_cast<const float4*>(r) + 3);
    const float4 r4 = __ldg(reinterpret_cast<const float4*>(r) + 4);
    const float4 r5 = __ldg(reinterpret_cast<const float4*>(r) + 5);
    // Lanes 0-7 fetch the alpha bitmap while the spans are computed.
    const unsigned int alpha_word =
        kAlpha && lane < 8 ? static_cast<unsigned int>(alpha[static_cast<size_t>(t) * 8 + lane]) : 0u;
    Box b;
    live_box(r4.z, r4.w, r5.x, r5.y, r5.z, row_off, height, width, b);  // live by construction
    const int tiles_x = (b.x1 - b.x0 + kTileCols) / kTileCols;
    const int ty = j ? j / tiles_x : 0;
    const int tx = j - ty * tiles_x;
    const int cx0 = b.x0 + tx * kTileCols, cx1 = min(b.x1, cx0 + kTileCols - 1);
    const int ry0 = b.y0 + ty * kTileRows, ry1 = min(b.y1, ry0 + kTileRows - 1);
    const Tri T{r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x,
                r3.x, r3.y, r3.z, r3.w, r4.x, r4.y, r4.z < 0.0f};

    // Lane k: the spans of row ry0 + k.
    int fx = 0, fn = 0, bx = 0, bn = 0;
    const int py = ry0 + lane;
    if (py <= ry1) {
      const float fy = static_cast<float>(py);
      const float xmag = static_cast<float>(cx1);
      float lo_f = static_cast<float>(cx0), hi_f = static_cast<float>(cx1);
      float lo_b = lo_f, hi_b = hi_f;
      edge_bounds(T.a0, T.b0, T.c0, r2.y, fy, xmag, lo_f, hi_f, lo_b, hi_b);
      edge_bounds(T.a1, T.b1, T.c1, r2.z, fy, xmag, lo_f, hi_f, lo_b, hi_b);
      edge_bounds(T.a2, T.b2, T.c2, r2.w, fy, xmag, lo_f, hi_f, lo_b, hi_b);
      span_pixels(lo_f, hi_f, cx0, cx1, fx, fn);
      if (T.two_sided) {
        span_pixels(lo_b, hi_b, cx0, cx1, bx, bn);
        // Overlapping or touching spans walk as one.
        if (fn > 0 && bn > 0 && bx <= fx + fn && fx <= bx + bn) {
          const int x_end = max(fx + fn, bx + bn);
          fx = min(fx, bx);
          fn = x_end - fx;
          bn = 0;
        }
      }
    }
    int end = fn + bn;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, end, d);
      if (lane >= d) end += y;
    }
    s_end[warp][lane] = end;
    s_fx[warp][lane] = fx;
    s_fn[warp][lane] = fn;
    s_bx[warp][lane] = bx;
    if (kAlpha && lane < 8) s_alpha[warp][lane] = alpha_word;
    __syncwarp();
    const int npx = __shfl_sync(kFull, end, 31);
    evaluated += static_cast<unsigned long long>(npx);
    // Each lane takes kPerLane pixels at a time, so that their key reads are
    // in flight together.
    for (int i0 = lane; i0 < npx; i0 += 32 * kPerLane) {
      unsigned long long key[kPerLane];
      size_t pix[kPerLane];
      bool ok[kPerLane];
#pragma unroll
      for (int p = 0; p < kPerLane; ++p) {
        const int i = i0 + 32 * p;
        ok[p] = false;
        if (i < npx) {
          // The row holding pixel i: how many rows end at or before it.
          int row = 0;
#pragma unroll
          for (int step = 16; step > 0; step >>= 1) {
            if (s_end[warp][row + step - 1] <= i) row += step;
          }
          const int k = i - (row > 0 ? s_end[warp][row - 1] : 0);
          const int rfn = s_fn[warp][row];
          const int px = k < rfn ? s_fx[warp][row] + k : s_bx[warp][row] + (k - rfn);
          ok[p] = fragment<kDepthOnly, kAffineZ, kZLimit, kAlpha>(T, t, px, ry0 + row, row_off,
                                                                 width, zlim, s_alpha[warp],
                                                                 key[p], pix[p]);
        }
      }
      unsigned long long cur[kPerLane];
#pragma unroll
      for (int p = 0; p < kPerLane; ++p) {
        if (ok[p]) cur[p] = kDepthOnly ? __ldcg(depth_bits + pix[p]) : __ldcg(keys + pix[p]);
      }
#pragma unroll
      for (int p = 0; p < kPerLane; ++p) {
        if (ok[p] && key[p] > cur[p]) {
          if (kDepthOnly) {
            atomicMax(depth_bits + pix[p], static_cast<unsigned int>(key[p]));
          } else {
            atomicMax(keys + pix[p], key[p]);
          }
        }
      }
    }
    __syncwarp();
  }

  if (lane == 0) s_eval[warp] = evaluated;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < kRasterWarps; ++w) sum += s_eval[w];
    if (sum) atomicAdd(counts + kEvaluated, sum);
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

struct RasterArgs {
  const float* recs;
  int row_off, height, width;
  const float* zlim;
  const int* alpha;
  const int* small_ids;
  const int* large_ids;
  const unsigned long long* offs;
  unsigned long long* counts;
  unsigned long long* keys;
  unsigned int* depth_bits;
};

template <bool kDepthOnly, bool kAffineZ>
void launch_raster(bool has_zlim, bool has_alpha, int blocks, cudaStream_t s, const RasterArgs& a) {
#define RASTER_LAUNCH(ZL, AL)                                                                  \
  raster_kernel<kDepthOnly, kAffineZ, ZL, AL><<<blocks, kRasterThreads, 0, s>>>(              \
      a.recs, a.row_off, a.height, a.width, a.zlim, a.alpha, a.small_ids, a.large_ids, a.offs, a.counts, \
      a.keys, a.depth_bits)
  if (has_zlim && has_alpha) {
    RASTER_LAUNCH(true, true);
  } else if (has_zlim) {
    RASTER_LAUNCH(true, false);
  } else if (has_alpha) {
    RASTER_LAUNCH(false, true);
  } else {
    RASTER_LAUNCH(false, false);
  }
#undef RASTER_LAUNCH
}

// Streaming multiprocessors of the current device (queried once per device).
int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms <= 0) {
    sms = 132;
  }
  if (dev >= 0 && dev < 64) cached[dev] = sms;
  return sms;
}

}  // namespace

// Rasterize ``n`` records (n, 24) f32 into a height x width target on ``stream``:
// rows [row_off, row_off + height) of the frame the records were set up for.
// zlim (height*width f32) and alpha (n*8 i32) may be null. depth_only writes
// ``depth`` only; otherwise ``keys`` (height*width u64 scratch) is combined into
// and resolved into ``depth`` and ``vis``. ``work`` is 5*n i32 of scratch (the
// large records' tile offsets as n u64, then the small list, the large list and
// the large records' tile counts); ``counts`` is 8 u64 of scratch that ends
// holding the work counts: small records, large records, their tiles, pixels
// evaluated, bbox pixels of the live records. Allocates nothing and never
// synchronises; returns the first CUDA error (0 on success).
extern "C" int raster_launch(const float* recs, int n, int height, int width,
                             const float* zlim, const int* alpha, int depth_only,
                             int affine_z, void* keys, float* depth, int* vis, int* work,
                             void* counts, void* stream, int row_off) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* cnt = static_cast<unsigned long long*>(counts);
  const long long npix = static_cast<long long>(height) * width;
  cudaError_t err = cudaMemsetAsync(cnt, 0, kNumCounts * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);

  auto* offs = reinterpret_cast<unsigned long long*>(work);
  int* small_ids = work + 2LL * n;
  int* large_ids = work + 3LL * n;
  int* large_units = work + 4LL * n;
  void* target = depth_only ? static_cast<void*>(depth) : keys;
  const long long words = npix * (depth_only ? 1 : 2);
  const long long clear_vec = words / 4;
  const int tail = static_cast<int>(words % 4);
  const long long threads = clear_vec > n ? clear_vec : static_cast<long long>(n);
  if (threads > 0) {
    const long long blocks = (threads + kPrepThreads - 1) / kPrepThreads;
    prep_kernel<<<static_cast<unsigned int>(blocks), kPrepThreads, 0, s>>>(
        recs, n, row_off, height, width, static_cast<uint4*>(target), clear_vec,
        static_cast<unsigned int*>(target) + clear_vec * 4, tail, small_ids, large_ids,
        large_units, cnt);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (n > 0) {
    scan_kernel<<<1, kScanThreads, 0, s>>>(large_units, offs, cnt);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const RasterArgs a{recs, row_off, height, width, zlim, alpha, small_ids, large_ids, offs, cnt,
                       static_cast<unsigned long long*>(keys), reinterpret_cast<unsigned int*>(depth)};
    const int blocks = sm_count() * kRasterBlocksPerSM;
    const bool hz = zlim != nullptr, ha = alpha != nullptr;
    if (depth_only && affine_z) {
      launch_raster<true, true>(hz, ha, blocks, s, a);
    } else if (depth_only) {
      launch_raster<true, false>(hz, ha, blocks, s, a);
    } else if (affine_z) {
      launch_raster<false, true>(hz, ha, blocks, s, a);
    } else {
      launch_raster<false, false>(hz, ha, blocks, s, a);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (!depth_only && npix > 0) {
    const int threads_r = 256;
    const long long blocks = (npix + threads_r - 1) / threads_r;
    resolve_kernel<<<static_cast<unsigned int>(blocks), threads_r, 0, s>>>(
        static_cast<const unsigned long long*>(keys), static_cast<int>(npix), depth, vis);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
