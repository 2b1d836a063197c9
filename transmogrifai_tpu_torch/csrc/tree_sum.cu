// The per-row tree sum of a served ensemble on Hopper: the reduction that
// follows the traversal K1 (serve_trees.cu), in the two orders of the JAX
// package's serving. It replaces no TPU kernel: for batches of up to 16384
// rows the reference adds the trees on the host (native/tptpu_native.cpp
// tp_tree_predict_sum, through transmogrifai_tpu/models/trees.py
// _leaf_sum); above that its device route reduces a one-hot leaf select in
// XLA (trees.py predict_boosted_raw / predict_forest_raw). For leaf values
// per_tree [N, T] f32 this computes, bit for bit as the plain versions
// (tree_sum.tree_sum_plain, tree_sum.tree_sum_device_route_plain):
//
// tree order (tp_tree_sum):
//   sum[r]           = ((0 + per_tree[r, 0]) + per_tree[r, 1]) + ... , one
//                      f32 rounding per add
//   boosted: out[r]  = base + (eta * sum[r])  (two roundings, no FMA)
//   forest:  out[r]  = sum[r] / T             (a true division)
//
// device route (tp_tree_sum_device_route), with win[r, t] = leaf // 32:
//   level 1: trees in windows of 32, lo1 zero trees before tree 0 (half the
//            padding); acc2[w, h] = the tree-order sum of the trees of
//            window w whose win is h
//   level 2: while the [W, H] grid has an axis over 32, windows of 32 on
//            both axes (padding centred), each summed in row-major order;
//            at most 32 x 32 cells are then summed in row-major order
//   boosted: out[r]  = fma(eta, total, base); forest: total * f32(1 / T)
// The sums are streamed per row: a partial per leaf window h for the
// current tree window (in registers for up to kRegWindows windows, else
// acc2[h] in shared memory); at the window's last tree they are folded, in
// h order, into the total (a grid of at most 32 x 32) or into acc3[h / 32],
// the current level-2 window's (and those into the total at that window's
// end). Adding an empty partial (+0.0) changes no sum that starts at +0.0,
// so the padding and the zeros of the one-hot select need no adds.
// Every add is __fadd_rn and the epilogues are __fmaf_rn, __fmul_rn,
// __fadd_rn, __fdiv_rn, which nvcc never contracts or splits.
//
// Design. A work item is 32 consecutive rows, one summing lane each (a
// row's adds are one dependent chain); a block is one warp, so every warp
// sums. An item's rows x T values are one contiguous slab: where it fits
// (T <= kSlabTrees) and the arrays are 16-byte aligned, one thread copies
// it into shared memory with one cp.async.bulk per array, completing on
// its stage's mbarrier (the last words past the slab's 16-byte multiple by
// plain loads), and each lane reads its row a float4 at a time where
// T % 4 == 0, a float2 where T % 2 == 0, else by words, the loads of the
// next 16 values issued before the adds of the current. Two stages: while
// one slab is summed the next is in flight, and the blocks are persistent,
// as many as fit on the card at once (the device's limits are read once),
// taking items b, b + grid, ...; a launch of fewer items than that has
// every item's slab in flight at once, so the card reads the whole input
// at its full rate and each SM's blocks start summing as their slabs land.
// The reads of the unpadded slab conflict in shared memory for some T (2-way
// at T = 200 with float4s, measured to cost the add chain about 3% on the
// H100 against a padded row). (Tried and measured slower on the
// H100: column tiles by 2-D tensor copies, per-row bulk copies, and 4- or
// 16-byte cp.async tiles at a padded stride, all of which issue more,
// smaller copies.) A longer row, or an unaligned array, is copied in
// column tiles of kTileTrees by the warp's 4-byte cp.async into an odd row
// stride (every lane reads its row at the same column in another bank),
// each lane arriving on the stage's mbarrier once its copies land, four
// stages deep. No serving or training call takes this tiles path (their T
// is 200, 50 or 20, and K1's output is 16-byte aligned): it exists only for
// T > kSlabTrees, for unaligned views, and for device-route accumulators
// too large to sit beside two slabs.
//
// The device route reads a tile in runs that end at tree-window ends: each
// run is a loop of adds alone (no test per tree), then the window's fold.
// With up to kRegWindows leaf windows every partial lives in a register and
// takes each tree's value or +0.0; with more, each tree is one
// read-modify-write of its window's partial in shared memory.
//
// What bounds it: reading per_tree once (4 N T bytes; the device route
// also reads win where H > 1) and writing out (4 N). At the serving sizes
// the tree order is latency-bound: the copy's first bytes, then a row's
// chain of T dependent adds after its slab lands. The device route adds a
// partial's update per tree and a fold per 32 trees to that chain; its
// time is several times the tree order's at the same shape (PERF.md).
//
// Shapes: per_tree, win [N, T] f32, row-major and contiguous; out [N] f32.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hist_ring.cuh"

namespace {

constexpr int kRows = 32;        // rows per item: one lane each
constexpr int kWindow = 32;      // XLA's reduction window on the CPU
constexpr int kMaxStages = 4;
constexpr int kSlabTrees = 512;  // longest slab staged whole (two stages)
constexpr int kTileTrees = 64;   // column tile of the tiles copy
constexpr int kMaxDevices = 64;
// device route: leaf windows whose partials live in registers (more live
// in shared memory: every register partial takes an add a tree)
constexpr int kRegWindows = 4;

// How an item reaches shared memory (see above).
enum Copy { kTiles = 0, kSlab = 1 };

struct Params {
  const float* per_tree;  // [N, T]
  const float* win;       // [N, T], or null (tree order; one leaf window)
  float* out;             // [N]
  int64_t n;
  int items;              // ceil(N / kRows)
  int t;
  int cols;               // trees per tile (T for a slab)
  int stride;             // words between a staged tile's rows
  int tiles;              // tiles per item
  int stages;
  int boosted;
  float base, eta, inv_t;
  // device route
  int h;                  // leaf windows
  int lo1;                // zero trees before tree 0
  int w;                  // tree windows
  int three;              // the [W, H] grid is windowed again
  int lo_w, lo_h, h2;     // its leading zeros and level-2 leaf windows
};

// Dynamic shared memory: kMaxStages mbarriers (a 32-byte header), the
// stages of values (and, with leaf windows, as many of windows), then
// acc2[h][32] and acc3[h2][32].
constexpr size_t kHeader = kMaxStages * sizeof(uint64_t);

__host__ __device__ inline size_t stage_words(const Params& p) {
  return static_cast<size_t>(kRows) * p.stride;
}

__host__ __device__ inline size_t smem_bytes(const Params& p, bool route) {
  const int arrays = p.win != nullptr ? 2 : 1;
  size_t words = static_cast<size_t>(p.stages) * arrays * stage_words(p);
  if (route) words += static_cast<size_t>(p.h + p.h2) * kRows;
  return kHeader + words * sizeof(float);
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          ring::smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(ring::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(ring::smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int kVec> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ float add_vec(float acc, float q) {
  return __fadd_rn(acc, q);
}
__device__ __forceinline__ float add_vec(float acc, float2 q) {
  return __fadd_rn(__fadd_rn(acc, q.x), q.y);
}
__device__ __forceinline__ float add_vec(float acc, float4 q) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, q.x), q.y), q.z), q.w);
}

// acc + row[0] + row[1] + ... + row[n - 1] in order (n a multiple of kVec),
// the loads of the next 16 values issued before the adds of the current.
template <int kVec>
__device__ __forceinline__ float sum_row(const float* row, int n, float acc) {
  using T = typename Vec<kVec>::T;
  constexpr int kGroup = 16 / kVec;
  const T* r = reinterpret_cast<const T*>(row);
  const int units = n / kVec;
  int u = 0;
  if (units >= kGroup) {
    T cur[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) cur[k] = r[k];
    for (u = kGroup; u + kGroup <= units; u += kGroup) {
      T nxt[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) nxt[k] = r[u + k];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) acc = add_vec(acc, cur[k]);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) cur[k] = nxt[k];
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) acc = add_vec(acc, cur[k]);
  }
  for (; u < units; ++u) acc = add_vec(acc, r[u]);
  return acc;
}

// Copies of tile `tile` of item `item` into `vals` (and `wins`), completing
// on `bar`.
// `reuse`: the stage was read before (by the generic proxy), so the bulk
// copies' writes (the async proxy) are fenced behind those reads.
template <int kCopy>
__device__ __forceinline__ void issue(const Params& p, float* vals, float* wins,
                                      uint64_t* bar, int64_t item, int tile,
                                      bool reuse, int lane) {
  const int64_t row0 = item * kRows;
  const int rows = p.n - row0 < kRows ? static_cast<int>(p.n - row0) : kRows;
  const int c0 = tile * p.cols;
  const int cols = min(p.cols, p.t - c0);
  if constexpr (kCopy == kSlab) {
    // lane 0 copies the slab: its 16-byte multiple in bulk, the rest by
    // plain loads
    if (lane == 0) {
      const size_t words = static_cast<size_t>(rows) * p.t;
      const size_t bulk = words & ~static_cast<size_t>(3);
      const size_t at = static_cast<size_t>(row0) * p.t;
      for (size_t i = bulk; i < words; ++i) {
        vals[i] = __ldg(p.per_tree + at + i);
        if (wins != nullptr) wins[i] = __ldg(p.win + at + i);
      }
      if (reuse || bulk < words) fence_async();
      const uint32_t bytes = static_cast<uint32_t>(bulk * sizeof(float));
      bar_expect(bar, wins != nullptr ? 2 * bytes : bytes);
      if (bytes) {
        bulk_copy(vals, p.per_tree + at, bytes, bar);
        if (wins != nullptr) bulk_copy(wins, p.win + at, bytes, bar);
      }
    }
  } else {
    if (cols > 0) {
      // element e = r * cols + c of the tile, e = lane, lane + 32, ...
      const int total = rows * cols;
      int r = lane / cols, c = lane - (lane / cols) * cols;
      const int step_r = kRows / cols, step_c = kRows - step_r * cols;
      for (int e = lane; e < total; e += 32) {
        const size_t at = static_cast<size_t>(row0 + r) * p.t + c0 + c;
        ring::copy4(vals + r * p.stride + c, p.per_tree + at);
        if (wins != nullptr) ring::copy4(wins + r * p.stride + c, p.win + at);
        r += step_r;
        c += step_c;
        if (c >= cols) {
          c -= cols;
          ++r;
        }
      }
    }
    ring::bar_arrive_on_copies(bar);
  }
}

__device__ __forceinline__ float lane_of(float q, int) { return q; }
__device__ __forceinline__ float lane_of(float2 q, int i) {
  return i == 0 ? q.x : q.y;
}
__device__ __forceinline__ float lane_of(float4 q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// The device route's windows, from the launch.
struct RouteShape {
  int h, lo1, w, three, lo_w, lo_h, h2;
};

// A lane's device-route sums: the partials of the current tree window's
// leaf windows, in registers where there are at most kR of them (kR 0:
// in shared memory, acc2), and the total.
template <int kR>
struct RouteSums {
  float part[kR > 0 ? kR : 1];
  float total;
};

// At tree j's window end: the leaf windows' partials folded, in window
// order, into the total (a grid of at most 32 x 32) or into the level-2
// accumulators acc3, and those into the total at their window's end.
template <int kR>
__device__ __forceinline__ void route_fold(const RouteShape& g, float* acc2,
                                           float* acc3, RouteSums<kR>& r,
                                           int j, int lane) {
  // window hh's partial into the total or its level-2 accumulator
  auto fold = [&](int hh, float v) {
    if (!g.three) {
      r.total = __fadd_rn(r.total, v);
    } else {
      float* b = acc3 + (hh + g.lo_h) / kWindow * kRows + lane;
      *b = __fadd_rn(*b, v);
    }
  };
  if constexpr (kR > 0) {
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      if (k < g.h) fold(k, r.part[k]);
      r.part[k] = 0.0f;
    }
  } else {
    for (int hh = 0; hh < g.h; ++hh) {
      float* a = acc2 + hh * kRows + lane;
      fold(hh, *a);
      *a = 0.0f;
    }
  }
  if (!g.three) return;
  const int w = (j + g.lo1) / kWindow;
  if ((w + g.lo_w) % kWindow == kWindow - 1 || w == g.w - 1) {
    for (int hh = 0; hh < g.h2; ++hh) {
      float* b = acc3 + hh * kRows + lane;
      r.total = __fadd_rn(r.total, *b);
      *b = 0.0f;
    }
  }
}

// One tree's value x into its leaf window's partial (hw: the window as
// read). In registers every partial takes x or +0.0, a no-op: a partial
// starts at +0.0 and never becomes -0.0. In shared memory, one
// read-modify-write.
template <int kR>
__device__ __forceinline__ void route_add(const RouteShape& g, float* acc2,
                                          RouteSums<kR>& r, float x, float hw,
                                          int lane) {
  const int h = min(static_cast<unsigned>(__float2int_rz(hw)),
                    static_cast<unsigned>(g.h - 1));
  if constexpr (kR > 0) {
    static_assert(kR == 4, "four register partials");
    r.part[0] = __fadd_rn(r.part[0], h == 0 ? x : 0.0f);
    r.part[1] = __fadd_rn(r.part[1], h == 1 ? x : 0.0f);
    if (g.h > 2) {
      r.part[2] = __fadd_rn(r.part[2], h == 2 ? x : 0.0f);
      r.part[3] = __fadd_rn(r.part[3], h == 3 ? x : 0.0f);
    }
  } else {
    float* a = acc2 + h * kRows + lane;
    *a = __fadd_rn(*a, x);
  }
}

// The device route's adds of one staged tile for this lane's row: runs of
// trees up to the next tree window's end (`left` counts them, across
// tiles), each run a loop of adds alone (read kVec values at a time, a
// word at a time to the first and from the last kVec boundary), then the
// window's fold. Without leaf windows (one window) the run adds into the
// one partial.
template <int kVec, int kR>
__device__ __forceinline__ void route_tile(const RouteShape& g, int t,
                                           const float* mv, const float* mw,
                                           float* acc2, float* acc3,
                                           RouteSums<kR>& r, int& left, int c0,
                                           int cols, bool live, int lane) {
  using T = typename Vec<kVec>::T;
  const bool windows = mw != nullptr;
  auto add = [&](float x, float hw) {
    if (windows) {
      route_add(g, acc2, r, x, hw, lane);
    } else if constexpr (kR > 0) {
      r.part[0] = __fadd_rn(r.part[0], x);
    }
  };
  const T* rv = reinterpret_cast<const T*>(mv);
  const T* rw = reinterpret_cast<const T*>(mw);
  int c = 0;
  while (c < cols) {
    const int run = left < cols - c ? left : cols - c;
    const int end = c + run;
    if (live) {
      int k = c;
      const int head = min(end, (k + kVec - 1) / kVec * kVec);
      for (; k < head; ++k) add(mv[k], windows ? mw[k] : 0.0f);
#pragma unroll 2
      for (; k + kVec <= end; k += kVec) {
        const T v = rv[k / kVec];
        const T w = windows ? rw[k / kVec] : T{};
#pragma unroll
        for (int e = 0; e < kVec; ++e) add(lane_of(v, e), lane_of(w, e));
      }
      for (; k < end; ++k) add(mv[k], windows ? mw[k] : 0.0f);
    }
    c = end;
    left -= run;
    if (left == 0) {
      const int j = c0 + c - 1;
      route_fold(g, acc2, acc3, r, j, lane);
      left = t - 1 - j < kWindow ? t - 1 - j : kWindow;
    }
  }
}

// kVec: the words a lane reads at a time; kR: the device route's leaf
// windows kept in registers (0: in shared memory).
template <bool kRoute, int kCopy, int kVec, int kR>
__global__ void __launch_bounds__(32) tree_sum_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* stage0 = reinterpret_cast<float*>(smem + kHeader);
  const bool two = p.win != nullptr;
  const size_t sw = stage_words(p);
  float* wins0 = two ? stage0 + p.stages * sw : nullptr;
  float* acc2 = stage0 + (two ? 2 : 1) * p.stages * sw;
  float* acc3 = acc2 + static_cast<size_t>(p.h) * kRows;
  const int lane = threadIdx.x;
  // the block's tiles, in order: tile `tile` of its k-th item, item
  // blockIdx.x + k * gridDim.x; positions advance by counters (no
  // divisions), the ring's stage and phase with them
  const int first = blockIdx.x, step = gridDim.x;
  const int mine = first < p.items ? (p.items - 1 - first) / step + 1 : 0;
  const int total = mine * p.tiles;
  int put_i = 0, put_s = 0, put_k = 0, put_tile = 0;
  auto put = [&]() {
    issue<kCopy>(p, stage0 + put_s * sw, two ? wins0 + put_s * sw : nullptr,
                 bars + put_s, first + static_cast<int64_t>(put_k) * step,
                 put_tile, put_i >= p.stages, lane);
    ++put_i;
    if (++put_s == p.stages) put_s = 0;
    if (++put_tile == p.tiles) {
      put_tile = 0;
      ++put_k;
    }
  };
  if (lane == 0) {
    for (int s = 0; s < p.stages; ++s) {
      ring::bar_init(bars + s, kCopy == kSlab ? 1 : 32);
    }
    fence_async();  // the initialized barriers, seen by the bulk copies
  }
  if (kRoute) {
    for (int i = lane; i < (p.h + p.h2) * kRows; i += 32) acc2[i] = 0.0f;
  }
  __syncthreads();
  while (put_i < p.stages && put_i < total) put();
  float acc = 0.0f;  // tree order: the row's sum
  RouteSums<kR> rr = {};  // device route: the partials and the total
  const RouteShape shape = {p.h, p.lo1, p.w, p.three, p.lo_w, p.lo_h, p.h2};
  // trees to the first window's end: kWindow - lo1, or all of them
  const int first_window = min(p.t, kWindow - p.lo1);
  int left = first_window;
  int s = 0, k = 0, tile = 0;
  uint32_t phase = 0;
  for (int i = 0; i < total; ++i) {
    const int64_t item = first + static_cast<int64_t>(k) * step;
    ring::bar_wait(bars + s, phase);
    const int64_t row = item * kRows + lane;
    const bool live = row < p.n;
    const int c0 = tile * p.cols;
    const int cols = min(p.cols, p.t - c0);
    const float* mv = stage0 + s * sw + lane * p.stride;
    if constexpr (kRoute) {
      if (tile == 0) left = first_window;
      route_tile<kVec, kR>(shape, p.t, mv,
                       two ? wins0 + s * sw + lane * p.stride : nullptr, acc2,
                       acc3, rr, left, c0, cols, live, lane);
    } else {
      if (live) acc = sum_row<kVec>(mv, cols, acc);
    }
    if (tile == p.tiles - 1) {
      if (live) {
        float o;
        if (kRoute) {
          o = p.boosted ? __fmaf_rn(p.eta, rr.total, p.base)
                        : __fmul_rn(rr.total, p.inv_t);
        } else {
          o = p.boosted ? __fadd_rn(p.base, __fmul_rn(p.eta, acc))
                        : __fdiv_rn(acc, static_cast<float>(p.t));
        }
        p.out[row] = o;
      }
      acc = 0.0f;
      rr.total = 0.0f;
    }
    __syncwarp();  // every lane is done with stage s
    if (put_i < total) put();
    if (++s == p.stages) {
      s = 0;
      phase ^= 1u;
    }
    if (++tile == p.tiles) {
      tile = 0;
      ++k;
    }
  }
}

// Per device, read once: SMs, shared memory per SM and per block, and the
// kernels' shared-memory limits raised.
struct DeviceInfo {
  bool ready;
  int sms, smem_sm, smem_block, reserved;
};
DeviceInfo g_devices[kMaxDevices];

template <bool kRoute, int kR>
cudaError_t raise_smem(int bytes) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(tree_sum_kernel<kRoute, kTiles, 1, kR>),
      reinterpret_cast<const void*>(tree_sum_kernel<kRoute, kSlab, 1, kR>),
      reinterpret_cast<const void*>(tree_sum_kernel<kRoute, kSlab, 2, kR>),
      reinterpret_cast<const void*>(tree_sum_kernel<kRoute, kSlab, 4, kR>)};
  for (const void* fn : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t device_info(const DeviceInfo** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_devices[dev];
  if (!d.ready) {
    const cudaDeviceAttr attrs[] = {
        cudaDevAttrMultiProcessorCount,
        cudaDevAttrMaxSharedMemoryPerMultiprocessor,
        cudaDevAttrMaxSharedMemoryPerBlockOptin,
        cudaDevAttrReservedSharedMemoryPerBlock};
    int* values[] = {&d.sms, &d.smem_sm, &d.smem_block, &d.reserved};
    for (int a = 0; a < 4; ++a) {
      err = cudaDeviceGetAttribute(values[a], attrs[a], dev);
      if (err != cudaSuccess) return err;
    }
    err = raise_smem<false, 0>(d.smem_block);
    if (err == cudaSuccess) err = raise_smem<true, kRegWindows>(d.smem_block);
    if (err == cudaSuccess) err = raise_smem<true, 0>(d.smem_block);
    if (err != cudaSuccess) return err;
    d.ready = true;
  }
  *out = &d;
  return cudaSuccess;
}

// The item layout of a copy mode: tile width, row stride, stages.
void layout(Params& p, Copy copy) {
  if (copy == kSlab) {
    p.cols = p.stride = p.t;
    p.stages = 2;
  } else {
    p.cols = std::max(1, std::min(p.t, kTileTrees));
    p.stride = p.cols | 1;  // odd
    p.stages = kMaxStages;
  }
  p.tiles = std::max(1, (p.t + p.cols - 1) / p.cols);
}

template <bool kRoute, int kCopy, int kVec, int kR>
void launch_as(const Params& p, int64_t grid, size_t smem, cudaStream_t s) {
  tree_sum_kernel<kRoute, kCopy, kVec, kR>
      <<<static_cast<unsigned>(grid), 32, smem, s>>>(p);
}

template <bool kRoute, int kR>
void launch_copy(const Params& p, Copy copy, int64_t grid, size_t smem,
                 cudaStream_t s) {
  if (copy == kSlab && p.t % 4 == 0) {
    launch_as<kRoute, kSlab, 4, kR>(p, grid, smem, s);
  } else if (copy == kSlab && p.t % 2 == 0) {
    launch_as<kRoute, kSlab, 2, kR>(p, grid, smem, s);
  } else if (copy == kSlab) {
    launch_as<kRoute, kSlab, 1, kR>(p, grid, smem, s);
  } else {
    launch_as<kRoute, kTiles, 1, kR>(p, grid, smem, s);
  }
}

template <bool kRoute>
int launch(Params& p, void* stream) {
  if (p.n < 0 || p.t < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p.n == 0) return static_cast<int>(cudaGetLastError());
  const DeviceInfo* d = nullptr;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = reinterpret_cast<uintptr_t>(p.per_tree) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(p.win) % 16 == 0;
  Copy copy = !aligned || p.t < 1 || p.t > kSlabTrees ? kTiles : kSlab;
  if ((p.n + kRows - 1) / kRows > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.items = static_cast<int>((p.n + kRows - 1) / kRows);
  layout(p, copy);
  size_t smem = smem_bytes(p, kRoute);
  if (copy != kTiles && smem > static_cast<size_t>(d->smem_block)) {
    copy = kTiles;  // the stages and the accumulators do not fit together
    layout(p, copy);
    smem = smem_bytes(p, kRoute);
  }
  if (smem > static_cast<size_t>(d->smem_block) ||
      static_cast<int64_t>(p.items) * p.tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t per_sm = std::min<int64_t>(
      32, d->smem_sm / static_cast<int64_t>(smem + d->reserved));
  const int64_t grid =
      std::min<int64_t>(p.items, std::max<int64_t>(1, per_sm) * d->sms);
  const auto s = static_cast<cudaStream_t>(stream);
  if (!kRoute) {
    launch_copy<kRoute, 0>(p, copy, grid, smem, s);
  } else if (p.h <= kRegWindows) {
    launch_copy<kRoute, kRegWindows>(p, copy, grid, smem, s);
  } else {
    launch_copy<kRoute, 0>(p, copy, grid, smem, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Windows of 32 over an axis of n, padding centred: (count, leading zeros).
void centred(int n, int* count, int* lo) {
  if (n <= kWindow) {
    *count = 1;
    *lo = 0;
    return;
  }
  *count = (n + kWindow - 1) / kWindow;
  *lo = (*count * kWindow - n) / 2;
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns the first CUDA error (0
// when the launch was accepted). boosted: 1 for base + eta * sum, 0 for the
// forest mean.
int tp_tree_sum(const void* per_tree, void* out, int64_t n, int64_t t,
                int boosted, float base, float eta, void* stream) {
  if (t > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.per_tree = static_cast<const float*>(per_tree);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.t = static_cast<int>(t);
  p.boosted = boosted;
  p.base = base;
  p.eta = eta;
  return launch<false>(p, stream);
}

// The device route's order. win may be null only with windows == 1. inv_t:
// f32(1 / T), the forest's factor.
int tp_tree_sum_device_route(const void* per_tree, const void* win, void* out,
                             int64_t n, int64_t t, int windows, int boosted,
                             float base, float eta, float inv_t, void* stream) {
  if (t > kWindow * kWindow * kWindow || windows < 1 ||
      windows > kWindow * kWindow || (windows > 1 && win == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.per_tree = static_cast<const float*>(per_tree);
  p.win = windows > 1 ? static_cast<const float*>(win) : nullptr;
  p.out = static_cast<float*>(out);
  p.n = n;
  p.t = static_cast<int>(t);
  p.boosted = boosted;
  p.base = base;
  p.eta = eta;
  p.inv_t = inv_t;
  p.h = windows;
  centred(p.t, &p.w, &p.lo1);
  p.three = p.w > kWindow || p.h > kWindow;
  p.h2 = 1;
  if (p.three) {
    int count_w = 1;
    centred(p.w, &count_w, &p.lo_w);
    centred(p.h, &p.h2, &p.lo_h);
  }
  return launch<true>(p, stream);
}

const char* tp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
