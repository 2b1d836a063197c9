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
// except for the ensemble shapes where the reference reduces in another
// order (models/tree_sum.py's table, chosen on the host and passed as
// `order`):
//   lanes L (L = 4 or 8; one window of at most 32 trees): tree t adds into
//            lane t % L over the first multiple of L trees, the lanes
//            are folded by halves (lane l += lane l + L/2, ...), and the
//            remaining trees add to lane 0 in order
//   fold_w  (two leaf windows, W a power of two): s[w] = acc2[w, 0] +
//            acc2[w, 1], then s folded by halves over w
// Adding an empty partial (+0.0) changes no sum that starts at +0.0, so
// the padding and the zeros of the one-hot select need no adds.
// Every add is __fadd_rn and the epilogues are __fmaf_rn, __fmul_rn,
// __fadd_rn, __fdiv_rn, which nvcc never contracts or splits.
//
// Design, tree order. A work item is 32 consecutive rows, one summing lane each
// (a row's adds are one dependent chain); a block is one warp, so every warp
// sums. An item's rows x T values are one contiguous slab: where it fits (T <=
// kSlabTrees) and the arrays are 16-byte aligned, one thread copies it into
// shared memory with one cp.async.bulk per array, completing on its stage's
// mbarrier (the last words past the slab's 16-byte multiple by plain loads),
// and each lane reads its row a float4 at a time where T % 4 == 0, a float2
// where T % 2 == 0, else by words, the loads of the next 16 values issued
// before the adds of the current. Two stages: while one slab is summed the next
// is in flight, and the blocks are persistent, as many as fit on the card at
// once (the device's limits are read once), taking items b, b + grid, ...; a
// launch of fewer items than that has every item's slab in flight at once, so
// the card reads the whole input at its full rate and each SM's blocks start
// summing as their slabs land. The reads of the unpadded slab conflict in
// shared memory for some T (2-way at T = 200 with float4s, measured to cost the
// add chain about 3% on the H100 against a padded row). (Tried and measured
// slower on the H100: column tiles by 2-D tensor copies, per-row bulk copies,
// and 4- or 16-byte cp.async tiles at a padded stride, all of which issue more,
// smaller copies.) A longer row, or an unaligned array, is copied in column
// tiles of kTileTrees by the warp's 4-byte cp.async into an odd row stride
// (every lane reads its row at the same column in another bank), each lane
// arriving on the stage's mbarrier once its copies land, four stages deep. No
// serving or training call takes this tiles path (their T is 200, 50 or 20, and
// K1's output is 16-byte aligned): it exists only for T > kSlabTrees and for
// unaligned views.
//
// The device route (route_pairs_kernel) spreads (row, tree window) pairs
// over lanes: the level-1 partials of different tree windows are
// independent, so a pair's chain is its window's (at most 32) trees, not
// T. A block takes a slab of R rows (8 where the leaf windows' partials
// live in registers or T <= 64, else 16; fewer where that slab and its
// partials would not fit the block's shared memory), each warp 32 / R
// tree windows (more where there are more windows than warps' pairs), a
// lane per (row, window); each pair keeps its leaf windows' partials in
// registers (up to kRegWindows of them: each tree's value or +0.0 into
// each) or in shared memory (one read-modify-write a tree, each lane its
// own bank), and stores them to part[W][H][R]; then warp 0 folds each
// row's partials in the fixed order (row major over [W, H], or windowed
// again where an axis is over 32) and writes the epilogue. The slab is one
// bulk copy per array where the arrays and the slab's start are 16-byte
// aligned, else plain loads by the whole block. Where even a one-row slab
// of all T trees does not fit (thousands of trees, or many leaf windows),
// the block takes the tree windows in chunks that fit, staged by plain
// loads, and warp 0 folds each chunk's partials into running sums (the
// total, and the level-2 cells of the current window of 32 tree windows)
// before the next chunk is staged: the same adds in the same order.
// (Against the two kernels this one replaced, pairs over whole slabs and
// a streamed kernel for the rest, it reads 1.5% slower at [20000, 200]
// with 2 leaf windows and 8% at serving's 50-tree calls on an H100,
// chip_ab.py --parts route; PERF.md.)
//
// The lanes order (route_lanes_kernel) takes a thread per row: a block of
// kLaneRows rows copies its [rows, T] slab (T <= 32) into shared memory by
// coalesced loads at an odd row stride, and each thread then sums its row
// in kLanes register lanes. fold_w is route_pairs_kernel's fold by warp 0
// in that order instead of row-major.
//
// What bounds it: reading per_tree once (4 N T bytes; the device route
// also reads win where H > 1) and writing out (4 N). At the serving sizes
// the tree order is latency-bound: the copy's first bytes, then a row's
// chain of T dependent adds after its slab lands. The device route's
// chains are a window's trees and the row's W x H fold.
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
// device route by pairs: warps per block
constexpr int kRouteWarps = 8;
// device route in lanes: rows (threads) per block
constexpr int kLaneRows = 128;

// The device route's reduction orders (tp_tree_sum_device_route's `order`).
enum Order { kGrid = 0, kFoldW = 1, kLanes4 = 4, kLanes8 = 8 };

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
  int rows, rshift;       // rows a block (a power of two <= 16), log2
  int cw;                 // tree windows a chunk (W: one chunk)
  int bulk;               // one chunk, staged by bulk copies
  int order;              // Order
};

// Dynamic shared memory: kMaxStages mbarriers (a 32-byte header), then the
// stages of values (tree order), or the device route's slab and partials.
constexpr size_t kHeader = kMaxStages * sizeof(uint64_t);

__host__ __device__ inline size_t stage_words(const Params& p) {
  return static_cast<size_t>(kRows) * p.stride;
}

__host__ __device__ inline size_t smem_bytes(const Params& p) {
  return kHeader + static_cast<size_t>(p.stages) * stage_words(p) * sizeof(float);
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

// Copies of tile `tile` of item `item` into `vals`, completing on `bar`.
// `reuse`: the stage was read before (by the generic proxy), so the bulk
// copies' writes (the async proxy) are fenced behind those reads.
template <int kCopy>
__device__ __forceinline__ void issue(const Params& p, float* vals,
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
      for (size_t i = bulk; i < words; ++i) vals[i] = __ldg(p.per_tree + at + i);
      if (reuse || bulk < words) fence_async();
      const uint32_t bytes = static_cast<uint32_t>(bulk * sizeof(float));
      bar_expect(bar, bytes);
      if (bytes) bulk_copy(vals, p.per_tree + at, bytes, bar);
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

// kVec: the words a lane reads at a time.
template <int kCopy, int kVec>
__global__ void __launch_bounds__(32) tree_sum_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* stage0 = reinterpret_cast<float*>(smem + kHeader);
  const size_t sw = stage_words(p);
  const int lane = threadIdx.x;
  // the block's tiles, in order: tile `tile` of its k-th item, item
  // blockIdx.x + k * gridDim.x; positions advance by counters (no
  // divisions), the ring's stage and phase with them
  const int first = blockIdx.x, step = gridDim.x;
  const int mine = first < p.items ? (p.items - 1 - first) / step + 1 : 0;
  const int total = mine * p.tiles;
  int put_i = 0, put_s = 0, put_k = 0, put_tile = 0;
  auto put = [&]() {
    issue<kCopy>(p, stage0 + put_s * sw, bars + put_s,
                 first + static_cast<int64_t>(put_k) * step, put_tile,
                 put_i >= p.stages, lane);
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
  __syncthreads();
  while (put_i < p.stages && put_i < total) put();
  float acc = 0.0f;  // the row's sum
  int s = 0, k = 0, tile = 0;
  uint32_t phase = 0;
  for (int i = 0; i < total; ++i) {
    const int64_t item = first + static_cast<int64_t>(k) * step;
    ring::bar_wait(bars + s, phase);
    const int64_t row = item * kRows + lane;
    const bool live = row < p.n;
    const int cols = min(p.cols, p.t - tile * p.cols);
    const float* mv = stage0 + s * sw + lane * p.stride;
    if (live) acc = sum_row<kVec>(mv, cols, acc);
    if (tile == p.tiles - 1) {
      if (live) {
        p.out[row] = p.boosted ? __fadd_rn(p.base, __fmul_rn(p.eta, acc))
                               : __fdiv_rn(acc, static_cast<float>(p.t));
      }
      acc = 0.0f;
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

// The device route by (row, tree window) pairs (see the top of the file):
// one block per slab of p.rows rows. Lane l of warp w takes row
// l % rows and the chunk's tree windows (32 / rows) w + l / rows, then
// every (32 / rows) nw-th after it. A pair's partials per leaf window live
// in registers (up to kR of them; kR 0: in shared memory) and land in
// part [cw][H][rows]; after the block's barrier warp 0 folds each row's
// partials in the device route's fixed order into its running total (and,
// where the grid is windowed again, into the level-2 cells of the current
// window of 32 tree windows, in registers, kept in acc3 [h2][rows] between
// chunks and added to the total at that window's end). Blocks are not
// persistent: small slabs let many blocks an SM hold their copies in
// flight at once. Shared memory: the mbarrier header, the chunk's values
// (and windows) at a row stride of its trees, then part and acc3.
__host__ __device__ inline int route_stride(const Params& p) {
  return p.cw >= p.w ? p.t : p.cw * kWindow;
}

__host__ __device__ inline size_t route_smem_bytes(const Params& p) {
  const int arrays = p.win != nullptr ? 2 : 1;
  const size_t words =
      static_cast<size_t>(arrays) * route_stride(p) +
      static_cast<size_t>(p.cw) * p.h + (p.three ? p.h2 : 0);
  return kHeader + words * p.rows * sizeof(float);
}

template <int kVec, int kR>
__global__ void __launch_bounds__(kRouteWarps * 32)
route_pairs_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const bool two = p.win != nullptr;
  const int R = p.rows, stride = route_stride(p);
  float* vals = reinterpret_cast<float*>(smem + kHeader);
  float* wins = vals + static_cast<size_t>(R) * stride;
  float* part = vals + static_cast<size_t>(two ? 2 : 1) * R * stride;
  float* acc3 = part + static_cast<size_t>(p.cw) * p.h * R;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = blockDim.x >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  const int rows = p.n - row0 < R ? static_cast<int>(p.n - row0) : R;
  const size_t at = static_cast<size_t>(row0) * p.t;
  if (p.bulk) {
    if (t == 0) {
      ring::bar_init(bar, 1);
      fence_async();  // the initialized barrier, seen by the bulk copies
      const size_t words = static_cast<size_t>(rows) * p.t;
      const size_t bulk = words & ~static_cast<size_t>(3);
      for (size_t i = bulk; i < words; ++i) {
        vals[i] = __ldg(p.per_tree + at + i);
        if (two) wins[i] = __ldg(p.win + at + i);
      }
      if (bulk < words) fence_async();
      const uint32_t bytes = static_cast<uint32_t>(bulk * sizeof(float));
      bar_expect(bar, two ? 2 * bytes : bytes);
      if (bytes) {
        bulk_copy(vals, p.per_tree + at, bytes, bar);
        if (two) bulk_copy(wins, p.win + at, bytes, bar);
      }
    }
  }
  if (p.three && warp == 0 && lane < rows) {
    for (int b = 0; b < p.h2; ++b) acc3[b * R + lane] = 0.0f;
  }
  __syncthreads();  // the barrier is initialized
  if (p.bulk) ring::bar_wait(bar, 0);
  const int row = lane & (R - 1);
  const int per_warp = 32 >> p.rshift;  // tree windows a warp takes a pass
  using T = typename Vec<kVec>::T;
  float total = 0.0f;  // warp 0's lanes: their row's running total
  // tree windows [wa, wb): staged (unless bulk), summed by pairs, folded
  auto chunk = [&](const int wa, const int wb) {
    const int j0 = max(0, wa * kWindow - p.lo1);
    const int j1 = min(p.t, wb * kWindow - p.lo1);
    if (!p.bulk) {
      // the chunk's trees [j0, j1) of each row, a row at a time; the last
      // chunk's pairs are done (the barrier after them)
      const int cols = j1 - j0;
      for (int r = 0; r < rows; ++r) {
        const size_t src = at + static_cast<size_t>(r) * p.t + j0;
        for (int c = t; c < cols; c += blockDim.x) {
          vals[r * stride + c] = __ldg(p.per_tree + src + c);
          if (two) wins[r * stride + c] = __ldg(p.win + src + c);
        }
      }
      __syncthreads();  // the chunk is staged; warp 0's last fold is done
    }
    if (row < rows) {
      const float* mv = vals + static_cast<size_t>(row) * stride;
      const float* mw = wins + static_cast<size_t>(row) * stride;
      for (int wl = per_warp * warp + (lane >> p.rshift); wl < wb - wa;
           wl += per_warp * nw) {
        float* pw = part + static_cast<size_t>(wl) * p.h * R + row;
        // the window's trees, as columns of the staged chunk
        const int k0 = max(j0, (wa + wl) * kWindow - p.lo1) - j0;
        const int k1 = min(j1, (wa + wl + 1) * kWindow - p.lo1) - j0;
        float acc[kR > 0 ? kR : 1] = {};
        if constexpr (kR == 0) {
          for (int hh = 0; hh < p.h; ++hh) pw[hh * R] = 0.0f;
        }
        auto add = [&](float x, float hw) {
          if (!two) {
            acc[0] = __fadd_rn(acc[0], x);
            return;
          }
          const int h = min(static_cast<unsigned>(__float2int_rz(hw)),
                            static_cast<unsigned>(p.h - 1));
          if constexpr (kR > 0) {
            static_assert(kR == 4, "four register partials");
            acc[0] = __fadd_rn(acc[0], h == 0 ? x : 0.0f);
            acc[1] = __fadd_rn(acc[1], h == 1 ? x : 0.0f);
            if (p.h > 2) {
              acc[2] = __fadd_rn(acc[2], h == 2 ? x : 0.0f);
              acc[3] = __fadd_rn(acc[3], h == 3 ? x : 0.0f);
            }
          } else {
            pw[h * R] = __fadd_rn(pw[h * R], x);
          }
        };
        int k = k0;
        const int head = min(k1, (k + kVec - 1) / kVec * kVec);
        for (; k < head; ++k) add(mv[k], two ? mw[k] : 0.0f);
        const T* rv = reinterpret_cast<const T*>(mv);
        const T* rw = reinterpret_cast<const T*>(mw);
#pragma unroll 2
        for (; k + kVec <= k1; k += kVec) {
          const T v = rv[k / kVec];
          const T hv = two ? rw[k / kVec] : T{};
#pragma unroll
          for (int e = 0; e < kVec; ++e) add(lane_of(v, e), lane_of(hv, e));
        }
        for (; k < k1; ++k) add(mv[k], two ? mw[k] : 0.0f);
        if constexpr (kR > 0) {
#pragma unroll
          for (int hh = 0; hh < kR; ++hh) {
            if (hh < p.h) pw[hh * R] = acc[hh];
          }
        }
      }
    }
    __syncthreads();  // every partial of the chunk is in part
    if (warp == 0 && lane < rows && p.order == kFoldW) {
      // one chunk, two leaf windows, W a power of two: each tree window's
      // two partials added, then those folded by halves (s[w] += s[w +
      // half], in place in part's leaf-window-0 cells)
      for (int w = 0; w < p.w; ++w) {
        float* c = part + static_cast<size_t>(w) * 2 * R + lane;
        c[0] = __fadd_rn(c[0], c[R]);
      }
      for (int half = p.w / 2; half >= 1; half /= 2) {
        for (int w = 0; w < half; ++w) {
          part[static_cast<size_t>(w) * 2 * R + lane] = __fadd_rn(
              part[static_cast<size_t>(w) * 2 * R + lane],
              part[static_cast<size_t>(w + half) * 2 * R + lane]);
        }
      }
      total = part[lane];
    } else if (warp == 0 && lane < rows && !p.three) {
      // the chunk's partials in [W, H] row-major order into the total
      const int cells = (wb - wa) * p.h;
      for (int c = 0; c < cells; ++c) {
        total = __fadd_rn(total, part[c * R + lane]);
      }
    } else if (warp == 0 && lane < rows) {
      // the grid windowed again: each window of 32 tree windows (ws..we
      // of it in this chunk) and 32 leaf windows is one cell, summed in
      // row-major order in a register (acc3 holds it between chunks), and
      // the cells of a window of tree windows go into the total in order
      // where it ends
      for (int ws = wa; ws < wb;) {
        const int a_end = (ws + p.lo_w) / kWindow * kWindow + kWindow - p.lo_w;
        const int we = min(wb, a_end);
        const bool closes = we == a_end || we == p.w;
        for (int b = 0; b < p.h2; ++b) {
          const int h0 = max(0, b * kWindow - p.lo_h);
          const int h1 = min(p.h, (b + 1) * kWindow - p.lo_h);
          float cell = acc3[b * R + lane];
          for (int w = ws; w < we; ++w) {
            const float* pl = part + static_cast<size_t>(w - wa) * p.h * R + lane;
            for (int hh = h0; hh < h1; ++hh) cell = __fadd_rn(cell, pl[hh * R]);
          }
          if (closes) {
            total = __fadd_rn(total, cell);
            cell = 0.0f;
          }
          acc3[b * R + lane] = cell;
        }
        ws = we;
      }
    }
  };
  if (p.cw >= p.w) {
    chunk(0, p.w);  // all T trees in one chunk: its own straight-line copy
  } else {
    for (int wa = 0; wa < p.w; wa += p.cw) chunk(wa, min(p.w, wa + p.cw));
  }
  if (warp == 0 && lane < rows) {
    p.out[row0 + lane] = p.boosted ? __fmaf_rn(p.eta, total, p.base)
                                   : __fmul_rn(total, p.inv_t);
  }
}

// The device route in kLanes lanes (one window of p.t <= 32 trees): a
// thread per row (see the top of the file).
template <int kLanes>
__global__ void __launch_bounds__(kLaneRows) route_lanes_kernel(const Params p) {
  __shared__ float slab[kLaneRows * (kWindow + 1)];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kLaneRows;
  const int rows =
      p.n - row0 < kLaneRows ? static_cast<int>(p.n - row0) : kLaneRows;
  const int stride = p.t | 1;  // odd: each thread's row in other banks
  const float* src = p.per_tree + static_cast<size_t>(row0) * p.t;
  for (int i = threadIdx.x; i < rows * p.t; i += kLaneRows) {
    const int r = i / p.t;
    slab[r * stride + (i - r * p.t)] = __ldg(src + i);
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= rows) return;
  const float* v = slab + r * stride;
  float acc[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) acc[l] = 0.0f;
  const int main = p.t / kLanes * kLanes;
  for (int j = 0; j < main; j += kLanes) {
#pragma unroll
    for (int l = 0; l < kLanes; ++l) acc[l] = __fadd_rn(acc[l], v[j + l]);
  }
#pragma unroll
  for (int half = kLanes / 2; half >= 1; half /= 2) {
#pragma unroll
    for (int l = 0; l < half; ++l) acc[l] = __fadd_rn(acc[l], acc[l + half]);
  }
  float total = acc[0];
  for (int j = main; j < p.t; ++j) total = __fadd_rn(total, v[j]);
  p.out[row0 + r] = p.boosted ? __fmaf_rn(p.eta, total, p.base)
                              : __fmul_rn(total, p.inv_t);
}

// Per device, read once: SMs, shared memory per SM and per block, and the
// kernels' shared-memory limits raised.
struct DeviceInfo {
  bool ready;
  int sms, smem_sm, smem_block, reserved;
};
DeviceInfo g_devices[kMaxDevices];

cudaError_t raise_smem(const void* const* kernels, int count, int bytes) {
  for (int i = 0; i < count; ++i) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t device_info(const DeviceInfo** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  static std::mutex mu;  // host threads may launch at once
  std::lock_guard<std::mutex> lock(mu);
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
    const void* kernels[] = {
        reinterpret_cast<const void*>(tree_sum_kernel<kTiles, 1>),
        reinterpret_cast<const void*>(tree_sum_kernel<kSlab, 1>),
        reinterpret_cast<const void*>(tree_sum_kernel<kSlab, 2>),
        reinterpret_cast<const void*>(tree_sum_kernel<kSlab, 4>),
        reinterpret_cast<const void*>(route_pairs_kernel<1, kRegWindows>),
        reinterpret_cast<const void*>(route_pairs_kernel<2, kRegWindows>),
        reinterpret_cast<const void*>(route_pairs_kernel<4, kRegWindows>),
        reinterpret_cast<const void*>(route_pairs_kernel<1, 0>),
        reinterpret_cast<const void*>(route_pairs_kernel<2, 0>),
        reinterpret_cast<const void*>(route_pairs_kernel<4, 0>)};
    err = raise_smem(kernels, 10, d.smem_block);
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

template <int kCopy, int kVec>
void launch_as(const Params& p, int64_t grid, size_t smem, cudaStream_t s) {
  tree_sum_kernel<kCopy, kVec><<<static_cast<unsigned>(grid), 32, smem, s>>>(p);
}

// The tree order.
int launch_tree_order(Params& p, void* stream) {
  if (p.n < 0 || p.t < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p.n == 0) return static_cast<int>(cudaGetLastError());
  const DeviceInfo* d = nullptr;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = reinterpret_cast<uintptr_t>(p.per_tree) % 16 == 0;
  const Copy copy = !aligned || p.t < 1 || p.t > kSlabTrees ? kTiles : kSlab;
  if ((p.n + kRows - 1) / kRows > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.items = static_cast<int>((p.n + kRows - 1) / kRows);
  layout(p, copy);
  const size_t smem = smem_bytes(p);
  if (smem > static_cast<size_t>(d->smem_block) ||
      static_cast<int64_t>(p.items) * p.tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t per_sm = std::min<int64_t>(
      32, d->smem_sm / static_cast<int64_t>(smem + d->reserved));
  const int64_t grid =
      std::min<int64_t>(p.items, std::max<int64_t>(1, per_sm) * d->sms);
  const auto s = static_cast<cudaStream_t>(stream);
  if (copy == kSlab && p.t % 4 == 0) {
    launch_as<kSlab, 4>(p, grid, smem, s);
  } else if (copy == kSlab && p.t % 2 == 0) {
    launch_as<kSlab, 2>(p, grid, smem, s);
  } else if (copy == kSlab) {
    launch_as<kSlab, 1>(p, grid, smem, s);
  } else {
    launch_as<kTiles, 1>(p, grid, smem, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kR>
void route_as(const Params& p, int vec, dim3 grid, dim3 block, size_t smem,
              cudaStream_t s) {
  if (vec == 4) {
    route_pairs_kernel<4, kR><<<grid, block, smem, s>>>(p);
  } else if (vec == 2) {
    route_pairs_kernel<2, kR><<<grid, block, smem, s>>>(p);
  } else {
    route_pairs_kernel<1, kR><<<grid, block, smem, s>>>(p);
  }
}

// The device route in lanes (see route_lanes_kernel).
int launch_lanes(const Params& p, void* stream) {
  if (p.h != 1 || p.t > kWindow) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (p.n + kLaneRows - 1) / kLaneRows;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (p.order == kLanes4) {
    route_lanes_kernel<4><<<static_cast<unsigned>(blocks), kLaneRows, 0, s>>>(p);
  } else {
    route_lanes_kernel<8><<<static_cast<unsigned>(blocks), kLaneRows, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The device route: the slab's rows and chunk (see route_pairs_kernel).
int launch_route(Params& p, void* stream) {
  if (p.n < 0 || p.t < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p.n == 0) return static_cast<int>(cudaGetLastError());
  if (p.order == kLanes4 || p.order == kLanes8) return launch_lanes(p, stream);
  const bool fold = p.order == kFoldW;
  if (p.order != kGrid &&
      !(fold && p.h == 2 && !p.three && (p.w & (p.w - 1)) == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceInfo* d = nullptr;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t limit = static_cast<size_t>(d->smem_block);
  // all T trees in one chunk, in the most rows up to 8 (leaf windows in
  // registers, or few trees: more blocks for as many bytes) or 16 that fit
  const bool regs = p.h <= kRegWindows;
  p.cw = p.w;
  p.rows = regs || p.t <= 2 * kWindow ? 8 : 16;
  while (p.rows > 1 && route_smem_bytes(p) > limit) p.rows >>= 1;
  if (route_smem_bytes(p) > limit) {
    // chunks of tree windows, one row a block
    p.rows = 1;
    p.cw = 1;
    while (p.cw < p.w) {
      ++p.cw;
      if (route_smem_bytes(p) > limit) {
        --p.cw;
        break;
      }
    }
    if (route_smem_bytes(p) > limit || fold) {
      return static_cast<int>(cudaErrorInvalidValue);  // fold_w: one chunk
    }
  }
  p.rshift = 0;
  while ((1 << p.rshift) < p.rows) ++p.rshift;
  const bool aligned = reinterpret_cast<uintptr_t>(p.per_tree) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(p.win) % 16 == 0;
  // a slab starts 16-byte aligned when rows * T is a multiple of 4 words
  p.bulk = p.cw >= p.w && aligned && p.t >= 1 &&
           static_cast<int64_t>(p.rows) * p.t % 4 == 0;
  const int stride = route_stride(p);
  const int vec = stride % 4 == 0 ? 4 : stride % 2 == 0 ? 2 : 1;
  const int64_t blocks = (p.n + p.rows - 1) / p.rows;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int per_warp = 32 / p.rows;  // tree windows a warp takes a pass
  const int warps =
      std::max(1, std::min((std::min(p.cw, p.w) + per_warp - 1) / per_warp,
                           kRouteWarps));
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = route_smem_bytes(p);
  const dim3 grid(static_cast<unsigned>(blocks)), block(32 * warps);
  if (regs) {
    route_as<kRegWindows>(p, vec, grid, block, smem, s);
  } else {
    route_as<0>(p, vec, grid, block, smem, s);
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
  return launch_tree_order(p, stream);
}

// The device route's order. win may be null only with windows == 1. inv_t:
// f32(1 / T), the forest's factor. order: 0 the windowed grid, 1 fold_w, 4
// or 8 that many lanes (see the top of the file).
int tp_tree_sum_device_route(const void* per_tree, const void* win, void* out,
                             int64_t n, int64_t t, int windows, int boosted,
                             float base, float eta, float inv_t, int order,
                             void* stream) {
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
  p.order = order;
  p.h = windows;
  centred(p.t, &p.w, &p.lo1);
  p.three = p.w > kWindow || p.h > kWindow;
  p.h2 = 1;
  if (p.three) {
    int count_w = 1;
    centred(p.w, &count_w, &p.lo_w);
    centred(p.h, &p.h2, &p.lo_h);
  }
  return launch_route(p, stream);
}

const char* tp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
