// The walk shared by the histogram kernels K2 (hist_binloop.cu) and K3
// (hist_wide.cu): persistent blocks over (feature tile, slot, fit) work
// items, each item's rows streamed through a ring of shared-memory stages.
//
// A launch has feat_tiles * M * K work items, numbered feature-tile-major
// (item = (tile * M + m) * K + k), so that the items in flight at once read
// the same few feature columns, which stay in L2 for every fit and slot
// that reads them (a 918-column code table does not fit in L2).
// The grid is as many blocks as fit on the card at once; block b takes items
// b, b + grid, b + 2 grid, ... in that order, kBatch at a time. An item
// whose slot holds no row costs one warp's store of zeros, not a resident
// block: the block's warps zero a batch's empty items first, a warp per
// item, and the walk skips them.
//
// An item walks the rows of its slot's run in `order` (node_order's stable
// sort), so in ascending row order, kTile rows (a stage) at a time.
// Roles in a block:
//  * producer warps (the last `producers` threads) fill the ring, taking
//    its stages in turn: for a tile of an item a producer warp waits until
//    the stage is free, stages the tile's row ids (read one of its tiles
//    ahead), issues cp.async copies of those rows' codes (the item's
//    features only; 16 bytes at a time where the rows allow it, else 4),
//    grad and hess into it, and signals its `full` mbarrier through
//    cp.async.mbarrier.arrive, which fires when the copies have landed;
//  * consumer threads (the first `consumers`) wait on `full`, add the tile
//    into their cells, and each consumer warp arrives once on the stage's
//    `empty` mbarrier.
// Both sides count stages in the same order, so stage s = g % S is in its
// (g / S)-th use and the parities follow from g alone. Up to S tiles are in
// flight at once, across item boundaries too.
//
// A consumer type C provides:
//   __device__ void begin(int fw);   // the item's feature count; zero cells
//   __device__ void tile(const Stage&, int rows);
//   __device__ void finish(float* out);  // out: the item's cells
// and every consumer thread calls them, whether or not it owns a cell.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <utility>
#include <vector>

namespace ring {

constexpr int kTile = 128;   // rows per stage
constexpr int kBatch = 256;  // items whose runs a block reads at once
constexpr int kMaxIds = kTile / 32;  // row ids per producer lane per tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed
// (counts as one of the barrier's expected arrivals).
__device__ __forceinline__ void bar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

struct Params {
  const int32_t* binned;  // [N, F], rows ldb apart
  const int32_t* order;   // [K, N]
  const int32_t* start;   // [K, M]
  const int32_t* count;   // [K, M]
  const float* grad;      // [K, N]
  const float* hess;      // [K, N]
  float* out;             // [K, M, F, B, 2]
  int n, f, k_fits, m_slots, bins;
  int ldb;                // row stride of binned, in words (>= F)
  bool vec;               // copy codes 4 words at a time: ldb, fpb and
                          // code_rs multiples of 4, binned 16-byte aligned
  int fpb, feat_tiles;    // features per item, feature tiles
  int stages;             // S
  int consumers, producers;  // thread counts (multiples of 32)
  int code_rs, code_cs;   // staged code (row, feature) strides, in words
  int stage_words;        // words per stage
};

struct Stage {
  int32_t* code;  // kTile rows x fpb features at (code_rs, code_cs)
  float* g;       // [kTile]
  float* h;       // [kTile]
  int32_t* row;   // [kTile]: the tile's row ids
};

// Shared memory: full[S], empty[S] barriers, kBatch runs, then S stages.
__host__ __device__ inline size_t header_bytes(int stages) {
  return 16 * static_cast<size_t>(stages) + kBatch * sizeof(int2);
}

__host__ __device__ inline size_t ring_bytes(int stages, int stage_words) {
  return header_bytes(stages) +
         static_cast<size_t>(stages) * stage_words * sizeof(int32_t);
}

// Words of one stage for `code_words` words of codes (kept 16-byte sized).
__host__ __device__ inline int stage_words_for(int code_words) {
  return (code_words + 3) / 4 * 4 + 3 * kTile;
}

__device__ __forceinline__ Stage stage_at(int32_t* base, int s, const Params& p) {
  Stage st;
  st.code = base + static_cast<size_t>(s) * p.stage_words;
  st.g = reinterpret_cast<float*>(st.code + p.stage_words - 3 * kTile);
  st.h = st.g + kTile;
  st.row = reinterpret_cast<int32_t*>(st.h + kTile);
  return st;
}

// Producer lane `lane` reads its row ids of tile `tl` of the run at `run0`
// (length len) into ids.
__device__ __forceinline__ void load_ids(int (&ids)[kMaxIds], const Params& p,
                                         int k, int run0, int len, int tl,
                                         int lane) {
  const int32_t* rows = p.order + static_cast<size_t>(k) * p.n + run0;
#pragma unroll
  for (int u = 0; u < kMaxIds; ++u) {
    const int idx = tl * kTile + lane + 32 * u;
    ids[u] = idx < len ? __ldg(rows + idx) : 0;
  }
}

// One producer warp's copies of one tile (`cnt` rows, ids in st.row) into
// stage `st`.
__device__ __forceinline__ void issue_tile(const Stage& st, const Params& p,
                                           int k, int f0, int fw, int cnt,
                                           int lane) {
  // (row j, column unit c) pairs, c fastest: a warp's copies of a row are
  // contiguous. A unit is 4 columns with p.vec (the columns past fw are
  // the row's own padding or the next tile's codes, never read), else 1.
  const int width = p.vec ? (fw + 3) / 4 : fw;
  const int total = cnt * width;
  int j = lane / width, c = lane - (lane / width) * width;
  const int step_j = 32 / width, step_c = 32 - step_j * width;
  for (int idx = lane; idx < total; idx += 32) {
    const int r = st.row[j];
    const int32_t* src = p.binned + static_cast<size_t>(r) * p.ldb + f0;
    if (p.vec) {
      copy16(st.code + j * p.code_rs + 4 * c, src + 4 * c);
    } else {
      copy4(st.code + j * p.code_rs + c * p.code_cs, src + c);
    }
    j += step_j;
    c += step_c;
    if (c >= width) {
      c -= width;
      ++j;
    }
  }
  const size_t fit = static_cast<size_t>(k) * p.n;
  for (int jj = lane; jj < cnt; jj += 32) {
    const int r = st.row[jj];
    copy4(st.g + jj, p.grad + fit + r);
    copy4(st.h + jj, p.hess + fit + r);
  }
}

// Item `it`'s feature count and its cells [fw][bins][2] in the output.
__device__ __forceinline__ int item_fw(const Params& p, int it) {
  return min(p.fpb, p.f - it / (p.k_fits * p.m_slots) * p.fpb);
}

__device__ __forceinline__ float* item_out(const Params& p, int it) {
  const int k = it % p.k_fits, m = (it / p.k_fits) % p.m_slots;
  const int f0 = it / (p.k_fits * p.m_slots) * p.fpb;
  return p.out + ((static_cast<size_t>(k) * p.m_slots + m) * p.f + f0) *
                     static_cast<size_t>(p.bins) * 2;
}

template <class C>
__device__ __forceinline__ void walk(const Params& p, unsigned char* smem,
                                     C& con) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + p.stages;
  int2* runs = reinterpret_cast<int2*>(smem + 16 * static_cast<size_t>(p.stages));
  int32_t* stages = reinterpret_cast<int32_t*>(smem + header_bytes(p.stages));
  const int t = threadIdx.x;
  const bool producer = t >= p.consumers;
  const int lane = t & 31;
  // producer warp pw of P fills the stages g with g % P == pw
  const unsigned pw = (t - p.consumers) >> 5, nprod = p.producers >> 5;
  if (t == 0) {
    for (int s = 0; s < p.stages; ++s) {
      bar_init(full + s, 32);
      bar_init(empty + s, p.consumers / 32);
    }
  }
  __syncthreads();

  const int items = p.feat_tiles * p.m_slots * p.k_fits;
  const int grid = gridDim.x;
  const int warps = blockDim.x >> 5;
  unsigned g = 0;  // stages used so far, the same count on both sides
  for (int b0 = blockIdx.x; b0 < items; b0 += kBatch * grid) {
    for (int i = t; i < kBatch; i += blockDim.x) {
      const int it = b0 + i * grid;
      if (it < items) {
        const int k = it % p.k_fits, m = (it / p.k_fits) % p.m_slots;
        const size_t at = static_cast<size_t>(k) * p.m_slots + m;
        runs[i] = make_int2(__ldg(p.start + at), __ldg(p.count + at));
      }
    }
    __syncthreads();
    // the batch's empty items first, a warp storing each one's zeros; the
    // walk below skips them
    for (int i = t >> 5; i < kBatch; i += warps) {
      const int it = b0 + i * grid;
      if (it >= items) break;
      if (runs[i].y != 0) continue;
      float2* o = reinterpret_cast<float2*>(item_out(p, it));
      const int cells = item_fw(p, it) * p.bins;
      for (int c = lane; c < cells; c += 32) o[c] = make_float2(0.0f, 0.0f);
    }
    for (int i = 0; i < kBatch; ++i) {
      const int it = b0 + i * grid;
      if (it >= items) break;
      const int run0 = runs[i].x, len = runs[i].y;
      if (len == 0) continue;
      const int k = it % p.k_fits;
      const int fw = item_fw(p, it);
      const int tiles = (len + kTile - 1) / kTile;
      if (producer) {
        const int f0 = it / (p.k_fits * p.m_slots) * p.fpb;
        // ids of this warp's next tile, read one of its tiles ahead
        int ids[kMaxIds];
        int ids_tile = -1;
        for (int tl = 0; tl < tiles; ++tl, ++g) {
          if (g % nprod != pw) continue;
          const int s = g % p.stages;
          if (g >= static_cast<unsigned>(p.stages)) {
            bar_wait(empty + s, ((g / p.stages) - 1) & 1);
          }
          const Stage st = stage_at(stages, s, p);
          if (ids_tile != tl) load_ids(ids, p, k, run0, len, tl, lane);
#pragma unroll
          for (int u = 0; u < kMaxIds; ++u) st.row[lane + 32 * u] = ids[u];
          ids_tile = tl + static_cast<int>(nprod);
          if (ids_tile < tiles) load_ids(ids, p, k, run0, len, ids_tile, lane);
          __syncwarp();
          issue_tile(st, p, k, f0, fw, min(kTile, len - tl * kTile), lane);
          bar_arrive_on_copies(full + s);
        }
      } else {
        con.begin(fw);
        for (int tl = 0; tl < tiles; ++tl, ++g) {
          const int s = g % p.stages;
          bar_wait(full + s, (g / p.stages) & 1);
          con.tile(stage_at(stages, s, p), min(kTile, len - tl * kTile));
          __syncwarp();
          if (lane == 0) bar_arrive(empty + s);
        }
        con.finish(item_out(p, it));
      }
    }
    __syncthreads();  // runs[] is refilled
  }
}

// The dynamic shared memory a block of `kernel` may use on the current
// device: the device's opt-in limit less the kernel's static shared memory.
// The first call per (kernel, device) raises the kernel's limit to it. The
// limit belongs to the function and every host thread sees it, so it is
// raised once to the most and never set per call: a call that set its own
// size could lower it between another thread's raise and that thread's
// launch, which the card then refuses (the model selector launches from
// several threads).
template <class Kernel>
inline cudaError_t max_dynamic_smem(Kernel kernel, int* bytes) {
  static std::mutex mu;
  static std::vector<std::pair<std::pair<const void*, int>, int>> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_pair(reinterpret_cast<const void*>(kernel), dev);
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& k : known) {
    if (k.first == key) {
      *bytes = k.second;
      return cudaSuccess;
    }
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  const int limit = optin - static_cast<int>(fa.sharedSizeBytes);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limit);
  if (err != cudaSuccess) return err;
  known.emplace_back(key, limit);
  *bytes = limit;
  return cudaSuccess;
}

// Blocks for a persistent launch: as many as are resident at once.
template <class Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                                   int items, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = std::min(items, per_sm * sms);
  return cudaSuccess;
}

}  // namespace ring
