// K4, the fused best-split search, walked through the ring of K2 and K3
// (hist_ring.cuh): a second design of best_split.cu, kept to be timed
// against it (chip_ab.py --parts k4ring). No wrapper of the package calls
// it; best_split.cu is K4's kernel.
//
// It computes what best_split.cu computes, bit for bit (each histogram
// cell a float32 sum in ascending row order over node_order's stable slot
// sort, then split_stage.cuh's split stage), with the ring walk's layout:
// persistent blocks over (feature tile, slot, fit) items, producer warps
// streaming each item's rows (codes of the tile's features, grad, hess)
// into shared-memory stages, consumer threads holding the item's cells in
// registers (K2's CellConsumer: kCellBins cells of one feature a thread).
// At an item's end the consumers store its cells to a shared-memory split
// tile and run the split stage on it (a named barrier among them, while
// the producers fill the next item's stages). An item's best goes to a
// scratch row per feature tile; the last of a slot's feature tiles to
// arrive (an atomic count per slot) takes the tiles' bests in tile order
// and writes the slot's result, so the launch writes only [K, M] bests. A
// slot with no row costs a warp per tile: the tile's first enabled feature
// gives its all-zero histogram's best without reading anything.
//
// Shapes: as best_split.cu; scratch: tile_gain [F, K, M] f32, tile_idx
// [F, K, M] int32 (the first feat_tiles rows used), arrivals [K, M] int32,
// zero on entry and left zero.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hist_ring.cuh"
#include "split_stage.cuh"

namespace {

constexpr int kMaxBins = 128;
constexpr int kMaxFeatTile = 32;  // features per item
constexpr int kMaxCells = 256;    // consumer threads per block
constexpr int kMaxThreads = kMaxCells + 128;
constexpr size_t kRingBudget = 72 * 1024;  // shared memory for the stages
constexpr int kUnroll = 16;       // staged rows read ahead of their adds
constexpr int kCellBins = 2;      // cells (bins of one feature) per thread

struct Split {
  const float* mask;  // [K, F]
  const float* lam;
  const float* gam;
  const float* mcw;
  float* tile_gain;   // [tiles, K * M]
  int32_t* tile_idx;
  int32_t* arrivals;  // [K * M]
  float* gain;
  int32_t* feat;
  int32_t* bin;
  split::Plan plan;
};

__device__ __forceinline__ void consumer_sync(int consumers) {
  asm volatile("bar.sync 1, %0;" ::"r"(consumers) : "memory");
}

// Item `it`'s best into its tile's scratch; the slot's last tile to arrive
// writes the slot's result and clears its count.
__device__ void publish(const ring::Params& p, const Split& q, int it,
                        split::Best b) {
  const int km_count = p.k_fits * p.m_slots;
  const int k = it % p.k_fits, m = (it / p.k_fits) % p.m_slots;
  const int km = k * p.m_slots + m;
  const int tile = it / km_count;
  q.tile_gain[static_cast<size_t>(tile) * km_count + km] = b.gain;
  q.tile_idx[static_cast<size_t>(tile) * km_count + km] = b.idx;
  __threadfence();
  if (atomicAdd(q.arrivals + km, 1) != p.feat_tiles - 1) return;
  __threadfence();
  split::Best best = split::no_best();
  for (int i = 0; i < p.feat_tiles; ++i) {
    const size_t at = static_cast<size_t>(i) * km_count + km;
    split::take(best, __ldcg(q.tile_gain + at), __ldcg(q.tile_idx + at));
  }
  const int len = q.plan.len;
  const bool none = !split::better(best.gain, -INFINITY);
  q.gain[km] = best.gain;
  q.feat[km] = none ? -1 : best.idx / len;
  q.bin[km] = none ? 0 : best.idx - best.idx / len * len;
  q.arrivals[km] = 0;
}

// K2's cell consumer, whose item end runs the split stage on its cells.
struct SplitConsumer {
  const ring::Params& p;
  const Split& q;
  float* tile_smem;
  split::Best* warp_bests;
  int f, b0;
  int fw;
  float gs[kCellBins], hs[kCellBins];

  __device__ bool owns() const { return f < fw && b0 < p.bins; }

  __device__ void begin(int item_fw) {
    fw = item_fw;
#pragma unroll
    for (int i = 0; i < kCellBins; ++i) gs[i] = hs[i] = 0.0f;
  }

  __device__ void tile(const ring::Stage& st, int cnt) {
    if (!owns()) return;
    const int32_t* codes = st.code + f;
    const int rs = p.code_rs;
    int j = 0;
    for (; j + kUnroll <= cnt; j += kUnroll) {
      int c[kUnroll];
      float gv[kUnroll], hv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; u += 4) {
        const float4 g4 = *reinterpret_cast<const float4*>(st.g + j + u);
        const float4 h4 = *reinterpret_cast<const float4*>(st.h + j + u);
        gv[u] = g4.x, gv[u + 1] = g4.y, gv[u + 2] = g4.z, gv[u + 3] = g4.w;
        hv[u] = h4.x, hv[u + 1] = h4.y, hv[u + 2] = h4.z, hv[u + 3] = h4.w;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) c[u] = codes[(j + u) * rs];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add(c[u], gv[u], hv[u]);
    }
    for (; j < cnt; ++j) add(codes[j * rs], st.g[j], st.h[j]);
  }

  __device__ __forceinline__ void add(int c, float gv, float hv) {
#pragma unroll
    for (int i = 0; i < kCellBins; ++i) {
      if (c == b0 + i) {
        gs[i] = __fadd_rn(gs[i], gv);
        hs[i] = __fadd_rn(hs[i], hv);
      }
    }
  }

  __device__ void finish(int it) {
    const int t = threadIdx.x;
    const int k = it % p.k_fits;
    const int f0 = it / (p.k_fits * p.m_slots) * p.fpb;
    const split::Tile tl = split::tile_at(tile_smem, q.plan, fw);
    if (owns()) {
#pragma unroll
      for (int i = 0; i < kCellBins; ++i) {
        if (b0 + i < p.bins) tl.cells[(b0 + i) * fw + f] = make_float2(gs[i], hs[i]);
      }
    }
    consumer_sync(p.consumers);
    split::Best best = split::no_best();
    const int consumers = p.consumers;
    split::search(q.plan, tl, f0, q.mask + static_cast<size_t>(k) * p.f + f0,
                  __ldg(q.lam + k), __ldg(q.gam + k), __ldg(q.mcw + k), best,
                  t, consumers, [consumers] { consumer_sync(consumers); });
    best = split::warp_best(best);
    if ((t & 31) == 0) warp_bests[t >> 5] = best;
    consumer_sync(p.consumers);
    if (t == 0) {
      for (int w = 1; w < p.consumers / 32; ++w) {
        split::take(best, warp_bests[w].gain, warp_bests[w].idx);
      }
      publish(p, q, it, best);
    }
  }
};

// A warp's best of an empty item: the tile's first enabled feature at
// threshold 0 where the all-zero histogram's gain beats -inf.
__device__ void empty_item(const ring::Params& p, const Split& q, int it,
                           int lane) {
  const int k = it % p.k_fits;
  const int f0 = it / (p.k_fits * p.m_slots) * p.fpb;
  const int fw = ring::item_fw(p, it);
  const float* mask = q.mask + static_cast<size_t>(k) * p.f + f0;
  int first_on = 0x7fffffff;
  for (int c = 0; c < fw && first_on == 0x7fffffff; c += 32) {
    const unsigned on =
        __ballot_sync(0xffffffffu, c + lane < fw && __ldg(mask + c + lane) > 0.0f);
    if (on) first_on = f0 + c + __ffs(on) - 1;
  }
  if (lane == 0) {
    publish(p, q, it,
            split::empty_best(__ldg(q.lam + k), __ldg(q.gam + k),
                              __ldg(q.mcw + k), first_on, q.plan.len));
  }
}

// ring::walk, with an empty item's zeros replaced by its best and the
// consumers' item end given the item.
__global__ void __launch_bounds__(kMaxThreads)
best_split_ring_kernel(ring::Params p, Split q, int tpf) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ split::Best warp_bests[kMaxCells / 32];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + p.stages;
  int2* runs = reinterpret_cast<int2*>(smem + 16 * static_cast<size_t>(p.stages));
  int32_t* stages = reinterpret_cast<int32_t*>(smem + ring::header_bytes(p.stages));
  float* tile_smem = reinterpret_cast<float*>(
      smem + ring::ring_bytes(p.stages, p.stage_words));
  const int t = threadIdx.x;
  SplitConsumer con{p, q, tile_smem, warp_bests, t / tpf, (t % tpf) * kCellBins,
                    0, {}, {}};
  const bool producer = t >= p.consumers;
  const int lane = t & 31;
  const unsigned pw = (t - p.consumers) >> 5, nprod = p.producers >> 5;
  if (t == 0) {
    for (int s = 0; s < p.stages; ++s) {
      ring::bar_init(full + s, 32);
      ring::bar_init(empty + s, p.consumers / 32);
    }
  }
  __syncthreads();

  const int items = p.feat_tiles * p.m_slots * p.k_fits;
  const int grid = gridDim.x;
  const int warps = blockDim.x >> 5;
  unsigned g = 0;
  for (int b0 = blockIdx.x; b0 < items; b0 += ring::kBatch * grid) {
    for (int i = t; i < ring::kBatch; i += blockDim.x) {
      const int it = b0 + i * grid;
      if (it < items) {
        const int k = it % p.k_fits, m = (it / p.k_fits) % p.m_slots;
        const size_t at = static_cast<size_t>(k) * p.m_slots + m;
        runs[i] = make_int2(__ldg(p.start + at), __ldg(p.count + at));
      }
    }
    __syncthreads();
    for (int i = t >> 5; i < ring::kBatch; i += warps) {
      const int it = b0 + i * grid;
      if (it >= items) break;
      if (runs[i].y == 0) empty_item(p, q, it, lane);
    }
    for (int i = 0; i < ring::kBatch; ++i) {
      const int it = b0 + i * grid;
      if (it >= items) break;
      const int run0 = runs[i].x, len = runs[i].y;
      if (len == 0) continue;
      const int k = it % p.k_fits;
      const int fw = ring::item_fw(p, it);
      const int tiles = (len + ring::kTile - 1) / ring::kTile;
      if (producer) {
        const int f0 = it / (p.k_fits * p.m_slots) * p.fpb;
        int ids[ring::kMaxIds];
        int ids_tile = -1;
        for (int tl = 0; tl < tiles; ++tl, ++g) {
          if (g % nprod != pw) continue;
          const int s = g % p.stages;
          if (g >= static_cast<unsigned>(p.stages)) {
            ring::bar_wait(empty + s, ((g / p.stages) - 1) & 1);
          }
          const ring::Stage st = ring::stage_at(stages, s, p);
          if (ids_tile != tl) ring::load_ids(ids, p, k, run0, len, tl, lane);
#pragma unroll
          for (int u = 0; u < ring::kMaxIds; ++u) st.row[lane + 32 * u] = ids[u];
          ids_tile = tl + static_cast<int>(nprod);
          if (ids_tile < tiles) ring::load_ids(ids, p, k, run0, len, ids_tile, lane);
          __syncwarp();
          ring::issue_tile(st, p, k, f0, fw, min(ring::kTile, len - tl * ring::kTile),
                           lane);
          ring::bar_arrive_on_copies(full + s);
        }
      } else {
        con.begin(fw);
        for (int tl = 0; tl < tiles; ++tl, ++g) {
          const int s = g % p.stages;
          ring::bar_wait(full + s, (g / p.stages) & 1);
          con.tile(ring::stage_at(stages, s, p), min(ring::kTile, len - tl * ring::kTile));
          __syncwarp();
          if (lane == 0) ring::bar_arrive(empty + s);
        }
        con.finish(it);
      }
    }
    __syncthreads();  // runs[] is refilled
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns the first CUDA error
// (0 when the launch was accepted). Requires 2 <= bins <= 128.
int tp_best_split_ring(const void* binned, const void* order, const void* start,
                       const void* count, const void* grad, const void* hess,
                       const void* feat_mask, const void* lam, const void* gam,
                       const void* mcw, void* gain, void* feat, void* bin,
                       void* tile_gain, void* tile_idx, void* arrivals, int n,
                       int f, int ldb, int k_fits, int m_slots, int bins,
                       void* stream) {
  if (bins < 2 || bins > kMaxBins || f < 1 || ldb < f || k_fits < 0 ||
      m_slots < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m_slots == 0 || k_fits == 0) return static_cast<int>(cudaGetLastError());
  ring::Params p{};
  p.binned = static_cast<const int32_t*>(binned);
  p.order = static_cast<const int32_t*>(order);
  p.start = static_cast<const int32_t*>(start);
  p.count = static_cast<const int32_t*>(count);
  p.grad = static_cast<const float*>(grad);
  p.hess = static_cast<const float*>(hess);
  p.out = nullptr;
  p.n = n;
  p.f = f;
  p.ldb = ldb;
  p.k_fits = k_fits;
  p.m_slots = m_slots;
  p.bins = bins;
  // K2's tiling: threads per feature the bins over kCellBins (a power of
  // two), at most 32 features and 256 consumer threads an item
  int tpf = 1;
  while (tpf * kCellBins < bins) tpf <<= 1;
  p.vec = ldb % 4 == 0 && reinterpret_cast<uintptr_t>(binned) % 16 == 0;
  const int fpb_max = std::min(kMaxFeatTile, std::max(1, kMaxCells / tpf));
  p.feat_tiles = (f + fpb_max - 1) / fpb_max;
  p.fpb = (f + p.feat_tiles - 1) / p.feat_tiles;
  if (p.vec) {
    p.fpb = std::min(fpb_max, (p.fpb + 3) / 4 * 4);
    p.feat_tiles = (f + p.fpb - 1) / p.fpb;
    p.vec = p.fpb % 4 == 0;
  }
  p.consumers = (p.fpb * tpf + 31) / 32 * 32;
  p.producers = p.fpb >= 16 ? 128 : 64;
  p.code_rs = p.fpb;
  p.code_cs = 1;
  p.stage_words = ring::stage_words_for(ring::kTile * p.fpb);
  const size_t stage_bytes = static_cast<size_t>(p.stage_words) * 4;
  p.stages = static_cast<int>(
      std::min<size_t>(8, std::max<size_t>(4, kRingBudget / stage_bytes)));
  p.producers = std::min(p.producers, 32 * p.stages);
  Split q{};
  q.mask = static_cast<const float*>(feat_mask);
  q.lam = static_cast<const float*>(lam);
  q.gam = static_cast<const float*>(gam);
  q.mcw = static_cast<const float*>(mcw);
  q.tile_gain = static_cast<float*>(tile_gain);
  q.tile_idx = static_cast<int32_t*>(tile_idx);
  q.arrivals = static_cast<int32_t*>(arrivals);
  q.gain = static_cast<float*>(gain);
  q.feat = static_cast<int32_t*>(feat);
  q.bin = static_cast<int32_t*>(bin);
  q.plan = split::make_plan(bins);
  const size_t smem = ring::ring_bytes(p.stages, p.stage_words) +
                      split::tile_words(q.plan, p.fpb) * sizeof(float);
  const int threads = p.consumers + p.producers;
  auto kernel = best_split_ring_kernel;
  int max_smem = 0;
  cudaError_t err = ring::max_dynamic_smem(kernel, &max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items = static_cast<long long>(p.feat_tiles) * m_slots * k_fits;
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  err = ring::persistent_grid(kernel, threads, smem, static_cast<int>(items), &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p, q, tpf);
  return static_cast<int>(cudaGetLastError());
}

const char* tp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
