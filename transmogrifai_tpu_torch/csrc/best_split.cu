// Fused best-split search on Hopper (kernel K4 of the port).
//
// Replaces the TPU kernel transmogrifai_tpu/models/hist_pallas.py:
// _split_kernel (called through build_best_split_pallas). For K fits
// sharing the codes binned [N, F] and M node slots it returns, per (k, m),
// the best split over the features the fit's mask enables:
//   hist[f, b]  = (sum grad, sum hess) of slot m's rows with code b
//   gain(f, t)  = the split stage of split_stage.cuh over hist (XLA's
//                 cumsum blocks and reduction windows, the XGBoost gain,
//                 -inf where a child weighs less than mcw or the feature is
//                 masked)
// and the first (f, t) in (feature, bin) order at the maximum (a NaN counts
// as the maximum), or feat -1, bin 0, gain -inf where no threshold is
// valid. No histogram is written to device memory: only [K, M] leaves.
//
// The TPU kernel builds the histogram with one-hot products, its prefix
// sums and totals with triangular matrix products. Here the arithmetic is
// the port's two-phase split search (models/hist.py: the scatter histogram
// then split_search_plain) in the same order, so the result equals it bit
// for bit: each histogram cell is a float32 sum in ascending row order (the
// stable slot sort of node_order.cu), and the split stage is the same
// device code as the split-search kernel's (split_search.cu).
//
// Layout. One block per (fit, slot), 256 threads, one launch. The block
// stages its slot's run of rows (row ids, grad, hess; 256 at a time, once
// for a run that short) in shared memory, and takes the features in
// rounds: thread (f, q) of a round owns kCellBins cells (feature f, bins
// kCellBins q, ...; 2, 4 or 8 of them, so that a round takes at least 16
// features) in registers, reads its feature's code of every staged row
// from device memory (a warp's lanes read neighbouring features of one row,
// or share one code), and adds the row to its cell of that bin, rows in
// order. The round's cells then go to shared memory, where the split stage
// runs; each thread keeps its best across rounds, and the block agrees on
// one by warp shuffles. A slot with no row takes an all-zero histogram's
// best without reading anything.
//
// (The ring walk of K2 and K3, hist_ring.cuh, with the split stage run by
// its consumers at each item's end, is best_split_ring.cu. Timed against
// this design on an H100, both making their row order (chip_ab.py --parts
// k4ring): 0.248 ms against 0.041 at (a), N = 2048 rows over 128 slots and
// 918 features, and slower at each of chip_smoke.py's K4 shapes (0.094
// against 0.048 at 128 bins). With ~16 rows a slot each (feature tile,
// slot) item's fixed latency through the ring dominates. PERF.md.)
//
// What bounds it: reading each live (row, feature) code once and K*N*12
// bytes of row data (node order, grad, hess), and the gain's arithmetic,
// 2 divides and ~12 other operations per (k, m, f, threshold). The
// reference runs it at N <= 2048 rows; the kernel takes any N and 2 <= B
// <= 128.
//
// Shapes: binned [N, F] int32, rows ldb >= F apart; order [K, N] int32;
// start, count [K, M] int32 (node_order's); grad, hess [K, N] f32;
// feat_mask [K, F] f32; lam, gam, mcw [K] f32; out gain [K, M] f32, feat,
// bin [K, M] int32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_stage.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 128;
constexpr int kRows = 256;    // rows staged at a time
constexpr int kUnroll = 8;    // codes read ahead of their adds

struct Params {
  const int32_t* binned;
  const int32_t* order;
  const int32_t* start;
  const int32_t* count;
  const float* grad;
  const float* hess;
  const float* mask;
  const float* lam;
  const float* gam;
  const float* mcw;
  float* gain;
  int32_t* feat;
  int32_t* bin;
  int n, f, ldb, m_slots;
  int tpf, fpr;  // threads per feature, features per round
  split::Plan plan;
};

// The slot's result: -1 and bin 0 where no gain beats -inf.
__device__ __forceinline__ void write_best(const Params& p, size_t km,
                                           const split::Best& b) {
  const int len = p.plan.len;
  const bool none = !split::better(b.gain, -INFINITY);
  p.gain[km] = b.gain;
  p.feat[km] = none ? -1 : b.idx / len;
  p.bin[km] = none ? 0 : b.idx - b.idx / len * len;
}

// kCellBins: cells (bins of one feature) per thread.
template <int kCellBins>
__global__ void __launch_bounds__(kThreads, 4)
best_split_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];  // the round's split tile
  __shared__ int32_t s_row[kRows];
  __shared__ float s_g[kRows], s_h[kRows];
  __shared__ split::Best warp_bests[kWarps];
  __shared__ int first_on;
  const int t = threadIdx.x;
  const size_t km = blockIdx.x;
  const int k = static_cast<int>(km / p.m_slots);
  const float lam = __ldg(p.lam + k), gam = __ldg(p.gam + k);
  const float mcw = __ldg(p.mcw + k);
  const float* mask = p.mask + static_cast<size_t>(k) * p.f;
  const int len = __ldg(p.count + km);
  const int plen = p.plan.len;
  split::Best best = split::no_best();
  if (len == 0) {
    // no row: an all-zero histogram, whose thresholds all take one gain;
    // where a child of weight 0 is allowed, the first enabled feature at
    // threshold 0 takes it, if it beats -inf
    if (!(0.0f >= mcw)) {
      if (t == 0) write_best(p, km, split::Best{-INFINITY, 0});
      return;
    }
    if (t == 0) first_on = 0x7fffffff;
    __syncthreads();
    for (int f = t; f < p.f; f += kThreads) {
      if (__ldg(mask + f) > 0.0f) {
        atomicMin(&first_on, f);
        break;
      }
    }
    __syncthreads();
    if (t == 0) {
      write_best(p, km, split::empty_best(lam, gam, mcw, first_on, plen));
    }
    return;
  }
  const int32_t* rows = p.order + static_cast<size_t>(k) * p.n + __ldg(p.start + km);
  const float* gk = p.grad + static_cast<size_t>(k) * p.n;
  const float* hk = p.hess + static_cast<size_t>(k) * p.n;
  auto stage = [&](int r0) {
    const int cnt = min(kRows, len - r0);
    for (int j = t; j < cnt; j += kThreads) {
      const int r = __ldg(rows + r0 + j);
      s_row[j] = r;
      s_g[j] = __ldg(gk + r);
      s_h[j] = __ldg(hk + r);
    }
  };
  const bool once = len <= kRows;
  if (once) {
    stage(0);
    __syncthreads();
  }
  const int fl = t / p.tpf, b0 = (t % p.tpf) * kCellBins;
  for (int f0 = 0; f0 < p.f; f0 += p.fpr) {
    const int fw = min(p.fpr, p.f - f0);
    const bool owns = fl < fw && b0 < p.plan.bins;
    const int32_t* codes = p.binned + f0 + fl;
    float gs[kCellBins] = {}, hs[kCellBins] = {};
    auto add = [&](int c, float gv, float hv) {
#pragma unroll
      for (int i = 0; i < kCellBins; ++i) {
        if (c == b0 + i) {
          gs[i] = __fadd_rn(gs[i], gv);
          hs[i] = __fadd_rn(hs[i], hv);
        }
      }
    };
    for (int r0 = 0; r0 < len; r0 += kRows) {
      if (!once) {
        __syncthreads();  // the last chunk's rows are added
        stage(r0);
        __syncthreads();
      }
      const int cnt = min(kRows, len - r0);
      if (owns) {
        int j = 0;
        for (; j + kUnroll <= cnt; j += kUnroll) {
          int c[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            c[u] = __ldg(codes + static_cast<size_t>(s_row[j + u]) * p.ldb);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) add(c[u], s_g[j + u], s_h[j + u]);
        }
        for (; j < cnt; ++j) {
          add(__ldg(codes + static_cast<size_t>(s_row[j]) * p.ldb), s_g[j],
              s_h[j]);
        }
      }
    }
    const split::Tile tile = split::tile_at(smem, p.plan, fw);
    if (f0 > 0) __syncthreads();  // the last round's gains are taken
    if (owns) {
#pragma unroll
      for (int i = 0; i < kCellBins; ++i) {
        if (b0 + i < p.plan.bins) {
          tile.cells[(b0 + i) * fw + fl] = make_float2(gs[i], hs[i]);
        }
      }
    }
    __syncthreads();
    split::search(p.plan, tile, f0, mask + f0, lam, gam, mcw, best, t,
                  kThreads, [] { __syncthreads(); });
  }
  best = split::warp_best(best);
  if ((t & 31) == 0) warp_bests[t >> 5] = best;
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kWarps; ++w) {
      split::take(best, warp_bests[w].gain, warp_bests[w].idx);
    }
    write_best(p, km, best);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns the first CUDA error
// (0 when the launch was accepted). Requires 2 <= bins <= 128.
int tp_best_split(const void* binned, const void* order, const void* start,
                  const void* count, const void* grad, const void* hess,
                  const void* feat_mask, const void* lam, const void* gam,
                  const void* mcw, void* gain, void* feat, void* bin, int n,
                  int f, int ldb, int k_fits, int m_slots, int bins,
                  void* stream) {
  if (bins < 2 || bins > kMaxBins || f < 1 || ldb < f || k_fits < 0 ||
      m_slots < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>(k_fits) * m_slots;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.binned = static_cast<const int32_t*>(binned);
  p.order = static_cast<const int32_t*>(order);
  p.start = static_cast<const int32_t*>(start);
  p.count = static_cast<const int32_t*>(count);
  p.grad = static_cast<const float*>(grad);
  p.hess = static_cast<const float*>(hess);
  p.mask = static_cast<const float*>(feat_mask);
  p.lam = static_cast<const float*>(lam);
  p.gam = static_cast<const float*>(gam);
  p.mcw = static_cast<const float*>(mcw);
  p.gain = static_cast<float*>(gain);
  p.feat = static_cast<int32_t*>(feat);
  p.bin = static_cast<int32_t*>(bin);
  p.n = n;
  p.f = f;
  p.ldb = ldb;
  p.m_slots = m_slots;
  // cells per thread: 2, or more where that leaves fewer than 16 features
  // a round
  const int cell_bins = bins <= 32 ? 2 : bins <= 64 ? 4 : 8;
  p.tpf = 1;
  while (p.tpf * cell_bins < bins) p.tpf <<= 1;
  p.fpr = kThreads / p.tpf;
  p.plan = split::make_plan(bins);
  const size_t smem = split::tile_words(p.plan, p.fpr) * sizeof(float);
  const dim3 grid(static_cast<unsigned>(blocks));
  const auto s = static_cast<cudaStream_t>(stream);
  if (cell_bins == 2) {
    best_split_kernel<2><<<grid, kThreads, smem, s>>>(p);
  } else if (cell_bins == 4) {
    best_split_kernel<4><<<grid, kThreads, smem, s>>>(p);
  } else {
    best_split_kernel<8><<<grid, kThreads, smem, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
