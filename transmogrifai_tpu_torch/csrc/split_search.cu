// The split search of tree growth on Hopper: each slot's best split over
// the histogram that K2 (hist_binloop.cu) or K3 (hist_wide.cu) wrote.
//
// It is the split stage of the TPU kernel transmogrifai_tpu/models/
// hist_pallas.py: _split_kernel (build_best_split_pallas, whose fused
// histogram the port's K4 carries), and it computes what the reference's
// two-phase route computes after its histogram (transmogrifai_tpu/models/
// trees.py, the gain and argmax after the histogram of each feature group)
// and the port's models/hist.py split_search_plain computes, bit for bit:
// for a histogram [K, M, F, B, 2] (grad, hess), per (fit k, slot m)
//   best_gain, best_feat, best_bin = the gain, feature and threshold at the
//   first flat (feature, threshold) index of the maximum gain (a NaN counts
//   as the maximum; index 0 where every gain is -inf)
// in the arithmetic order of split_stage.cuh (XLA's cumsum blocks and
// reduction windows, separately rounded adds, multiplies and divides).
// `count` [K, M] (node_order's run lengths, or null) marks the slots that
// hold no row: their histogram is all zeros, and their result is computed
// from the knobs and the feature mask without reading it.
//
// Layout. One block of 128 threads per (fit, slot) (a slot with no row
// returns after a read of its count, where no child of weight 0 is
// allowed): the slot's cells are
// read from device memory into shared memory once (coalesced, four loads
// in flight a thread, stored feature fastest), a tile of features at a
// time (all of them where F * B * 8 bytes fit the tile budget), and the
// tile's split stage runs there: a thread per (block of 16 bins or window
// of 32, feature), then a thread per (threshold, feature); the block's
// threads then agree on the best by warp shuffles and one shared-memory
// round.
//
// What bounds it: reading the histogram of the slots that hold rows once,
// 8 bytes per (feature, bin), and writing 12 bytes per (fit, slot): at the
// training paths' 256-bin chunks ([18, 256, 10, 256, 2], 94 MB) about 28 us
// over the card's memory rate; the gains' ~20 operations per threshold are
// far below the scalar rate.
//
// Shapes: hist [K, M, F, B, 2] f32, contiguous; mask [K, F] f32; lam, gam,
// mcw [K] f32 each (or one value for every fit); count [K, M] int32 or null; out
// gain [K, M] f32, feat, bin [K, M] int32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

#include "split_stage.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr size_t kTileBudget = 24 * 1024;  // cell bytes per feature tile
constexpr int kMaxDevices = 64;
constexpr int kStaticReserve = 1024;  // bytes kept for static shared memory

struct Params {
  const float* hist;
  const float* mask;
  const float* lam;
  const float* gam;
  const float* mcw;
  int knob_strides;  // bit i set: knob i (lam, gam, mcw) has a value per fit
  const int32_t* count;
  float* gain;
  int32_t* feat;
  int32_t* bin;
  int m_slots, f, fc;  // slots per fit, features, features per tile
  split::Plan plan;
};

// Copies fw features' cells [fw][bins] (float2, feature-major in device
// memory) into the tile's feature-fastest layout [bins][fw]: 16 bytes (two
// cells of one feature) a load where the bin count is even and the source
// 16-byte aligned, else 8; four loads in flight a thread.
__device__ __forceinline__ void load_cells(float2* dst, const float2* src,
                                           int fw, int bins, int t) {
  const bool pairs = bins % 2 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int per = pairs ? 2 : 1;  // cells a load
  const int units = bins / per;   // loads a feature
  const int total = fw * units;
  // unit e = f * units + q covers cells (f, per * q ...)
  split::Tasks k(t, kThreads, units);
  int e = t;
  for (; e + 3 * kThreads < total; e += 4 * kThreads) {
    float4 v[4];
    int at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      at[u] = k.f * per * fw + k.i;  // cell (k.i, per * k.f)
      if (pairs) {
        v[u] = __ldg(reinterpret_cast<const float4*>(src) + e + u * kThreads);
      } else {
        const float2 c = __ldg(src + e + u * kThreads);
        v[u] = make_float4(c.x, c.y, 0.0f, 0.0f);
      }
      k.next(units);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      dst[at[u]] = make_float2(v[u].x, v[u].y);
      if (pairs) dst[at[u] + fw] = make_float2(v[u].z, v[u].w);
    }
  }
  for (; e < total; e += kThreads, k.next(units)) {
    const int at = k.f * per * fw + k.i;
    if (pairs) {
      const float4 c = __ldg(reinterpret_cast<const float4*>(src) + e);
      dst[at] = make_float2(c.x, c.y);
      dst[at + fw] = make_float2(c.z, c.w);
    } else {
      dst[at] = __ldg(src + e);
    }
  }
}

// The slot's result.
__device__ __forceinline__ void write_best(const Params& p, long long km,
                                           const split::Best& b) {
  const int len = p.plan.len;
  p.gain[km] = b.gain;
  p.feat[km] = b.idx / len;
  p.bin[km] = b.idx - b.idx / len * len;
}

__global__ void __launch_bounds__(kThreads, 8)
split_search_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ split::Best warp_bests[kWarps];
  __shared__ int first_on;
  const int t = threadIdx.x;
  const long long km = blockIdx.x;
  const int k = static_cast<int>(km / p.m_slots);
  const float lam = __ldg(p.lam + (p.knob_strides & 1 ? k : 0));
  const float gam = __ldg(p.gam + (p.knob_strides & 2 ? k : 0));
  const float mcw = __ldg(p.mcw + (p.knob_strides & 4 ? k : 0));
  const float* mask = p.mask + static_cast<size_t>(k) * p.f;
  const int len = p.plan.len;
  if (p.count != nullptr && __ldg(p.count + km) == 0) {
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
      write_best(p, km, split::empty_best(lam, gam, mcw, first_on, len));
    }
    return;
  }
  split::Best best = split::no_best();
  const float2* cells = reinterpret_cast<const float2*>(p.hist) +
                        km * p.f * static_cast<size_t>(p.plan.bins);
  for (int f0 = 0; f0 < p.f; f0 += p.fc) {
    const int fw = min(p.fc, p.f - f0);
    const split::Tile tile = split::tile_at(smem, p.plan, fw);
    if (f0 > 0) __syncthreads();  // the last tile's gains are taken
    load_cells(tile.cells, cells + static_cast<size_t>(f0) * p.plan.bins, fw,
               p.plan.bins, t);
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

bool g_ready[kMaxDevices];
int g_smem_block[kMaxDevices];

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns the first CUDA error
// (0 when the launch was accepted). Requires 2 <= bins <= 16^4 + 1.
int tp_split_search(const void* hist, const void* mask, const void* lam,
                    const void* gam, const void* mcw, int knob_strides,
                    const void* count, void* gain, void* feat, void* bin,
                    int k_fits, int m_slots, int f, int bins, void* stream) {
  if (!split::plan_fits(bins) || f < 1 || k_fits < 0 || m_slots < 0 ||
      knob_strides < 0 || knob_strides > 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>(k_fits) * m_slots;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  static std::mutex mu;  // host threads may launch at once
  std::unique_lock<std::mutex> lock(mu);
  if (!g_ready[dev]) {
    err = cudaDeviceGetAttribute(&g_smem_block[dev],
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_block[dev] -= kStaticReserve;  // the kernel's static arrays
    err = cudaFuncSetAttribute(split_search_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               g_smem_block[dev]);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_ready[dev] = true;
  }
  lock.unlock();
  Params p{};
  p.hist = static_cast<const float*>(hist);
  p.mask = static_cast<const float*>(mask);
  p.lam = static_cast<const float*>(lam);
  p.gam = static_cast<const float*>(gam);
  p.mcw = static_cast<const float*>(mcw);
  p.knob_strides = knob_strides;
  p.count = static_cast<const int32_t*>(count);
  p.gain = static_cast<float*>(gain);
  p.feat = static_cast<int32_t*>(feat);
  p.bin = static_cast<int32_t*>(bin);
  p.m_slots = m_slots;
  p.f = f;
  p.plan = split::make_plan(bins);
  const size_t cell_bytes = static_cast<size_t>(bins) * 8;
  p.fc = static_cast<int>(
      std::max<size_t>(1, std::min<size_t>(f, kTileBudget / cell_bytes)));
  const size_t smem = split::tile_words(p.plan, p.fc) * sizeof(float);
  if (smem > static_cast<size_t>(g_smem_block[dev])) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  split_search_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* tp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
