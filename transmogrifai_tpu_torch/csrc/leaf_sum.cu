// The leaf sums of tree growth on Hopper, in the reference's order for
// wide leaf tables.
//
// It replaces no TPU kernel: past its one-hot budget the JAX package sums a
// grown tree's leaves with a vmapped scatter-add (transmogrifai_tpu/models/
// trees.py _segment_sum_small, the `.at[].add` branch), which XLA's CPU
// backend applies in row order. For K fits of N rows, slots idx [K, N] in
// [0, S) and values g, h [K, N] f32 it computes
//   out_g[k, m] = the float32 sum, in ascending row order from +0, of
//                 g[k, r] over rows r with idx[k, r] == m   (out_h the same)
// bit for bit as the plain version (models/leaf_sum.py leaf_sum_plain on
// the CPU: an index_add_ per fit, in row order). The rows
// come from node_order (node_order.cu): a stable sort by slot, so a slot's
// run lists its rows in ascending order; it leaves out rows whose g and h
// are both zero, which change no such sum (it starts at +0.0, never
// becomes -0.0, and adding +0.0 or -0.0 to it keeps its bits).
//
// Layout. A warp per (fit, slot) run, 8 warps a block, warps striding over
// the K * S runs. The warp reads a run 32 * kU rows at a time: each lane
// kU row ids (coalesced) and their g and h (gathered), kept in registers
// and stored to the warp's shared-memory buffers; lane 0 then adds the g
// column and lane 1 the h column in row order (the same instructions on
// two addresses), while the next kU rows of every lane are already being
// read. A slot's sum is one dependent chain however the work is cut, so a
// run of thousands of rows (a late boosting round puts most rows in a few
// leaves) costs one add latency per row on one lane.
//
// What bounds it: reading order, g and h (12 bytes per live row and fit)
// and writing 8 bytes per (fit, slot); and the longest run's chain of
// dependent adds.
//
// Shapes: order [K, N] int32, start, count [K, S] int32 (node_order's);
// g, h [K, N] f32; out_g, out_h [K, S] f32, every element written. h and
// out_h may both be null: then g alone is summed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kU = 16;             // rows per lane per step
constexpr int kStep = 32 * kU;     // rows per warp per step

__global__ void __launch_bounds__(kWarps * 32)
leaf_sum_kernel(const int32_t* __restrict__ order,
                const int32_t* __restrict__ start,
                const int32_t* __restrict__ count,
                const float* __restrict__ g, const float* __restrict__ h,
                float* __restrict__ out_g, float* __restrict__ out_h, int n,
                int slots, long long runs) {
  __shared__ float buf[kWarps][2][kStep];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float* bg = buf[w][0];
  float* bh = buf[w][1];
  // lane 0 reads the g column, lane 1 the h column
  const float* col = lane == 0 ? bg : bh;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long run = static_cast<long long>(blockIdx.x) * kWarps + w;
       run < runs; run += warps) {
    const int k = static_cast<int>(run / slots);
    const int len = __ldg(count + run);
    const int32_t* rows = order + static_cast<size_t>(k) * n + __ldg(start + run);
    const float* gk = g + static_cast<size_t>(k) * n;
    const float* hk = h != nullptr ? h + static_cast<size_t>(k) * n : nullptr;
    float gv[kU], hv[kU];
    auto fetch = [&](int base) {
      int id[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = base + 32 * u + lane;
        id[u] = i < len ? __ldg(rows + i) : -1;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        gv[u] = id[u] >= 0 ? __ldg(gk + id[u]) : 0.0f;
        hv[u] = id[u] >= 0 && hk != nullptr ? __ldg(hk + id[u]) : 0.0f;
      }
    };
    float acc = 0.0f;
    if (len > 0) fetch(0);
    for (int base = 0; base < len; base += kStep) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        bg[32 * u + lane] = gv[u];
        bh[32 * u + lane] = hv[u];
      }
      __syncwarp();
      if (base + kStep < len) fetch(base + kStep);
      const int cnt = min(kStep, len - base);
      if (lane < (h != nullptr ? 2 : 1)) {
        int j = 0;
        for (; j + 8 <= cnt; j += 8) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = col[j + u];
#pragma unroll
          for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, v[u]);
        }
        for (; j < cnt; ++j) acc = __fadd_rn(acc, col[j]);
      }
      __syncwarp();  // the buffers are free again
    }
    if (lane == 0) out_g[run] = acc;
    if (lane == 1 && h != nullptr) out_h[run] = acc;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns the first CUDA error
// (0 when the launch was accepted).
int tp_leaf_sum(const void* order, const void* start, const void* count,
                const void* g, const void* h, void* out_g, void* out_h, int n,
                int k_fits, int slots, void* stream) {
  if (n < 0 || k_fits < 0 || slots < 1 ||
      (h == nullptr) != (out_h == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long runs = static_cast<long long>(k_fits) * slots;
  if (runs == 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // enough warps to fill the card (8 blocks of 8 warps an SM), no more
  // than there are runs
  const long long want = (runs + kWarps - 1) / kWarps;
  const long long grid = want < 8LL * sms ? want : 8LL * sms;
  leaf_sum_kernel<<<static_cast<unsigned>(grid), kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(start),
      static_cast<const int32_t*>(count), static_cast<const float*>(g),
      static_cast<const float*>(h), static_cast<float*>(out_g),
      static_cast<float*>(out_h), n, slots, runs);
  return static_cast<int>(cudaGetLastError());
}

const char* tp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
