// Gradient histograms for tree growth on Hopper (kernel K2 of the port).
//
// Replaces the TPU kernel transmogrifai_tpu/models/hist_pallas.py:
// _hist_binloop_kernel (called through build_histogram_pallas_binloop). It
// computes the same function:
//   out[k, m, f, b, 0] = sum of grad[k, r]  over rows r with node[k, r] == m
//   out[k, m, f, b, 1] = sum of hess[k, r]  and binned[r, f] == b
// for K fits sharing the codes binned [N, F], M node slots and B <= 64 bins.
// Rows whose slot is -1 or >= M add nothing.
//
// The TPU kernel builds each bin's plane as a one-hot matrix product on the
// MXU, with grad and hess split into bf16 high and low halves. This card
// has no reason for either: here every cell is a float32 sum taken in
// ascending row order, with one writer per cell, so the result is the same
// bits on every launch and equal to the plain scatter version's (which
// also adds each cell's rows in ascending order).
//
// Layout. Persistent blocks walk (feature tile, slot, fit) work items
// through the ring of hist_ring.cuh: producer warps stream each run's rows
// (their codes row-major, 16 bytes at a time when the rows are padded to
// 16 bytes, grad and hess) into shared-memory stages, up to S tiles of 128
// rows ahead, across item boundaries. Each consumer thread owns kCellBins
// cells of one feature, bins q * kCellBins ..., and keeps their grad and
// hess sums in registers: for every staged row it reads the row's code for
// its feature once and adds the row to the cell of that bin (a predicated
// add, so the other cells skip it as the plain version does). At 2 bins (the
// indicator columns, most of the flagship vector) a thread owns a whole
// feature, four add chains; at 32 bins 16 threads share a feature. Measured
// on the H100 against one warp per feature with ordered adds in shared
// memory (as K3): faster at 32 bins at every level of the path, and at 2
// bins than one thread per cell (PERF.md).
// No cell has a second writer: no atomics, and the order of every cell's
// adds is fixed. An item whose slot holds no row only stores its zeros.
//
// What bounds it: reading each live (row, feature) code once, plus
// K*N*(4+4+4) bytes of order/grad/hess, and writing K*M*F*B*8 bytes; and
// 2*K*N*F float32 adds. This design reads the codes once per fit, and a
// slot's run is one serial walk per cell, so a root level (one slot holding
// every row) is bound by that walk (one add per row per cell); the ring
// keeps it fed from shared memory. The wrapper leaves out rows of zero
// weight, which change no sum.
//
// Shapes: binned [N, F] int32 with codes in [0, B) (a code outside that
// range is skipped); order [K, N] int32; start, count [K, M] int32; grad,
// hess [K, N] f32; out [K, M, F, B, 2] f32, every element written.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hist_ring.cuh"

namespace {

constexpr int kMaxBins = 64;
constexpr int kMaxFeatTile = 32;  // features per item
constexpr int kMaxCells = 256;    // consumer threads per block
constexpr int kMaxThreads = kMaxCells + 128;
constexpr size_t kRingBudget = 72 * 1024;  // shared memory for the stages
constexpr int kUnroll = 16;       // staged rows read ahead of their adds
constexpr int kCellBins = 2;      // cells (bins of one feature) per thread

// Thread (f, q) = (t / tpf, t % tpf) owns the kCellBins cells (feature
// f0 + f, bins q * kCellBins ...), keeping each one's grad and hess sums in
// registers.
struct CellConsumer {
  const ring::Params& p;
  int f, b0;
  int fw;
  float gs[kCellBins], hs[kCellBins];

  __device__ bool owns() const { return f < fw && b0 < p.bins; }

  __device__ void begin(int item_fw) {
    fw = item_fw;
#pragma unroll
    for (int i = 0; i < kCellBins; ++i) gs[i] = hs[i] = 0.0f;
  }

  // A row of another bin is skipped by a predicated add, as the plain
  // version skips it. Rows go kUnroll at a time: their codes, grad and hess
  // are read first, so the reads overlap and only the adds form chains.
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
    for (; j < cnt; ++j) {
      add(codes[j * rs], st.g[j], st.h[j]);
    }
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

  __device__ void finish(float* out) {
    // out: this item's [fw][bins][2] cells, 8-byte aligned
    if (!owns()) return;
    float2* o = reinterpret_cast<float2*>(out) + f * p.bins;
#pragma unroll
    for (int i = 0; i < kCellBins; ++i) {
      if (b0 + i < p.bins) o[b0 + i] = make_float2(gs[i], hs[i]);
    }
  }
};

__global__ void __launch_bounds__(kMaxThreads)
hist_binloop_kernel(ring::Params p, int tpf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  CellConsumer con{p, t / tpf, (t % tpf) * kCellBins, 0, {}, {}};
  ring::walk(p, smem, con);
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns the first CUDA error
// (0 when the launch was accepted). Requires 1 <= bins <= 64.
int tp_hist_binloop(const void* binned, const void* order, const void* start,
                    const void* count, const void* grad, const void* hess,
                    void* out, int n, int f, int ldb, int k_fits, int m_slots,
                    int bins, void* stream) {
  if (bins < 1 || bins > kMaxBins || ldb < f) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (f <= 0 || m_slots <= 0 || k_fits <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  ring::Params p{};
  p.binned = static_cast<const int32_t*>(binned);
  p.order = static_cast<const int32_t*>(order);
  p.start = static_cast<const int32_t*>(start);
  p.count = static_cast<const int32_t*>(count);
  p.grad = static_cast<const float*>(grad);
  p.hess = static_cast<const float*>(hess);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.f = f;
  p.ldb = ldb;
  p.k_fits = k_fits;
  p.m_slots = m_slots;
  p.bins = bins;
  // threads per feature: the bins over kCellBins, rounded up to a power of
  // two; features per item: at most 32 and 256 threads, the fewest tiles,
  // balanced (in multiples of 4 for 16-byte copies)
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
  const size_t smem = ring::ring_bytes(p.stages, p.stage_words);
  // no more producer warps than stages: each stage has one filler at a time
  p.producers = std::min(p.producers, 32 * p.stages);
  const int threads = p.consumers + p.producers;
  auto kernel = hist_binloop_kernel;
  int max_smem = 0;
  cudaError_t err = ring::max_dynamic_smem(kernel, &max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items =
      static_cast<long long>(p.feat_tiles) * m_slots * k_fits;
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  err = ring::persistent_grid(kernel, threads, smem, static_cast<int>(items),
                              &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p, tpf);
  return static_cast<int>(cudaGetLastError());
}

const char* tp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
