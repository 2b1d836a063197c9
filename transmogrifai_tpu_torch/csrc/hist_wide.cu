// Gradient histograms for wide bin sketches on Hopper (kernel K3 of the
// port).
//
// Replaces the TPU kernel transmogrifai_tpu/models/hist_pallas.py:
// _hist_kernel (called through _build_histogram_pallas_batched), which the
// reference takes for more than 64 bins (256-bin sketches). It computes the
// same function as K2 (hist_binloop.cu):
//   out[k, m, f, b, 0] = sum of grad[k, r]  over rows r with node[k, r] == m
//   out[k, m, f, b, 1] = sum of hess[k, r]  and binned[r, f] == b
// for K fits sharing the codes binned [N, F], M node slots and any bin
// count up to kMaxBins. Rows whose slot is -1 or >= M add nothing; a code
// outside [0, B) is skipped.
//
// The TPU kernel packs the bins onto its 128 lanes and builds them with
// one-hot products on the MXU, grad and hess split into bf16 halves. Here,
// as in K2, every cell is a float32 sum taken in ascending row order with
// one writer per cell, so the result is the same bits on every launch and
// equal to the plain scatter version's.
//
// Layout. Persistent blocks walk (feature tile of up to 8, slot, fit) work
// items through the ring of hist_ring.cuh: two producer warps stream each
// run's rows (its codes feature-major, grad and hess) into shared-memory
// stages, up to S tiles of 128 rows ahead. One consumer warp per feature
// owns that feature's B x 2 cells in shared memory and adds a stage 32
// rows at a time (OrderedConsumer, with warp_ordered_add.cuh): lanes
// hold consecutive rows, lanes with distinct codes add at once, lanes that
// share a code add in lane (= row) order.
//
// What bounds it: writing K*M*F*B*8 bytes of output (every slot of the
// chunk, live or not: at a 256-slot chunk and 256 bins that dwarfs the
// K*N*12 bytes of row data and the live codes read), and otherwise the
// serial walk of the longest run (the root level's single slot), which the
// ring keeps fed so that it runs at the pace of the ordered adds.
//
// Shapes: binned [N, F] int32, rows ldb >= F apart; order [K, N] int32;
// start, count [K, M] int32; grad, hess [K, N] f32; out [K, M, F, B, 2]
// f32, every element written.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hist_ring.cuh"
#include "warp_ordered_add.cuh"

namespace {

using ring::kTile;

constexpr int kMaxWarps = 8;   // features per block
constexpr int kMaxBins = 16384;
constexpr int kCodeStride = kTile + 1;  // a feature's staged codes, padded
constexpr size_t kRingBudget = 48 * 1024;  // shared memory for the stages

// One consumer warp per feature, owning that feature's cells [2][bins] in
// shared memory (grad, then hess): a stage's rows go 32 at a time through
// warp_ordered_add.cuh (lanes hold consecutive rows, lanes with distinct
// codes add at once, lanes that share a code add in lane = row order), and
// a stage's (up to) four groups are read and ranked before the first is
// added, so their reads and lane matches overlap.
struct OrderedConsumer {
  const ring::Params& p;
  float* cg;  // this warp's grad cells (hess cells follow)
  int lane, w, fw;

  __device__ void begin(int item_fw) {
    fw = item_fw;
    if (w < fw) {
      for (int b = lane; b < p.bins; b += 32) {
        cg[b] = 0.0f;
        cg[p.bins + b] = 0.0f;
      }
    }
    __syncwarp();
  }

  __device__ void tile(const ring::Stage& st, int cnt) {
    if (w >= fw) return;
    const int32_t* codes = st.code + w * p.code_cs;
    constexpr int kGroups = kTile / 32;
    int c[kGroups];
    float gv[kGroups], hv[kGroups];
    bool ok[kGroups];
    OrderedAdd a[kGroups];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int j = 32 * u + lane;
      ok[u] = j < cnt;
      c[u] = ok[u] ? codes[j * p.code_rs] : -1;
      gv[u] = ok[u] ? st.g[j] : 0.0f;
      hv[u] = ok[u] ? st.h[j] : 0.0f;
      ok[u] = ok[u] && static_cast<unsigned>(c[u]) < static_cast<unsigned>(p.bins);
    }
#pragma unroll
    for (int u = 0; u < kGroups; ++u) a[u] = ordered_add_plan(c[u], ok[u], lane);
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      ordered_add_apply(cg, cg + p.bins, c[u], gv[u], hv[u], ok[u], a[u]);
    }
  }

  __device__ void finish(float* out) {
    // out: this item's [fw][bins][2] cells, 8-byte aligned
    if (w >= fw) return;
    float2* o = reinterpret_cast<float2*>(out) + static_cast<size_t>(w) * p.bins;
    for (int b = lane; b < p.bins; b += 32) o[b] = make_float2(cg[b], cg[p.bins + b]);
  }
};

__global__ void __launch_bounds__(kMaxWarps * 32 + 64)
hist_wide_kernel(ring::Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  float* cells = reinterpret_cast<float*>(
      smem + ring::ring_bytes(p.stages, p.stage_words));
  const int w = t >> 5;
  OrderedConsumer con{p, cells + static_cast<size_t>(w) * 2 * p.bins, t & 31, w,
                      0};
  ring::walk(p, smem, con);
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns the first CUDA error
// (0 when the launch was accepted). Requires 1 <= bins <= 16384.
int tp_hist_wide(const void* binned, const void* order, const void* start,
                 const void* count, const void* grad, const void* hess,
                 void* out, int n, int f, int ldb, int k_fits, int m_slots,
                 int bins, void* stream) {
  if (bins < 1 || bins > kMaxBins || ldb < f) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (f <= 0 || m_slots <= 0 || k_fits <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  int max_smem = 0;
  cudaError_t err = ring::max_dynamic_smem(hist_wide_kernel, &max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  p.vec = false;  // the feature-major stage takes single codes
  p.k_fits = k_fits;
  p.m_slots = m_slots;
  p.bins = bins;
  p.producers = 64;
  p.code_rs = 1;
  p.code_cs = kCodeStride;
  // features per block: the fewest tiles of at most 8, balanced, and as
  // many as the shared memory holds beside a ring of at least 4 stages
  const int tiles0 = (f + kMaxWarps - 1) / kMaxWarps;
  int fpb = (f + tiles0 - 1) / tiles0;
  size_t smem = 0;
  for (;; --fpb) {
    p.stage_words = ring::stage_words_for(fpb * kCodeStride);
    const size_t stage_bytes = static_cast<size_t>(p.stage_words) * 4;
    p.stages = static_cast<int>(
        std::min<size_t>(8, std::max<size_t>(4, kRingBudget / stage_bytes)));
    smem = ring::ring_bytes(p.stages, p.stage_words) +
           2 * static_cast<size_t>(fpb) * bins * sizeof(float);
    if (smem <= static_cast<size_t>(max_smem) || fpb == 1) break;
  }
  if (smem > static_cast<size_t>(max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.fpb = fpb;
  p.feat_tiles = (f + fpb - 1) / fpb;
  p.consumers = 32 * fpb;
  // no more producer warps than stages: each stage has one filler at a time
  p.producers = std::min(p.producers, 32 * p.stages);
  const int threads = p.consumers + p.producers;
  const long long items =
      static_cast<long long>(p.feat_tiles) * m_slots * k_fits;
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  err = ring::persistent_grid(hist_wide_kernel, threads, smem,
                              static_cast<int>(items), &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  hist_wide_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

const char* tp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
