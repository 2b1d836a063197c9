// Fused best-split search on Hopper (kernel K4 of the port).
//
// Replaces the TPU kernel transmogrifai_tpu/models/hist_pallas.py:
// _split_kernel (called through build_best_split_pallas). For K fits
// sharing the codes binned [N, F] and M node slots it returns, per (k, m),
// the best split over the features the fit's mask enables:
//   hist[f, b]  = (sum grad, sum hess) of slot m's rows with code b
//   GL, HL      = prefix sums over bins 0..t, G, H the totals
//   gain(f, t)  = 0.5 * (GL^2/(HL+lam) + GR^2/(HR+lam) - G^2/(H+lam)) - gam
// over thresholds t = 0..B-2 where HL >= mcw, HR >= mcw and
// feat_mask[k, f] > 0; the first (f, t) in (feature, bin) order at the
// maximum (a NaN counts as the maximum), or feat -1, bin 0, gain -inf where
// no threshold is valid. Only [K, M] leaves the kernel pair; no histogram
// is written to device memory.
//
// The TPU kernel builds the histogram with one-hot products, its prefix
// sums and totals with triangular matrix products. Here the arithmetic is
// the port's two-phase split search (models/hist.py: the scatter histogram
// then split_search) in the same order, so the result equals it bit for
// bit: each histogram cell is a float32 sum in ascending row order (the
// wrapper's stable slot sort; lanes sharing a bin add in row order, see
// warp_ordered_add.cuh); the prefix is sequential within blocks of 16 bins,
// each block offset by the running total before it (XLA's cumsum order);
// the total is summed in zero-padded windows of 32 bins, front-padded by
// half the padding, then over the windows (XLA's reduction order); every
// add, multiply and divide is a separately rounded __f*_rn intrinsic, so
// the compiler contracts none of them into a fused multiply-add.
//
// Layout. Pass 1: one block per (tile of feat_tile features, slot m, fit
// k), 8 warps. The block walks slot m's run of the sorted rows in tiles of
// 128: it stages row ids, grad, hess and the tile's codes in shared memory
// and each warp adds its features' rows into their cells (shared memory,
// [feat_tile][2][B]). Then one thread per feature scans its bins for the
// feature's best threshold, and one thread keeps the tile's best feature.
// Pass 2: one thread per (k, m) takes the best over the feature tiles, the
// lowest tile on equal gain.
//
// What bounds it: reading each live (row, feature) code once and K*N*12
// bytes of row data (node order, grad, hess), and the gain's arithmetic,
// 2 divides and ~12 other operations per (k, m, f, threshold). The
// reference runs it at N <= 2048 rows; the kernel takes any N and 2 <= B
// <= 128.
//
// Shapes: binned [N, F] int32; order [K, N] int32; start, count [K, M]
// int32; grad, hess [K, N] f32; feat_mask [K, F] f32; lam, gam, mcw [K]
// f32; scratch part_* [K, tiles, M]; out gain [K, M] f32, feat, bin [K, M]
// int32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_ordered_add.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 128;  // rows staged per tile
constexpr int kMaxBins = 128;
constexpr int kMaxFeatTile = 32;
constexpr int kReduceWindow = 32;
constexpr int kCumsumBlock = 16;

__host__ __device__ inline size_t smem_bytes(int feat_tile, int bins) {
  // cells [feat_tile][2][bins], codes [feat_tile][kTile], row id, grad and
  // hess [kTile], each feature's best gain and bin [feat_tile]
  return (2 * static_cast<size_t>(feat_tile) * bins +
          static_cast<size_t>(feat_tile) * kTile + 3 * kTile +
          2 * static_cast<size_t>(feat_tile)) * 4;
}

// a > b in argmax's order: a NaN beats every number, and nothing beats NaN
__device__ __forceinline__ bool better(float a, float b) {
  return a > b || (isnan(a) && !isnan(b));
}

// The total of x[0..n) in the order XLA's CPU backend reduces (n <= 1024):
// sequential from 0 for n <= 32, otherwise zero-padded windows of 32 (half
// the padding in front), each summed in order, then the window sums.
__device__ float xla_sum(const float* x, int n) {
  if (n <= kReduceWindow) {
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, x[i]);
    return acc;
  }
  const int nb = (n + kReduceWindow - 1) / kReduceWindow;
  const int front = (nb * kReduceWindow - n) / 2;
  float tot = 0.0f;
  for (int wnd = 0; wnd < nb; ++wnd) {
    float acc = 0.0f;
    for (int p = 0; p < kReduceWindow; ++p) {
      const int i = wnd * kReduceWindow + p - front;
      acc = __fadd_rn(acc, (i >= 0 && i < n) ? x[i] : 0.0f);
    }
    tot = __fadd_rn(tot, acc);
  }
  return tot;
}

__global__ void __launch_bounds__(kThreads)
best_split_tiles(const int32_t* __restrict__ binned,
                 const int32_t* __restrict__ order,
                 const int32_t* __restrict__ start,
                 const int32_t* __restrict__ count,
                 const float* __restrict__ grad,
                 const float* __restrict__ hess,
                 const float* __restrict__ feat_mask,
                 const float* __restrict__ lam_k,
                 const float* __restrict__ gam_k,
                 const float* __restrict__ mcw_k,
                 float* __restrict__ part_gain,
                 int32_t* __restrict__ part_feat,
                 int32_t* __restrict__ part_bin,
                 int n, int f, int m_slots, int bins, int feat_tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cells = reinterpret_cast<float*>(smem);
  int32_t* s_code = reinterpret_cast<int32_t*>(cells + 2 * feat_tile * bins);
  int32_t* s_row = s_code + feat_tile * kTile;
  float* s_g = reinterpret_cast<float*>(s_row + kTile);
  float* s_h = s_g + kTile;
  float* s_best_gain = s_h + kTile;
  int32_t* s_best_bin = reinterpret_cast<int32_t*>(s_best_gain + feat_tile);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int f0 = tile * feat_tile;
  const int fw = min(feat_tile, f - f0);
  const int m = blockIdx.y;
  const int k = blockIdx.z;
  const int run0 = __ldg(start + static_cast<size_t>(k) * m_slots + m);
  const int len = __ldg(count + static_cast<size_t>(k) * m_slots + m);
  const int32_t* rows = order + static_cast<size_t>(k) * n + run0;
  const float* gk = grad + static_cast<size_t>(k) * n;
  const float* hk = hess + static_cast<size_t>(k) * n;

  for (int i = t; i < 2 * fw * bins; i += kThreads) cells[i] = 0.0f;
  for (int base = 0; base < len; base += kTile) {
    const int cnt = min(kTile, len - base);
    __syncthreads();  // the cells are zeroed and the last tile is summed
    for (int j = t; j < cnt; j += kThreads) {
      const int row = __ldg(rows + base + j);
      s_row[j] = row;
      s_g[j] = __ldg(gk + row);
      s_h[j] = __ldg(hk + row);
    }
    __syncthreads();
    // consecutive threads read consecutive features of one row
    for (int i = t; i < cnt * fw; i += kThreads) {
      const int j = i / fw, c = i - j * fw;
      s_code[c * kTile + j] =
          __ldg(binned + static_cast<size_t>(s_row[j]) * f + f0 + c);
    }
    __syncthreads();
    for (int c = w; c < fw; c += kWarps) {
      float* cg = cells + 2 * c * bins;
      for (int j0 = 0; j0 < cnt; j0 += 32) {
        const int j = j0 + lane;
        int code = -1;
        float gv = 0.0f, hv = 0.0f;
        if (j < cnt) {
          code = s_code[c * kTile + j];
          gv = s_g[j];
          hv = s_h[j];
        }
        const bool ok = static_cast<unsigned>(code) < static_cast<unsigned>(bins);
        warp_ordered_add(cg, cg + bins, code, gv, hv, ok, lane);
      }
    }
  }
  __syncthreads();
  if (t < fw) {
    const float* cg = cells + 2 * t * bins;
    const float* ch = cg + bins;
    const float lam = __ldg(lam_k + k);
    const float gam = __ldg(gam_k + k);
    const float mcw = __ldg(mcw_k + k);
    float best = -INFINITY;
    int best_bin = -1;
    if (__ldg(feat_mask + static_cast<size_t>(k) * f + f0 + t) > 0.0f) {
      const float gt = xla_sum(cg, bins);
      const float ht = xla_sum(ch, bins);
      const float parent = __fdiv_rn(__fmul_rn(gt, gt), __fadd_rn(ht, lam));
      float loc_g = 0.0f, loc_h = 0.0f, off_g = 0.0f, off_h = 0.0f;
      for (int j = 0; j + 1 < bins; ++j) {
        // XLA's cumsum: sequential within a block of 16, then the block
        // offset by the (offset) last prefix of the block before
        if (j % kCumsumBlock == 0) {
          loc_g = cg[j];
          loc_h = ch[j];
        } else {
          loc_g = __fadd_rn(loc_g, cg[j]);
          loc_h = __fadd_rn(loc_h, ch[j]);
        }
        const float gl = j < kCumsumBlock ? loc_g : __fadd_rn(loc_g, off_g);
        const float hl = j < kCumsumBlock ? loc_h : __fadd_rn(loc_h, off_h);
        if (j % kCumsumBlock == kCumsumBlock - 1) {
          off_g = gl;
          off_h = hl;
        }
        const float gr = __fsub_rn(gt, gl);
        const float hr = __fsub_rn(ht, hl);
        const float left = __fdiv_rn(__fmul_rn(gl, gl), __fadd_rn(hl, lam));
        const float right = __fdiv_rn(__fmul_rn(gr, gr), __fadd_rn(hr, lam));
        const float gain = __fsub_rn(
            __fmul_rn(0.5f, __fsub_rn(__fadd_rn(left, right), parent)), gam);
        if (hl >= mcw && hr >= mcw && better(gain, best)) {
          best = gain;
          best_bin = j;
        }
      }
    }
    s_best_gain[t] = best;
    s_best_bin[t] = best_bin;
  }
  __syncthreads();
  if (t == 0) {
    float best = -INFINITY;
    int feat = -1, bin = 0;
    for (int c = 0; c < fw; ++c) {
      if (s_best_bin[c] >= 0 && better(s_best_gain[c], best)) {
        best = s_best_gain[c];
        feat = f0 + c;
        bin = s_best_bin[c];
      }
    }
    const size_t o = (static_cast<size_t>(k) * tiles + tile) * m_slots + m;
    part_gain[o] = best;
    part_feat[o] = feat;
    part_bin[o] = bin;
  }
}

// Pass 2: the best over the feature tiles, the lowest tile on equal gain.
__global__ void best_split_reduce(const float* __restrict__ part_gain,
                                  const int32_t* __restrict__ part_feat,
                                  const int32_t* __restrict__ part_bin,
                                  float* __restrict__ gain,
                                  int32_t* __restrict__ feat,
                                  int32_t* __restrict__ bin,
                                  int k_fits, int tiles, int m_slots) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= k_fits * m_slots) return;
  const int k = idx / m_slots, m = idx - k * m_slots;
  float best = -INFINITY;
  int bf = -1, bb = 0;
  for (int i = 0; i < tiles; ++i) {
    const size_t o = (static_cast<size_t>(k) * tiles + i) * m_slots + m;
    if (part_feat[o] >= 0 && better(part_gain[o], best)) {
      best = part_gain[o];
      bf = part_feat[o];
      bb = part_bin[o];
    }
  }
  gain[idx] = best;
  feat[idx] = bf;
  bin[idx] = bb;
}

}  // namespace

extern "C" {

// Launches both passes on `stream` (a cudaStream_t) and returns the first
// CUDA error (0 when both launches were accepted). Requires 2 <= bins <=
// 128 and 1 <= feat_tile <= 32; the part_* scratch holds
// [k_fits, ceil(f / feat_tile), m_slots] entries.
int tp_best_split(const void* binned, const void* order, const void* start,
                  const void* count, const void* grad, const void* hess,
                  const void* feat_mask, const void* lam, const void* gam,
                  const void* mcw, void* part_gain, void* part_feat,
                  void* part_bin, void* gain, void* feat, void* bin, int n,
                  int f, int k_fits, int m_slots, int bins, int feat_tile,
                  void* stream) {
  if (bins < 2 || bins > kMaxBins || feat_tile < 1 ||
      feat_tile > kMaxFeatTile || m_slots > 65535 || k_fits > 65535 || f < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m_slots > 0 && k_fits > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const int tiles = (f + feat_tile - 1) / feat_tile;
    const size_t smem = smem_bytes(feat_tile, bins);
    cudaError_t err = cudaFuncSetAttribute(
        best_split_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    best_split_tiles<<<dim3(tiles, m_slots, k_fits), kThreads, smem, s>>>(
        static_cast<const int32_t*>(binned),
        static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(start),
        static_cast<const int32_t*>(count), static_cast<const float*>(grad),
        static_cast<const float*>(hess), static_cast<const float*>(feat_mask),
        static_cast<const float*>(lam), static_cast<const float*>(gam),
        static_cast<const float*>(mcw), static_cast<float*>(part_gain),
        static_cast<int32_t*>(part_feat), static_cast<int32_t*>(part_bin), n, f,
        m_slots, bins, feat_tile);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int total = k_fits * m_slots;
    best_split_reduce<<<(total + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(part_gain),
        static_cast<const int32_t*>(part_feat),
        static_cast<const int32_t*>(part_bin), static_cast<float*>(gain),
        static_cast<int32_t*>(feat), static_cast<int32_t*>(bin), k_fits, tiles,
        m_slots);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
