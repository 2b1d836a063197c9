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
// Layout. The wrapper sorts each fit's live rows by slot (a stable sort, so
// rows keep ascending order within a slot) and passes, per (k, m), where
// that slot's run starts in `order` and how long it is. One block takes one
// (tile of kFeatTile features, m, k) and walks the run in tiles of kTile
// rows:
//  * producer threads stage a tile's row ids, grad, hess and the tile's
//    [kTile, kFeatTile] codes into shared memory with cp.async, so a whole
//    tile's loads are in flight at once; they stage tile i+1 (and read the
//    row ids of tile i+2) while tile i is summed;
//  * consumer threads (the first kFeatTile) own one feature each and add
//    the tile's rows in order into that feature's B x 2 cells: registers
//    for B = 2 (the indicator columns, most of the flagship vector),
//    shared memory for wider bins. No two threads share a cell: no
//    atomics, and the order of every cell's adds is fixed.
//
// What bounds it: reading each live (row, feature) code once, plus
// K*N*(4+4+4) bytes of order/grad/hess, and writing K*M*F*B*8 bytes; and
// 2*K*N*F float32 adds. This design reads the codes once per fit, not
// once, since each fit walks its own rows. A slot's run is one serial walk
// per feature, so a root level (one slot holding every row) is bound by
// that walk; the staging keeps it fed from shared memory. The wrapper
// leaves out rows of zero weight, which change no sum.
//
// Shapes: binned [N, F] int32 with codes in [0, B) (a code outside that
// range is skipped); order [K, N] int32; start, count [K, M] int32;
// grad, hess [K, N] f32; out [K, M, F, B, 2] f32, every element written.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 32 consumer threads (= features) and 96 producer threads per block, and
// tiles of 128 rows: on an H100 the shape that ran the main path's
// launches fastest among 16-64 features x 32-256 rows (a root launch of
// the indicator group and skewed deeper levels; more rows per tile help
// the long runs, fewer the occupancy of short ones)
constexpr int kFeatTile = 32;
constexpr int kProducers = 3 * kFeatTile;
constexpr int kThreads = kFeatTile + kProducers;
constexpr int kTile = 128;  // rows staged per tile
constexpr int kRowStep = kProducers / kFeatTile;  // rows apart per producer
constexpr int kBatch = 8;  // copies issued per batch of row ids
constexpr int kMaxBins = 64;

struct Stage {
  int32_t code[2][kTile * kFeatTile];
  float g[2][kTile];
  float h[2][kTile];
  int32_t row[2][kTile];
};

// Producer thread p (0..kProducers-1) issues the async copies of a tile of
// `cnt` rows into buffer `buf` (its row ids already in st.row[buf]).
__device__ __forceinline__ void stage_tile(Stage& st, int buf, int cnt, int p,
                                           const int32_t* __restrict__ binned,
                                           const float* __restrict__ gk,
                                           const float* __restrict__ hk,
                                           int f, int f0, int fw) {
  // thread p copies feature column c of rows i0, i0 + kRowStep, ...: a
  // warp's copies of one row are contiguous. Row ids are read from shared
  // memory kBatch at a time ahead of the copies that use them (a copy is
  // ordered with the shared-memory reads around it).
  const int c = p % kFeatTile;
  if (c < fw) {
    const int32_t* col = binned + f0 + c;
    int32_t* dst = st.code[buf] + c;
    int i = p / kFeatTile;
    for (; i + (kBatch - 1) * kRowStep < cnt; i += kBatch * kRowStep) {
      int32_t r[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) r[u] = st.row[buf][i + u * kRowStep];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        __pipeline_memcpy_async(dst + (i + u * kRowStep) * kFeatTile,
                                col + static_cast<size_t>(r[u]) * f,
                                sizeof(int32_t));
      }
    }
    for (; i < cnt; i += kRowStep) {
      __pipeline_memcpy_async(dst + i * kFeatTile,
                              col + static_cast<size_t>(st.row[buf][i]) * f,
                              sizeof(int32_t));
    }
  }
  for (int i = p; i < cnt; i += kProducers) {
    const int r = st.row[buf][i];
    __pipeline_memcpy_async(&st.g[buf][i], gk + r, sizeof(float));
    __pipeline_memcpy_async(&st.h[buf][i], hk + r, sizeof(float));
  }
  __pipeline_commit();
}

// Producers read the row ids of tile `tile` (if it exists) into st.row[buf].
__device__ __forceinline__ void load_rows(Stage& st, int buf, int tile,
                                          int len, int p,
                                          const int32_t* __restrict__ rows) {
  const int base = tile * kTile;
  const int cnt = min(kTile, len - base);
  for (int i = p; i < cnt; i += kProducers) st.row[buf][i] = __ldg(rows + base + i);
}

// kBins2: the bin count is 2 and the cells live in registers; otherwise
// they live in shared memory after the stage, [bins][kFeatTile] for grad
// then for hess (thread t's cells in bank t % 32).
template <bool kBins2>
__global__ void __launch_bounds__(kThreads)
hist_binloop_kernel(const int32_t* __restrict__ binned,
                    const int32_t* __restrict__ order,
                    const int32_t* __restrict__ start,
                    const int32_t* __restrict__ count,
                    const float* __restrict__ grad,
                    const float* __restrict__ hess,
                    float* __restrict__ out,
                    int n, int f, int m_slots, int bins) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage& st = *reinterpret_cast<Stage*>(smem);
  float* cg = reinterpret_cast<float*>(smem + sizeof(Stage));
  float* ch = cg + bins * kFeatTile;

  const int t = threadIdx.x;
  const int f0 = blockIdx.x * kFeatTile;
  const int fw = min(kFeatTile, f - f0);
  const int m = blockIdx.y;
  const int k = blockIdx.z;
  const int run0 = __ldg(start + static_cast<size_t>(k) * m_slots + m);
  const int len = __ldg(count + static_cast<size_t>(k) * m_slots + m);
  const int32_t* rows = order + static_cast<size_t>(k) * n + run0;
  const float* gk = grad + static_cast<size_t>(k) * n;
  const float* hk = hess + static_cast<size_t>(k) * n;
  const bool consumer = t < kFeatTile;
  const bool mine = consumer && t < fw;
  const int p = t - kFeatTile;

  float g0 = 0.0f, g1 = 0.0f, h0 = 0.0f, h1 = 0.0f;
  if (!kBins2 && consumer) {
    for (int b = 0; b < bins; ++b) {
      cg[b * kFeatTile + t] = 0.0f;
      ch[b * kFeatTile + t] = 0.0f;
    }
  }
  const int tiles = (len + kTile - 1) / kTile;
  if (tiles > 0) {
    // prologue: row ids of tiles 0 and 1, then tile 0 staged
    if (!consumer) {
      load_rows(st, 0, 0, len, p, rows);
      if (tiles > 1) load_rows(st, 1, 1, len, p, rows);
    }
    __syncthreads();
    if (!consumer) {
      stage_tile(st, 0, min(kTile, len), p, binned, gk, hk, f, f0, fw);
      __pipeline_wait_prior(0);
    }
    __syncthreads();
  }
  for (int i = 0; i < tiles; ++i) {
    const int buf = i & 1;
    if (!consumer) {
      // stage tile i+1 (its row ids were read an iteration ago), then read
      // the row ids of tile i+2 into the buffer tile i's ids leave free
      if (i + 1 < tiles) {
        stage_tile(st, buf ^ 1, min(kTile, len - (i + 1) * kTile), p, binned,
                   gk, hk, f, f0, fw);
      }
      if (i + 2 < tiles) load_rows(st, buf, i + 2, len, p, rows);
      __pipeline_wait_prior(0);
    } else if (mine) {
      const int cnt = min(kTile, len - i * kTile);
      const int32_t* codes = st.code[buf] + t;
      const float* sg = st.g[buf];
      const float* sh = st.h[buf];
      if (kBins2) {
#pragma unroll 8
        for (int j = 0; j < cnt; ++j) {
          const int c = codes[j * kFeatTile];
          const float gv = sg[j];
          const float hv = sh[j];
          if (c == 0) {
            g0 += gv;
            h0 += hv;
          } else if (c == 1) {
            g1 += gv;
            h1 += hv;
          }
        }
      } else {
        // the next row's code and values are read before this row's
        // read-modify-writes, which the compiler may not reorder with them
        int c = codes[0];
        float gv = sg[0], hv = sh[0];
        for (int j = 0; j < cnt; ++j) {
          const int jn = min(j + 1, cnt - 1);
          const int c_next = codes[jn * kFeatTile];
          const float g_next = sg[jn], h_next = sh[jn];
          if (c >= 0 && c < bins) {
            float* pg = cg + c * kFeatTile + t;
            float* ph = ch + c * kFeatTile + t;
            const float a = *pg, b = *ph;
            *pg = a + gv;
            *ph = b + hv;
          }
          c = c_next;
          gv = g_next;
          hv = h_next;
        }
      }
    }
    __syncthreads();
  }
  if (mine) {
    float* o = out + ((static_cast<size_t>(k) * m_slots + m) * f + f0 + t) *
                         static_cast<size_t>(bins) * 2;
    if (kBins2) {
      reinterpret_cast<float4*>(o)[0] = make_float4(g0, h0, g1, h1);
    } else {
      for (int b = 0; b < bins; ++b) {
        o[2 * b] = cg[b * kFeatTile + t];
        o[2 * b + 1] = ch[b * kFeatTile + t];
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns the first CUDA error
// (0 when the launch was accepted). Requires 1 <= bins <= 64.
int tp_hist_binloop(const void* binned, const void* order, const void* start,
                    const void* count, const void* grad, const void* hess,
                    void* out, int n, int f, int k_fits, int m_slots, int bins,
                    void* stream) {
  if (bins < 1 || bins > kMaxBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (f > 0 && m_slots > 0 && k_fits > 0) {
    const dim3 grid((f + kFeatTile - 1) / kFeatTile, m_slots, k_fits);
    const bool bins2 = bins == 2;
    const size_t smem = sizeof(Stage) +
        (bins2 ? 0 : 2 * static_cast<size_t>(bins) * kFeatTile * sizeof(float));
    auto kernel = bins2 ? hist_binloop_kernel<true> : hist_binloop_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(binned),
        static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(start),
        static_cast<const int32_t*>(count), static_cast<const float*>(grad),
        static_cast<const float*>(hess), static_cast<float*>(out), n, f,
        m_slots, bins);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
