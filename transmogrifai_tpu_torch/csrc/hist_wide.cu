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
// Layout. The wrapper sorts each fit's live rows by slot (stably) and
// passes where each slot's run starts and how long it is. One block takes
// one (tile of up to 8 features, slot m, fit k); it has one warp per
// feature and walks the slot's run in tiles of 128 rows:
//  * every thread stages whole rows of the next tile (its grad, hess and
//    the tile's codes) into shared memory with cp.async while the current
//    tile is summed, and reads the row ids of the tile after that;
//  * each warp owns its feature's B x 2 cells in shared memory and adds
//    the tile 32 rows at a time with warp_ordered_add: lanes hold
//    consecutive rows, lanes with distinct codes add at once, lanes that
//    share a code add in lane (= row) order. K2's layout, one thread per
//    feature, would leave a 256-bin group of 3-10 features with 3-10 busy
//    threads per block walking every row serially.
//
// What bounds it: writing K*M*F*B*8 bytes of output (every slot of the
// chunk, live or not: at a 256-slot chunk and 256 bins that dwarfs the
// K*N*12 bytes of row data and the live codes read), and otherwise the
// serial walk of the longest run (the root level's single slot).
//
// Shapes: binned [N, F] int32; order [K, N] int32; start, count [K, M]
// int32; grad, hess [K, N] f32; out [K, M, F, B, 2] f32, every element
// written.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_ordered_add.cuh"

namespace {

constexpr int kMaxWarps = 8;   // features per block
constexpr int kTile = 128;     // rows staged per tile
constexpr int kRowsPerThread = kTile / 32;  // at least one warp per block
constexpr int kMaxBins = 16384;

__host__ __device__ inline size_t smem_bytes(int fpb, int bins) {
  // codes [2][fpb][kTile], grad and hess [2][kTile], cells [fpb][2][bins]
  return (2 * static_cast<size_t>(fpb) * kTile + 4 * kTile +
          2 * static_cast<size_t>(fpb) * bins) * sizeof(float);
}

struct Tile {
  int32_t* code;  // [2][fpb][kTile]
  float* g;       // [2][kTile]
  float* h;       // [2][kTile]
};

// Row ids of tile `tile` (-1 past the run) for this thread's staging rows.
__device__ __forceinline__ void load_rows(int (&r)[kRowsPerThread], int tile,
                                          int len, int t, int nthr,
                                          const int32_t* __restrict__ rows) {
#pragma unroll
  for (int u = 0; u < kRowsPerThread; ++u) {
    const int j = t + u * nthr;
    const int idx = tile * kTile + j;
    r[u] = (j < kTile && idx < len) ? __ldg(rows + idx) : -1;
  }
}

// Async copies of this thread's rows (ids in r) into buffer `buf`.
__device__ __forceinline__ void stage(const Tile& st, int buf,
                                      const int (&r)[kRowsPerThread], int t,
                                      int nthr, int fpb, int fw,
                                      const int32_t* __restrict__ binned,
                                      int f, int f0,
                                      const float* __restrict__ gk,
                                      const float* __restrict__ hk) {
#pragma unroll
  for (int u = 0; u < kRowsPerThread; ++u) {
    const int j = t + u * nthr;
    if (j < kTile && r[u] >= 0) {
      const int row = r[u];
      __pipeline_memcpy_async(st.g + buf * kTile + j, gk + row, sizeof(float));
      __pipeline_memcpy_async(st.h + buf * kTile + j, hk + row, sizeof(float));
      const int32_t* src = binned + static_cast<size_t>(row) * f + f0;
      int32_t* dst = st.code + static_cast<size_t>(buf) * fpb * kTile + j;
      for (int c = 0; c < fw; ++c) {
        __pipeline_memcpy_async(dst + c * kTile, src + c, sizeof(int32_t));
      }
    }
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(kMaxWarps * 32)
hist_wide_kernel(const int32_t* __restrict__ binned,
                 const int32_t* __restrict__ order,
                 const int32_t* __restrict__ start,
                 const int32_t* __restrict__ count,
                 const float* __restrict__ grad,
                 const float* __restrict__ hess,
                 float* __restrict__ out,
                 int n, int f, int m_slots, int bins, int fpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile st;
  st.code = reinterpret_cast<int32_t*>(smem);
  st.g = reinterpret_cast<float*>(st.code + 2 * fpb * kTile);
  st.h = st.g + 2 * kTile;
  float* cells = st.h + 2 * kTile;

  const int t = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = t & 31;
  const int w = t >> 5;
  const int f0 = blockIdx.x * fpb;
  const int fw = min(fpb, f - f0);
  const int m = blockIdx.y;
  const int k = blockIdx.z;
  const int run0 = __ldg(start + static_cast<size_t>(k) * m_slots + m);
  const int len = __ldg(count + static_cast<size_t>(k) * m_slots + m);
  const int32_t* rows = order + static_cast<size_t>(k) * n + run0;
  const float* gk = grad + static_cast<size_t>(k) * n;
  const float* hk = hess + static_cast<size_t>(k) * n;
  const bool mine = w < fw;
  float* cg = cells + static_cast<size_t>(w) * 2 * bins;
  float* ch = cg + bins;

  if (mine) {
    for (int b = lane; b < bins; b += 32) {
      cg[b] = 0.0f;
      ch[b] = 0.0f;
    }
  }
  const int tiles = (len + kTile - 1) / kTile;
  int r_next[kRowsPerThread];
#pragma unroll
  for (int u = 0; u < kRowsPerThread; ++u) r_next[u] = -1;
  if (tiles > 0) {
    int r0[kRowsPerThread];
    load_rows(r0, 0, len, t, nthr, rows);
    stage(st, 0, r0, t, nthr, fpb, fw, binned, f, f0, gk, hk);
    if (tiles > 1) load_rows(r_next, 1, len, t, nthr, rows);
    __pipeline_wait_prior(0);
  }
  __syncthreads();
  for (int i = 0; i < tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < tiles) {
      // stage tile i+1 (ids read an iteration ago), then read tile i+2's ids
      stage(st, buf ^ 1, r_next, t, nthr, fpb, fw, binned, f, f0, gk, hk);
      if (i + 2 < tiles) load_rows(r_next, i + 2, len, t, nthr, rows);
    }
    if (mine) {
      const int cnt = min(kTile, len - i * kTile);
      const int32_t* codes = st.code + (static_cast<size_t>(buf) * fpb + w) * kTile;
      const float* sg = st.g + buf * kTile;
      const float* sh = st.h + buf * kTile;
      for (int j0 = 0; j0 < cnt; j0 += 32) {
        const int j = j0 + lane;
        int c = -1;
        float gv = 0.0f, hv = 0.0f;
        if (j < cnt) {
          c = codes[j];
          gv = sg[j];
          hv = sh[j];
        }
        const bool ok = static_cast<unsigned>(c) < static_cast<unsigned>(bins);
        warp_ordered_add(cg, ch, c, gv, hv, ok, lane);
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  if (mine) {
    float2* o = reinterpret_cast<float2*>(
        out + ((static_cast<size_t>(k) * m_slots + m) * f + f0 + w) *
                  static_cast<size_t>(bins) * 2);
    for (int b = lane; b < bins; b += 32) o[b] = make_float2(cg[b], ch[b]);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns the first CUDA error
// (0 when the launch was accepted). Requires 1 <= bins <= 16384.
int tp_hist_wide(const void* binned, const void* order, const void* start,
                 const void* count, const void* grad, const void* hess,
                 void* out, int n, int f, int k_fits, int m_slots, int bins,
                 void* stream) {
  if (bins < 1 || bins > kMaxBins || m_slots > 65535 || k_fits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (f > 0 && m_slots > 0 && k_fits > 0) {
    int dev = 0, max_smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    // features per block: the fewest blocks of at most 8, balanced, and
    // as many as the shared memory holds
    const int feat_tiles = (f + kMaxWarps - 1) / kMaxWarps;
    int fpb = (f + feat_tiles - 1) / feat_tiles;
    while (fpb > 1 && smem_bytes(fpb, bins) > static_cast<size_t>(max_smem)) --fpb;
    const size_t smem = smem_bytes(fpb, bins);
    if (smem > static_cast<size_t>(max_smem)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    err = cudaFuncSetAttribute(hist_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((f + fpb - 1) / fpb, m_slots, k_fits);
    hist_wide_kernel<<<grid, 32 * fpb, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(binned),
        static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(start),
        static_cast<const int32_t*>(count), static_cast<const float*>(grad),
        static_cast<const float*>(hess), static_cast<float*>(out), n, f,
        m_slots, bins, fpb);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
