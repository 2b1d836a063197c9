// The per-row tree sum of a served ensemble on Hopper: the reduction that
// follows the traversal K1 (serve_trees.cu). It replaces no TPU kernel: the
// JAX package's serving route for batches of up to 16384 rows adds the
// trees on the host (native/tptpu_native.cpp tp_tree_predict_sum, through
// transmogrifai_tpu/models/trees.py _leaf_sum), and this reproduces that
// arithmetic bit for bit. For leaf values per_tree [N, T] f32:
//   sum[r]           = ((0 + per_tree[r, 0]) + per_tree[r, 1]) + ... in
//                      tree order, one f32 rounding per add
//   boosted: out[r]  = base + (eta * sum[r])  (two roundings, no FMA)
//   forest:  out[r]  = sum[r] / T             (a true division)
// the same bits as the plain version (tree_sum.tree_sum_plain). The
// epilogues use the _rn intrinsics, which nvcc never contracts into a fused
// multiply-add, so the result does not depend on -fmad.
//
// One launch. A block owns kRows consecutive rows, one summing lane each.
// The rows' values arrive in tiles of kCols trees: each thread loads its
// column of the tile for every row into registers (a warp reads 32
// consecutive trees of one row, so the loads coalesce, and all of a
// thread's loads are in flight together), stores them into shared memory,
// then each summing lane adds its row's kCols values in order. The tile's
// rows are padded by one float, so the summing warp's reads and the
// threads' stores fall in 32 different banks.
//
// What bounds it: reading per_tree once (4 N T bytes) and writing out
// (4 N). The adds of a row are a dependent chain of T adds.
//
// Shapes: per_tree [N, T] f32, row-major and contiguous; out [N] f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;      // rows per block: one summing lane each
constexpr int kThreads = 128;  // threads per block (4 warps load a tile)
constexpr int kCols = kThreads;  // trees per staged tile: one per thread

template <bool kBoosted>
__global__ void __launch_bounds__(kThreads)
tree_sum_kernel(const float* __restrict__ per_tree, float* __restrict__ out,
                int64_t n, int64_t t, float base, float eta) {
  __shared__ float tile[kRows][kCols + 1];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(n - row0 < kRows ? n - row0 : kRows);
  const int lane_row = threadIdx.x;
  float acc = 0.0f;
  for (int64_t c0 = 0; c0 < t; c0 += kCols) {
    const int cols = static_cast<int>(t - c0 < kCols ? t - c0 : kCols);
    const bool live = static_cast<int>(threadIdx.x) < cols;
    const float* col = per_tree + row0 * t + c0 + threadIdx.x;
    float v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      v[r] = (live && r < rows) ? __ldg(col + r * t) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) tile[r][threadIdx.x] = v[r];
    __syncthreads();
    if (lane_row < rows) {
      const float* mine = tile[lane_row];
      if (cols == kCols) {
#pragma unroll 16
        for (int c = 0; c < kCols; ++c) acc = __fadd_rn(acc, mine[c]);
      } else {
        for (int c = 0; c < cols; ++c) acc = __fadd_rn(acc, mine[c]);
      }
    }
    __syncthreads();
  }
  if (lane_row < rows) {
    out[row0 + lane_row] =
        kBoosted ? __fadd_rn(base, __fmul_rn(eta, acc))
                 : __fdiv_rn(acc, static_cast<float>(t));
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns the first CUDA error (0
// when the launch was accepted). boosted: 1 for base + eta * sum, 0 for the
// forest mean.
int tp_tree_sum(const void* per_tree, void* out, int64_t n, int64_t t,
                int boosted, float base, float eta, void* stream) {
  if (n < 0 || t < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (n + kRows - 1) / kRows;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const float*>(per_tree);
  auto* o = static_cast<float*>(out);
  if (boosted) {
    tree_sum_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        in, o, n, t, base, eta);
  } else {
    tree_sum_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        in, o, n, t, base, eta);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
