// Multi-tree traversal for serving a fitted tree ensemble on Hopper.
//
// Replaces the TPU kernel transmogrifai_tpu/models/serve_pallas.py:_serve_kernel
// (called through serve_trees_pallas). It computes the same function:
// out[r, t] = leaf_value[t, node] where node is reached by walking tree t
// level by level from the root, going right iff split_feat >= 0 and
// binned[r, split_feat] > split_bin, with child = 2 * node + right. A -1
// feature is a leaf that routes left; its index is never read.
//
// The TPU kernel recasts the walk as one-hot matrix products for the MXU.
// On this card the walk itself is the natural kernel: one thread per
// (row, tree) pair does `depth` dependent reads of split_feat/split_bin at
// [t, l, node] and one read of binned[r, f] per level, then one read of
// leaf_value[t, node]. Everything is integer compare logic, so the output
// is bit-identical to the plain PyTorch walk.
//
// What bounds it: reading the binned plane (at most N*F int32), the split
// arrays (at most 2*T*(2^depth - 1) int32: level l reads only node slots
// [0, 2^l), and only the nodes some row reaches) and the leaf table (at
// most T*2^depth f32), plus writing the N*T f32 output. In practice the `depth` dependent gathers per (row, tree)
// set the time: each level waits on the previous one's load. A block covers
// 32 rows x 8 trees; each warp walks one tree over 32 neighbouring rows, so
// the tree's level arrays are shared through L1/L2 and the binned rows are
// neighbours. The output tile goes through shared memory so that each row's
// 8 tree values are written as one contiguous segment.
//
// This first version aims to be right and simple; making it fast (keeping
// the binned rows or the top levels in shared memory, fusing the per-row
// reduction) is later work.
//
// Shapes: binned [N, F] int32; split_feat, split_bin [T, depth, W] int32
// with W >= 2^(depth-1); leaf_value [T, L] f32 with L = 2^depth; out [N, T]
// f32. Ragged N and T are masked here; nothing is padded in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;
constexpr int kTrees = 8;

__global__ void __launch_bounds__(kRows * kTrees)
serve_trees_kernel(const int32_t* __restrict__ binned,
                   const int32_t* __restrict__ split_feat,
                   const int32_t* __restrict__ split_bin,
                   const float* __restrict__ leaf_value,
                   float* __restrict__ out,
                   int n, int f, int t, int depth, int width, int leaf_width) {
  __shared__ float tile[kRows][kTrees + 1];
  const int lr = threadIdx.x;  // row within the block (fastest: one warp)
  const int lt = threadIdx.y;  // tree within the block
  const int row = blockIdx.x * kRows + lr;
  const int tree = blockIdx.y * kTrees + lt;
  if (row < n && tree < t) {
    const int32_t* codes = binned + static_cast<size_t>(row) * f;
    const size_t tree_base = static_cast<size_t>(tree) * depth * width;
    const int32_t* sf = split_feat + tree_base;
    const int32_t* sb = split_bin + tree_base;
    int node = 0;
    for (int l = 0; l < depth; ++l) {
      const int at = l * width + node;
      const int feat = __ldg(sf + at);
      int right = 0;
      if (feat >= 0) {
        right = __ldg(codes + feat) > __ldg(sb + at) ? 1 : 0;
      }
      node = 2 * node + right;
    }
    tile[lr][lt] =
        __ldg(leaf_value + static_cast<size_t>(tree) * leaf_width + node);
  }
  __syncthreads();
  // write back row-major: consecutive threads take consecutive trees of
  // one row
  const int lin = lt * kRows + lr;
  const int wr = lin / kTrees;
  const int wt = lin % kTrees;
  const int orow = blockIdx.x * kRows + wr;
  const int otree = blockIdx.y * kTrees + wt;
  if (orow < n && otree < t) {
    out[static_cast<size_t>(orow) * t + otree] = tile[wr][wt];
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError():
// 0 when the launch was accepted.
int tp_serve_trees(const void* binned, const void* split_feat,
                   const void* split_bin, const void* leaf_value, void* out,
                   int n, int f, int t, int depth, int width, int leaf_width,
                   void* stream) {
  if (n > 0 && t > 0) {
    const dim3 block(kRows, kTrees);
    const dim3 grid((n + kRows - 1) / kRows, (t + kTrees - 1) / kTrees);
    serve_trees_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(binned),
        static_cast<const int32_t*>(split_feat),
        static_cast<const int32_t*>(split_bin),
        static_cast<const float*>(leaf_value), static_cast<float*>(out), n, f,
        t, depth, width, leaf_width);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
