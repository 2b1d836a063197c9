// Multi-tree traversal for serving a fitted tree ensemble on Hopper.
//
// Replaces the TPU kernel transmogrifai_tpu/models/serve_pallas.py:_serve_kernel
// (called through serve_trees_pallas). It computes the same function:
// out[r, t] = leaf_value[t, node] where node is reached by walking tree t
// level by level from the root, going right iff the node's feature is not
// -1 and binned[r, feature] > its split bin, with child = 2 * node + right.
// A -1 feature routes left and the walk goes on below it. Everything is
// integer compare logic, so the output is bit-identical to the plain walk.
//
// Node layout (made by the wrapper: once per model on the host, or per call
// from the split arrays). A tree's internal nodes are numbered in heap
// order (level l, node m is node 2^l - 1 + m; the children of node h are
// 2h + 1 and 2h + 2). A node is one 32-bit word, feature << 16 | split bin
// with bins in [0, 0xFFFE], or, where the word cannot hold the model
// (F > 65536, or a split bin outside [0, 0xFFFE]), two words {feature,
// bin} ("wide"): the same kernel, templated on the node type. A leaf (-1)
// is feature 0 with bin 0xFFFF (wide: INT32_MAX), above every code it is
// compared with, so it routes left and the walk goes on below it with no
// test of its own. Trees are grouped in tiles of tile_trees (a power of two,
// 8-32): `top` [tiles, Ps, tile_trees] holds the top top_levels levels (Ps
// = 2^top_levels - 1 nodes, at most 10 levels) with the tile's trees
// interleaved, node i of the tile's tree j at i * tile_trees + j, so the
// lanes of a warp that walk different trees of a tile read different
// shared-memory banks. `leaf_tiles` [tiles, 2^depth, tile_trees] has the
// leaves interleaved the same way (depth <= 10); levels 10 and below sit
// per tree in `bottom` [T, 2^depth - 1 - Ps].
//
// Design. Persistent blocks (1024 threads, one per SM) walk (row chunk,
// tree tile) work items; block b takes a contiguous run of them. A tile's
// nodes (and, with stage_leaves, its leaves) reach shared memory by bulk
// asynchronous copies (cp.async.bulk) under an mbarrier; with two buffers
// the next tile is copied while the current one is walked. Lanes go on
// trees: a warp's lanes take tile_trees trees of 32 / tile_trees rows, and
// each thread walks kWalks (2, or 1 where a row chunk is small) rows at
// once, level by level. Row codes are read from global memory through L1,
// or staged per row chunk in shared memory, narrowed to the bytes that the
// model's split bins need (codes above saturate, which keeps `code > bin`
// exact).
//
// The items run in one of two orders, chosen by the wrapper from the bytes
// each moves: tile-major (a block keeps one tile for many small row chunks:
// the codes are read again for every tile, the trees about once per block;
// best when rows are narrow) or chunk-major (a block keeps one row chunk's
// staged codes and streams every tile past them: the codes are read about
// once, the trees once per chunk; best for wide rows).
//
// What bounds it: the card's least time is the bytes, at 3.35 TB/s: each
// binned code the walks read, each node and leaf they visit, once, and the
// N*T f32 output written once. The kernel is far from that: a walk is
// 2 * depth dependent loads (node, then code) and a handful of instructions
// a level, so narrow rows leave it bound by instruction throughput and
// latency (PERF.md), and wide rows by moving the codes and trees from L2 to
// the SMs, which the item order keeps low.
//
// Shapes: binned [N, F] int32; leaf_value [T, 2^depth] f32; out [N, T]
// f32. Ragged N and T are masked here; the tiles are padded with leaf-only
// trees.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_ring.cuh"

namespace {

constexpr int kThreads = 1024;

struct Params {
  const int32_t* binned;    // [N, F]
  const void* top;          // [tiles, Ps, tile_trees] nodes
  const void* bottom;       // [T, P - Ps] nodes
  const float* leaf;        // [T, 2^depth]
  const float* leaf_tiles;  // [tiles, 2^depth, tile_trees]
  float* out;               // [N, T]
  int n, f, t, depth, top_levels, tile_trees;
  int chunk_rows, chunks, tiles, items;
  int tile_major;           // item order
  int stage_leaves;         // copy the tile's leaves beside its nodes
  int code_stride;          // staged codes per row, in elements
  int buffers;              // tile buffers: 1, or 2 to copy ahead
  uint32_t node_bytes;      // one tile's nodes
  uint32_t buffer_bytes;    // one tile buffer (nodes, 16-aligned, + leaves)
};

template <int kCodeBytes>
struct CodeType {
  using T = int32_t;  // 0: read from global memory; 4: staged as is
};
template <>
struct CodeType<1> {
  using T = uint8_t;
};
template <>
struct CodeType<2> {
  using T = uint16_t;
};

// A node's feature and split bin. Leaves are (0, 0xFFFF) as a word and
// (0, INT_MAX) as a pair: no code a walk compares them with is above the
// bin, so they route left with no test of their own.
__device__ __forceinline__ void decode(uint32_t w, int& feat, int& bin) {
  feat = static_cast<int>(w >> 16);
  bin = static_cast<int>(w & 0xFFFFu);
}

__device__ __forceinline__ void decode(int2 w, int& feat, int& bin) {
  feat = w.x;
  bin = w.y;
}

// A code read from global memory. A word's bins are below 0xFFFF, so a code
// clamped to 0xFFFF compares with them as the code does, and a leaf's 0xFFFF
// is above every clamped code.
__device__ __forceinline__ int global_code(const int32_t* row, int feat,
                                           uint32_t) {
  return min(__ldg(row + feat), 0xFFFF);
}

__device__ __forceinline__ int global_code(const int32_t* row, int feat, int2) {
  return __ldg(row + feat);
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          ring::smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(ring::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(ring::smem_addr(bar))
      : "memory");
}

template <int kCodeBytes>
__device__ __forceinline__ typename CodeType<kCodeBytes>::T narrow(int v) {
  if constexpr (kCodeBytes == 1) {
    return static_cast<uint8_t>(min(max(v, 0), 255));
  } else if constexpr (kCodeBytes == 2) {
    return static_cast<uint16_t>(min(max(v, 0), 65535));
  } else {
    return v;
  }
}

template <typename NodeT, int kCodeBytes, int kWalks>
__global__ void __launch_bounds__(kThreads, 1)
serve_trees_kernel(const Params p) {
  using CodeT = typename CodeType<kCodeBytes>::T;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2];
  const int tt = p.tile_trees;
  const int ps = (1 << p.top_levels) - 1;
  const int pb = (1 << p.depth) - 1 - ps;
  const int leaves = 1 << p.depth;
  const int lane_tree = threadIdx.x % tt;
  const int rgroup = threadIdx.x / tt;
  const int groups = kThreads / tt;
  const uint32_t node_region = (p.node_bytes + 15u) & ~15u;
  const uint32_t node_stride = tt * sizeof(NodeT);  // bytes between levels' nodes
  CodeT* codes_s = reinterpret_cast<CodeT*>(smem + p.buffers * p.buffer_bytes);
  const NodeT* bottom = static_cast<const NodeT*>(p.bottom);
  const int i0 = static_cast<int>(static_cast<long long>(blockIdx.x) *
                                  p.items / gridDim.x);
  const int i1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) *
                                  p.items / gridDim.x);
  if (threadIdx.x == 0) {
    ring::bar_init(&bars[0], 1);
    ring::bar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto tile_of = [&](int item) {
    return p.tile_major ? item / p.chunks : item % p.tiles;
  };
  auto chunk_of = [&](int item) {
    return p.tile_major ? item % p.chunks : item / p.tiles;
  };
  // thread 0: copy `tile` into buffer b
  auto copy_tile = [&](int tile, int b) {
    unsigned char* dst = smem + b * p.buffer_bytes;
    const uint32_t leaf_bytes =
        p.stage_leaves ? static_cast<uint32_t>(leaves) * tt * 4u : 0u;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bar_expect(&bars[b], p.node_bytes + leaf_bytes);
    if (p.node_bytes) {
      bulk_copy(dst, static_cast<const unsigned char*>(p.top) +
                         static_cast<size_t>(tile) * p.node_bytes,
                p.node_bytes, &bars[b]);
    }
    if (leaf_bytes) {
      bulk_copy(dst + node_region,
                p.leaf_tiles + static_cast<size_t>(tile) * leaves * tt,
                leaf_bytes, &bars[b]);
    }
  };

  int held[2] = {-1, -1};  // tile in each buffer (copied or in flight)
  bool pending[2] = {false, false};  // a copy into the buffer is in flight
  uint32_t parity[2] = {0u, 0u};
  // wait for buffer b's copy in flight, if any (each copy is waited once)
  auto settle = [&](int b) {
    if (pending[b]) {
      ring::bar_wait(&bars[b], parity[b]);
      parity[b] ^= 1u;
      pending[b] = false;
    }
  };
  int cur = 0, staged = -1;
  const bool copies = p.node_bytes > 0 || p.stage_leaves;
  for (int item = i0; item < i1; ++item) {
    const int tile = tile_of(item);
    const int chunk = chunk_of(item);
    const bool new_tile = copies && tile != held[cur];
    const bool new_chunk = kCodeBytes != 0 && chunk != staged;
    if (new_tile || new_chunk) __syncthreads();  // the last item's walks ended
    if (new_chunk) {
      // one warp a row: coalesced reads of the chunk's codes, narrowed
      const int row0 = chunk * p.chunk_rows;
      const int rows = min(p.chunk_rows, p.n - row0);
      for (int r = threadIdx.x / 32; r < rows; r += kThreads / 32) {
        const int32_t* src = p.binned + static_cast<size_t>(row0 + r) * p.f;
        CodeT* dst = codes_s + static_cast<size_t>(r) * p.code_stride;
        for (int c = threadIdx.x % 32; c < p.f; c += 32) {
          dst[c] = narrow<kCodeBytes>(__ldg(src + c));
        }
      }
      staged = chunk;
    }
    if (new_tile) {
      const int b = p.buffers == 2 ? cur ^ 1 : cur;
      if (held[b] != tile) {
        settle(b);
        if (threadIdx.x == 0) copy_tile(tile, b);
        held[b] = tile;
        pending[b] = true;
      }
      settle(b);  // a tile copied earlier and kept needs no wait
      cur = b;
      if (p.buffers == 2) {
        // copy the next tile of this block's run into the other buffer
        const int next = p.tile_major ? (tile + 1) * p.chunks : item + 1;
        if (next < i1) {
          const int nt = tile_of(next);
          if (nt != tile && held[cur ^ 1] != nt) {
            if (threadIdx.x == 0) copy_tile(nt, cur ^ 1);
            held[cur ^ 1] = nt;
            pending[cur ^ 1] = true;
          }
        }
      }
    }
    if (new_chunk) __syncthreads();  // the chunk's codes are staged

    const int t0 = tile * tt;
    // lanes past the last tree walk the last tree and store nothing
    const int tree = min(t0 + lane_tree, p.t - 1);
    const int local = tree - t0;
    const unsigned char* buf = smem + cur * p.buffer_bytes;
    const unsigned char* tnodes = buf + local * sizeof(NodeT);
    const float* tleaves =
        reinterpret_cast<const float*>(buf + node_region) + local;
    const NodeT* below = bottom + static_cast<size_t>(tree) * pb - ps;
    const float* leaf = p.leaf + static_cast<size_t>(tree) * leaves - (leaves - 1);
    const int row0 = chunk * p.chunk_rows;
    const int rows = min(p.chunk_rows, p.n - row0);
    for (int r = rgroup; r < rows; r += groups * kWalks) {
      const CodeT* code_row[kWalks];
      uint32_t h[kWalks];  // heap index: the children of h are 2h + 1, 2h + 2
#pragma unroll
      for (int i = 0; i < kWalks; ++i) {
        const int rl = min(r + i * groups, rows - 1);
        if constexpr (kCodeBytes == 0) {
          code_row[i] = p.binned + static_cast<size_t>(row0 + rl) * p.f;
        } else {
          code_row[i] = codes_s + static_cast<size_t>(rl) * p.code_stride;
        }
        h[i] = 0;
      }
      // one level of every walk: its node, its code, its child
      auto level = [&](const NodeT (&w)[kWalks]) {
#pragma unroll
        for (int i = 0; i < kWalks; ++i) {
          int feat, bin;
          decode(w[i], feat, bin);
          int code;
          if constexpr (kCodeBytes == 0) {
            code = global_code(code_row[i], feat, NodeT{});
          } else {
            code = code_row[i][feat];
          }
          h[i] = 2 * h[i] + (code > bin ? 2u : 1u);
        }
      };
      for (int l = 0; l < p.top_levels; ++l) {
        NodeT w[kWalks];
#pragma unroll
        for (int i = 0; i < kWalks; ++i) {
          w[i] = *reinterpret_cast<const NodeT*>(tnodes + h[i] * node_stride);
        }
        level(w);
      }
      for (int l = p.top_levels; l < p.depth; ++l) {
        NodeT w[kWalks];
#pragma unroll
        for (int i = 0; i < kWalks; ++i) w[i] = __ldg(below + h[i]);
        level(w);
      }
#pragma unroll
      for (int i = 0; i < kWalks; ++i) {
        const int rl = r + i * groups;
        const float v = p.stage_leaves ? tleaves[(h[i] - (leaves - 1)) * tt]
                                       : __ldg(leaf + h[i]);
        if (rl < rows && t0 + lane_tree < p.t) {
          p.out[static_cast<size_t>(row0 + rl) * p.t + tree] = v;
        }
      }
    }
  }
}

template <typename NodeT, int kCodeBytes, int kWalks>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = serve_trees_kernel<NodeT, kCodeBytes, kWalks>;
  int max_smem = 0;
  cudaError_t err = ring::max_dynamic_smem(kernel, &max_smem);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  // the resident blocks at the last shared-memory size asked: a serving
  // loop launches the same shape again and again (host threads share it)
  static std::mutex mu;
  static int last_grid = 0;
  static size_t last_smem = 0;
  int grid = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (last_grid == 0 || smem != last_smem) {
      err = ring::persistent_grid(kernel, kThreads, smem, 1 << 30, &last_grid);
      if (err != cudaSuccess) return err;
      last_smem = smem;
    }
    grid = last_grid;
  }
  kernel<<<std::min(p.items, grid), kThreads, smem, stream>>>(p);
  return cudaSuccess;
}

template <typename NodeT, int kCodeBytes>
cudaError_t launch_walks(const Params& p, size_t smem, int walks,
                         cudaStream_t stream) {
  switch (walks) {
    case 1: return launch<NodeT, kCodeBytes, 1>(p, smem, stream);
    case 2: return launch<NodeT, kCodeBytes, 2>(p, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename NodeT>
cudaError_t launch_codes(const Params& p, size_t smem, int code_bytes,
                         int walks, cudaStream_t stream) {
  switch (code_bytes) {
    case 0: return launch_walks<NodeT, 0>(p, smem, walks, stream);
    case 1: return launch_walks<NodeT, 1>(p, smem, walks, stream);
    case 2: return launch_walks<NodeT, 2>(p, smem, walks, stream);
    case 4: return launch_walks<NodeT, 4>(p, smem, walks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The walk. `args` holds 13 ints: n, f, t, depth, top_levels, wide (the
// node type), tile_trees, walks (1 or 2 at once), code_bytes (0: codes
// read from global memory; 1, 2 or 4 bytes a code staged in shared
// memory), chunk_rows, tile_major, buffers (1 or 2) and stage_leaves: the
// items and their copies, which the wrapper plans (see the header).
// Launches kThreads-thread blocks on `stream` (a cudaStream_t) and returns
// cudaGetLastError(): 0 when the launch was accepted.
int tp_serve_trees(const void* binned, const void* top, const void* bottom,
                   const void* leaf_value, const void* leaf_tiles, void* out,
                   const int* args, void* stream) {
  const int n = args[0], f = args[1], t = args[2], depth = args[3],
            top_levels = args[4], wide = args[5], tile_trees = args[6],
            walks = args[7], code_bytes = args[8], chunk_rows = args[9],
            tile_major = args[10], buffers = args[11], stage_leaves = args[12];
  if (n > 0 && t > 0) {
    const bool shape_ok =
        tile_trees >= 1 && tile_trees <= 32 &&
        (tile_trees & (tile_trees - 1)) == 0 && top_levels <= depth &&
        top_levels <= 10 && chunk_rows >= 1 && (buffers == 1 || buffers == 2) &&
        (!stage_leaves || depth <= 10) && f >= 1;
    if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
    Params p{};
    p.binned = static_cast<const int32_t*>(binned);
    p.top = top;
    p.bottom = bottom;
    p.leaf = static_cast<const float*>(leaf_value);
    p.leaf_tiles = static_cast<const float*>(leaf_tiles);
    p.out = static_cast<float*>(out);
    p.n = n;
    p.f = f;
    p.t = t;
    p.depth = depth;
    p.top_levels = top_levels;
    p.tile_trees = tile_trees;
    p.chunk_rows = chunk_rows;
    p.chunks = (n + chunk_rows - 1) / chunk_rows;
    p.tiles = (t + tile_trees - 1) / tile_trees;
    p.tile_major = tile_major;
    p.stage_leaves = stage_leaves;
    p.buffers = buffers;
    const int ps = (1 << top_levels) - 1;
    p.node_bytes = static_cast<uint32_t>(tile_trees) * ps * (wide ? 8 : 4);
    p.buffer_bytes = ((p.node_bytes + 15u) & ~15u) +
                     (stage_leaves ? (4u << depth) * tile_trees : 0u);
    p.code_stride = code_bytes ? (f * code_bytes + 15) / 16 * 16 / code_bytes : 0;
    const size_t smem = static_cast<size_t>(buffers) * p.buffer_bytes +
                        static_cast<size_t>(chunk_rows) * p.code_stride * code_bytes;
    const long long items = static_cast<long long>(p.chunks) * p.tiles;
    if (items >= (1LL << 31) || smem > 232448) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.items = static_cast<int>(items);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        wide ? launch_codes<int2>(p, smem, code_bytes, walks, s)
             : launch_codes<uint32_t>(p, smem, code_bytes, walks, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* tp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
