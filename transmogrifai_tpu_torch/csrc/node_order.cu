// The row order of the histogram kernels K2 and K3 on Hopper: a stable
// counting sort of each fit's rows by node slot.
//
// The TPU kernels it serves (transmogrifai_tpu/models/hist_pallas.py:
// _hist_binloop_kernel and _hist_kernel) need no row order: they one-hot
// every row against every slot on the MXU. K2 and K3 instead walk each
// slot's rows, in ascending order, so that every histogram cell is a
// sequential float32 sum. This computes, for K fits of N rows and M slots:
//   key[k, r]   = node[k, r] if 0 <= node[k, r] < M and grad or hess is
//                 nonzero, else M (dead)
//   order[k, :] = the rows sorted by key, ascending row order within a key
//   start[k, m] = where key m's run starts in order[k, :], count[k, m] its
//                 length (m < M; the dead rows fill the tail)
// the same arrays as the plain version (hist.node_order_plain), bit for bit.
//
// One launch. Each fit is one cluster of kCluster blocks (on as many SMs),
// and each warp of the cluster owns a contiguous share of the fit's rows,
// in cluster order, with one counter per key in its block's shared memory:
//  1. each warp counts its rows' keys, 32 rows at a time (__match_any_sync
//     groups lanes by key and the lowest lane of each group adds its size);
//  2. each block takes, per key, the exclusive prefix of its warps' counts
//     and its total; after a cluster barrier every block reads the other
//     blocks' totals from their shared memory, and a warp's offset for a
//     key is the rows of smaller keys (a prefix over the key totals) plus
//     the key's rows in earlier blocks and in earlier warps of its own
//     (block 0 writes start and count);
//  3. each warp walks its rows again: a row goes to its key's running
//     offset plus the number of lanes below it with the same key, and the
//     offsets advance by the group sizes.
// Positions come from prefix sums and lane ranks alone (no atomics), so
// the order never depends on scheduling.
//
// What bounds it: reading node, grad and hess (12 bytes a row and fit) and
// writing order (4); the walks are serial per warp, 32 rows a step, about
// N / (32 * kCluster * warps) steps each.
//
// Shapes: node [K, N] int32; grad, hess [K, N] f32; order [K, N] int32;
// start, count [K, M] int32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // blocks per fit
constexpr int kMaxWarps = 16;  // warps per block, at most
constexpr int kSteps = 8;      // 32-row steps whose keys load at once

__device__ __forceinline__ int row_key(const int32_t* __restrict__ node,
                                       const float* __restrict__ grad,
                                       const float* __restrict__ hess,
                                       size_t at, int m_slots) {
  // three independent loads (no short cut), so that a step's are in flight
  // together
  const int s = __ldg(node + at);
  const float g = __ldg(grad + at), h = __ldg(hess + at);
  const bool live = s >= 0 && s < m_slots && (g != 0.0f || h != 0.0f);
  return live ? s : m_slots;
}

// One 32-row step of a warp's walk: lane `lane` holds the key of row `row`
// (a negative key, unique to the lane, when it holds none). Lanes sharing a
// key are ranked by lane; with kPlace each row goes to its key's running
// offset cnt[key] plus its rank. The lowest lane of each key then advances
// cnt[key] by the key's lane count.
template <bool kPlace>
__device__ __forceinline__ void walk_step(int key, int row, int32_t* order_fit,
                                          int32_t* cnt, int lane) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const unsigned below = peers & ((1u << lane) - 1u);
  if (kPlace && key >= 0) order_fit[cnt[key] + __popc(below)] = row;
  __syncwarp();
  if (below == 0 && key >= 0) cnt[key] += __popc(peers);
  __syncwarp();
}

// A warp's walk over rows [lo, hi) of the fit at `fit`, kSteps steps of keys
// loaded at once.
template <bool kPlace>
__device__ __forceinline__ void warp_walk(const int32_t* __restrict__ node,
                                          const float* __restrict__ grad,
                                          const float* __restrict__ hess,
                                          int32_t* __restrict__ order_fit,
                                          int32_t* cnt, size_t fit, int lo,
                                          int hi, int m_slots, int lane) {
  for (int r0 = lo; r0 < hi; r0 += 32 * kSteps) {
    int keys[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int r = r0 + 32 * u + lane;
      keys[u] = r < hi ? row_key(node, grad, hess, fit + r, m_slots) : -1 - lane;
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      if (r0 + 32 * u >= hi) break;
      walk_step<kPlace>(keys[u], r0 + 32 * u + lane, order_fit, cnt, lane);
    }
  }
}

// Inclusive prefix sum of v over the block's threads, in thread order; every
// thread calls it and gets the block's total too. warp_sums holds 32 ints.
__device__ __forceinline__ int block_scan(int v, int32_t* warp_sums,
                                          int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += u;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  incl += warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[warps - 1];
  __syncthreads();  // warp_sums is free again
  return incl;
}

// Fit k = blockIdx.x / kCluster. Dynamic shared memory: tot[M + 1], this
// block's key totals, then cnt[warp][M + 1].
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kMaxWarps * 32)
node_order_kernel(const int32_t* __restrict__ node,
                  const float* __restrict__ grad,
                  const float* __restrict__ hess, int32_t* __restrict__ order,
                  int32_t* __restrict__ start, int32_t* __restrict__ count,
                  int n, int m_slots) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ int32_t smem[];
  __shared__ int32_t warp_sums[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int warps = blockDim.x >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int k = blockIdx.x / kCluster;
  const int nkeys = m_slots + 1;
  const size_t fit = static_cast<size_t>(k) * n;
  int32_t* tot = smem;
  int32_t* cnt = smem + nkeys;
  for (int i = t; i < warps * nkeys; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  // warp gw of the cluster walks 32-row steps [gw * per, (gw + 1) * per)
  const int steps = (n + 31) / 32;
  const int per = (steps + kCluster * warps - 1) / (kCluster * warps);
  const int gw = rank * warps + warp;
  const int lo = min(n, gw * per * 32), hi = min(n, lo + per * 32);
  int32_t* mine = cnt + static_cast<size_t>(warp) * nkeys;
  warp_walk<false>(node, grad, hess, order + fit, mine, fit, lo, hi, m_slots,
                   lane);
  __syncthreads();
  for (int key = t; key < nkeys; key += blockDim.x) {
    int sum = 0;
    for (int w = 0; w < warps; ++w) {
      const int v = cnt[w * nkeys + key];
      cnt[w * nkeys + key] = sum;
      sum += v;
    }
    tot[key] = sum;
  }
  cluster.sync();  // every block's totals are written
  int carry = 0;
  for (int key0 = 0; key0 < nkeys; key0 += blockDim.x) {
    const int key = key0 + t;
    int all = 0, before = 0;
    if (key < nkeys) {
      for (int b = 0; b < kCluster; ++b) {
        const int v = cluster.map_shared_rank(tot, b)[key];
        all += v;
        if (b < rank) before += v;
      }
    }
    int total;
    const int base = carry + block_scan(all, warp_sums, &total) - all;
    if (key < nkeys) {
      for (int w = 0; w < warps; ++w) cnt[w * nkeys + key] += base + before;
      if (rank == 0 && key < m_slots) {
        start[static_cast<size_t>(k) * m_slots + key] = base;
        count[static_cast<size_t>(k) * m_slots + key] = all;
      }
    }
    carry += total;
  }
  cluster.sync();  // no block leaves while another reads its totals
  warp_walk<true>(node, grad, hess, order + fit, mine, fit, lo, hi, m_slots,
                  lane);
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) and returns the first CUDA error (0
// when the launch was accepted).
int tp_node_order(const void* node, const void* grad, const void* hess,
                  void* order, void* start, void* count, int n, int k_fits,
                  int m_slots, void* stream) {
  if (n < 0 || k_fits < 0 || m_slots < 1 || k_fits > (1 << 20)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || k_fits == 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many warps as the counters leave room for
  const size_t keys_bytes = static_cast<size_t>(m_slots + 1) * sizeof(int32_t);
  int warps = kMaxWarps;
  while (warps > 1 && (warps + 1) * keys_bytes > static_cast<size_t>(max_smem)) {
    warps >>= 1;
  }
  const size_t smem = (warps + 1) * keys_bytes;
  if (smem > static_cast<size_t>(max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(node_order_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  node_order_kernel<<<k_fits * kCluster, 32 * warps, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(node), static_cast<const float*>(grad),
      static_cast<const float*>(hess), static_cast<int32_t*>(order),
      static_cast<int32_t*>(start), static_cast<int32_t*>(count), n, m_slots);
  return static_cast<int>(cudaGetLastError());
}

const char* tp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
