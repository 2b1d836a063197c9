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
// One launch. Each fit is one cluster of C blocks (16, a non-portable
// size, where the fits are few enough for 16 each to find their SMs, else
// 8), and each warp of the cluster owns a contiguous share of the fit's
// rows, in cluster order, with one counter per key in its block's shared
// memory:
//  1. each warp reads its rows' keys once, all of its 32-row steps' loads
//     in flight together, and keeps them in registers (up to kCache steps
//     a warp; a longer share is read in groups of kCache steps, twice);
//     it counts them, 32 rows at a time (__match_any_sync groups lanes by
//     key and the lowest lane of each group adds its size);
//  2. each block takes, per key, the exclusive prefix of its warps' counts
//     and its total; after a cluster barrier every block reads the other
//     blocks' totals from their shared memory (all C reads in flight), and
//     a warp's offset for a key is the rows of smaller keys (a block-wide
//     scan over the key totals) plus the key's rows in earlier blocks and
//     in earlier warps of its own (block 0 writes start and count);
//  3. each warp places its rows from the keys it holds: a row goes to its
//     key's running offset plus the number of lanes below it with the same
//     key, and the offsets advance by the group sizes. The barrier that
//     keeps a block's totals alive until every block has read them is
//     split: each block arrives once it has read, places its rows, then
//     waits.
// The cluster size is a template parameter, so the reads of the other
// blocks' totals unroll to exactly C (with the size read at run time, the
// 18-fit launches measured 4% slower on the H100, PERF.md); the 16-block
// kernel keeps at most 64 registers a thread (two blocks an SM).
// Positions come from prefix sums and lane ranks alone (no atomics), so
// the order never depends on scheduling. The device's SM count, its
// shared-memory limit and whether clusters of 16 fit are read once per
// device, and the kernels' attributes set once.
//
// What bounds it: reading node, grad and hess (12 bytes a row and fit) and
// writing order (4); the steps are serial per warp, 32 rows each, about
// N / (32 * C * warps) of them; at the training paths' sizes (16384 rows)
// the fixed latencies of the phases, not the bytes.
//
// Shapes: node [K, N] int32; grad, hess [K, N] f32; order [K, N] int32;
// start, count [K, M] int32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;  // blocks per fit, at most
constexpr int kWarps = 16;       // warps per block, at most
constexpr int kCache = 8;        // 32-row steps whose keys a warp holds
constexpr int kMaxDevices = 64;
// the most shared memory a block of a 16-block cluster takes
constexpr size_t kSmem16 = 48 * 1024;

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

// The keys of the warp's 32-row steps r0, r0 + 32, ... below hi, kCache of
// them, their loads all in flight together (a negative key, unique to the
// lane, past hi).
__device__ __forceinline__ void load_keys(int (&keys)[kCache],
                                          const int32_t* __restrict__ node,
                                          const float* __restrict__ grad,
                                          const float* __restrict__ hess,
                                          size_t fit, int r0, int hi,
                                          int m_slots, int lane) {
#pragma unroll
  for (int u = 0; u < kCache; ++u) {
    const int r = r0 + 32 * u + lane;
    keys[u] = r < hi ? row_key(node, grad, hess, fit + r, m_slots) : -1 - lane;
  }
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

// The steps of those keys below hi, counting or (kPlace) placing.
template <bool kPlace>
__device__ __forceinline__ void walk_keys(const int (&keys)[kCache], int r0,
                                          int hi, int32_t* order_fit,
                                          int32_t* cnt, int lane) {
#pragma unroll
  for (int u = 0; u < kCache; ++u) {
    if (r0 + 32 * u >= hi) break;
    walk_step<kPlace>(keys[u], r0 + 32 * u + lane, order_fit, cnt, lane);
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
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

// Fit k = blockIdx.x / kC, in a cluster of kC blocks (a compile-time size,
// so that the reads of the other blocks' totals unroll exactly). Dynamic
// shared memory: tot[M + 1], this block's key totals, then cnt[warp][M + 1].
template <int kC>
__global__ void __launch_bounds__(kWarps * 32, kC == kMaxCluster ? 2 : 1)
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
  const int k = blockIdx.x / kC;
  const int nkeys = m_slots + 1;
  const size_t fit = static_cast<size_t>(k) * n;
  int32_t* tot = smem;
  int32_t* cnt = smem + nkeys;
  for (int i = t; i < warps * nkeys; i += blockDim.x) cnt[i] = 0;
  __syncthreads();
  // warp gw of the cluster walks 32-row steps [gw * per, (gw + 1) * per)
  const int steps = (n + 31) / 32;
  const int per = (steps + kC * warps - 1) / (kC * warps);
  const int gw = rank * warps + warp;
  const int lo = min(n, gw * per * 32), hi = min(n, lo + per * 32);
  int32_t* mine = cnt + static_cast<size_t>(warp) * nkeys;
  int32_t* order_fit = order + fit;
  const bool cached = per <= kCache;
  int keys[kCache];
  if (cached) {
    load_keys(keys, node, grad, hess, fit, lo, hi, m_slots, lane);
    walk_keys<false>(keys, lo, hi, order_fit, mine, lane);
  } else {
    for (int r0 = lo; r0 < hi; r0 += 32 * kCache) {
      load_keys(keys, node, grad, hess, fit, r0, hi, m_slots, lane);
      walk_keys<false>(keys, r0, hi, order_fit, mine, lane);
    }
  }
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
#pragma unroll
      for (int b = 0; b < kC; ++b) {
        const int v = cluster.map_shared_rank(tot, b)[key];
        all += v;
        before += b < rank ? v : 0;
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
  // every warp's offsets are in place; this block is done reading the
  // others' totals, and none leaves before all are (the wait below)
  __syncthreads();
  cluster_arrive();
  if (cached) {
    walk_keys<true>(keys, lo, hi, order_fit, mine, lane);
  } else {
    for (int r0 = lo; r0 < hi; r0 += 32 * kCache) {
      load_keys(keys, node, grad, hess, fit, r0, hi, m_slots, lane);
      walk_keys<true>(keys, r0, hi, order_fit, mine, lane);
    }
  }
  cluster_wait();
}

// Per device, read once: SMs, the dynamic shared memory a block may opt
// into, and whether clusters of 16 blocks can run; the kernel's attributes
// are set once.
struct DeviceInfo {
  bool ready;
  int sms, smem_block, cluster16;
};
DeviceInfo g_devices[kMaxDevices];

cudaLaunchConfig_t launch_config(unsigned grid, int threads, size_t smem,
                                 int cluster, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t device_info(const DeviceInfo** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  // host threads may launch at once: one of them reads the device
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  DeviceInfo& d = g_devices[dev];
  if (!d.ready) {
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&d.smem_block,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    // the dynamic part of the opt-in limit (the kernels' static shared
    // memory, the same in both, counts against it too)
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, node_order_kernel<kMaxCluster>);
    if (err != cudaSuccess) return err;
    d.smem_block -= static_cast<int>(fa.sharedSizeBytes);
    for (const void* fn :
         {reinterpret_cast<const void*>(node_order_kernel<kMaxCluster>),
          reinterpret_cast<const void*>(node_order_kernel<kMaxCluster / 2>)}) {
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem_block);
      if (err != cudaSuccess) return err;
    }
    err = cudaFuncSetAttribute(node_order_kernel<kMaxCluster>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(
        kMaxCluster, kWarps * 32, kSmem16, kMaxCluster, nullptr, &attr);
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters,
                                       node_order_kernel<kMaxCluster>,
                                       &cfg) != cudaSuccess) {
      clusters = 0;
      cudaGetLastError();  // a refused query is an answer, not a fault
    }
    d.cluster16 = clusters > 0;
    d.ready = true;
  }
  *out = &d;
  return cudaSuccess;
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
  const DeviceInfo* d = nullptr;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many warps as the counters leave room for; clusters of 16 where the
  // fits are few enough to find their SMs and the counters fit beside
  const size_t keys_bytes = static_cast<size_t>(m_slots + 1) * sizeof(int32_t);
  int warps = kWarps;
  while (warps > 1 &&
         (warps + 1) * keys_bytes > static_cast<size_t>(d->smem_block)) {
    warps >>= 1;
  }
  const size_t smem = (warps + 1) * keys_bytes;
  if (smem > static_cast<size_t>(d->smem_block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cluster = d->cluster16 && k_fits * kMaxCluster <= d->sms &&
                              smem <= kSmem16
                          ? kMaxCluster
                          : kMaxCluster / 2;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(static_cast<unsigned>(k_fits * cluster), 32 * warps, smem,
                    cluster, static_cast<cudaStream_t>(stream), &attr);
  const auto kernel = cluster == kMaxCluster ? node_order_kernel<kMaxCluster>
                                             : node_order_kernel<kMaxCluster / 2>;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const int32_t*>(node),
                           static_cast<const float*>(grad),
                           static_cast<const float*>(hess),
                           static_cast<int32_t*>(order),
                           static_cast<int32_t*>(start),
                           static_cast<int32_t*>(count), n, m_slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* tp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
