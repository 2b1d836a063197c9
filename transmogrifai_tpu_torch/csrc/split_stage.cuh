// The split stage of tree growth on Hopper, shared by the split-search
// kernel (split_search.cu, over a histogram in device memory) and the fused
// kernel K4 (best_split.cu, over cells it builds in shared memory).
//
// For one fit's slot and a tile of features whose cells [fw][bins] (grad,
// hess) lie in shared memory, it computes what models/hist.py's
// split_search_plain computes for them, in the same order, bit for bit:
//   GL, HL   = the prefix over bins 0..t in the order XLA's CPU backend
//              takes jnp.cumsum: sequential within blocks of 16, each block
//              then offset by the cumsum of the block totals before it,
//              itself taken the same way (so the blocking recurses past 16
//              blocks, 257 bins);
//   G, H     = the total over all bins in the order XLA's CPU backend
//              reduces: zero-padded windows of 32 (half the padding in
//              front), each summed in order from +0, then the window sums
//              the same way, until 32 or fewer are summed in order;
//   gain     = 0.5 * (GL^2/(HL+lam) + GR^2/(HR+lam) - G^2/(H+lam)) - gam
// for thresholds t = 0..B-2, -inf where HL < mcw, HR < mcw or the feature's
// mask is not > 0; each thread keeps the best (gain, flat index) of the
// candidates it took, the flat index being feature * (B-1) + t, with
// argmax's order: a NaN beats every number, and equal gains go to the lower
// index. Every add, multiply and divide is a separately rounded __f*_rn
// intrinsic, which nvcc never contracts into a fused multiply-add.
//
// The prefix and the total are taken in place, level by level: a thread
// per (block of 16 (prefix) or window of 32 (total), feature) of a level,
// the levels' partial sums in a scratch (`aux`), a barrier between levels.
// The callers pass their own barrier: the whole block in split_search.cu
// and best_split.cu, the ring's consumer threads (a named barrier) in K4's
// ring design, best_split_ring.cu.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace split {

constexpr int kBlock = 16;   // XLA's cumsum block on the CPU
constexpr int kWindow = 32;  // XLA's reduction window on the CPU
constexpr int kMaxLevels = 4;

// a beats b in argmax's order: a NaN beats every number, and nothing beats
// a NaN
__device__ __forceinline__ bool better(float a, float b) {
  return a > b || (isnan(a) && !isnan(b));
}

struct Best {
  float gain;
  int idx;  // flat (feature, threshold) index
};

__device__ __forceinline__ Best no_best() { return {-INFINITY, 0x7fffffff}; }

// Candidate (g, i) into b: a better gain, or an equal one (or both NaN) at
// a lower index.
__device__ __forceinline__ void take(Best& b, float g, int i) {
  if (better(g, b.gain) || (!better(b.gain, g) && i < b.idx)) {
    b.gain = g;
    b.idx = i;
  }
}

__device__ __forceinline__ Best warp_best(Best b) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float g = __shfl_xor_sync(0xffffffffu, b.gain, d);
    const int i = __shfl_xor_sync(0xffffffffu, b.idx, d);
    take(b, g, i);
  }
  return b;
}

__device__ __forceinline__ float parent_of(float gt, float ht, float lam) {
  return __fdiv_rn(__fmul_rn(gt, gt), __fadd_rn(ht, lam));
}

// The gain of one threshold, in split_search_plain's expression order.
__device__ __forceinline__ float gain_of(float gl, float hl, float gt, float ht,
                                         float parent, float lam, float gam,
                                         float mcw) {
  const float gr = __fsub_rn(gt, gl);
  const float hr = __fsub_rn(ht, hl);
  if (!(hl >= mcw && hr >= mcw)) return -INFINITY;
  const float left = __fdiv_rn(__fmul_rn(gl, gl), __fadd_rn(hl, lam));
  const float right = __fdiv_rn(__fmul_rn(gr, gr), __fadd_rn(hr, lam));
  return __fsub_rn(
      __fmul_rn(0.5f, __fsub_rn(__fadd_rn(left, right), parent)), gam);
}

// The levels of one feature's prefix and total for a bin count.
struct Plan {
  int bins, len;              // B, and the B - 1 thresholds
  int cs_levels;              // prefix levels: cs_n[0] = len, then blocks
  int cs_n[kMaxLevels];
  int cs_off[kMaxLevels];     // level i >= 1 in the feature's aux
  int xs_levels;              // total levels: xs_n[0] = bins, then windows
  int xs_n[kMaxLevels];
  int xs_off[kMaxLevels];
  int aux;                    // float2 of scratch per feature
};

__host__ __device__ inline Plan make_plan(int bins) {
  Plan p{};
  p.bins = bins;
  p.len = bins - 1;
  int off = 0;
  p.cs_n[0] = p.len;
  p.cs_levels = 1;
  while (p.cs_n[p.cs_levels - 1] > kBlock && p.cs_levels < kMaxLevels) {
    const int n = p.cs_n[p.cs_levels - 1];
    p.cs_n[p.cs_levels] = (n + kBlock - 1) / kBlock;
    p.cs_off[p.cs_levels] = off;
    off += p.cs_n[p.cs_levels];
    ++p.cs_levels;
  }
  p.xs_n[0] = bins;
  p.xs_levels = 1;
  while (p.xs_n[p.xs_levels - 1] > kWindow && p.xs_levels < kMaxLevels) {
    const int n = p.xs_n[p.xs_levels - 1];
    p.xs_n[p.xs_levels] = (n + kWindow - 1) / kWindow;
    p.xs_off[p.xs_levels] = off;
    off += p.xs_n[p.xs_levels];
    ++p.xs_levels;
  }
  p.aux = off;
  return p;
}

// Bins the levels can take: a prefix of 16^4 thresholds and a total of
// 32^4 bins.
__host__ __device__ inline bool plan_fits(int bins) {
  return bins >= 2 && bins - 1 <= kBlock * kBlock * kBlock * kBlock;
}

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

// Shared-memory words (float) of one feature tile: cells, aux, totals,
// parents and masks.
__host__ __device__ inline size_t tile_words(const Plan& p, int fw) {
  return static_cast<size_t>(fw) * (2 * (p.bins + p.aux) + 4);
}

// A feature tile's arrays in shared memory, feature fastest: cell (f, b) at
// cells[b * fw + f], so that the lanes of a warp, which take consecutive
// features, read consecutive words at every step of their sequential sums
// (a feature-major layout would put a warp's 16- or 32-cell blocks the same
// bank apart).
struct Tile {
  float2* cells;  // [bins][fw]
  float2* aux;    // [aux][fw]
  float2* tot;    // [fw]
  float* parent;  // [fw]
  float* mask;    // [fw]
  int fw;
};

__device__ __forceinline__ Tile tile_at(float* base, const Plan& p, int fw) {
  Tile t;
  t.fw = fw;
  t.cells = reinterpret_cast<float2*>(base);
  t.aux = t.cells + static_cast<size_t>(fw) * p.bins;
  t.tot = t.aux + static_cast<size_t>(fw) * p.aux;
  t.parent = reinterpret_cast<float*>(t.tot + fw);
  t.mask = t.parent + fw;
  return t;
}

// Level `lv` (>= 1) of the window sums, or the cells for lv 0; element i of
// feature f at [i * fw + f].
__device__ __forceinline__ float2* xs_level(const Plan& p, const Tile& t,
                                            int lv) {
  return lv == 0 ? t.cells : t.aux + static_cast<size_t>(p.xs_off[lv]) * t.fw;
}

__device__ __forceinline__ float2* cs_level(const Plan& p, const Tile& t,
                                            int lv) {
  return lv == 0 ? t.cells : t.aux + static_cast<size_t>(p.cs_off[lv]) * t.fw;
}

// Task task = tid, tid + nth, ... < n * fw of a thread as (i, f), task =
// i * fw + f, stepped without a division per task.
struct Tasks {
  int i, f, di, df;
  __device__ Tasks(int tid, int nth, int fw)
      : i(tid / fw), f(tid - tid / fw * fw), di(nth / fw),
        df(nth - nth / fw * fw) {}
  __device__ void next(int fw) {
    i += di;
    f += df;
    if (f >= fw) {
      f -= fw;
      ++i;
    }
  }
};

// The split stage over a tile of fw features (global ids f0...), its cells
// in place in t.cells; `mask` points at the tile's first feature's mask.
// Threads tid of nth take part; `sync` is their barrier. The cells are
// overwritten by the prefix. Every thread must call it. Tasks go feature
// fastest, so a warp's lanes take consecutive features.
template <class Sync>
__device__ void search(const Plan& p, const Tile& t, int f0, const float* mask,
                       float lam, float gam, float mcw, Best& best, int tid,
                       int nth, Sync sync) {
  const int fw = t.fw;
  const float2 zero = make_float2(0.0f, 0.0f);
  // the tile's masks, read once (the gains read them after the barriers
  // below)
  for (int f = tid; f < fw; f += nth) t.mask[f] = mask[f];
  // totals: window sums level by level, then the last level in order
  for (int lv = 1; lv < p.xs_levels; ++lv) {
    const int n = p.xs_n[lv - 1], nb = p.xs_n[lv];
    const int front = (nb * kWindow - n) / 2;
    const float2* x = xs_level(p, t, lv - 1);
    float2* y = xs_level(p, t, lv);
    Tasks k(tid, nth, fw);
    for (int task = tid; task < fw * nb; task += nth, k.next(fw)) {
      const int i0 = k.i * kWindow - front;
      float2 acc = zero;
      if (i0 >= 0 && i0 + kWindow <= n) {
#pragma unroll
        for (int g8 = 0; g8 < kWindow; g8 += 8) {
          float2 v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = x[(i0 + g8 + u) * fw + k.f];
#pragma unroll
          for (int u = 0; u < 8; ++u) acc = add2(acc, v[u]);
        }
      } else {  // a window with padding: its elements alone
        for (int i = max(i0, 0); i < min(i0 + kWindow, n); ++i) {
          acc = add2(acc, x[i * fw + k.f]);
        }
      }
      y[task] = acc;
    }
    sync();
  }
  {
    const int lv = p.xs_levels - 1, n = p.xs_n[lv];
    const float2* x = xs_level(p, t, lv);
    for (int f = tid; f < fw; f += nth) {
      float2 acc = zero;
      int i = 0;
      for (; i + 8 <= n; i += 8) {
        float2 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = x[(i + u) * fw + f];
#pragma unroll
        for (int u = 0; u < 8; ++u) acc = add2(acc, v[u]);
      }
      for (; i < n; ++i) acc = add2(acc, x[i * fw + f]);
      t.tot[f] = acc;
      t.parent[f] = parent_of(acc.x, acc.y, lam);
    }
  }
  sync();  // the cells are read; the prefix overwrites them
  // prefix, up: each block of 16 of a level summed in place from its first
  // element, its total (with the zero padding of a short last block) into
  // the next level
  for (int lv = 0; lv < p.cs_levels; ++lv) {
    const int n = p.cs_n[lv];
    if (n == 1) break;  // one element: its own prefix, and no level above
    const int nb = (n + kBlock - 1) / kBlock;
    const bool up = lv + 1 < p.cs_levels;
    float2* x = cs_level(p, t, lv);
    float2* y = up ? cs_level(p, t, lv + 1) : nullptr;
    Tasks k(tid, nth, fw);
    for (int task = tid; task < fw * nb; task += nth, k.next(fw)) {
      float2* xb = x + k.i * kBlock * fw + k.f;
      const int len = min(kBlock, n - k.i * kBlock);
      float2 w = xb[0];
      if (len == kBlock) {
#pragma unroll
        for (int g8 = 0; g8 < kBlock; g8 += 8) {
          float2 v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (g8 + u > 0) v[u] = xb[(g8 + u) * fw];
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (g8 + u > 0) {
              w = add2(w, v[u]);
              xb[(g8 + u) * fw] = w;
            }
          }
        }
      } else {
        for (int u = 1; u < len; ++u) {
          w = add2(w, xb[u * fw]);
          xb[u * fw] = w;
        }
        if (up) {
          // the zero padding of the last block, as the blocked cumsum adds it
          for (int u = len; u < kBlock; ++u) w = add2(w, zero);
        }
      }
      if (up) y[task] = w;
    }
    sync();
  }
  // prefix, down: every block after the first offset by the final prefix
  // of the block totals before it; level 0's offsets are added in the
  // gains below, as each threshold's prefix is read
  for (int lv = p.cs_levels - 2; lv >= 1; --lv) {
    const int n = p.cs_n[lv];
    float2* x = cs_level(p, t, lv);
    const float2* y = cs_level(p, t, lv + 1);
    Tasks k(kBlock * fw + tid, nth, fw);
    for (int task = kBlock * fw + tid; task < fw * n; task += nth, k.next(fw)) {
      x[task] = add2(x[task], y[(k.i / kBlock - 1) * fw + k.f]);
    }
    sync();
  }
  // gains
  const int len = p.len;
  const float2* up = p.cs_levels > 1 ? cs_level(p, t, 1) : nullptr;
  Tasks k(tid, nth, fw);
  for (int task = tid; task < fw * len; task += nth, k.next(fw)) {
    float g = -INFINITY;
    if (t.mask[k.f] > 0.0f) {
      float2 c = t.cells[task];
      if (k.i >= kBlock) c = add2(c, up[(k.i / kBlock - 1) * fw + k.f]);
      const float2 tot = t.tot[k.f];
      g = gain_of(c.x, c.y, tot.x, tot.y, t.parent[k.f], lam, gam, mcw);
    }
    take(best, g, (f0 + k.f) * len + k.i);
  }
}

// The best split of a slot with no rows (an all-zero histogram: every
// prefix and total +0, so every threshold of an enabled feature has the
// same gain), without reading its cells. `first_on` is the lowest feature
// whose mask is > 0 (INT_MAX for none).
__device__ __forceinline__ Best empty_best(float lam, float gam, float mcw,
                                           int first_on, int len) {
  const float parent = parent_of(0.0f, 0.0f, lam);
  const float g = gain_of(0.0f, 0.0f, 0.0f, 0.0f, parent, lam, gam, mcw);
  Best b = {-INFINITY, 0};
  if (first_on != 0x7fffffff && better(g, -INFINITY)) {
    b.gain = g;
    b.idx = first_on * len;
  }
  return b;
}

}  // namespace split
