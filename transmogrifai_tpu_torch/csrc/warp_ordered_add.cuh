// Ordered histogram adds by one warp, shared by kernels K3 (hist_wide.cu)
// and K4 (best_split.cu).
//
// Lane l holds row r0 + l of 32 consecutive rows of a slot's run: its bin
// `code`, its grad `gv` and hess `hv`, and `ok` (the row exists and its
// code is in range). The warp adds every ok row into the cells cg[code],
// ch[code] (shared memory, owned by this warp alone) so that each cell
// still receives its rows one at a time in ascending row order: lanes that
// share a code are ranked by lane, and step s adds the rank-s lane of every
// code at once. Distinct codes never wait on each other, so a tile of 32
// rows takes as many steps as its most repeated code, not 32.
//
// Every lane of the warp must call it (it synchronises the warp).

#pragma once

#include <cuda_runtime.h>

// The two halves of warp_ordered_add, so that a caller can rank several
// groups of 32 rows before it adds any of them: plan() ranks this lane among
// the lanes sharing its code and finds the warp's step count; apply() adds.
struct OrderedAdd {
  int rank;
  unsigned steps;
};

__device__ __forceinline__ OrderedAdd ordered_add_plan(int code, bool ok,
                                                       int lane) {
  // a lane that adds nothing gets a key no code can take (codes are >= 0)
  const unsigned peers = __match_any_sync(0xffffffffu, ok ? code : -1 - lane);
  OrderedAdd a;
  a.rank = __popc(peers & ((1u << lane) - 1u));
  a.steps =
      __reduce_max_sync(0xffffffffu, ok ? static_cast<unsigned>(__popc(peers)) : 0u);
  return a;
}

__device__ __forceinline__ void ordered_add_apply(float* cg, float* ch,
                                                  int code, float gv, float hv,
                                                  bool ok, OrderedAdd a) {
  for (unsigned s = 0; s < a.steps; ++s) {
    if (ok && a.rank == static_cast<int>(s)) {
      cg[code] = __fadd_rn(cg[code], gv);
      ch[code] = __fadd_rn(ch[code], hv);
    }
    __syncwarp();
  }
}

__device__ __forceinline__ void warp_ordered_add(float* cg, float* ch,
                                                 int code, float gv, float hv,
                                                 bool ok, int lane) {
  ordered_add_apply(cg, ch, code, gv, hv, ok, ordered_add_plan(code, ok, lane));
}
