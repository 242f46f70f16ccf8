// pv_common.cuh: what the three volume kernels (volume_mask.cu, pv_choice.cu,
// pv_fold.cu) share — the per-node lists of available PVs, a pod's volume
// slots, the per-slot candidacy test, and the SDR-safe claim choice.
//
// The PV lists (ops/volumes.py VolumeTables): node_pv[node_off[n] ..
// node_off[n+1]) are the available PVs whose nodeAffinity admits node n,
// global_pv[0 .. G) those without nodeAffinity; both ascending. A PV v is
// usable for slot t iff mode_t == 1, pv_class[v] == class_t and
// pv_cap[v] + 1e-3f >= size_t (in f32, as the reference), and it is not
// claimed. Claim bitmaps are read with __ldcg (L2, never the read-only or
// L1 path), because pv_fold.cu writes them inside its launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pv {

constexpr int kMaxVol = 8;   // ops/volume_mask.py MAX_VOLUME_SLOTS
constexpr int kMaxSub = 64;  // subset counters per pod (singletons + subsets)

struct Ctx {
  int N, V, Rq, MVol, G;
  const int* node_off;    // [N + 1]
  const int* node_pv;     // [L]
  const int* global_pv;   // [G]
  const int* pv_class;    // [V]
  const float* pv_cap;    // [V]
  const uint8_t* req;     // [Rq, N]
  // the pod rows (a pod view: B rows)
  const int* vol_mode;    // [B, MVol]
  const int* vol_req;     // [B, MVol]
  const int* vol_class;   // [B, MVol]
  const float* vol_size;  // [B, MVol]
};

struct Slots {
  int mode[kMaxVol], rid[kMaxVol], cls[kMaxVol];
  float size[kMaxVol];
};

__device__ __forceinline__ void load_slots(const Ctx& c, int b, Slots& s) {
#pragma unroll
  for (int t = 0; t < kMaxVol; ++t) {
    if (t < c.MVol) {
      const size_t i = (size_t)b * c.MVol + t;
      s.mode[t] = c.vol_mode[i];
      s.rid[t] = c.vol_req[i];
      s.cls[t] = c.vol_class[i];
      s.size[t] = c.vol_size[i];
    } else {
      s.mode[t] = -1; s.rid[t] = -1; s.cls[t] = -1; s.size[t] = 0.0f;
    }
  }
}

// bit t set iff PV v is a class/size candidate of slot t (mode 1)
__device__ __forceinline__ unsigned cand_bits(const Ctx& c, const Slots& s, int v) {
  const int cls = c.pv_class[v];
  const float cap = c.pv_cap[v] + 1e-3f;
  unsigned bits = 0;
#pragma unroll
  for (int t = 0; t < kMaxVol; ++t)
    if (s.mode[t] == 1 && cls == s.cls[t] && cap >= s.size[t]) bits |= 1u << t;
  return bits;
}

// requirement row `rid` at node n; rid < 0 -> `fill`
__device__ __forceinline__ bool req_at(const Ctx& c, int rid, int n, bool fill) {
  if (rid < 0) return fill;
  const int r = rid < c.Rq ? rid : c.Rq - 1;
  return c.req[(size_t)r * c.N + n] != 0;
}

// can slot t ride dynamic provisioning at node n
__device__ __forceinline__ bool dyn_at(const Ctx& c, const Slots& s, int t, int n) {
  return s.rid[t] == -2 ? false : req_at(c, s.rid[t], n, true);
}

// f(v) over node n's list and the global list, merged in ascending PV
// order; stops when f returns false
template <class F>
__device__ __forceinline__ void for_each_pv(const Ctx& c, int n, F f) {
  int i = c.node_off[n];
  const int end = c.node_off[n + 1];
  int g = 0;
  while (i < end || g < c.G) {
    int v;
    if (g >= c.G || (i < end && c.node_pv[i] < c.global_pv[g])) v = c.node_pv[i++];
    else v = c.global_pv[g++];
    if (!f(v)) return;
  }
}

__device__ __forceinline__ bool claimed_at(const uint8_t* claimed, int v) {
  return __ldcg(claimed + v) != 0;
}

// Subset masks of the SDR-safe choice, per slot j: sdr_mask[sdr_off[j] ..
// sdr_off[j+1]) over slot bits (ops/volumes.py _sdr_other_subsets).
struct Sdr {
  const unsigned* mask;
  const int* off;  // [MVol + 1]
  int multi;       // MVol >= 2 and has_multi_volume
};

__device__ __forceinline__ bool in_mine(const int* mine, int n_mine, int v) {
  for (int k = 0; k < n_mine; ++k)
    if (mine[k] == v) return true;
  return false;
}

// The PV claimant b's slot j claims at node n against `claimed` (and, in
// the contention-free simulation, excluding the PVs in `mine`), or -1:
// ops/volumes.py chosen_pv (single-volume) or chosen_pv_sdr (multi-volume)
// for one row. `pending` holds the claimant's unresolved slots (bit j
// included iff slot j is active).
__device__ int choose(const Ctx& c, const Sdr& sdr, const Slots& s, int n, int j,
                      unsigned pending, const uint8_t* claimed, const int* mine,
                      int n_mine) {
  if (!((pending >> j) & 1u)) return -1;
  if (!sdr.multi) {
    int best = -1;
    for_each_pv(c, n, [&](int v) {
      if (claimed_at(claimed, v)) return true;
      if ((cand_bits(c, s, v) >> j) & 1u) { best = v; return false; }
      return true;
    });
    return best;
  }
  // multi-volume: Hall margins over the other pending needy slots
  unsigned needy = 0;
  bool dyn_j = false;
  for (int t = 0; t < c.MVol; ++t) {
    const bool d = dyn_at(c, s, t, n);
    if (t == j) dyn_j = d;
    if (((pending >> t) & 1u) && s.mode[t] == 1 && !d) needy |= 1u << t;
  }
  auto usable = [&](int v) {
    return !claimed_at(claimed, v) && !in_mine(mine, n_mine, v);
  };
  unsigned eff[kMaxSub];
  int need[kMaxSub], cnt[kMaxSub];
  int n_sub = 0;
  for (int k = sdr.off[j]; k < sdr.off[j + 1] && n_sub < kMaxSub; ++k) {
    eff[n_sub] = sdr.mask[k] & needy;
    need[n_sub] = __popc(eff[n_sub]);
    cnt[n_sub] = 0;
    ++n_sub;
  }
  if (c.MVol - 1 > 6) {
    // dominance groups over the node-restricted candidate sets: t is in
    // anchor a's group iff cands_t is a subset of cands_a (and t is needy)
    unsigned nonmem[kMaxVol];
    for (int t = 0; t < kMaxVol; ++t) nonmem[t] = 0;
    for_each_pv(c, n, [&](int v) {
      if (!usable(v)) return true;
      const unsigned bits = cand_bits(c, s, v);
      for (int t = 0; t < c.MVol; ++t)
        if ((bits >> t) & 1u) nonmem[t] |= ~bits;
      return true;
    });
    for (int a = 0; a < c.MVol && n_sub < kMaxSub; ++a) {
      if (a == j) continue;
      unsigned g = 0;
      for (int t = 0; t < c.MVol; ++t)
        if (t != j && !((nonmem[t] >> a) & 1u)) g |= 1u << t;
      eff[n_sub] = g & needy;
      need[n_sub] = __popc(eff[n_sub]);
      cnt[n_sub] = 0;
      ++n_sub;
    }
  }
  for_each_pv(c, n, [&](int v) {
    if (!usable(v)) return true;
    const unsigned bits = cand_bits(c, s, v);
    if (bits)
      for (int k = 0; k < n_sub; ++k)
        if (bits & eff[k]) ++cnt[k];
    return true;
  });
  int best_safe = -1, best_any = -1;
  for_each_pv(c, n, [&](int v) {
    if (!usable(v)) return true;
    const unsigned bits = cand_bits(c, s, v);
    if (!((bits >> j) & 1u)) return true;
    if (best_any < 0) best_any = v;
    bool unsafe = false;
    for (int k = 0; k < n_sub && !unsafe; ++k)
      unsafe = (bits & eff[k]) != 0 && cnt[k] <= need[k];
    if (!unsafe) { best_safe = v; return false; }
    return true;
  });
  if (best_safe >= 0) return best_safe;
  if (dyn_j) return -1;
  return best_any;
}

}  // namespace pv
