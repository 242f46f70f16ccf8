// pv_choice: the static PV each of a round's claimants would bind per
// volume slot — the rounds engine's PV guard key, i32 [B, MVol].
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/ops/volumes.py:535 chosen_pv_slots, with
// chosen_pv (:489), chosen_pv_sdr (:511), _sdr_safe_choice (:329) and
// _dyn_at_node (:386): a contention-free fold pass against the round-start
// claim bitmap — slots in index order, the lowest-index usable PV for a
// single-volume pod, the SDR-safe choice for a multi-volume one (the
// lowest PV whose removal keeps Hall's condition over the pod's other
// pending needy slots), and intra-pod distinctness (a PV the pod already
// chose for an earlier slot is not usable again).
//
// The reference gathers [B, V] candidate planes per slot and reduces them.
// Here one thread owns a pod row. It reads the row's active flag, node and
// slot modes first; a row with no pending slot writes its -1s and leaves
// (at config #4's volume cell 85% of the rows). A claimant walks its node's
// list of available PVs and the global list ONCE, merged in ascending PV
// order (pv_common.cuh for_each_pv's order), up to kCap entries: entry e
// sets bit e of E[t] when it is unclaimed and a class/size candidate of
// slot t. Every slot's choice is then register work on those words — the
// lowest set bit for the single-volume path; for the SDR-safe choice the
// Hall margins as popcounts of ORs of the E[t] (minus the pod's own
// choices, a word too), the dominance groups (MVol = 8) as subset tests
// of the words — and the chosen entry's PV id is read back once. The
// kernel is templated on MVol, so the per-slot words, modes, classes and
// sizes are registers. A longer list (node entries + global PVs > kCap)
// takes pv::choose, the walk per slot of the earlier design.
//
// Bound on an H100: bytes — the pod rows read, the claimants' node lists,
// the [B, MVol] output written. The time is latency: the launch and a
// chain of dependent loads (node_of -> node_off -> the list entries ->
// their class, capacity and claimed flag), a few entries at the cell.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a --fmad=false ...

#include "pv_common.cuh"

namespace {

constexpr int kThreads = 64;  // 256 CTAs at B = 16384
constexpr int kCap = 32;      // list entries held as the bits of a word

// the PV at entry e of node n's merged list (gmask: the entries taken from
// the global list)
__device__ __forceinline__ int entry_pv(const pv::Ctx& c, int beg, unsigned gmask, int e) {
  const unsigned below = (1u << e) - 1u;
  return (gmask >> e) & 1u ? c.global_pv[__popc(gmask & below)]
                           : c.node_pv[beg + __popc(~gmask & below)];
}

// the earlier design for a list longer than kCap: pv::choose walks the
// merged list once per pass of each slot
__device__ __noinline__ void choose_long(const pv::Ctx& c, const pv::Sdr& sdr, int b,
                                         int node, unsigned pending, const uint8_t* claimed,
                                         int* o) {
  pv::Slots s;
  pv::load_slots(c, b, s);
  int mine[pv::kMaxVol];
  int n_mine = 0;
  for (int j = 0; j < c.MVol; ++j) {
    const int ch = pv::choose(c, sdr, s, node, j, pending, claimed, mine, n_mine);
    o[j] = ch;
    if (ch >= 0) mine[n_mine++] = ch;
    pending &= ~(1u << j);
  }
}

template <int kVol>
__global__ void __launch_bounds__(kThreads)
    pv_choice_kernel(pv::Ctx c, pv::Sdr sdr, int B, const int* node_of,
                     const uint8_t* active, const uint8_t* claimed, int* out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  int* o = out + (size_t)b * kVol;
  // the gate: active, node and modes in one round of loads
  const bool act = active[b] != 0;
  const int nraw = node_of[b];
  int mode[kVol];
#pragma unroll
  for (int t = 0; t < kVol; ++t) mode[t] = c.vol_mode[(size_t)b * kVol + t];
  unsigned pending = 0;
#pragma unroll
  for (int t = 0; t < kVol; ++t)
    if (act && mode[t] == 1) pending |= 1u << t;
  if (!pending) {
#pragma unroll
    for (int t = 0; t < kVol; ++t) o[t] = -1;
    return;
  }
  const int node = nraw < 0 ? 0 : (nraw > c.N - 1 ? c.N - 1 : nraw);
  const int beg = c.node_off[node], end = c.node_off[node + 1];
  if (end - beg + c.G > kCap) {
    choose_long(c, sdr, b, node, pending, claimed, o);
    return;
  }
  // the pending slots' class and size; whether each can ride dynamic
  // provisioning at the node (multi-volume only)
  int cls[kVol];
  float size[kVol];
  unsigned dyn = 0;
#pragma unroll
  for (int t = 0; t < kVol; ++t) {
    const size_t i = (size_t)b * kVol + t;
    cls[t] = (pending >> t) & 1u ? c.vol_class[i] : -1;
    size[t] = (pending >> t) & 1u ? c.vol_size[i] : 0.0f;
  }
  if (sdr.multi) {
#pragma unroll
    for (int t = 0; t < kVol; ++t) {
      const int rid = c.vol_req[(size_t)b * kVol + t];
      const bool d = rid == -2 ? false : pv::req_at(c, rid, node, true);
      if (d) dyn |= 1u << t;
    }
  }
  // the walk: E[t] bit e = entry e is unclaimed and a candidate of slot t
  unsigned E[kVol];
#pragma unroll
  for (int t = 0; t < kVol; ++t) E[t] = 0;
  unsigned gmask = 0;
  auto take = [&](int e, int v) {
    if (pv::claimed_at(claimed, v)) return;
    const int pc = c.pv_class[v];
    const float cap = c.pv_cap[v] + 1e-3f;
#pragma unroll
    for (int t = 0; t < kVol; ++t)
      if (((pending >> t) & 1u) && pc == cls[t] && cap >= size[t]) E[t] |= 1u << e;
  };
  const int L = end - beg;
  if (c.G == 0) {
    // the node's list alone: four entries' loads at a time
    for (int e0 = 0; e0 < L; e0 += 4) {
      int v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = e0 + k < L ? c.node_pv[beg + e0 + k] : -1;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (v[k] >= 0) take(e0 + k, v[k]);
    }
  } else {
    int i = beg, g = 0;
    for (int e = 0; e < L + c.G; ++e) {
      int v;
      if (g >= c.G || (i < end && c.node_pv[i] < c.global_pv[g])) {
        v = c.node_pv[i++];
      } else {
        v = c.global_pv[g++];
        gmask |= 1u << e;
      }
      take(e, v);
    }
  }
  // each slot's choice from the words
  unsigned mine = 0;  // entries the pod chose for earlier slots
  int res[kVol];
#pragma unroll
  for (int j = 0; j < kVol; ++j) {
    res[j] = -1;
    if (!((pending >> j) & 1u)) continue;
    int e = -1;
    if (!sdr.multi) {
      if (E[j]) e = __ffs(E[j]) - 1;
    } else {
      unsigned Eu[kVol];
#pragma unroll
      for (int t = 0; t < kVol; ++t) Eu[t] = E[t] & ~mine;
      const unsigned cand = Eu[j];
      if (cand) {
        const unsigned needy = pending & ~dyn;
        unsigned unsafe = 0;
        // the Hall margins of the other needy slots' subsets
        for (int k = __ldg(sdr.off + j); k < __ldg(sdr.off + j + 1); ++k) {
          const unsigned s = (unsigned)__ldg(sdr.mask + k) & needy;
          if (!s) continue;
          unsigned u = 0;
#pragma unroll
          for (int t = 0; t < kVol; ++t)
            if ((s >> t) & 1u) u |= Eu[t];
          if (__popc(u) <= __popc(s)) unsafe |= u;
        }
        if (kVol - 1 > 6) {
          // dominance groups: t joins anchor a's group iff t's candidates
          // are a subset of a's
#pragma unroll
          for (int a = 0; a < kVol; ++a) {
            if (a == j) continue;
            unsigned s = 0;
#pragma unroll
            for (int t = 0; t < kVol; ++t)
              if (t != j && !(Eu[t] & ~Eu[a])) s |= 1u << t;
            s &= needy;
            if (!s) continue;
            unsigned u = 0;
#pragma unroll
            for (int t = 0; t < kVol; ++t)
              if ((s >> t) & 1u) u |= Eu[t];
            if (__popc(u) <= __popc(s)) unsafe |= u;
          }
        }
        const unsigned safe = cand & ~unsafe;
        if (safe) e = __ffs(safe) - 1;
        else if (!((dyn >> j) & 1u)) e = __ffs(cand) - 1;
      }
    }
    if (e >= 0) {
      res[j] = entry_pv(c, beg, gmask, e);
      mine |= 1u << e;
    }
    pending &= ~(1u << j);
  }
#pragma unroll
  for (int t = 0; t < kVol; ++t) o[t] = res[t];
}

template <int kVol>
cudaError_t launch(const pv::Ctx& c, const pv::Sdr& sdr, int B, const int* node_of,
                   const uint8_t* active, const uint8_t* claimed, int* out,
                   cudaStream_t stream) {
  pv_choice_kernel<kVol><<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      c, sdr, B, node_of, active, claimed, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pv_choice_launch(
    int* out, int B, int N, int V, int Rq, int MVol, int G,
    const int* node_off, const int* node_pv, const int* global_pv,
    const int* pv_class, const float* pv_cap, const uint8_t* req,
    const int* vol_mode, const int* vol_req, const int* vol_class,
    const float* vol_size, const int* node_of, const uint8_t* active,
    const uint8_t* claimed, int multi, const unsigned* sdr_mask,
    const int* sdr_off, void* stream) {
  if (B <= 0 || MVol <= 0) return 0;
  if (MVol > pv::kMaxVol) return (int)cudaErrorInvalidValue;
  pv::Ctx c{N, V, Rq, MVol, G, node_off, node_pv, global_pv, pv_class, pv_cap,
            req, vol_mode, vol_req, vol_class, vol_size};
  pv::Sdr sdr{sdr_mask, sdr_off, multi};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (MVol) {
    case 1: return (int)launch<1>(c, sdr, B, node_of, active, claimed, out, st);
    case 2: return (int)launch<2>(c, sdr, B, node_of, active, claimed, out, st);
    case 3: return (int)launch<3>(c, sdr, B, node_of, active, claimed, out, st);
    case 4: return (int)launch<4>(c, sdr, B, node_of, active, claimed, out, st);
    case 5: return (int)launch<5>(c, sdr, B, node_of, active, claimed, out, st);
    case 6: return (int)launch<6>(c, sdr, B, node_of, active, claimed, out, st);
    case 7: return (int)launch<7>(c, sdr, B, node_of, active, claimed, out, st);
    default: return (int)launch<8>(c, sdr, B, node_of, active, claimed, out, st);
  }
}
