// volume_mask: VolumeBinding's per (pod, node) feasibility, one bool [B, N]
// plane written once.
//
// Replaces (no Pallas kernel existed; these are the XLA-compiled device
// functions): k8s_scheduler_tpu/ops/volumes.py:159 volume_mask (the static
// variant: bound-PV affinity, static-or-dynamic per unbound slot, missing
// claims) and :208 volume_mask_unbound (the per-round residue: unbound
// slots only, against the live claim bitmap), both with _hall_ok (:109),
// Hall's condition over the slot subsets of multi-volume pods.
//
// The reference spends this in dense count products, [P, V] x [V, N] per
// slot and per slot subset (about 3 TFLOP each at 16384 pods x 11264 PVs x
// 8192 nodes), for a count that is short and sparse: a node admits a
// handful of available PVs. Here one thread per (pod, node) walks the
// node's list of available PVs and the global list (pv_common.cuh), tests
// each against the pod's slots (class, f32 capacity + 1e-3, not claimed),
// and counts, per slot and per enumerated subset (host bitmasks: the
// singletons, then ops/volumes.py _hall_subsets), the PVs that serve it.
// Then: a mode-1 slot needs a static PV (count > 0) or dynamic
// provisioning at the node; every subset needs count >= its slots that
// need a static PV; above 6 slots the dominance groups (membership table
// from the caller, on the raw candidate sets) need count(anchor) >= the
// group's needy members; in the static variant a mode-0 slot needs its
// PV's nodeAffinity and a mode-2 slot fails. Counts are integers, so the
// mask is exact in any order.
//
// Bound on an H100: bytes — the [B, N] output, the pod rows (broadcast
// within a block), the node offsets and the short lists.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a --fmad=false ...

#include "pv_common.cuh"

namespace {

constexpr int kThreads = 256;

struct Args {
  pv::Ctx c;
  uint8_t* out;              // [B, N]
  int B, unbound, multi;
  const uint8_t* claimed;    // [V] or null (static variant)
  const unsigned* sub_mask;  // [n_sub]: MVol singletons, then Hall subsets
  int n_sub;
  const uint8_t* member;     // [B, MVol, MVol] (anchor, member) or null
};

template <int MAXSUB>
__global__ void volume_mask_kernel(Args a) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= a.c.N) return;
  const pv::Ctx& c = a.c;
  for (int p = blockIdx.y; p < a.B; p += gridDim.y) {
    pv::Slots s;
    pv::load_slots(c, p, s);
    bool ok = true, any1 = false;
    bool dyn[pv::kMaxVol];
#pragma unroll
    for (int t = 0; t < pv::kMaxVol; ++t) {
      dyn[t] = false;
      if (t >= c.MVol) continue;
      if (s.mode[t] == 1) {
        any1 = true;
        dyn[t] = pv::dyn_at(c, s, t, n);
      } else if (!a.unbound) {
        if (s.mode[t] == 0) ok = ok && pv::req_at(c, s.rid[t], n, true);
        else if (s.mode[t] >= 2) ok = false;
      }
    }
    if (ok && any1) {
      int cnt[MAXSUB];
#pragma unroll
      for (int k = 0; k < MAXSUB; ++k) cnt[k] = 0;
      pv::for_each_pv(c, n, [&](int v) {
        if (a.claimed != nullptr && pv::claimed_at(a.claimed, v)) return true;
        const unsigned bits = pv::cand_bits(c, s, v);
        if (bits) {
#pragma unroll
          for (int k = 0; k < MAXSUB; ++k)
            if (k < a.n_sub && (bits & a.sub_mask[k])) ++cnt[k];
        }
        return true;
      });
      // every slot loop below has a constant bound, so the per-thread
      // arrays stay in registers
      unsigned needy = 0;
#pragma unroll
      for (int t = 0; t < pv::kMaxVol; ++t) {
        if (t >= c.MVol || s.mode[t] != 1) continue;
        const int n_t = t < MAXSUB ? cnt[t < MAXSUB ? t : 0] : 0;
        ok = ok && (n_t > 0 || dyn[t]);
        if (!dyn[t]) needy |= 1u << t;
      }
      if (a.multi) {
#pragma unroll
        for (int k = 0; k < MAXSUB; ++k)
          if (k >= c.MVol && k < a.n_sub)
            ok = ok && cnt[k] >= __popc(a.sub_mask[k] & needy);
        if (a.member != nullptr) {
          const uint8_t* mem = a.member + (size_t)p * c.MVol * c.MVol;
#pragma unroll
          for (int g = 0; g < pv::kMaxVol; ++g) {
            if (g >= c.MVol) continue;
            int need = 0;
            for (int t = 0; t < c.MVol; ++t)
              need += (mem[g * c.MVol + t] != 0) && ((needy >> t) & 1u);
            const int avail = g < MAXSUB ? cnt[g < MAXSUB ? g : 0] : 0;
            ok = ok && avail >= need;
          }
        }
      }
    }
    a.out[(size_t)p * c.N + n] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int volume_mask_launch(
    uint8_t* out, int B, int N, int V, int Rq, int MVol, int G,
    const int* node_off, const int* node_pv, const int* global_pv,
    const int* pv_class, const float* pv_cap, const uint8_t* req,
    const int* vol_mode, const int* vol_req, const int* vol_class,
    const float* vol_size, const uint8_t* claimed, int unbound, int multi,
    const unsigned* sub_mask, int n_sub, const uint8_t* member, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (MVol > pv::kMaxVol || n_sub > pv::kMaxSub) return (int)cudaErrorInvalidValue;
  Args a;
  a.c = pv::Ctx{N, V, Rq, MVol, G, node_off, node_pv, global_pv, pv_class, pv_cap,
                req, vol_mode, vol_req, vol_class, vol_size};
  a.out = out; a.B = B; a.unbound = unbound; a.multi = multi;
  a.claimed = claimed; a.sub_mask = sub_mask; a.n_sub = n_sub; a.member = member;
  dim3 grid((N + kThreads - 1) / kThreads, B < 65535 ? B : 65535);
  cudaStream_t st = (cudaStream_t)stream;
  if (n_sub <= 4) volume_mask_kernel<4><<<grid, kThreads, 0, st>>>(a);
  else volume_mask_kernel<pv::kMaxSub><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
