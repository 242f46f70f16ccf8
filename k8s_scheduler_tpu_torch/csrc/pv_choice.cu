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
// The reference gathers [B, V] candidate planes per slot and reduces them;
// here one thread per claimant walks its node's list of available PVs and
// the global list in ascending order (pv_common.cuh pv::choose), a few
// entries each at the cell. Bound on an H100: bytes — the claimants' rows,
// their nodes' lists, the [B, MVol] output.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a --fmad=false ...

#include "pv_common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void pv_choice_kernel(pv::Ctx c, pv::Sdr sdr, int B, const int* node_of,
                                 const uint8_t* active, const uint8_t* claimed,
                                 int* out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  pv::Slots s;
  pv::load_slots(c, b, s);
  int node = node_of[b];
  node = node < 0 ? 0 : (node > c.N - 1 ? c.N - 1 : node);
  unsigned pending = 0;
  if (active[b])
    for (int t = 0; t < c.MVol; ++t)
      if (s.mode[t] == 1) pending |= 1u << t;
  int mine[pv::kMaxVol];
  int n_mine = 0;
  for (int j = 0; j < c.MVol; ++j) {
    const int ch = pv::choose(c, sdr, s, node, j, pending, claimed, mine, n_mine);
    out[(size_t)b * c.MVol + j] = ch;
    if (ch >= 0) mine[n_mine++] = ch;
    pending &= ~(1u << j);
  }
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
  if (B <= 0) return 0;
  if (MVol > pv::kMaxVol) return (int)cudaErrorInvalidValue;
  pv::Ctx c{N, V, Rq, MVol, G, node_off, node_pv, global_pv, pv_class, pv_cap,
            req, vol_mode, vol_req, vol_class, vol_size};
  pv::Sdr sdr{sdr_mask, sdr_off, multi};
  pv_choice_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      c, sdr, B, node_of, active, claimed, out);
  return (int)cudaGetLastError();
}
