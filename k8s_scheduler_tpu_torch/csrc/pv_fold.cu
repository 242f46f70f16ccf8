// pv_fold: a round's static-PV claims folded into the claim bitmap, the
// whole fixed-point loop in one launch.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/ops/volumes.py:419 fold_pv_claims — a
// while_loop whose body runs, slot by slot: every pending claimant chooses
// its PV against the current bitmap (chosen_pv, or chosen_pv_sdr when
// multi-volume; no intra-pod `mine`, the bitmap already holds the pod's
// earlier slots), the lowest rank per PV wins, winners set the bitmap, and
// a slot resolves when it won or had no choice. The first pass always
// runs; the loop continues while a pass made progress and a slot is still
// pending.
//
// A launch per pass and slot, plus a host read of the loop condition,
// would cost more than the work. One persistent block of 1024 threads runs
// the loop: claimants are strided over the threads (each owns its pending
// bits and its choice slot in device memory), the per-PV winner is an
// atomicMin of the rank, __syncthreads orders choose -> resolve -> reset,
// and __syncthreads_or reads the loop condition on the device. The bitmap
// and the winner table are read through L2 (__ldcg), never a read-only
// path. The choice is pv_common.cuh pv::choose, K11's device function.
//
// Bound on an H100: latency (one block, dependent passes); bytes — the
// claimants' rows and lists, the [V] bitmap in and out.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a --fmad=false ...

#include "pv_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kNoRank = 0x7fffffff;

__global__ void __launch_bounds__(kThreads, 1)
pv_fold_kernel(pv::Ctx c, pv::Sdr sdr, int B, const int* node_of,
               const uint8_t* accepted, const int* rank, uint8_t* claimed,
               int* winner, int* chs, unsigned* pend) {
  const int tid = threadIdx.x;
  for (int v = tid; v < c.V; v += kThreads) winner[v] = kNoRank;
  for (int b = tid; b < B; b += kThreads) {
    unsigned m = 0;
    if (accepted[b])
      for (int t = 0; t < c.MVol; ++t)
        if (c.vol_mode[(size_t)b * c.MVol + t] == 1) m |= 1u << t;
    pend[b] = m;
    chs[b] = -1;
  }
  __syncthreads();
  while (true) {
    int progress = 0;
    for (int j = 0; j < c.MVol; ++j) {
      // choose against the bitmap as the previous slot left it
      for (int b = tid; b < B; b += kThreads) {
        const unsigned pb = pend[b];
        if (!((pb >> j) & 1u)) continue;
        pv::Slots s;
        pv::load_slots(c, b, s);
        int node = node_of[b];
        node = node < 0 ? 0 : (node > c.N - 1 ? c.N - 1 : node);
        const int ch = pv::choose(c, sdr, s, node, j, pb, claimed, nullptr, 0);
        chs[b] = ch;
        if (ch >= 0) atomicMin(winner + ch, rank[b]);
      }
      __syncthreads();
      // the lowest rank per PV wins; won or choiceless slots resolve
      for (int b = tid; b < B; b += kThreads) {
        const unsigned pb = pend[b];
        if (!((pb >> j) & 1u)) continue;
        const int ch = chs[b];
        const bool won = ch >= 0 && __ldcg(winner + ch) == rank[b];
        if (won) {
          claimed[ch] = 1;
          progress = 1;
        }
        if (won || ch < 0) pend[b] = pb & ~(1u << j);
      }
      __syncthreads();
      for (int b = tid; b < B; b += kThreads) {
        const int ch = chs[b];
        if (ch >= 0) winner[ch] = kNoRank;
        chs[b] = -1;
      }
      __syncthreads();
    }
    int left = 0;
    for (int b = tid; b < B && !left; b += kThreads) left = pend[b] != 0;
    const int go_on = __syncthreads_or(progress);
    const int any_left = __syncthreads_or(left);
    if (!(go_on && any_left)) break;
  }
}

}  // namespace

extern "C" int pv_fold_launch(
    uint8_t* claimed, int B, int N, int V, int Rq, int MVol, int G,
    const int* node_off, const int* node_pv, const int* global_pv,
    const int* pv_class, const float* pv_cap, const uint8_t* req,
    const int* vol_mode, const int* vol_req, const int* vol_class,
    const float* vol_size, const int* node_of, const uint8_t* accepted,
    const int* rank, int multi, const unsigned* sdr_mask, const int* sdr_off,
    int* winner, int* chs, unsigned* pend, void* stream) {
  if (MVol > pv::kMaxVol) return (int)cudaErrorInvalidValue;
  pv::Ctx c{N, V, Rq, MVol, G, node_off, node_pv, global_pv, pv_class, pv_cap,
            req, vol_mode, vol_req, vol_class, vol_size};
  pv::Sdr sdr{sdr_mask, sdr_off, multi};
  pv_fold_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      c, sdr, B, node_of, accepted, rank, claimed, winner, chs, pend);
  return (int)cudaGetLastError();
}
