// guard_sweep: the round-end participant-table sweep of the rounds engine,
// after the (group, rank) sort.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/ops/rounds.py:342-514 guards_ok with
// _seg_scan_tables (:178) — stacked int prefix counts of the role columns
// per group, the per-role tests, and the per-pod AND (.at[pods].min).
//
// The table holds L = slots * B entries; entry e of the slot-major table is
// claimant e % B in emit slot e / B, whose role is role_tab[e / B]. It is
// sorted on key * 2^rank_bits + rank (`s_packed`, permutation `perm`). A
// group is a run of equal keys; a pod's run is a run of its entries within
// a group (equal packed keys are one pod's, so the sort's tie order never
// matters). For every entry the kernel needs, per role, the count of that
// role's entries in the group strictly before the entry's pod run — what
// the reference computes as before[run_first] - before[seg_first] over one
// global cumsum, exact in integers.
//
// segments_kernel lists the group starts (GK_INVALID padding excluded) with
// an atomic counter and sets ok = 1. sweep_kernel gives each group one warp:
// 32-entry chunks, per-role ballot + popcount prefix counts plus a carry
// from the earlier chunks; each entry walks back to its pod run's start
// (at most one pod's entries: the emit slot count) and takes the counts
// there — from a lane of this chunk, or the carried start of the run that
// crosses the chunk boundary. A failed test clears ok[pod] (a plain store
// of 0: the AND). Groups are tens of entries at config #4; a long group
// costs O(len / 32) iterations of its warp.
//
// Bound on an H100: bytes — the sorted keys and the permutation read once
// (the ok bytes are small).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// role bits (ops/guard_sweep.py RB_*)
constexpr int kMatch = 1, kAnti = 2, kBoot = 4, kGmatch = 8, kSpread = 16,
              kPort = 32, kPv = 64;
// count columns
enum { cMatch, cAnti, cBoot, cGmatch, cPort, cPv, cArrive, kCols };

__device__ __forceinline__ bool in_col(int role, int c) {
  switch (c) {
    case cMatch: return role == kMatch;
    case cAnti: return role == kAnti;
    case cBoot: return role == kBoot;
    case cGmatch: return role == kGmatch;
    case cPort: return role == kPort;
    case cPv: return role == kPv;
    default: return role == kMatch || role == kSpread;  // cArrive
  }
}

__global__ void segments_kernel(int L, int B, int rank_bits, long long gk_invalid,
                                const long long* s_packed, int* seg_list,
                                int* n_seg, uint8_t* ok) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < B) ok[i] = 1;
  if (i >= L) return;
  const long long key = s_packed[i] >> rank_bits;
  if (key == gk_invalid) return;
  if (i == 0 || (s_packed[i - 1] >> rank_bits) != key)
    seg_list[atomicAdd(n_seg, 1)] = (int)i;
}

__global__ void sweep_kernel(int L, int B, int rank_bits,
                             const long long* s_packed, const long long* perm,
                             const int* role_tab, const int* caps,
                             const int* seg_list, const int* n_seg,
                             uint8_t* ok) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int warps = gridDim.x * (kThreads / 32);
  const int n = *n_seg;
  for (int g = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); g < n;
       g += warps) {
    const int s0 = seg_list[g];
    const long long key0 = s_packed[s0] >> rank_bits;
    int carry[kCols], run_start_prev[kCols];
    for (int c = 0; c < kCols; ++c) carry[c] = run_start_prev[c] = 0;
    for (int base = s0;; base += 32) {
      const int i = base + lane;
      const bool in = i < L && (s_packed[i] >> rank_bits) == key0;
      const unsigned in_mask = __ballot_sync(kFull, in);
      if (in_mask == 0) break;
      const long long e = in ? perm[i] : 0;
      const int pod = (int)(e % B);
      const int role = in ? role_tab[e / B] : 0;
      int before[kCols], total[kCols];
      for (int c = 0; c < kCols; ++c) {
        const unsigned m = __ballot_sync(kFull, in && in_col(role, c));
        before[c] = carry[c] + __popc(m & lt);
        total[c] = __popc(m);
      }
      // start of this entry's pod run within the group
      int rf = i;
      if (in)
        while (rf > s0 && (int)(perm[rf - 1] % B) == pod) --rf;
      const int src = rf - base;  // < 0: the run started in an earlier chunk
      int at[kCols];
      for (int c = 0; c < kCols; ++c) {
        const int v = __shfl_sync(kFull, before[c], src >= 0 ? src : 0);
        at[c] = src >= 0 ? v : run_start_prev[c];
      }
      if (in) {
        bool good = true;
        if (role == kAnti) good = at[cMatch] == 0;
        else if (role == kMatch) good = at[cAnti] == 0;
        else if (role == kBoot) good = at[cBoot] == 0 && at[cGmatch] == 0;
        else if (role == kSpread) good = caps == nullptr || at[cArrive] < caps[e];
        else if (role == kPort) good = at[cPort] == 0;
        else if (role == kPv) good = at[cPv] == 0;
        if (!good) ok[pod] = 0;
      }
      for (int c = 0; c < kCols; ++c) {
        run_start_prev[c] = __shfl_sync(kFull, at[c], 31);
        carry[c] += total[c];
      }
      if (in_mask != kFull) break;
    }
  }
}

}  // namespace

extern "C" int guard_sweep_launch(int L, int B, int rank_bits, int slots,
                                  long long gk_invalid, const long long* s_packed,
                                  const long long* perm, const int* role_tab,
                                  const int* caps, int* seg_list, int* n_seg,
                                  uint8_t* ok, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long span = L > B ? L : B;
  segments_kernel<<<(unsigned)((span + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      L, B, rank_bits, gk_invalid, s_packed, seg_list, n_seg, ok);
  if (L > 0) {
    int blocks = (L / 32 + kThreads / 32 - 1) / (kThreads / 32);
    if (blocks < 1) blocks = 1;
    if (blocks > 132 * 16) blocks = 132 * 16;
    sweep_kernel<<<blocks, kThreads, 0, st>>>(L, B, rank_bits, s_packed, perm,
                                              role_tab, caps, seg_list, n_seg, ok);
  }
  (void)slots;
  return (int)cudaGetLastError();
}
