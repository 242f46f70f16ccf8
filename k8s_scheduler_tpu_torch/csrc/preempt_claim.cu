// preempt_claim: preemption's serial claim loop, one persistent block.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/ops/preemption.py:402-576 — `step` under a
// `while_loop` bounded by the live count. For each live rank in order
// (a preemptor candidate, highest scheduling rank first):
//   - per node: eligible victims (priority strictly below the preemptor's),
//     the first prefix k in [k_claimed, elig] that fits against
//     free_base + prefix_freed[k] (free_base = ((alloc - node_requested) -
//     nominated_req) + slack), passes the what-if verdict and hits no port
//     claimed by an earlier nomination; the node is a candidate when the
//     gate holds and k > k_claimed (at least one new victim);
//   - PDB violations of the new victims: victim j violates when, for one of
//     its budgets g, the number of new victims of g up to and including j
//     exceeds pdb_allowed[g] - pdb_used[g];
//   - the node minimising (violations, highest victim priority, victim
//     priority sum (i32, wrapping), victim count, -start of the highest
//     victim, node index);
//   - the carry update: victims, PDB budgets spent, k_claimed,
//     nominated_req, claimed ports.
//
// The loop is serial by nature and each step is small (N nodes x MPN+1
// prefixes), so a launch per step (the plain version pays ~40 of them, and
// a host read of the loop bound) costs more than the step. One block of
// 1024 threads runs the whole loop on the device: it reads the live count
// from device memory, each thread scans N / 1024 nodes and keeps its best
// node by the lexicographic key, a block-wide argmin (warp shuffles, then
// one warp over the 32 warp winners) picks the nomination, thread 0
// updates the carry in device memory, and __syncthreads orders the steps
// (block-scope visibility of the carry). Carry pointers are read through
// the ordinary data path, never the read-only cache.
//
// Bound on an H100: operations at this size are tiny; the loop is latency-
// bound (one block, n_live dependent steps). Bytes: the what-if verdicts
// and the gate of the live ranks, read once, and the node tables.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 8;     // ops/preempt_claim.py MAX_RESOURCES
constexpr int kMaxMB = 4;    // ops/preempt_claim.py MAX_PDBS_PER_POD
constexpr int kNone = 0x7fffffff;

struct Args {
  int C2, N, MPN, R, MB, GP, Q, MP;
  const int* n_live;           // [1]
  const uint8_t* live;         // [C2]
  const int* prio;             // [C2]
  const float* req;            // [C2, R]
  const int* port_ids;         // [C2, MP]
  const uint8_t* gate;         // [C2, N]
  const uint8_t* ok_nr;        // [C2, N, MPN+1]
  const uint8_t* node_valid;   // [N]
  const float* alloc;          // [N, R]
  const float* node_req;       // [N, R]
  const float* slack;          // [N, R]
  const int* pdb_allowed;      // [GP]
  const int* node_pods;        // [N, MPN]
  const int* vict_prio;        // [N, MPN]
  const float* vict_start;     // [N, MPN]
  const int* vict_pdb;         // [N, MPN, MB]
  const float* prefix_freed;   // [N, MPN+1, R]
  const int* prefix_prio;      // [N, MPN+1]
  // outputs and carry (zeroed by the caller)
  int* noms;                   // [C2]
  int* k_claimed;              // [N]
  float* nominated_req;        // [N, R]
  uint8_t* victims;            // [E]
  int* pdb_used;               // [GP]
  uint8_t* claimed_q;          // [N, Q]
};

struct Key {
  int viol, maxp, sum, nv;
  float nhs;  // -start of the highest victim
  int idx, kmin;
};

__device__ __forceinline__ bool before(const Key& a, const Key& b) {
  if (a.idx == kNone) return false;
  if (b.idx == kNone) return true;
  if (a.viol != b.viol) return a.viol < b.viol;
  if (a.maxp != b.maxp) return a.maxp < b.maxp;
  if (a.sum != b.sum) return a.sum < b.sum;
  if (a.nv != b.nv) return a.nv < b.nv;
  if (a.nhs < b.nhs) return true;  // -0 and +0 tie, as in the reference
  if (b.nhs < a.nhs) return false;
  return a.idx < b.idx;
}

__device__ __forceinline__ Key shfl(const Key& k, int src) {
  Key o;
  o.viol = __shfl_xor_sync(0xffffffffu, k.viol, src);
  o.maxp = __shfl_xor_sync(0xffffffffu, k.maxp, src);
  o.sum = __shfl_xor_sync(0xffffffffu, k.sum, src);
  o.nv = __shfl_xor_sync(0xffffffffu, k.nv, src);
  o.nhs = __shfl_xor_sync(0xffffffffu, k.nhs, src);
  o.idx = __shfl_xor_sync(0xffffffffu, k.idx, src);
  o.kmin = __shfl_xor_sync(0xffffffffu, k.kmin, src);
  return o;
}

__device__ __forceinline__ Key warp_min(Key k) {
  for (int off = 16; off > 0; off >>= 1) {
    const Key o = shfl(k, off);
    if (before(o, k)) k = o;
  }
  return k;
}

// is victim slot j of node n (valid) a member of budget g?
__device__ __forceinline__ bool member(const Args& a, int n, int j, int g) {
  if (a.node_pods[(size_t)n * a.MPN + j] < 0) return false;
  const int* pb = a.vict_pdb + ((size_t)n * a.MPN + j) * a.MB;
  for (int b = 0; b < a.MB; ++b)
    if (pb[b] == g) return true;
  return false;
}

// node n's candidate key for rank `rank`, or idx = kNone
__device__ Key node_key(const Args& a, int rank, int n, const float* q, int p) {
  const Key none{0, 0, 0, 0, 0.0f, kNone, 0};
  if (!a.gate[(size_t)rank * a.N + n] || !a.node_valid[n]) return none;
  const int M = a.MPN;
  for (int m = 0; m < a.MP; ++m) {
    const int qp = a.port_ids[(size_t)rank * a.MP + m];
    if (qp >= 0 && a.claimed_q[(size_t)n * a.Q + min(qp, a.Q - 1)]) return none;
  }
  const int kc = a.k_claimed[n];
  int elig = 0;
  for (int j = 0; j < M; ++j) elig += a.vict_prio[(size_t)n * M + j] < p;
  float fb[kMaxR];
  for (int r = 0; r < a.R; ++r) {
    const size_t nr = (size_t)n * a.R + r;
    fb[r] = ((a.alloc[nr] - a.node_req[nr]) - a.nominated_req[nr]) + a.slack[nr];
  }
  const uint8_t* okn = a.ok_nr + ((size_t)rank * a.N + n) * (M + 1);
  int kmin = -1;
  for (int k = kc; k <= elig && kmin < 0; ++k) {
    if (!okn[k]) continue;
    const float* pf = a.prefix_freed + ((size_t)n * (M + 1) + k) * a.R;
    bool fits = true;
    for (int r = 0; r < a.R; ++r)
      if (!(q[r] <= fb[r] + pf[r])) fits = false;
    if (fits) kmin = k;
  }
  if (kmin <= kc) return none;  // none fits, or fits without a new victim
  Key key;
  key.idx = n;
  key.kmin = kmin;
  int viol = 0;
  for (int j = kc; j < kmin; ++j) {
    if (a.node_pods[(size_t)n * M + j] < 0) continue;
    bool prot = false;
    for (int b = 0; b < a.MB && !prot; ++b) {
      const int g = a.vict_pdb[((size_t)n * M + j) * a.MB + b];
      if (g < 0 || g >= a.GP) continue;
      int ord = 0;  // new victims of g up to and including j
      for (int jj = kc; jj <= j; ++jj) ord += member(a, n, jj, g);
      prot = ord > a.pdb_allowed[g] - a.pdb_used[g];
    }
    viol += prot;
  }
  const int last = min(max(kmin - 1, 0), M - 1);
  key.viol = viol;
  key.maxp = a.vict_prio[(size_t)n * M + last];
  key.sum = (int)((unsigned)a.prefix_prio[(size_t)n * (M + 1) + kmin] -
                  (unsigned)a.prefix_prio[(size_t)n * (M + 1) + kc]);
  key.nv = kmin - kc;
  key.nhs = -a.vict_start[(size_t)n * M + last];
  return key;
}

__global__ void __launch_bounds__(kThreads, 1) claim_kernel(Args a) {
  __shared__ Key warp_best[kWarps];
  __shared__ float s_req[kMaxR];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < a.C2; i += kThreads) a.noms[i] = -1;
  const int n_live = *a.n_live;
  __syncthreads();
  for (int rank = 0; rank < n_live; ++rank) {
    if (tid < a.R) s_req[tid] = a.req[(size_t)rank * a.R + tid];
    __syncthreads();
    float q[kMaxR];
    for (int r = 0; r < a.R; ++r) q[r] = s_req[r];
    const int p = a.prio[rank];
    Key best{0, 0, 0, 0, 0.0f, kNone, 0};
    for (int n = tid; n < a.N; n += kThreads) {
      const Key k = node_key(a, rank, n, q, p);
      if (before(k, best)) best = k;
    }
    best = warp_min(best);
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = warp_min(warp_best[lane]);
      if (lane == 0) {
        const bool act = a.live[rank] && best.idx != kNone;
        a.noms[rank] = act ? best.idx : -1;
        if (act) {
          const int b = best.idx, M = a.MPN;
          const int kc = a.k_claimed[b];
          for (int j = kc; j < best.kmin; ++j) {
            const int e = a.node_pods[(size_t)b * M + j];
            if (e < 0) continue;
            a.victims[e] = 1;
            for (int bb = 0; bb < a.MB; ++bb) {
              const int g = a.vict_pdb[((size_t)b * M + j) * a.MB + bb];
              if (g >= 0) a.pdb_used[min(g, a.GP - 1)] += 1;
            }
          }
          a.k_claimed[b] = best.kmin;
          for (int r = 0; r < a.R; ++r) a.nominated_req[(size_t)b * a.R + r] += s_req[r];
          for (int m = 0; m < a.MP; ++m) {
            const int qp = a.port_ids[(size_t)rank * a.MP + m];
            if (qp >= 0) a.claimed_q[(size_t)b * a.Q + min(qp, a.Q - 1)] = 1;
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int preempt_claim_launch(
    int C2, int N, int MPN, int R, int MB, int GP, int Q, int MP,
    const int* n_live, const uint8_t* live, const int* prio, const float* req,
    const int* port_ids, const uint8_t* gate, const uint8_t* ok_nr,
    const uint8_t* node_valid, const float* alloc, const float* node_req,
    const float* slack, const int* pdb_allowed, const int* node_pods,
    const int* vict_prio, const float* vict_start, const int* vict_pdb,
    const float* prefix_freed, const int* prefix_prio, int* noms,
    int* k_claimed, float* nominated_req, uint8_t* victims, int* pdb_used,
    uint8_t* claimed_q, void* stream) {
  if (C2 <= 0) return 0;
  if (R > kMaxR || MB > kMaxMB) return (int)cudaErrorInvalidValue;
  Args a{C2, N, MPN, R, MB, GP, Q, MP, n_live, live, prio, req, port_ids,
         gate, ok_nr, node_valid, alloc, node_req, slack, pdb_allowed,
         node_pods, vict_prio, vict_start, vict_pdb, prefix_freed, prefix_prio,
         noms, k_claimed, nominated_req, victims, pdb_used, claimed_q};
  claim_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
