// preempt_claim: preemption's serial claim loop, one thread-block cluster.
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
// Bound on an H100: the loop is n_live dependent steps, each a small
// argmin over N nodes x MPN+1 prefixes. Bytes (the what-if verdicts and
// gate rows of the live ranks, the node tables once) take microseconds;
// what bounds a step is the latency of reading every node's tables and of
// agreeing on one winner. One block (the earlier design) read all N nodes'
// tables through one SM's load path on every step, 10-20 us a step.
//
// Design: one cluster of 16 CTAs (8, the portable size, where the card
// cannot schedule 16), launched once per pass. CTA c owns the contiguous
// node slice [c * ns, (c + 1) * ns), ns = ceil(N / cluster size), one node
// a thread (kThreads per CTA, at most kPer a thread):
//   - once per launch, each CTA stages its slice's static tables in shared
//     memory: room = alloc - node_requested, slack, node validity and a
//     "has a PDB-covered victim" bit per node, and (where they fit in
//     227 KB; else they are read from L2 through the same pointers) the
//     victim priorities, starts and pod ids and the prefix sums of freed
//     requests and priorities;
//   - the carry of a node (k_claimed, nominated_req in shared memory,
//     claimed ports in device memory) is read and written only by the
//     thread that owns the node, so it never crosses threads or CTAs; each
//     CTA keeps a replica of pdb_used [GP], and every CTA applies the
//     winner's budget increments (from the static vict_pdb rows and the
//     winner's k_claimed and kmin, which travel in the key record);
//   - per step: each CTA reduces its slice to its best key (per warp, then
//     warp 0 over the warps), writes the record into slot [step parity][its
//     rank] of every CTA's shared memory (DSMEM), and all CTAs meet at one
//     cluster barrier; then every warp reduces the records the same way, so
//     all agree on the winner (ties go to the node index; -0 and +0 tie on
//     the start, as in the reference). A key is six words whose unsigned
//     order is the lexicographic one, so a warp's argmin is one redux.sync
//     a word (half the floor of a step was three shuffle argmins over
//     eight fields). The slots are double-buffered by the step's parity: a
//     CTA that writes step t + 2's records has passed step t + 1's barrier,
//     which no CTA reaches before it has read step t's;
//   - the ranks' requests, priorities, liveness and port ids are staged at
//     launch; the gate and what-if rows of a rank are read from device
//     memory (L2) in its step (a prefetch of the next rank's rows through
//     registers and shared memory measured 7% slower);
//   - a node bit says whether an earlier nomination claimed ports there,
//     so the claimed-port table is read only then.
// A step needs a __syncthreads for the block argmin, the cluster barrier,
// and a __syncthreads after a PDB budget changed. Measured on an H100
// (64 steps): the barrier, the exchange and the argmins take 2.1 us a
// step, the keys of the fifth of the nodes whose gate is open 1.2 us.
//
// Exactness: the f32 order is the reference's, ((room - nominated_req) +
// slack) + prefix_freed[k] against req, and nominated_req += req in rank
// order; the priority sum wraps in u32 as the reference's i32 does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;            // nodes a thread at most
constexpr int kMaxCluster = 16;    // record slots per parity
constexpr int kClusterWant = 16;   // the cluster size, where schedulable
constexpr int kClusterPortable = 8;
constexpr bool kStageTables = true;
constexpr size_t kSmemLimit = 232448;  // 227 KB a block
constexpr int kMaxR = 8;     // ops/preempt_claim.py MAX_RESOURCES
constexpr int kMaxMB = 4;    // ops/preempt_claim.py MAX_PDBS_PER_POD
constexpr uint8_t kValid = 1, kHasPdb = 2, kPortClaimed = 4;
#ifndef CLAIM_TIE_LAST
#define CLAIM_TIE_LAST 0
#endif
// the fuzz harness's last-max tie-break (fuzz/replay.py engine_bug
// "tiebreak"; ops/kernel_build.py HARNESS_KERNELS builds it apart as
// preempt_claim_tie_last): the key's last word is 0x7fffffff - the node
// index, so the largest index wins a tie (and never reads as the none key)
constexpr bool kTieLast = CLAIM_TIE_LAST != 0;

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
  // the launch's shape (host-computed)
  int ns;                      // slice length
  int staged;                  // victim tables in shared memory
  int o_slots, o_wbest, o_pdb, o_kc, o_nomreq, o_room, o_slack, o_flag;
  int o_rreq, o_rprio, o_rlive, o_rports;
  int o_vprio, o_vstart, o_pods, o_pprio, o_pfreed;
};

// a node's key, packed so that unsigned order on k[0..5] is the reference's
// lexicographic order: violations, highest victim priority and priority sum
// (i32, sign bit flipped), victim count, -start of the highest victim (the
// f32 mapped to an order-preserving u32, -0 as +0: they tie, as in the
// reference), node index; the none key is all ones. kmin and kcf
// (k_claimed | kHasPdb-bit << 30 of the node) travel with it.
struct alignas(16) Rec {
  uint32_t k[6];
  int kmin, kcf;
  __device__ __forceinline__ int idx() const {
    return kTieLast ? (int)(0x7fffffffu - k[5]) : (int)k[5];
  }
  __device__ __forceinline__ bool none() const { return k[5] == 0xffffffffu; }
};

__device__ __forceinline__ Rec none_rec() {
  Rec r;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.k[i] = 0xffffffffu;
  r.kmin = r.kcf = 0;
  return r;
}

__device__ __forceinline__ uint32_t ord_i32(int v) { return (uint32_t)v ^ 0x80000000u; }

__device__ __forceinline__ uint32_t ord_f32(float f) {
  const uint32_t b = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ bool before(const Rec& a, const Rec& b) {
#pragma unroll
  for (int i = 0; i < 6; ++i)
    if (a.k[i] != b.k[i]) return a.k[i] < b.k[i];
  return false;
}

// every lane ends with the warp's least record: one redux.sync a word,
// lanes dropping out as soon as a word of theirs is above the least
__device__ __forceinline__ Rec warp_min(const Rec& r) {
  Rec o;
  bool eq = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    o.k[i] = __reduce_min_sync(0xffffffffu, eq ? r.k[i] : 0xffffffffu);
    eq = eq && r.k[i] == o.k[i];
  }
  const int src = __ffs(__ballot_sync(0xffffffffu, eq)) - 1;
  o.kmin = __shfl_sync(0xffffffffu, r.kmin, src);
  o.kcf = __shfl_sync(0xffffffffu, r.kcf, src);
  return o;
}

// the slice's tables: shared memory, or device memory (the victim tables
// when they do not fit), indexed by the node's place in the slice
struct Slice {
  int* kc;           // [ns]            carry
  float* nomreq;     // [ns, R]         carry
  const float* room;   // [ns, R]
  const float* slack;  // [ns, R]
  uint8_t* flag;       // [ns] kValid | kHasPdb | kPortClaimed (carry)
  const int* vprio;    // [ns, MPN]
  const float* vstart; // [ns, MPN]
  const int* pods;     // [ns, MPN]
  const int* pprio;    // [ns, MPN+1]
  const float* pfreed; // [ns, MPN+1, R]
  const int* pdb;      // [GP] replica of pdb_used
};

// node n's (slot ln of the slice) candidate key for a rank: its gate row
// over the slice, its what-if row of the node, its port ids
template <int R, int MB>
__device__ Rec node_key(const Args& a, const Slice& s, int ln, int n, const uint8_t* gate,
                        const uint8_t* okn, const int* ports, const float (&q)[R], int p) {
  const Rec none = none_rec();
  const uint8_t fl = s.flag[ln];
  if (!(fl & kValid) || !gate[ln]) return none;
  if (fl & kPortClaimed)  // an earlier nomination holds ports here
    for (int m = 0; m < a.MP; ++m) {
      const int qp = ports[m];
      if (qp >= 0 && a.claimed_q[(size_t)n * a.Q + min(qp, a.Q - 1)]) return none;
    }
  const int M = a.MPN;
  const int kc = s.kc[ln];
  // 8 prefixes at a time: their loads are independent, one latency a chunk
  int elig = 0;
  for (int j0 = 0; j0 < M; j0 += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (j0 + u < M) elig += s.vprio[(size_t)ln * M + j0 + u] < p;
  }
  float fb[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    fb[r] = (s.room[ln * R + r] - s.nomreq[ln * R + r]) + s.slack[ln * R + r];
  int kmin = -1;
  for (int k0 = kc; k0 <= elig && kmin < 0; k0 += 8) {
    unsigned hit = 0;  // bit u: prefix k0 + u passes the what-if and fits
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = k0 + u;
      if (k <= elig) {
        const float* pf = s.pfreed + ((size_t)ln * (M + 1) + k) * R;
        bool fits = okn[k] != 0;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (!(q[r] <= fb[r] + pf[r])) fits = false;
        hit |= (unsigned)fits << u;
      }
    }
    if (hit) kmin = k0 + __ffs(hit) - 1;
  }
  if (kmin <= kc) return none;  // none fits, or fits without a new victim
  int viol = 0;
  if (fl & kHasPdb) {  // the budgets, from device memory (rare)
    const int* gp = a.node_pods + (size_t)n * M;
    const int* vp = a.vict_pdb + (size_t)n * M * MB;
    for (int j = kc; j < kmin; ++j) {
      if (gp[j] < 0) continue;
      bool prot = false;
      for (int b = 0; b < MB && !prot; ++b) {
        const int g = vp[j * MB + b];
        if (g < 0 || g >= a.GP) continue;
        int ord = 0;  // new victims of g up to and including j
        for (int jj = kc; jj <= j; ++jj) {
          bool mem = false;
          for (int bb = 0; bb < MB; ++bb) mem |= vp[jj * MB + bb] == g;
          ord += gp[jj] >= 0 && mem;
        }
        prot = ord > __ldg(a.pdb_allowed + g) - s.pdb[g];
      }
      viol += prot;
    }
  }
  const int last = min(max(kmin - 1, 0), M - 1);
  Rec key;
  key.k[0] = (uint32_t)viol;
  key.k[1] = ord_i32(s.vprio[(size_t)ln * M + last]);
  key.k[2] = ord_i32((int)((unsigned)s.pprio[(size_t)ln * (M + 1) + kmin] -
                           (unsigned)s.pprio[(size_t)ln * (M + 1) + kc]));
  key.k[3] = (uint32_t)(kmin - kc);
  key.k[4] = ord_f32(-s.vstart[(size_t)ln * M + last]);
  key.k[5] = kTieLast ? 0x7fffffffu - (uint32_t)n : (uint32_t)n;
  key.kmin = kmin;
  key.kcf = kc | ((fl & kHasPdb) ? 1 << 30 : 0);
  return key;
}

// the winner's carry update: its owner thread claims the victims and the
// ports and grows k_claimed and nominated_req; every CTA spends the
// budgets of its replica (a __syncthreads then, uniform over the block)
template <int R, int MB>
__device__ __forceinline__ void apply(const Args& a, const Slice& s, const Rec& w, int n0,
                                      int nn, const int* ports, const float (&q)[R],
                                      int* pdb) {
  const int M = a.MPN, tid = threadIdx.x;
  const int wkc = w.kcf & 0xffff;
  const int ln = w.idx() - n0;
  if (ln >= 0 && ln < nn && ln % kThreads == tid) {  // the node's owner
    for (int j = wkc; j < w.kmin; ++j) {
      const int e = s.pods[(size_t)ln * M + j];
      if (e >= 0) a.victims[e] = 1;
    }
    s.kc[ln] = w.kmin;
#pragma unroll
    for (int r = 0; r < R; ++r) s.nomreq[ln * R + r] += q[r];
    for (int m = 0; m < a.MP; ++m) {
      const int qp = ports[m];
      if (qp < 0) continue;
      a.claimed_q[(size_t)w.idx() * a.Q + min(qp, a.Q - 1)] = 1;
      s.flag[ln] |= kPortClaimed;
    }
  }
  if (w.kcf >> 30) {  // the winner's new victims may spend budgets
    if (tid == 0) {
      const int* gp = a.node_pods + (size_t)w.idx() * M;
      const int* vp = a.vict_pdb + (size_t)w.idx() * M * MB;
      for (int j = wkc; j < w.kmin; ++j) {
        if (gp[j] < 0) continue;
        for (int b = 0; b < MB; ++b) {
          const int g = vp[j * MB + b];
          if (g >= 0) pdb[min(g, a.GP - 1)] += 1;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ T* at(unsigned char* smem, int off) {
  return reinterpret_cast<T*>(smem + off);
}

template <int R, int MB>
__global__ void __launch_bounds__(kThreads, 1) claim_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int me = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = a.MPN;
  const int n0 = me * a.ns;
  const int nn = max(0, min(a.ns, a.N - n0));  // nodes this CTA owns

  Rec* slots = at<Rec>(smem, a.o_slots);  // [2][kMaxCluster]
  Rec* wbest = at<Rec>(smem, a.o_wbest);  // [kWarps]
  int* pdb = at<int>(smem, a.o_pdb);
  int* kc = at<int>(smem, a.o_kc);
  float* nomreq = at<float>(smem, a.o_nomreq);
  float* room = at<float>(smem, a.o_room);
  float* slack = at<float>(smem, a.o_slack);
  uint8_t* flag = at<uint8_t>(smem, a.o_flag);

  // ---- stage the slice ----
  for (int i = tid; i < nn * R; i += kThreads) {
    const size_t g = (size_t)n0 * R + i;
    room[i] = a.alloc[g] - a.node_req[g];
    slack[i] = a.slack[g];
    nomreq[i] = a.nominated_req[g];
  }
  for (int ln = tid; ln < nn; ln += kThreads) {
    const int n = n0 + ln;
    kc[ln] = a.k_claimed[n];
    bool has_pdb = false;
    for (int j = 0; j < M; ++j)
      if (a.node_pods[(size_t)n * M + j] >= 0)
        for (int b = 0; b < MB; ++b)
          has_pdb |= a.vict_pdb[((size_t)n * M + j) * MB + b] >= 0;
    flag[ln] = (a.node_valid[n] ? kValid : 0) | (has_pdb ? kHasPdb : 0);
  }
  for (int g = tid; g < a.GP; g += kThreads) pdb[g] = a.pdb_used[g];
  // the ranks' requests, priorities, liveness and port ids
  float* rreq = at<float>(smem, a.o_rreq);
  int* rprio = at<int>(smem, a.o_rprio);
  uint8_t* rlive = at<uint8_t>(smem, a.o_rlive);
  int* rports = at<int>(smem, a.o_rports);
  for (int i = tid; i < a.C2 * R; i += kThreads) rreq[i] = a.req[i];
  for (int i = tid; i < a.C2; i += kThreads) {
    rprio[i] = a.prio[i];
    rlive[i] = a.live[i];
  }
  for (int i = tid; i < a.C2 * a.MP; i += kThreads) rports[i] = a.port_ids[i];
  Slice s{kc, nomreq, room, slack, flag, nullptr, nullptr, nullptr, nullptr, nullptr,
          pdb};
  if (a.staged) {
    int* vprio = at<int>(smem, a.o_vprio);
    float* vstart = at<float>(smem, a.o_vstart);
    int* pods = at<int>(smem, a.o_pods);
    int* pprio = at<int>(smem, a.o_pprio);
    float* pfreed = at<float>(smem, a.o_pfreed);
    const size_t b1 = (size_t)n0 * M, b2 = (size_t)n0 * (M + 1);
    for (int i = tid; i < nn * M; i += kThreads) {
      vprio[i] = a.vict_prio[b1 + i];
      vstart[i] = a.vict_start[b1 + i];
      pods[i] = a.node_pods[b1 + i];
    }
    for (int i = tid; i < nn * (M + 1); i += kThreads) pprio[i] = a.prefix_prio[b2 + i];
    for (int i = tid; i < nn * (M + 1) * R; i += kThreads)
      pfreed[i] = a.prefix_freed[b2 * R + i];
    s.vprio = vprio;
    s.vstart = vstart;
    s.pods = pods;
    s.pprio = pprio;
    s.pfreed = pfreed;
  } else {
    s.vprio = a.vict_prio + (size_t)n0 * M;
    s.vstart = a.vict_start + (size_t)n0 * M;
    s.pods = a.node_pods + (size_t)n0 * M;
    s.pprio = a.prefix_prio + (size_t)n0 * (M + 1);
    s.pfreed = a.prefix_freed + (size_t)n0 * (M + 1) * R;
  }
  if (me == 0)
    for (int i = tid; i < a.C2; i += kThreads) a.noms[i] = -1;
  const int n_live = *a.n_live;
  cluster.sync();  // staged, and every CTA of the cluster is running

  for (int rank = 0; rank < n_live; ++rank) {
    const int par = rank & 1;
    const uint8_t* gate = a.gate + (size_t)rank * a.N + n0;
    const uint8_t* ok = a.ok_nr + ((size_t)rank * a.N + n0) * (M + 1);
    const int* ports = rports + rank * a.MP;
    float q[R];
#pragma unroll
    for (int r = 0; r < R; ++r) q[r] = rreq[rank * R + r];
    const int p = rprio[rank];
    Rec best = none_rec();
    for (int i = 0; i < kPer; ++i) {
      const int ln = tid + i * kThreads;
      if (ln >= nn) break;
      const Rec k = node_key<R, MB>(a, s, ln, n0 + ln, gate, ok + ln * (M + 1), ports, q, p);
      if (before(k, best)) best = k;
    }
    best = warp_min(best);
    if (lane == 0) wbest[warp] = best;
    __syncthreads();
    if (warp == 0) {
      const Rec b = warp_min(lane < kWarps ? wbest[lane] : none_rec());
      if (lane < csize) *cluster.map_shared_rank(&slots[par * kMaxCluster + me], lane) = b;
    }
    cluster.sync();
    const Rec w = warp_min(lane < csize ? slots[par * kMaxCluster + lane] : none_rec());
    const bool act = rlive[rank] && !w.none();
    if (me == 0 && tid == 0) a.noms[rank] = act ? w.idx() : -1;
    if (act) apply<R, MB>(a, s, w, n0, nn, ports, q, pdb);
  }

  __syncthreads();
  for (int ln = tid; ln < nn; ln += kThreads) a.k_claimed[n0 + ln] = kc[ln];
  for (int i = tid; i < nn * R; i += kThreads) a.nominated_req[(size_t)n0 * R + i] = nomreq[i];
  if (me == 0)
    for (int g = tid; g < a.GP; g += kThreads) a.pdb_used[g] = pdb[g];
  cluster.sync();  // no CTA leaves while another may still address it
}

// shared memory layout for a slice of ns nodes; returns the bytes, or 0
// when even the carry does not fit
size_t layout(Args& a, int ns, bool stage) {
  size_t off = 0;
  auto take = [&off](size_t bytes) {
    const size_t o = off;
    off = (off + bytes + 15) & ~(size_t)15;
    return (int)o;
  };
  const size_t M = a.MPN, R = a.R;
  a.ns = ns;
  a.o_slots = take(2 * kMaxCluster * sizeof(Rec));
  a.o_wbest = take(kWarps * sizeof(Rec));
  a.o_pdb = take((size_t)a.GP * 4);
  a.o_kc = take((size_t)ns * 4);
  a.o_nomreq = take((size_t)ns * R * 4);
  a.o_room = take((size_t)ns * R * 4);
  a.o_slack = take((size_t)ns * R * 4);
  a.o_flag = take((size_t)ns);
  a.o_rreq = take((size_t)a.C2 * R * 4);
  a.o_rprio = take((size_t)a.C2 * 4);
  a.o_rlive = take((size_t)a.C2);
  a.o_rports = take((size_t)a.C2 * a.MP * 4);
  const size_t carry = off;
  if (carry > kSmemLimit) return 0;
  a.staged = 0;
  a.o_vprio = a.o_vstart = a.o_pods = a.o_pprio = a.o_pfreed = 0;
  if (stage) {
    a.o_vprio = take((size_t)ns * M * 4);
    a.o_vstart = take((size_t)ns * M * 4);
    a.o_pods = take((size_t)ns * M * 4);
    a.o_pprio = take((size_t)ns * (M + 1) * 4);
    a.o_pfreed = take((size_t)ns * (M + 1) * R * 4);
    if (off <= kSmemLimit) {
      a.staged = 1;
      return off;
    }
    a.o_vprio = a.o_vstart = a.o_pods = a.o_pprio = a.o_pfreed = 0;
  }
  return carry;
}

// the cluster size and layout of a launch: 16 CTAs where the card can
// schedule the cluster, else the portable 8; error when neither fits
template <int R, int MB>
cudaError_t plan(Args& a, cudaStream_t st, cudaLaunchConfig_t& cfg,
                 cudaLaunchAttribute& attr, size_t& smem) {
  const void* fn = (const void*)claim_kernel<R, MB>;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  const int sizes[2] = {kClusterWant, kClusterPortable};
  for (const int csize : sizes) {
    const int ns = (a.N + csize - 1) / csize;
    if (ns > kThreads * kPer) continue;
    smem = layout(a, ns, kStageTables);
    if (smem == 0) continue;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(csize, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = csize;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters >= 1) return cudaSuccess;
  }
  return cudaErrorInvalidConfiguration;
}

template <int R, int MB>
cudaError_t run(Args& a, cudaStream_t st, int* shape) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  size_t smem = 0;
  cudaError_t e = plan<R, MB>(a, st, cfg, attr, smem);
  if (e != cudaSuccess) return e;
  if (shape) {
    shape[0] = (int)cfg.gridDim.x;
    shape[1] = a.staged;
    shape[2] = (int)smem;
    return cudaSuccess;
  }
  e = cudaLaunchKernelEx(&cfg, claim_kernel<R, MB>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int R>
cudaError_t run_mb(Args& a, cudaStream_t st, int* shape) {
  switch (a.MB) {
    case 0: return run<R, 0>(a, st, shape);
    case 1: return run<R, 1>(a, st, shape);
    case 2: return run<R, 2>(a, st, shape);
    case 3: return run<R, 3>(a, st, shape);
    case 4: return run<R, 4>(a, st, shape);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(Args& a, cudaStream_t st, int* shape) {
  switch (a.R) {
    case 1: return run_mb<1>(a, st, shape);
    case 2: return run_mb<2>(a, st, shape);
    case 3: return run_mb<3>(a, st, shape);
    case 4: return run_mb<4>(a, st, shape);
    case 5: return run_mb<5>(a, st, shape);
    case 6: return run_mb<6>(a, st, shape);
    case 7: return run_mb<7>(a, st, shape);
    case 8: return run_mb<8>(a, st, shape);
  }
  return cudaErrorInvalidValue;
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
  if (R < 1 || R > kMaxR || MB < 0 || MB > kMaxMB || N < 1 || GP < 1)
    return (int)cudaErrorInvalidValue;
  Args a{C2, N, MPN, R, MB, GP, Q, MP, n_live, live, prio, req, port_ids,
         gate, ok_nr, node_valid, alloc, node_req, slack, pdb_allowed,
         node_pods, vict_prio, vict_start, vict_pdb, prefix_freed, prefix_prio,
         noms, k_claimed, nominated_req, victims, pdb_used, claimed_q};
  return (int)dispatch(a, (cudaStream_t)stream, nullptr);
}

// the launch's shape without launching: shape[0] the cluster size,
// shape[1] 1 when the victim tables are staged in shared memory, shape[2]
// the dynamic shared memory bytes of a CTA
extern "C" int preempt_claim_shape(int C2, int N, int MPN, int R, int MB, int GP, int MP,
                                   int* shape) {
  if (R < 1 || R > kMaxR || MB < 0 || MB > kMaxMB || N < 1 || GP < 1)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.C2 = C2;
  a.N = N;
  a.MPN = MPN;
  a.R = R;
  a.MB = MB;
  a.GP = GP;
  a.MP = MP;
  return (int)dispatch(a, nullptr, shape);
}
