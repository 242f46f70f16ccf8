// scan_commit: the scan engine's sequential commit, one thread-block cluster.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/ops/commit.py:63 greedy_commit — a lax.scan
// over the priority-ordered pending set — with the per-pod hooks of the
// default plugin set (k8s_scheduler_tpu/framework/plugins.py NodePorts,
// NodeResourcesFit, NodeResourcesBalancedAllocation, InterPodAffinity,
// PodTopologySpread; k8s_scheduler_tpu/ops/interpod.py:151-315). For each
// valid pod p in rank order:
//   feasible[n] = sbase[p, n] > NEG_INF / 2 (K1: every static filter)
//                 & no host port of p claimed at n this cycle
//                 & p's request fits (allocatable - requested) + slack
//                 & required affinity (count > 0 in n's domain, or the
//                   bootstrap rule) & anti-affinity (count <= 0) & no placed
//                   pod's anti term over n whose selector matches p
//                 & DoNotSchedule: count + 1 - min over the key's domains
//                   <= maxSkew, n has the key
//   score[n]    = sbase + the dynamic scores in the framework's order
//                 (fit, balanced allocation, affinity normalised by max
//                 |raw| over feasible nodes, spread by max raw), weighted
//                 and summed with the fused multiply-adds of the
//                 reference's compiled step; NEG_INF where infeasible
//   best        = the nominated node if feasible, else the first index of
//                 the maximum; committed when feasible
// and the commit: assignment, requested resources, claimed ports, the
// affinity counts of p's matched selectors in best's domains, and the
// anti-presence / preferred-weight rows of p's own terms over the nodes
// of best's domains.
//
// Bound on an H100: latency — P dependent steps of O(N) work each. Bytes
// (the [P, N] static base once) take a tenth of a millisecond; a step is
// bound by the latency of its loads and of agreeing on one winner. One
// block (the earlier design) read every node's state through one SM, 15 us
// a step.
//
// Design: one cluster of 16 CTAs (8, the portable size, where the card
// cannot schedule 16) of 512 threads, launched once per scan. CTA c owns
// the node slice [c * ns, (c + 1) * ns), ns = ceil(N / cluster size), at
// most two nodes a thread (node ln of the slice: thread ln % 512):
//   - once per launch, each CTA stages its slice's allocatable, slack,
//     requested resources, topology domains and host-port bits in shared
//     memory ([R][ns], [K][ns], [QW][ns] words), and a replica of the
//     selector totals [S]; a node's requested resources and port bits are
//     read and written only by its thread;
//   - the affinity counts [S, D]: each CTA keeps a replica of its own in
//     device memory (CTA 0 the output, the others scratch copied at
//     launch) and applies every step's +1s to it, so no count crosses
//     CTAs. With one owner per domain a zone's count, read by every slice
//     the zone spans, would need a cluster barrier between each commit
//     and the next step's lookups; a replica needs a __syncthreads;
//   - the anti-presence and preferred-weight columns [S, n] are read and
//     written only by node n's thread;
//   - per step: the spread minimum of the pod's DoNotSchedule constraints
//     over the CTA's replica (a block reduction), the masks and raw scores
//     of the thread's nodes, the two normalisation maxima (a cluster
//     exchange, only for a pod whose raw affinity or spread score can be
//     nonzero: the wrapper's pod flags; otherwise both maxima are 0), the
//     scores and the thread's best key, and the winner: each CTA reduces
//     to one record (per warp, then warp 0 over the warps) and stores it
//     with st.async into slot [step parity][its rank] of every CTA, where
//     it completes 48 bytes on that CTA's mbarrier of the parity; each CTA
//     waits for its mbarrier's phase, and every warp reduces the records
//     the same way, so all agree. No cluster barrier: its release would
//     wait for the step's device-memory writes to reach L2 (the counts
//     reductions, the table stores), which no other CTA reads. A CTA sends
//     step t + 2's records only after it has all of step t + 1's, which no
//     CTA sends before it has read step t's: the parity slots are free;
//   - a key is (score, -index) as two order-preserving words (-0 as +0:
//     the reference ties them and the index decides), one redux.sync a
//     word; the record carries the node's domains, so the commit reads
//     none from device memory; the owner of the nominated node ORs its
//     feasibility into its record;
//   - the wrapper packs each pod's operands into one row (request, port
//     ids, terms, constraints, its first kPodSels matched selectors,
//     flags) and the valid pods' rank order; each step loads the next
//     rank's row word and static-base values into registers, and stores
//     the row into shared memory at the next step's start (on an H100 80GB
//     HBM3 at 700 W, config #4's scan: 0.3 us a step faster than loading
//     them then; a cp.async copy of the row during the step 5% slower, a
//     prefetch of its lines into L2 no faster).
// A step has a CTA barrier after the staging (which also orders the last
// commit's counts and totals before this step's lookups), the CTA barrier
// and the mbarrier wait of the winner, a CTA barrier for the spread
// minimum and a CTA and cluster barrier for the maxima when the pod needs
// them.
//
// Exactness: the per-node arithmetic is the one-block design's; minimum,
// maximum and the first-index argmax are exact in any partition; counts
// and totals take integer +1s; each preferred-weight column is updated by
// one thread in rank and slot order.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a --fmad=false ...
// (--fmad=false keeps every multiply and add separately rounded except
// the explicit __fmaf_rn calls, where the reference's compiled arithmetic
// fuses them).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 2;            // nodes a thread at most
constexpr int kMaxCluster = 16;    // record slots per parity
constexpr size_t kSmemLimit = 232448;  // 227 KB a block
constexpr int kMaxR = 8;   // ops/scan_commit.py MAX_RESOURCES
constexpr int kMaxMP = 8;  // MAX_PORTS
constexpr int kMaxMA = 8;  // MAX_TERMS
constexpr int kMaxMC = 8;  // MAX_CONSTRAINTS
constexpr int kMaxK = 8;   // MAX_KEYS
constexpr int kPodSels = 8;  // POD_SELS: matched selectors carried in a pod row
constexpr float kNegInf = -1e9f;
constexpr int kWhenDoNotSchedule = 0, kWhenScheduleAnyway = 1;

// flag bits and score-term codes (ops/scan_commit.py mirrors these)
constexpr int kPorts = 1, kFit = 2, kAffinity = 4, kSpread = 8, kPortState = 16,
              kState = 32, kTables = 64, kMost = 128, kFitOnes = 256, kBalAll = 512;
// kTermConst: BalancedAllocation over one resource, folded to the constant
// 100 * w its weight slot holds (a bare value)
constexpr int kTermFit = 1, kTermBalanced = 2, kTermAffinity = 3, kTermSpread = 4,
              kTermConst = 5;
// pod flags: a DoNotSchedule constraint; a raw affinity / spread score
// that can be nonzero (else its normalisation maximum is 0 everywhere); an
// invalid pod row (the full mode walks it without a commit)
constexpr int kPodHard = 1, kPodAffNorm = 2, kPodSprNorm = 4, kPodInvalid = 8;
// the full mode's dynamic parts, in the order of their fail bits: NodePorts,
// NodeResourcesFit, InterPodAffinity, PodTopologySpread
constexpr int kParts = 4;

// ops/scan_commit.py ScanArgs mirrors this struct field for field
struct Args {
  int P, N, R, MP, MA, MC, K, S, D, Q, QW, W, flags, csize, ns, rep_stride;
  int term[4];
  float weight[4];
  float w100[kMaxR];  // fit score: f32(w) * f32(100) per resource
  float rwsum;  // f32(1 / weight sum): the fit score's constant factor
  float rnf;    // f32(1 / count) of the resources BalancedAllocation averages
  int bal_mask;  // resources BalancedAllocation averages
  // shared memory layout (byte offsets) and its size
  int o_slot3, o_slot2, o_wbest, o_wred, o_smin, o_dptr, o_rows, o_mbar, o_total, o_alloc,
      o_slack, o_nreq, o_ndom, o_pbits, o_wcnt, smem;
  // a pod row (int offsets): request (f32 bits) [R], port ids [MP], required
  // terms [MA, 2], self-match [MA], anti terms [MA, 2], preferred terms
  // [MA, 2], their weights (f32 bits) [MA], constraints [MC, 3], skews [MC],
  // the first kPodSels matched selectors, where the list starts, its length,
  // the nominated node and its domains [K], pod flags, the pod
  int r_req, r_ports, r_aff, r_self, r_anti, r_pref, r_prefw, r_tsc, r_skew, r_sels,
      r_sel0, r_nsel, r_nom, r_nomdom, r_flags, r_p;
  const float* sbase;          // [P, N]
  const int* vorder;           // [P] the valid pods in rank order
  const int* nv;               // [1] how many
  const int* rows;             // [P, W]
  const float* alloc;          // [N, R]
  const float* slack;          // [N, R]
  const int* node_domains;     // [N, K]
  const int* dom_ptr;          // [K + 1]
  const int* dom_list;         // [nd]
  const int* sel_list;         // [nnz]
  // outputs; the carried state arrives as copies of the cycle-start state
  int* assignment;             // [P]
  float* node_req;             // [N, R]
  uint8_t* ports;              // [N, Q]
  float* counts;               // [S, D] (CTA 0's replica)
  float* counts_rep;           // [csize - 1, rep_stride] the other replicas
  float* total;                // [S]
  uint8_t* anti;               // [S, N]
  float* pref;                 // [S, N]
  // the full mode: rejects[p, rej_col[j]] += the nodes whose first failing
  // part is j (null in the latency instance)
  int* rejects;                // [P, F], zeroed by the caller
  int F;
  int rej_col[kParts];         // each part's column (-1: no such filter)
};

// a node's key: hi the score's order-preserving word, lo ~index (the lower
// index the larger word); none is all zeros
struct alignas(16) Rec {
  uint32_t hi, lo, nomf, pad;
  int dom[kMaxK];
};
static_assert(sizeof(Rec) == 48, "ops/scan_commit.py REC_BYTES");

__device__ __forceinline__ Rec none_rec() {
  Rec r;
  r.hi = r.lo = r.nomf = r.pad = 0;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) r.dom[k] = -1;
  return r;
}

__device__ __forceinline__ uint32_t ord_f32(float f) {
  const uint32_t b = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// every lane ends with the warp's best record: the largest (hi, lo), the
// OR of the nominated-node bits
__device__ __forceinline__ Rec warp_best(const Rec& r, int K) {
  Rec o;
  o.hi = __reduce_max_sync(0xffffffffu, r.hi);
  const bool eq = r.hi == o.hi;
  o.lo = __reduce_max_sync(0xffffffffu, eq ? r.lo : 0u);
  const int src = __ffs(__ballot_sync(0xffffffffu, eq && r.lo == o.lo)) - 1;
  o.nomf = __reduce_or_sync(0xffffffffu, r.nomf);
  o.pad = 0;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) o.dom[k] = k < K ? __shfl_sync(0xffffffffu, r.dom[k], src) : -1;
  return o;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T>
__device__ __forceinline__ T* at(unsigned char* smem, int off) {
  return reinterpret_cast<T*>(smem + off);
}

// the CTA's slice in shared memory, indexed [field][slot]
struct Slice {
  int ns;
  const float* alloc;  // [R][ns]
  const float* slack;  // [R][ns]
  float* nreq;         // [R][ns]
  const int* ndom;     // [K][ns]
  uint32_t* pbits;     // [QW][ns]
  float* rep;          // the CTA's counts replica [S, D] (device memory)
};

// counts[sel, domain(n, k)], -1 where n lacks key k (reference
// _counts_at_nodes, with its clamps)
// (the load is unconditional, so the lookups of a node issue together)
__device__ __forceinline__ float count_at(const Args& a, const Slice& s, int ln, int sel,
                                          int k) {
  k = min(max(k, 0), a.K - 1);
  const int d = s.ndom[k * s.ns + ln];
  sel = min(max(sel, 0), a.S - 1);
  const float c = s.rep[(size_t)sel * a.D + min(max(d, 0), a.D - 1)];
  return d < 0 ? -1.0f : c;
}

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__device__ __forceinline__ float pod_req(const Args& a, const int* pod, int r) {
  return __int_as_float(pod[a.r_req + r]);
}

// (node_requested + request) / allocatable, 1 where allocatable is 0
__device__ __forceinline__ float used_fraction(const Args& a, const Slice& s, const int* pod,
                                               int ln, int r) {
  const float al = s.alloc[r * s.ns + ln];
  const float after = s.nreq[r * s.ns + ln] + pod_req(a, pod, r);
  return al > 0.0f ? after / fmaxf(al, 1e-9f) : 1.0f;
}

// clamp01(used fraction) of each resource a resource score reads, each
// computed once for both scores (their loads and divisions independent)
__device__ __forceinline__ void used_fractions(const Args& a, const Slice& s, const int* pod,
                                               int ln, float (&frac)[kMaxR]) {
#pragma unroll
  for (int r = 0; r < kMaxR; ++r)
    frac[r] = r < a.R && (a.w100[r] != 0.0f || ((a.bal_mask >> r) & 1))
                  ? clamp01(used_fraction(a, s, pod, ln, r)) : 0.0f;
}

// the fit score's weighted sum; the score is this times a.rwsum, a product
// the score sum fuses (the reference divides by the constant weight sum as
// a multiply by its reciprocal). With every weight 1 the reference's
// weight multiply folds away and the sum adds rounded products.
__device__ __forceinline__ float fit_sum(const Args& a, const float (&frac)[kMaxR]) {
  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    if (r >= a.R || a.w100[r] == 0.0f) continue;  // adds an exact 0
    const float x = (a.flags & kMost) ? frac[r] : 1.0f - frac[r];
    acc = (a.flags & kFitOnes) ? acc + x * a.w100[r] : __fmaf_rn(x, a.w100[r], acc);
  }
  return acc;
}

// 1 - std of the used fractions: the balanced-allocation score before its
// final multiply by 100 (which the score sum fuses)
__device__ __forceinline__ float balanced_factor(const Args& a, const float (&frac)[kMaxR]) {
  float tot = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r)
    if (r < a.R && ((a.bal_mask >> r) & 1)) tot = tot + frac[r];
  const float mean = tot * a.rnf;
  // the masked sum is not contracted; over every resource the mask folds
  // away and the squares fuse into the sum
  float var = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    if (r >= a.R || !((a.bal_mask >> r) & 1)) continue;
    const float d = frac[r] - mean;
    var = (a.flags & kBalAll) ? __fmaf_rn(d, d, var) : var + d * d;
  }
  return 1.0f - sqrtf(var * a.rnf);
}

// fn(selector) for each matched selector of the pod: the first kPodSels
// from its row, the rest from the list (two loops: no device-memory load
// for the common case, not even a speculated one)
template <typename F>
__device__ __forceinline__ void for_each_sel(const Args& a, const int* pod, F fn) {
  const int nsel = pod[a.r_nsel];
  for (int j = 0; j < min(nsel, kPodSels); ++j) fn(pod[a.r_sels + j]);
  for (int j = kPodSels; j < nsel; ++j) fn(__ldg(a.sel_list + pod[a.r_sel0] + j));
}

// node ln's feasibility for the pod (the one-block design's tests, each
// ANDed in; no test waits on an earlier one, so the node's device-memory
// lookups issue together); kFull also sets bit j of `fail` where part j
// (kParts' order) rejects the node
template <bool kFull>
__device__ __forceinline__ bool node_mask(const Args& a, const Slice& s, const int* pod,
                                          int ln, int n, float sb, const float (&minc)[kMaxMC],
                                          const float* total, unsigned& fail) {
  bool f = sb > kNegInf / 2;
  if (a.flags & kPorts) {
    for (int m = 0; m < a.MP; ++m) {
      const int q = pod[a.r_ports + m];
      if (q < 0) continue;
      const int qq = min(q, a.Q - 1);
      if ((s.pbits[(qq >> 5) * s.ns + ln] >> (qq & 31)) & 1u) {
        f = false;
        if constexpr (kFull) fail |= 1u;
      }
    }
  }
  if (a.flags & kFit) {
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r >= a.R) break;
      const int i = r * s.ns + ln;
      if (!(pod_req(a, pod, r) <= (s.alloc[i] - s.nreq[i]) + s.slack[i])) {
        f = false;
        if constexpr (kFull) fail |= 2u;
      }
    }
  }
  if (a.flags & kAffinity) {
#pragma unroll
    for (int t = 0; t < kMaxMA; ++t) {
      if (t >= a.MA) break;
      const int sel = pod[a.r_aff + 2 * t];
      if (sel >= 0) {
        const bool boot = pod[a.r_self + t] && total[min(sel, a.S - 1)] == 0.0f;
        if (!(boot || count_at(a, s, ln, sel, pod[a.r_aff + 2 * t + 1]) > 0.0f)) {
          f = false;
          if constexpr (kFull) fail |= 4u;
        }
      }
      const int asel = pod[a.r_anti + 2 * t];
      if (asel >= 0 && !(count_at(a, s, ln, asel, pod[a.r_anti + 2 * t + 1]) <= 0.0f)) {
        f = false;
        if constexpr (kFull) fail |= 4u;
      }
    }
    for_each_sel(a, pod, [&](int sl) {
      if (a.anti[(size_t)sl * a.N + n]) {
        f = false;
        if constexpr (kFull) fail |= 4u;
      }
    });
  }
  if (pod[a.r_flags] & kPodHard) {
#pragma unroll
    for (int c = 0; c < kMaxMC; ++c) {
      if (c >= a.MC) break;
      const int k = pod[a.r_tsc + 3 * c];
      if (k < 0 || pod[a.r_tsc + 3 * c + 2] != kWhenDoNotSchedule) continue;
      const float cnt = count_at(a, s, ln, pod[a.r_tsc + 3 * c + 1], k);
      if ((cnt + 1.0f) - minc[c] > (float)pod[a.r_skew + c] || cnt < 0.0f) {
        f = false;
        if constexpr (kFull) fail |= 8u;
      }
    }
  }
  return f;
}

// integer-valued terms far below 2^24 (the wrapper checks): exact
__device__ __forceinline__ float affinity_raw(const Args& a, const Slice& s, const int* pod,
                                              int ln, int n) {
  float raw = 0.0f;
  for (int t = 0; t < a.MA; ++t) {
    const int sel = pod[a.r_pref + 2 * t];
    if (sel < 0) continue;
    const float c = count_at(a, s, ln, sel, pod[a.r_pref + 2 * t + 1]);
    if (c > 0.0f) raw = raw + __int_as_float(pod[a.r_prefw + t]) * c;
  }
  for_each_sel(a, pod, [&](int sl) { raw = raw + a.pref[(size_t)sl * a.N + n]; });
  return raw;
}

__device__ __forceinline__ float spread_raw(const Args& a, const Slice& s, const int* pod,
                                            int ln) {
  float sraw = 0.0f;
  for (int c = 0; c < a.MC; ++c) {
    const int k = pod[a.r_tsc + 3 * c];
    if (k < 0 || pod[a.r_tsc + 3 * c + 2] != kWhenScheduleAnyway) continue;
    sraw = sraw + fmaxf(count_at(a, s, ln, pod[a.r_tsc + 3 * c + 1], k), 0.0f);
  }
  return sraw;
}

// the static score plus the dynamic score sum as the reference's fused
// scan step forms it (framework/runtime.py Framework.dyn): each add fuses
// a multiply feeding it — the running sum's while that is a bare product
// (a first term that is one), else the new term's; one bare product alone
// fuses into the static score's add
__device__ __forceinline__ float node_score(const Args& a, const Slice& s, const int* pod,
                                            int ln, float sb, float araw, float aff_hi,
                                            float sraw, float spr_hi) {
  float frac[kMaxR];
  used_fractions(a, s, pod, ln, frac);
  float dyn = 0.0f, hx = 0.0f, hc = 0.0f;
  bool have = false, held = false;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    float x, c = a.weight[t];
    switch (a.term[t]) {
      case kTermFit:
        x = fit_sum(a, frac);
        c = a.rwsum * a.weight[t];
        break;
      case kTermBalanced:
        x = balanced_factor(a, frac);
        c = 100.0f * a.weight[t];
        break;
      case kTermAffinity:
        x = aff_hi > 0.0f ? (araw / aff_hi) * 100.0f : 0.0f;
        break;
      case kTermSpread:
        x = spr_hi > 0.0f ? (1.0f - sraw / spr_hi) * 100.0f : 100.0f;
        break;
      case kTermConst:
        x = a.weight[t];
        c = 1.0f;
        break;
      default: continue;
    }
    const bool prod = c != 1.0f;
    if (!have) {
      have = true;
      if (prod) {
        held = true;
        hx = x;
        hc = c;
      } else {
        dyn = x;
      }
    } else if (held) {
      dyn = __fmaf_rn(hx, hc, prod ? x * c : x);
      held = false;
    } else {
      dyn = prod ? __fmaf_rn(x, c, dyn) : dyn + x;
    }
  }
  return held ? __fmaf_rn(hx, hc, sb) : sb + dyn;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the shared::cluster address of `addr` (this CTA's) in CTA `rank`
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// one arrival on this CTA's mbarrier, expecting `bytes` of st.async stores
__device__ __forceinline__ void mbar_expect(uint64_t* mbar, uint32_t bytes) {
  uint64_t state;
  asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state) : "r"(smem_addr(mbar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* mbar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(mbar)), "r"(parity) : "memory");
}

// record `r` into the slot at `dst` of another CTA (shared::cluster
// addresses), completing 48 bytes on that CTA's mbarrier at `mbar`
__device__ __forceinline__ void st_async4(uint32_t dst, uint32_t mbar, uint32_t x, uint32_t y,
                                          uint32_t z, uint32_t w) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" :: "r"(dst), "r"(x), "r"(y), "r"(z), "r"(w), "r"(mbar) : "memory");
}

__device__ __forceinline__ void send_rec(uint32_t dst, uint32_t mbar, const Rec& r) {
  st_async4(dst, mbar, r.hi, r.lo, r.nomf, r.pad);
  st_async4(dst + 16, mbar, r.dom[0], r.dom[1], r.dom[2], r.dom[3]);
  st_async4(dst + 32, mbar, r.dom[4], r.dom[5], r.dom[6], r.dom[7]);
}

// the full mode's counts of one step: each warp's nodes whose first failing
// part (the smallest column among the parts that reject a node the static
// base admits) is part j, into wcnt[warp][j]
__device__ __forceinline__ void count_parts(const Args& a, const unsigned (&failb)[kPer],
                                            int* wcnt, int lane, int warp) {
  int first[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    first[i] = -1;
    int col = 1 << 30;
#pragma unroll
    for (int j = 0; j < kParts; ++j)
      if (((failb[i] >> j) & 1u) && a.rej_col[j] >= 0 && a.rej_col[j] < col) {
        col = a.rej_col[j];
        first[i] = j;
      }
  }
#pragma unroll
  for (int j = 0; j < kParts; ++j) {
    int n = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) n += first[i] == j;
    n = __reduce_add_sync(0xffffffffu, n);
    if (lane == 0) wcnt[warp * kParts + j] = n;
  }
}

// the step's counts over the CTA's warps, one integer atomic a part (lanes
// 0 .. kParts - 1 of the calling warp)
__device__ __forceinline__ void add_parts(const Args& a, const int* wcnt, int p, int lane) {
  if (lane >= kParts || a.rej_col[lane] < 0) return;
  int n = 0;
  for (int w = 0; w < kWarps; ++w) n += wcnt[w * kParts + lane];
  if (n > 0) atomicAdd(a.rejects + (size_t)p * a.F + a.rej_col[lane], n);
}

template <bool kFull>
__global__ void __launch_bounds__(kThreads, 1) scan_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int me = (int)cluster.block_rank();
  const int csize = a.csize, ns = a.ns, R = a.R, K = a.K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = me * ns;
  const int nn = max(0, min(ns, a.N - n0));  // nodes this CTA owns

  Rec* slot3 = at<Rec>(smem, a.o_slot3);       // [2][kMaxCluster] winner records
  uint2* slot2 = at<uint2>(smem, a.o_slot2);   // [2][kMaxCluster] maxima
  Rec* wbest = at<Rec>(smem, a.o_wbest);       // [kWarps]
  uint2* wred = at<uint2>(smem, a.o_wred);     // [kWarps]
  float* smin = at<float>(smem, a.o_smin);     // [kMaxMC][kWarps]
  int* dptr = at<int>(smem, a.o_dptr);         // [K + 1]
  int* rows = at<int>(smem, a.o_rows);         // [2][W] the step's pod row, by parity
  uint64_t* mbar = at<uint64_t>(smem, a.o_mbar);  // [2] the winner records' arrival
  float* total = at<float>(smem, a.o_total);   // [S]
  int* wcnt = at<int>(smem, a.o_wcnt);         // [kWarps][kParts] (kFull)
  Slice s{ns, at<float>(smem, a.o_alloc), at<float>(smem, a.o_slack),
          at<float>(smem, a.o_nreq), at<int>(smem, a.o_ndom), at<uint32_t>(smem, a.o_pbits),
          me == 0 ? a.counts : a.counts_rep + (size_t)(me - 1) * a.rep_stride};
  const bool aff_score = a.term[0] == kTermAffinity || a.term[1] == kTermAffinity ||
                         a.term[2] == kTermAffinity || a.term[3] == kTermAffinity;
  const bool spr_score = a.term[0] == kTermSpread || a.term[1] == kTermSpread ||
                         a.term[2] == kTermSpread || a.term[3] == kTermSpread;

  // ---- stage the slice, the totals and the counts replica ----
  {
    float* alloc = at<float>(smem, a.o_alloc);
    float* slack = at<float>(smem, a.o_slack);
    int* ndom = at<int>(smem, a.o_ndom);
    for (int i = tid; i < nn * R; i += kThreads) {
      const int ln = i / R, r = i % R;
      const size_t g = (size_t)n0 * R + i;
      alloc[r * ns + ln] = a.alloc[g];
      slack[r * ns + ln] = a.slack[g];
      s.nreq[r * ns + ln] = a.node_req[g];
    }
    for (int i = tid; i < nn * K; i += kThreads)
      ndom[(i % K) * ns + i / K] = a.node_domains[(size_t)n0 * K + i];
    for (int i = tid; i < nn * a.QW; i += kThreads) {
      const int ln = i / a.QW, w = i % a.QW;
      uint32_t bits = 0;
      for (int q = w * 32; q < min(a.Q, w * 32 + 32); ++q)
        bits |= (uint32_t)(a.ports[(size_t)(n0 + ln) * a.Q + q] != 0) << (q & 31);
      s.pbits[w * ns + ln] = bits;
    }
  }
  for (int i = tid; i < a.S; i += kThreads) total[i] = a.total[i];
  for (int i = tid; i <= K; i += kThreads) dptr[i] = a.dom_ptr[i];
  if (me > 0) {
    const size_t m = (size_t)a.S * a.D;
    const float4* src = reinterpret_cast<const float4*>(a.counts);
    float4* dst = reinterpret_cast<float4*>(s.rep);
    for (size_t i = tid; i < m / 4; i += kThreads) dst[i] = src[i];
    for (size_t i = m / 4 * 4 + tid; i < m; i += kThreads) s.rep[i] = a.counts[i];
  }
  if (me == 0)
    for (int i = tid; i < a.P; i += kThreads) a.assignment[i] = -1;
  const int nv = *a.nv;

  if (tid < 2)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&mbar[tid])));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  // the next rank's pod (loaded two steps ahead), its row word and its
  // static-base values (loaded a step ahead, into registers)
  int p_next = nv > 1 ? a.vorder[1] : 0, row_next = 0;
  float sb_next[kPer];
  if (nv > 0) {
    const int p0 = a.vorder[0];
    row_next = tid < a.W ? __ldg(a.rows + (size_t)p0 * a.W + tid) : 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int ln = tid + i * kThreads;
      sb_next[i] = ln < nn ? __ldcs(a.sbase + (size_t)p0 * a.N + n0 + ln) : kNegInf;
    }
  }
  cluster.sync();  // staged, and every CTA of the cluster is running

  int ex = 0;  // kFull: the winner exchanges so far (a step of a valid pod)
  for (int rank = 0; rank < nv; ++rank) {
    const int par = rank & 1;
    // ---- stage the pod's row and its static-base values, and load the
    // next rank's ----
    const int p_after = rank + 2 < nv ? __ldg(a.vorder + rank + 2) : 0;
    int* pod = rows + par * a.W;
    if (tid < a.W) pod[tid] = row_next;
    float sb_cur[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) sb_cur[i] = sb_next[i];
    if (rank + 1 < nv) {
      row_next = tid < a.W ? __ldg(a.rows + (size_t)p_next * a.W + tid) : 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int ln = tid + i * kThreads;
        sb_next[i] = ln < nn ? __ldcs(a.sbase + (size_t)p_next * a.N + n0 + ln) : kNegInf;
      }
    }
    p_next = p_after;
    if (!kFull && tid == 0) mbar_expect(&mbar[par], (uint32_t)(csize * sizeof(Rec)));
    // the row, and the previous step's counts and totals
    __syncthreads();
    const int pflags = pod[a.r_flags];
    // kFull walks every rank: an invalid pod's step counts its rejections
    // and exchanges nothing; the exchanges take their slots and phases by
    // their own count
    const bool live = !kFull || !(pflags & kPodInvalid);
    const int xs = kFull ? ex : rank;
    const int xpar = xs & 1;
    if (kFull && live && tid == 0) mbar_expect(&mbar[xpar], (uint32_t)(csize * sizeof(Rec)));

    // ---- spread: min count over each hard constraint's key domains ----
    float minc[kMaxMC];
#pragma unroll
    for (int c = 0; c < kMaxMC; ++c) minc[c] = 0.0f;
    if (pflags & kPodHard) {
#pragma unroll
      for (int c = 0; c < kMaxMC; ++c) {
        if (c >= a.MC) break;
        float m = INFINITY;
        const int k = pod[a.r_tsc + 3 * c];
        if (k >= 0 && pod[a.r_tsc + 3 * c + 2] == kWhenDoNotSchedule && k < K) {
          const int sel = min(max(pod[a.r_tsc + 3 * c + 1], 0), a.S - 1);
          const float* row = s.rep + (size_t)sel * a.D;
          for (int i = dptr[k] + tid; i < dptr[k + 1]; i += kThreads)
            m = fminf(m, row[__ldg(a.dom_list + i)]);
        }
        m = warp_min(m);
        if (lane == 0) smin[c * kWarps + warp] = m;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kMaxMC; ++c) {
        if (c >= a.MC) break;
        const float v = warp_min(lane < kWarps ? smin[c * kWarps + lane] : INFINITY);
        minc[c] = isfinite(v) ? v : 0.0f;
      }
    }

    // ---- masks and raw affinity / spread scores of this thread's nodes ----
    const bool need_aff = aff_score && (pflags & kPodAffNorm);
    const bool need_spr = spr_score && (pflags & kPodSprNorm);
    const int nom = pod[a.r_nom];
    const int nom_n = nom >= 0 ? min(nom, a.N - 1) : -1;
    unsigned feas = 0, nomf = 0;
    unsigned failb[kPer];
    float araw[kPer], sraw[kPer];
    float aff_hi = 0.0f, spr_hi = 0.0f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      araw[i] = sraw[i] = 0.0f;
      failb[i] = 0;
      const int ln = tid + i * kThreads;
      if (ln >= nn) continue;
      const int n = n0 + ln;
      const bool f = node_mask<kFull>(a, s, pod, ln, n, sb_cur[i], minc, total, failb[i]);
      if (kFull && !(sb_cur[i] > kNegInf / 2)) failb[i] = 0;  // the static base's rejection
      if (n == nom_n) nomf = f;
      if (!f) continue;
      feas |= 1u << i;
      if (need_aff) {
        araw[i] = affinity_raw(a, s, pod, ln, n);
        aff_hi = fmaxf(aff_hi, fabsf(araw[i]));
      }
      if (need_spr) {
        sraw[i] = spread_raw(a, s, pod, ln);
        spr_hi = fmaxf(spr_hi, sraw[i]);
      }
    }
    if constexpr (kFull) {
      count_parts(a, failb, wcnt, lane, warp);
      if (!live) {  // an invalid pod: its counts out, no exchange, no commit
        __syncthreads();
        if (warp == 0) add_parts(a, wcnt, pod[a.r_p], lane);
        continue;
      }
    }
    // ---- the two normalisation maxima over the cluster's feasible nodes
    // (non-negative floats: their bits order as unsigned words) ----
    if (need_aff || need_spr) {
      const uint32_t ah = __reduce_max_sync(0xffffffffu, __float_as_uint(aff_hi));
      const uint32_t sh = __reduce_max_sync(0xffffffffu, __float_as_uint(spr_hi));
      if (lane == 0) wred[warp] = make_uint2(ah, sh);
      __syncthreads();
      if (warp == 0) {
        const uint2 v = lane < kWarps ? wred[lane] : make_uint2(0u, 0u);
        const uint2 m = make_uint2(__reduce_max_sync(0xffffffffu, v.x),
                                   __reduce_max_sync(0xffffffffu, v.y));
        if (lane < csize) *cluster.map_shared_rank(&slot2[xpar * kMaxCluster + me], lane) = m;
      }
      cluster.sync();
      const uint2 v = lane < csize ? slot2[xpar * kMaxCluster + lane] : make_uint2(0u, 0u);
      aff_hi = __uint_as_float(__reduce_max_sync(0xffffffffu, v.x));
      spr_hi = __uint_as_float(__reduce_max_sync(0xffffffffu, v.y));
    }

    // ---- scores and this thread's best (score, -index) ----
    Rec best = none_rec();
    int best_ln = -1;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (!((feas >> i) & 1u)) continue;
      const int ln = tid + i * kThreads;
      const float sc = node_score(a, s, pod, ln, sb_cur[i], araw[i], aff_hi, sraw[i], spr_hi);
      if (!(sc > -INFINITY)) continue;
      const uint32_t hi = ord_f32(sc), lo = ~(uint32_t)(n0 + ln);
      if (hi > best.hi || (hi == best.hi && lo > best.lo)) {
        best.hi = hi;
        best.lo = lo;
        best_ln = ln;
      }
    }
    if (best_ln >= 0) {
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) best.dom[k] = k < K ? s.ndom[k * ns + best_ln] : -1;
    }
    best.nomf = nomf;
    // ---- the winner: per warp, over the warps, over the cluster ----
    {
      const Rec w = warp_best(best, K);
      if (lane == 0) wbest[warp] = w;
    }
    __syncthreads();
    if (warp == 0) {
      const Rec c = warp_best(lane < kWarps ? wbest[lane] : none_rec(), K);
      if (lane < csize)
        send_rec(cluster_addr(smem_addr(&slot3[xpar * kMaxCluster + me]), lane),
                 cluster_addr(smem_addr(&mbar[xpar]), lane), c);
    }
    if (kFull && warp == 1) add_parts(a, wcnt, pod[a.r_p], lane);
    mbar_wait(&mbar[xpar], (xs >> 1) & 1);  // every CTA's record has arrived
    if (kFull) ++ex;
    const Rec win = warp_best(lane < csize ? slot3[xpar * kMaxCluster + lane] : none_rec(), K);
    const bool nom_ok = nom >= 0 && win.nomf;
    const int bn = nom_ok ? nom_n : (int)~win.lo;
    const bool ok = nom_ok || win.hi != 0u;

    // ---- the commit ----
    const int nsel = pod[a.r_nsel];
    if (ok) {
      int dom[kMaxK];
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        dom[k] = k >= K ? -1 : nom_ok ? pod[a.r_nomdom + k] : win.dom[k];
      const int bl = bn - n0;
      if (bl >= 0 && bl < nn && tid == bl % kThreads) {  // the node's thread
        a.assignment[pod[a.r_p]] = bn;
        for (int r = 0; r < R; ++r) s.nreq[r * ns + bl] += pod_req(a, pod, r);
        if (a.flags & kPortState) {
          for (int m = 0; m < a.MP; ++m) {
            const int q = pod[a.r_ports + m];
            if (q < 0) continue;
            const int qq = min(q, a.Q - 1);
            s.pbits[(qq >> 5) * ns + bl] |= 1u << (qq & 31);
          }
        }
      }
      if (a.flags & kState) {
        // matched selectors: +1 in each of best's domains (distinct words),
        // all by thread 0
        if (tid == 0)
          for_each_sel(a, pod, [&](int sl) {
#pragma unroll
            for (int k = 0; k < kMaxK; ++k)
              if (k < K && dom[k] >= 0)  // a reduction: no load on the step's path
                atomicAdd(s.rep + (size_t)sl * a.D + min(dom[k], a.D - 1), 1.0f);
            total[sl] += 1.0f;
          });
      }
      if (a.flags & kTables) {
        // p's own terms over the nodes of best's domain; each thread its
        // own nodes, terms in slot order
        for (int t = 0; t < a.MA; ++t) {
          const int asel = pod[a.r_anti + 2 * t], psel = pod[a.r_pref + 2 * t];
          if (asel < 0 && psel < 0) continue;
          const int ak = min(max(pod[a.r_anti + 2 * t + 1], 0), K - 1);
          const int pk = min(max(pod[a.r_pref + 2 * t + 1], 0), K - 1);
          int ad = -1, pd = -1;
#pragma unroll
          for (int k = 0; k < kMaxK; ++k) {
            if (k == ak) ad = dom[k];
            if (k == pk) pd = dom[k];
          }
          const float pw = __int_as_float(pod[a.r_prefw + t]);
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const int ln = tid + i * kThreads;
            if (ln >= nn) continue;
            const size_t n = (size_t)n0 + ln;
            if (asel >= 0 && ad >= 0 && s.ndom[ak * ns + ln] == ad)
              a.anti[(size_t)min(asel, a.S - 1) * a.N + n] = 1;
            if (psel >= 0 && pd >= 0 && s.ndom[pk * ns + ln] == pd)
              a.pref[(size_t)min(psel, a.S - 1) * a.N + n] += pw;
          }
        }
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < nn * R; i += kThreads)
    a.node_req[(size_t)n0 * R + i] = s.nreq[(i % R) * ns + i / R];
  for (int i = tid; i < nn * a.Q; i += kThreads) {
    const int ln = i / a.Q, q = i % a.Q;
    a.ports[(size_t)n0 * a.Q + i] = (s.pbits[(q >> 5) * ns + ln] >> (q & 31)) & 1u;
  }
  if (me == 0)
    for (int i = tid; i < a.S; i += kThreads) a.total[i] = total[i];
  cluster.sync();  // no CTA leaves while another may still address it
}

// the latency instance, or the full mode's where the caller gives rejects
const void* kernel_of(bool full) {
  return full ? (const void*)scan_kernel<true> : (const void*)scan_kernel<false>;
}

cudaError_t configure(const Args& a, cudaStream_t st, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  const void* fn = kernel_of(a.rejects != nullptr);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (e != cudaSuccess) return e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(a.csize, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" int scan_commit_args_size() { return (int)sizeof(Args); }

// how many clusters of `csize` CTAs with `smem` bytes each the card can
// hold at once (0: it cannot schedule one), of the latency instance or
// (`full`) the full mode's
extern "C" int scan_commit_clusters(int csize, int smem, int full, int* clusters) {
  if (csize < 1 || csize > kMaxCluster || smem < 0 || (size_t)smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.csize = csize;
  a.smem = smem;
  int dummy = 0;
  a.rejects = full ? &dummy : nullptr;  // selects the instance only
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(a, nullptr, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel_of(full != 0), &cfg);
}

// `args` points at an Args (an opaque pointer: a type of the anonymous
// namespace in the signature would give the function internal linkage)
extern "C" int scan_commit_launch(const void* args, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  if (a.P <= 0) return 0;
  if (a.R < 1 || a.R > kMaxR || a.MP > kMaxMP || a.MA > kMaxMA || a.MC > kMaxMC ||
      a.K < 1 || a.K > kMaxK || a.N < 1 || a.csize < 1 || a.csize > kMaxCluster ||
      a.ns < 1 || a.ns > kThreads * kPer || (long long)a.ns * a.csize < a.N ||
      a.smem < 0 || (size_t)a.smem > kSmemLimit || a.W > kThreads ||
      (a.csize > 1 && a.rep_stride % 4 != 0) ||
      (a.rejects != nullptr && (a.F < 1 || a.o_wcnt < 0)))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(a, (cudaStream_t)stream, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  e = a.rejects != nullptr ? cudaLaunchKernelEx(&cfg, scan_kernel<true>, a)
                           : cudaLaunchKernelEx(&cfg, scan_kernel<false>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
