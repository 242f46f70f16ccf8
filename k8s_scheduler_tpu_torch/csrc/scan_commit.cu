// scan_commit: the scan engine's sequential commit, one persistent block.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/ops/commit.py:63 greedy_commit — a lax.scan
// over the priority-ordered pending set — with the per-pod hooks of the
// default plugin set (k8s_scheduler_tpu/framework/plugins.py NodePorts,
// NodeResourcesFit, NodeResourcesBalancedAllocation, InterPodAffinity,
// PodTopologySpread; k8s_scheduler_tpu/ops/interpod.py:151-315). For each
// rank in order, pod p = order[rank] (pad pods change nothing: skipped):
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
// The scan is P dependent steps of O(N) work each: a launch per step (the
// plain version pays some 150 small launches per step) costs more than the
// step. One block of 1024 threads runs every step: each thread owns the
// nodes n = tid + j * 1024 (their feasibility as bits of one register,
// their raw scores in shared memory, 8 bytes per node); block
// reductions (warp shuffles, then every warp reduces the 32 warp partials,
// so one __syncthreads per reduction) give the spread minimum, the two
// normalisation maxima and the argmax over (score, -index); every thread
// then knows the decision, and the commit is split over the threads with
// no two writing one word. The carried state lives in device memory (block-
// scope visibility through __syncthreads), read through the ordinary data
// path, never the read-only cache.
//
// Bound on an H100: latency (one block, P dependent steps). Bytes: the
// [P, N] static base read once; the rest stays in L2.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a --fmad=false ...
// (--fmad=false keeps every multiply and add separately rounded except
// the explicit __fmaf_rn calls, where the reference's compiled arithmetic
// fuses them).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 8;   // ops/scan_commit.py MAX_RESOURCES
constexpr int kMaxMP = 8;  // MAX_PORTS
constexpr int kMaxMA = 8;  // MAX_TERMS
constexpr int kMaxMC = 8;  // MAX_CONSTRAINTS
constexpr int kMaxK = 8;   // MAX_KEYS
constexpr float kNegInf = -1e9f;
constexpr int kWhenDoNotSchedule = 0, kWhenScheduleAnyway = 1;

// flag bits and score-term codes (ops/scan_commit.py mirrors these)
constexpr int kPorts = 1, kFit = 2, kAffinity = 4, kSpread = 8, kPortState = 16,
              kState = 32, kTables = 64, kMost = 128, kFitOnes = 256, kBalAll = 512;
constexpr int kTermFit = 1, kTermBalanced = 2, kTermAffinity = 3, kTermSpread = 4;

struct Args {
  int P, N, R, MP, MA, MC, K, S, D, Q, flags;
  int term[4];
  float weight[4];
  float w100[kMaxR];  // fit score: f32(w) * f32(100) per resource
  float rwsum;  // f32(1 / weight sum): the fit score's constant factor
  float rnf;    // f32(1 / count) of the resources BalancedAllocation averages
  int bal_mask;  // resources BalancedAllocation averages
  const float* sbase;          // [P, N]
  const int* order;            // [P]
  const uint8_t* pod_valid;    // [P]
  const int* nominated;        // [P]
  const float* req;            // [P, R]
  const float* alloc;          // [N, R]
  const float* slack;          // [N, R]
  const int* port_ids;         // [P, MP]
  const int* aff;              // [P, MA, 2]
  const uint8_t* aff_self;     // [P, MA]
  const int* anti_terms;       // [P, MA, 2]
  const int* pref_terms;       // [P, MA, 2]
  const float* pref_w;         // [P, MA]
  const int* tsc;              // [P, MC, 3]
  const int* tsc_skew;         // [P, MC]
  const int* node_domains;     // [N, K]
  const int* dom_ptr;          // [K + 1]
  const int* dom_list;         // [nd]
  const int* sel_ptr;          // [P + 1]
  const int* sel_list;         // [nnz]
  // outputs; the carried state arrives as copies of the cycle-start state
  int* assignment;             // [P]
  float* node_req;             // [N, R]
  uint8_t* ports;              // [N, Q]
  float* counts;               // [S, D]
  float* total;                // [S]
  uint8_t* anti;               // [S, N]
  float* pref;                 // [S, N]
};

// the pod of the current step, staged in shared memory
struct Pod {
  float req[kMaxR];
  int ports[kMaxMP];
  int aff_sel[kMaxMA], aff_k[kMaxMA], aff_boot[kMaxMA];
  int anti_sel[kMaxMA], anti_k[kMaxMA];
  int pref_sel[kMaxMA], pref_k[kMaxMA];
  float pref_w[kMaxMA];
  int tsc_k[kMaxMC], tsc_sel[kMaxMC], tsc_when[kMaxMC];
  float skew[kMaxMC], minc[kMaxMC];
  int sel0, sel1, nom;
  int any_hard;
};

struct Red {  // warp partials of one reduction (double-buffered)
  float v[kMaxMC][kWarps];
  int i[kWarps];
};

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// (score, index): the larger score, the lower index on ties (-0 == +0)
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// counts[sel, domain(n, k)], -1 where n lacks key k (reference
// _counts_at_nodes, with its clamps)
__device__ __forceinline__ float count_at(const Args& a, int n, int sel, int k) {
  k = min(max(k, 0), a.K - 1);
  const int d = a.node_domains[(size_t)n * a.K + k];
  if (d < 0) return -1.0f;
  sel = min(max(sel, 0), a.S - 1);
  return a.counts[(size_t)sel * a.D + min(d, a.D - 1)];
}

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// (node_requested + request) / allocatable, 1 where allocatable is 0
__device__ __forceinline__ float used_fraction(const Args& a, const Pod& pod, int n, int r) {
  const size_t nr = (size_t)n * a.R + r;
  const float al = a.alloc[nr];
  const float after = a.node_req[nr] + pod.req[r];
  return al > 0.0f ? after / fmaxf(al, 1e-9f) : 1.0f;
}

// the fit score's weighted sum; the score is this times a.rwsum, a product
// the score sum fuses (the reference divides by the constant weight sum as
// a multiply by its reciprocal). With every weight 1 the reference's
// weight multiply folds away and the sum adds rounded products.
__device__ float fit_sum(const Args& a, const Pod& pod, int n) {
  float acc = 0.0f;
  for (int r = 0; r < a.R; ++r) {
    if (a.w100[r] == 0.0f) continue;  // adds an exact 0
    const float f = clamp01(used_fraction(a, pod, n, r));
    const float x = (a.flags & kMost) ? f : 1.0f - f;
    acc = (a.flags & kFitOnes) ? acc + x * a.w100[r] : __fmaf_rn(x, a.w100[r], acc);
  }
  return acc;
}

// 1 - std of the used fractions: the balanced-allocation score before its
// final multiply by 100 (which the score sum fuses)
__device__ float balanced_factor(const Args& a, const Pod& pod, int n) {
  float frac[kMaxR];
  float tot = 0.0f;
  for (int r = 0; r < a.R; ++r) {
    if (!((a.bal_mask >> r) & 1)) continue;
    frac[r] = clamp01(used_fraction(a, pod, n, r));
    tot = tot + frac[r];
  }
  const float mean = tot * a.rnf;
  // the masked sum is not contracted; over every resource the mask folds
  // away and the squares fuse into the sum
  float var = 0.0f;
  for (int r = 0; r < a.R; ++r) {
    if (!((a.bal_mask >> r) & 1)) continue;
    const float d = frac[r] - mean;
    var = (a.flags & kBalAll) ? __fmaf_rn(d, d, var) : var + d * d;
  }
  return 1.0f - sqrtf(var * a.rnf);
}

__global__ void __launch_bounds__(kThreads, 1) scan_kernel(Args a) {
  // the raw affinity and spread scores of every node, between the masks
  // and the argmax (each thread reads only its own nodes)
  extern __shared__ float s_raw[];  // [2, N]
  float* aff_raw = s_raw;
  float* spr_raw = s_raw + a.N;
  __shared__ Pod pod;
  __shared__ Red red[2];
  __shared__ int s_nom_feasible;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool ports_on = a.flags & kPorts, fit_on = a.flags & kFit,
             aff_on = a.flags & kAffinity, spread_on = a.flags & kSpread;
  bool aff_score = false, spr_score = false;  // raw scores someone reads
  for (int t = 0; t < 4; ++t) {
    aff_score |= a.term[t] == kTermAffinity;
    spr_score |= a.term[t] == kTermSpread;
  }
  for (int i = tid; i < a.P; i += kThreads) a.assignment[i] = -1;
  int buf = 0;
  __syncthreads();
  for (int rank = 0; rank < a.P; ++rank) {
    const int p = a.order[rank];
    if (!a.pod_valid[p]) continue;  // the same branch in every thread
    // ---- stage the pod ----
    if (tid < a.R) pod.req[tid] = a.req[(size_t)p * a.R + tid];
    if (tid < a.MP) pod.ports[tid] = a.port_ids[(size_t)p * a.MP + tid];
    if (tid < a.MA) {
      const size_t t = (size_t)p * a.MA + tid;
      pod.aff_sel[tid] = a.aff[2 * t];
      pod.aff_k[tid] = a.aff[2 * t + 1];
      pod.aff_boot[tid] = a.aff_self[t];  // & total == 0, below
      pod.anti_sel[tid] = a.anti_terms[2 * t];
      pod.anti_k[tid] = a.anti_terms[2 * t + 1];
      pod.pref_sel[tid] = a.pref_terms[2 * t];
      pod.pref_k[tid] = a.pref_terms[2 * t + 1];
      pod.pref_w[tid] = a.pref_w[t];
      if (pod.aff_sel[tid] >= 0 && aff_on)
        pod.aff_boot[tid] &= a.total[min(pod.aff_sel[tid], a.S - 1)] == 0.0f;
    }
    if (tid < a.MC) {
      const size_t t = (size_t)p * a.MC + tid;
      pod.tsc_k[tid] = a.tsc[3 * t];
      pod.tsc_sel[tid] = a.tsc[3 * t + 1];
      pod.tsc_when[tid] = a.tsc[3 * t + 2];
      pod.skew[tid] = (float)a.tsc_skew[t];
    }
    if (tid == 0) {
      pod.sel0 = a.sel_ptr[p];
      pod.sel1 = a.sel_ptr[p + 1];
      pod.nom = a.nominated[p];
      s_nom_feasible = 0;
      int hard = 0;
      for (int c = 0; c < a.MC; ++c)
        hard |= a.tsc[3 * ((size_t)p * a.MC + c)] >= 0 &&
                a.tsc[3 * ((size_t)p * a.MC + c) + 2] == kWhenDoNotSchedule;
      pod.any_hard = spread_on && hard;
    }
    __syncthreads();

    // ---- spread: min count over each hard constraint's key domains ----
    if (pod.any_hard) {
      float m[kMaxMC];
      for (int c = 0; c < a.MC; ++c) {
        m[c] = INFINITY;
        const int k = pod.tsc_k[c];
        if (k < 0 || pod.tsc_when[c] != kWhenDoNotSchedule || k >= a.K) continue;
        const int sel = min(max(pod.tsc_sel[c], 0), a.S - 1);
        const float* row = a.counts + (size_t)sel * a.D;
        for (int i = a.dom_ptr[k] + tid; i < a.dom_ptr[k + 1]; i += kThreads)
          m[c] = fminf(m[c], row[a.dom_list[i]]);
      }
      for (int c = 0; c < a.MC; ++c) {
        const float w = warp_min(m[c]);
        if (lane == 0) red[buf].v[c][warp] = w;
      }
      __syncthreads();
      if (tid < a.MC) {  // one thread per constraint finishes its minimum
        float v = INFINITY;
        for (int w = 0; w < kWarps; ++w) v = fminf(v, red[buf].v[tid][w]);
        pod.minc[tid] = isfinite(v) ? v : 0.0f;
      }
      buf ^= 1;
      __syncthreads();
    }

    // ---- masks and raw affinity / spread scores of this thread's nodes ----
    unsigned feas = 0;  // bit j: node tid + j * kThreads is feasible
    float aff_hi = 0.0f, spr_hi = 0.0f;
    for (int j = 0, n = tid; n < a.N; ++j, n += kThreads) {
      bool f = a.sbase[(size_t)p * a.N + n] > kNegInf / 2;
      if (f && ports_on) {
        for (int m = 0; m < a.MP; ++m) {
          const int q = pod.ports[m];
          if (q >= 0 && a.ports[(size_t)n * a.Q + min(q, a.Q - 1)]) f = false;
        }
      }
      if (f && fit_on) {
        for (int r = 0; r < a.R; ++r) {
          const size_t nr = (size_t)n * a.R + r;
          if (!(pod.req[r] <= (a.alloc[nr] - a.node_req[nr]) + a.slack[nr])) f = false;
        }
      }
      if (f && aff_on) {
        for (int t = 0; t < a.MA; ++t) {
          const int sel = pod.aff_sel[t];
          if (sel >= 0 && !(pod.aff_boot[t] || count_at(a, n, sel, pod.aff_k[t]) > 0.0f))
            f = false;
          const int asel = pod.anti_sel[t];
          if (asel >= 0 && !(count_at(a, n, asel, pod.anti_k[t]) <= 0.0f)) f = false;
        }
        for (int i = pod.sel0; i < pod.sel1 && f; ++i)
          if (a.anti[(size_t)a.sel_list[i] * a.N + n]) f = false;
      }
      if (f && pod.any_hard) {
        for (int c = 0; c < a.MC; ++c) {
          if (pod.tsc_k[c] < 0 || pod.tsc_when[c] != kWhenDoNotSchedule) continue;
          const float cnt = count_at(a, n, pod.tsc_sel[c], pod.tsc_k[c]);
          if ((cnt + 1.0f) - pod.minc[c] > pod.skew[c] || cnt < 0.0f) f = false;
        }
      }
      if (pod.nom >= 0 && n == min(pod.nom, a.N - 1)) s_nom_feasible = f;
      if (!f) continue;
      feas |= 1u << j;
      // integer-valued terms far below 2^24 (the wrapper checks): exact
      if (aff_score) {
        float raw = 0.0f;
        for (int t = 0; t < a.MA; ++t) {
          const int sel = pod.pref_sel[t];
          if (sel < 0) continue;
          const float c = count_at(a, n, sel, pod.pref_k[t]);
          if (c > 0.0f) raw = raw + pod.pref_w[t] * c;
        }
        for (int i = pod.sel0; i < pod.sel1; ++i)
          raw = raw + a.pref[(size_t)a.sel_list[i] * a.N + n];
        aff_raw[n] = raw;
        aff_hi = fmaxf(aff_hi, fabsf(raw));
      }
      if (spr_score) {
        float sraw = 0.0f;
        for (int c = 0; c < a.MC; ++c) {
          if (pod.tsc_k[c] < 0 || pod.tsc_when[c] != kWhenScheduleAnyway) continue;
          sraw = sraw + fmaxf(count_at(a, n, pod.tsc_sel[c], pod.tsc_k[c]), 0.0f);
        }
        spr_raw[n] = sraw;
        spr_hi = fmaxf(spr_hi, sraw);
      }
    }
    // ---- the two normalisation maxima over feasible nodes ----
    aff_hi = warp_max(aff_hi);
    spr_hi = warp_max(spr_hi);
    if (lane == 0) {
      red[buf].v[0][warp] = aff_hi;
      red[buf].v[1][warp] = spr_hi;
    }
    __syncthreads();
    aff_hi = warp_max(red[buf].v[0][lane]);
    spr_hi = warp_max(red[buf].v[1][lane]);
    buf ^= 1;

    // ---- scores and the first-index argmax ----
    float best_v = -INFINITY;
    int best_i = a.N;
    for (int j = 0, n = tid; n < a.N; ++j, n += kThreads) {
      if (!((feas >> j) & 1u)) continue;
      // the dynamic score sum as the reference's fused scan step forms it
      // (framework/runtime.py Framework.dyn): each add fuses a multiply
      // feeding it — the running sum's while that is a bare product (a
      // first term that is one), else the new term's
      float dyn = 0.0f, hx = 0.0f, hc = 0.0f;
      bool have = false, held = false;
      for (int t = 0; t < 4; ++t) {
        float x, c = a.weight[t];
        switch (a.term[t]) {
          case kTermFit:
            x = fit_sum(a, pod, n);
            c = a.rwsum * a.weight[t];
            break;
          case kTermBalanced:
            x = balanced_factor(a, pod, n);
            c = 100.0f * a.weight[t];
            break;
          case kTermAffinity:
            x = aff_hi > 0.0f ? (aff_raw[n] / aff_hi) * 100.0f : 0.0f;
            break;
          case kTermSpread:
            x = spr_hi > 0.0f ? (1.0f - spr_raw[n] / spr_hi) * 100.0f : 100.0f;
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
      // one bare product: the static score's add fuses it
      const float sb = a.sbase[(size_t)p * a.N + n];
      const float s = held ? __fmaf_rn(hx, hc, sb) : sb + dyn;
      if (s > best_v) {  // j ascends, so n does: ties keep the lower index
        best_v = s;
        best_i = n;
      }
    }
    warp_argmax(best_v, best_i);
    if (lane == 0) {
      red[buf].v[0][warp] = best_v;
      red[buf].i[warp] = best_i;
    }
    __syncthreads();
    best_v = red[buf].v[0][lane];
    best_i = red[buf].i[lane];
    warp_argmax(best_v, best_i);
    buf ^= 1;
    const bool nom_ok = pod.nom >= 0 && s_nom_feasible;
    const int best = nom_ok ? min(pod.nom, a.N - 1) : best_i;
    const bool ok = nom_ok || best_i < a.N;

    // ---- the commit ----
    if (ok) {
      if (tid == 0) a.assignment[p] = best;
      if (tid < a.R) a.node_req[(size_t)best * a.R + tid] += pod.req[tid];
      if ((a.flags & kPortState) && tid < a.MP) {
        const int q = pod.ports[tid];
        if (q >= 0) a.ports[(size_t)best * a.Q + min(q, a.Q - 1)] = 1;
      }
      if (a.flags & kState) {
        // matched selectors: +1 in each of best's domains (distinct words)
        for (int i = pod.sel0 + tid; i < pod.sel1; i += kThreads) {
          const int s = a.sel_list[i];
          for (int k = 0; k < a.K; ++k) {
            const int d = a.node_domains[(size_t)best * a.K + k];
            if (d >= 0) a.counts[(size_t)s * a.D + min(d, a.D - 1)] += 1.0f;
          }
          a.total[s] += 1.0f;
        }
      }
      if (a.flags & kTables) {
        // p's own terms over the nodes of best's domain; each thread its
        // own nodes, terms in slot order
        for (int t = 0; t < a.MA; ++t) {
          const int asel = pod.anti_sel[t], psel = pod.pref_sel[t];
          const int ak = min(max(pod.anti_k[t], 0), a.K - 1);
          const int pk = min(max(pod.pref_k[t], 0), a.K - 1);
          const int ad = a.node_domains[(size_t)best * a.K + ak];
          const int pd = a.node_domains[(size_t)best * a.K + pk];
          for (int n = tid; n < a.N; n += kThreads) {
            if (asel >= 0 && ad >= 0 && a.node_domains[(size_t)n * a.K + ak] == ad)
              a.anti[(size_t)min(asel, a.S - 1) * a.N + n] = 1;
            if (psel >= 0 && pd >= 0 && a.node_domains[(size_t)n * a.K + pk] == pd)
              a.pref[(size_t)min(psel, a.S - 1) * a.N + n] += pod.pref_w[t];
          }
        }
      }
    }
    __syncthreads();
  }
}


}  // namespace

extern "C" int scan_commit_launch(
    int P, int N, int R, int MP, int MA, int MC, int K, int S, int D, int Q,
    int flags, int t0, int t1, int t2, int t3, float w0, float w1, float w2,
    float w3, float f0, float f1, float f2, float f3, float f4, float f5,
    float f6, float f7, float rwsum, float rnf, int bal_mask, const float* sbase,
    const int* order, const uint8_t* pod_valid, const int* nominated,
    const float* req, const float* alloc, const float* slack,
    const int* port_ids, const int* aff, const uint8_t* aff_self,
    const int* anti_terms, const int* pref_terms, const float* pref_w,
    const int* tsc, const int* tsc_skew, const int* node_domains,
    const int* dom_ptr, const int* dom_list, const int* sel_ptr,
    const int* sel_list, int* assignment, float* node_req, uint8_t* ports,
    float* counts, float* total, uint8_t* anti, float* pref, void* stream) {
  if (P <= 0) return 0;
  if (R > kMaxR || MP > kMaxMP || MA > kMaxMA || MC > kMaxMC || K > kMaxK || K < 1 ||
      N < 1 || N > 16 * kThreads)
    return (int)cudaErrorInvalidValue;
  Args a{P, N, R, MP, MA, MC, K, S, D, Q, flags, {t0, t1, t2, t3}, {w0, w1, w2, w3},
         {f0, f1, f2, f3, f4, f5, f6, f7}, rwsum, rnf, bal_mask, sbase, order,
         pod_valid, nominated, req, alloc, slack, port_ids, aff, aff_self,
         anti_terms, pref_terms, pref_w, tsc, tsc_skew, node_domains, dom_ptr,
         dom_list, sel_ptr, sel_list, assignment, node_req, ports, counts,
         total, anti, pref};
  const size_t smem = 2 * (size_t)N * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
