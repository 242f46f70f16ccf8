// affinity_update: fold one rounds-engine round's accepted placements into
// the inter-pod affinity state, old tables in, new tables out.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/ops/interpod.py:489-548
// affinity_update_batched, which sums one-hot products ([S, P] x [P, D] per
// topology key, [S, P] x [P, N] per term slot) onto the old tables.
//
// Bound on an H100: bytes — the [S, B] match table read once, the four
// old tables (counts [S, D] f32, total [S], anti_presence [S, N] bool,
// pref_sym [S, N] f32; about 30 MB at S = 500, D = 5008, N = 8192) read
// once and the new ones written once. The earlier design cloned the four
// tables (4 copies), then added with atomics over a thread per [S, B] cell
// and a block per (pod, term slot) that scanned all N nodes at stride K.
//
// Design, two launches:
//   1. domain_kernel, a thread per (pod, term slot), puts the round's term
//      updates into domain space, in scratch tables the caller zeroes for
//      the call: an accepted pod's anti term marks anti_dom[sel, d] and its
//      preferred term adds the weight to pref_dom[sel, d], d the domain of
//      the pod's node under the term's key. Domain ids are global (D covers
//      every key's domains), so a (selector, domain) cell is unambiguous.
//      Touched selectors are flagged per table.
//   2. fold_kernel, a block per selector row s, writes the row's new tables
//      from the old in one stream (16-byte loads and stores): the counts row
//      is staged in shared memory, the row of the match table (the pods
//      that match s) adds 1 per accepted pod and key at its node's domain,
//      and the total gains their number; then, for a flagged row, anti |
//      OR_k anti_dom[s, nd[m, k]] and pref + sum_k pref_dom[s, nd[m, k]] over
//      the row's domain tables, staged in shared memory; an unflagged row is
//      a plain copy.
//
// Exactness: every added value is an integer (1, or the API's int32
// preference weights) and every table entry stays below 2^24 (checked by
// chip_smoke.py on the card), so the f32 sums are exact in any order — the
// reference's values. The anti table is an OR.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemLimit = 232448;  // 227 KB a block

struct Args {
  int B, N, S, D, K, MA, do_aff;
  const uint8_t* m_pending;   // [S, B]
  const uint8_t* accepted;    // [B]
  const int* node_of;         // [B]
  const int* node_domains;    // [N, K]
  const int* anti_terms;      // [B, MA, 2]
  const int* pref_terms;      // [B, MA, 2]
  const float* pref_w;        // [B, MA]
  const float* counts;        // [S, D] old
  const float* total;         // [S]
  const uint8_t* anti;        // [S, N]
  const float* pref;          // [S, N]
  float* counts_out;          // [S, D] new
  float* total_out;           // [S]
  uint8_t* anti_out;          // [S, N]
  float* pref_out;            // [S, N]
  // scratch, zero at the call
  uint8_t* anti_dom;          // [S, D]
  float* pref_dom;            // [S, D]
  uint8_t* touched;           // [2, S]: anti, pref rows
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads) domain_kernel(Args a) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (size_t)a.B * a.MA) return;
  const int p = (int)(i / a.MA);
  if (!a.accepted[p]) return;
  const int node = clampi(a.node_of[p], 0, a.N - 1);
  const int* at = a.anti_terms + i * 2;
  const int* pt = a.pref_terms + i * 2;
  const int a_sel = at[0], p_sel = pt[0];
  if (a_sel >= 0 && a_sel < a.S) {
    const int d = a.node_domains[(size_t)node * a.K + clampi(at[1], 0, a.K - 1)];
    if (d >= 0) {
      a.anti_dom[(size_t)a_sel * a.D + d] = 1;
      a.touched[a_sel] = 1;
    }
  }
  if (p_sel >= 0 && p_sel < a.S) {
    const int d = a.node_domains[(size_t)node * a.K + clampi(pt[1], 0, a.K - 1)];
    if (d >= 0) {
      atomicAdd(a.pref_dom + (size_t)p_sel * a.D + d, a.pref_w[i]);
      a.touched[a.S + p_sel] = 1;
    }
  }
}

// an accepted pod p matching the block's selector: 1 at its node's domain
// of every key, in the staged counts row; returns 1 when accepted
__device__ __forceinline__ int match(const Args& a, int p, float* sc) {
  if (!a.accepted[p]) return 0;
  const int node = clampi(a.node_of[p], 0, a.N - 1);
  for (int k = 0; k < a.K; ++k) {
    const int d = __ldg(a.node_domains + (size_t)node * a.K + k);
    if (d >= 0) atomicAdd(sc + d, 1.0f);
  }
  return 1;
}

// the 4 pods p0.. of one word of the match row
__device__ __forceinline__ int match4(const Args& a, uint32_t w, int p0, float* sc) {
  int n = 0;
  if (w)
    for (int b = 0; b < 4; ++b)
      if ((w >> (8 * b)) & 0xffu) n += match(a, p0 + b, sc);
  return n;
}

// node m's part of a flagged row: the OR of its K domains' anti marks and
// the sum of their preferred weights
struct Fold {
  uint8_t hit;
  float add;
};

__device__ __forceinline__ Fold fold_node(const Args& a, int m, const uint8_t* sa,
                                          const float* sp) {
  Fold f{0, 0.0f};
  for (int k = 0; k < a.K; ++k) {
    const int d = __ldg(a.node_domains + (size_t)m * a.K + k);
    if (d < 0) continue;
    f.hit |= sa[d];
    f.add = f.add + sp[d];
  }
  return f;
}

__global__ void __launch_bounds__(kThreads) fold_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int flags[2], n_match;
  const int s = blockIdx.x, tid = threadIdx.x;
  if (tid < 2) flags[tid] = a.touched[tid * a.S + s];
  if (tid == 0) n_match = 0;

  // ---- counts and total: the row staged, the row's matches added ----
  float* sc = reinterpret_cast<float*>(smem);  // [D]
  const size_t rd = (size_t)s * a.D;
  const bool cvec = (a.D & 3) == 0 && aligned16(a.counts + rd) && aligned16(a.counts_out + rd);
  if (cvec) {
    for (int i = tid; i < a.D / 4; i += kThreads)
      reinterpret_cast<float4*>(sc)[i] = reinterpret_cast<const float4*>(a.counts + rd)[i];
  } else {
    for (int i = tid; i < a.D; i += kThreads) sc[i] = a.counts[rd + i];
  }
  __syncthreads();
  const uint8_t* mrow = a.m_pending + (size_t)s * a.B;
  int mine = 0;
  if ((a.B & 15) == 0 && aligned16(mrow)) {  // 16 pods a load
    for (int i = tid; i < a.B / 16; i += kThreads) {
      const uint4 v = reinterpret_cast<const uint4*>(mrow)[i];
      mine += match4(a, v.x, 16 * i, sc) + match4(a, v.y, 16 * i + 4, sc) +
              match4(a, v.z, 16 * i + 8, sc) + match4(a, v.w, 16 * i + 12, sc);
    }
  } else {
    for (int p = tid; p < a.B; p += kThreads)
      if (mrow[p]) mine += match(a, p, sc);
  }
  if (mine) atomicAdd(&n_match, mine);
  __syncthreads();
  if (cvec) {
    for (int i = tid; i < a.D / 4; i += kThreads)
      __stcs(reinterpret_cast<float4*>(a.counts_out + rd) + i, reinterpret_cast<float4*>(sc)[i]);
  } else {
    for (int i = tid; i < a.D; i += kThreads) a.counts_out[rd + i] = sc[i];
  }
  if (tid == 0) a.total_out[s] = a.total[s] + (float)n_match;
  if (!a.do_aff) return;

  // ---- anti and preferred rows ----
  const bool ta = flags[0], tp = flags[1];
  const size_t rn = (size_t)s * a.N;
  if (!ta && !tp) {  // an untouched row: a copy
    if ((a.N & 15) == 0 && aligned16(a.anti + rn) && aligned16(a.anti_out + rn) &&
        aligned16(a.pref + rn) && aligned16(a.pref_out + rn)) {
      const uint4* ao = reinterpret_cast<const uint4*>(a.anti + rn);
      uint4* aw = reinterpret_cast<uint4*>(a.anti_out + rn);
      const float4* po = reinterpret_cast<const float4*>(a.pref + rn);
      float4* pw = reinterpret_cast<float4*>(a.pref_out + rn);
      for (int i = tid; i < a.N / 16; i += kThreads) {
        const uint4 h = ao[i];
        const float4 p0 = po[4 * i], p1 = po[4 * i + 1], p2 = po[4 * i + 2], p3 = po[4 * i + 3];
        __stcs(aw + i, h);
        __stcs(pw + 4 * i, p0);
        __stcs(pw + 4 * i + 1, p1);
        __stcs(pw + 4 * i + 2, p2);
        __stcs(pw + 4 * i + 3, p3);
      }
    } else {
      for (int i = tid; i < a.N; i += kThreads) {
        a.anti_out[rn + i] = a.anti[rn + i];
        a.pref_out[rn + i] = a.pref[rn + i];
      }
    }
    return;
  }
  // stage the row's domain tables (the counts row is written: its shared
  // memory is reused)
  __syncthreads();
  float* sp = reinterpret_cast<float*>(smem);
  uint8_t* sa = smem + (size_t)a.D * 4;
  for (int d = tid; d < a.D; d += kThreads) {
    sp[d] = tp ? a.pref_dom[rd + d] : 0.0f;
    sa[d] = ta ? a.anti_dom[rd + d] : 0;
  }
  __syncthreads();
  const bool vec = (a.N & 3) == 0 && aligned16(a.pref + rn) && aligned16(a.pref_out + rn) &&
                   ((reinterpret_cast<uintptr_t>(a.anti + rn) |
                     reinterpret_cast<uintptr_t>(a.anti_out + rn)) & 3) == 0;
  if (vec) {  // 4 nodes a thread: float4 and 4-byte loads and stores
    for (int i = tid; i < a.N / 4; i += kThreads) {
      float4 p = reinterpret_cast<const float4*>(a.pref + rn)[i];
      uint32_t h = reinterpret_cast<const uint32_t*>(a.anti + rn)[i];
      const Fold f0 = fold_node(a, 4 * i, sa, sp), f1 = fold_node(a, 4 * i + 1, sa, sp);
      const Fold f2 = fold_node(a, 4 * i + 2, sa, sp), f3 = fold_node(a, 4 * i + 3, sa, sp);
      if (ta)
        h |= (uint32_t)f0.hit | ((uint32_t)f1.hit << 8) | ((uint32_t)f2.hit << 16) |
             ((uint32_t)f3.hit << 24);
      if (tp) {
        p.x = p.x + f0.add;
        p.y = p.y + f1.add;
        p.z = p.z + f2.add;
        p.w = p.w + f3.add;
      }
      __stcs(reinterpret_cast<float4*>(a.pref_out + rn) + i, p);
      reinterpret_cast<uint32_t*>(a.anti_out + rn)[i] = h;
    }
    return;
  }
  for (int m = tid; m < a.N; m += kThreads) {
    const Fold f = fold_node(a, m, sa, sp);
    a.anti_out[rn + m] = ta ? (uint8_t)(a.anti[rn + m] | f.hit) : a.anti[rn + m];
    a.pref_out[rn + m] = tp ? a.pref[rn + m] + f.add : a.pref[rn + m];
  }
}

}  // namespace

extern "C" int affinity_update_fold(
    int B, int N, int S, int D, int K, int MA, int do_aff,
    const uint8_t* m_pending, const uint8_t* accepted, const int* node_of,
    const int* node_domains, const int* anti_terms, const int* pref_terms,
    const float* pref_w, const float* counts, const float* total,
    const uint8_t* anti, const float* pref, float* counts_out, float* total_out,
    uint8_t* anti_out, float* pref_out, uint8_t* anti_dom, float* pref_dom,
    uint8_t* touched, void* stream) {
  if (S <= 0) return 0;
  if (N <= 0 || D <= 0 || K <= 0 || B < 0 || MA < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)D * 5;  // the counts row, then the domain rows
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Args a{B, N, S, D, K, MA, do_aff, m_pending, accepted, node_of, node_domains,
         anti_terms, pref_terms, pref_w, counts, total, anti, pref, counts_out,
         total_out, anti_out, pref_out, anti_dom, pref_dom, touched};
  const size_t terms = do_aff ? (size_t)B * MA : 0;
  if (terms > 0) {
    domain_kernel<<<(unsigned)((terms + kThreads - 1) / kThreads), kThreads, 0, st>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fold_kernel<<<S, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}
