// interpod_terms + interpod_norm: the inter-pod affinity and topology-spread
// masks and scores of one rounds-engine round, for every pod of the view.
//
// Replaces (no Pallas kernel existed; these are the XLA-compiled device
// functions): the multi-hot products of k8s_scheduler_tpu/ops/interpod.py
// :358-486 (affinity_mask_batched, affinity_score_batched,
// spread_mask_batched, spread_score_batched) over the [K*S, N]
// counts-by-node table.
//
// interpod_terms_kernel: one block of 256 threads per (256-node tile, pod).
// Thread 0 reads the pod's <= MA / MC terms once into shared memory:
//   - needed required-affinity terms (a term bootstraps, and is dropped,
//     when nothing matches its selector anywhere and the pod matches it);
//   - required anti-affinity terms;
//   - preferred terms, duplicate (selector, key) rows merged in slot order
//     and sorted by row, the reference multi-hot's summation order;
//   - DoNotSchedule constraints with their minc and maxSkew;
//   - ScheduleAnyway rows, merged the same way.
// Each thread then reads the counts it needs straight from the f32 [S, D]
// table through its node's domain ids (count(k, s, n) = counts[s, dom(n, k)],
// -1 without a domain) and writes the pod's four [N] row tiles: affinity
// mask (with the symmetric anti hits `sym_anti` folded in), raw preferred
// sum (+ `sym_pref`), spread mask, raw soft-spread sum.
//
// interpod_norm_kernel: one block per pod row; hi = max over the feasible
// nodes of |raw| (raw for spread), then raw / hi * 100 or
// (1 - raw / hi) * 100 — IEEE division and separately rounded products
// (built with --fmad=false), the reference's arithmetic.
//
// Bound on an H100: bytes. The [B, N] traffic is the symmetric inputs (1 + 4
// B per element) and the outputs (1 + 4 + 1 + 4 B); the [S, D] counts (10 MB
// at config #4) and [N, K] domain ids stay in L2; the per-pod terms are read
// once per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTerms = 8;  // ops/interpod_terms.py MAX_TERMS
constexpr int kMaxKeys = 8;   // MAX_KEYS

struct Args {
  int B, N, S, D, K, MA, MC, do_aff, do_spread, when_dns;
  const float* counts;        // [S, D]
  const float* total;         // [S]
  const int* node_domains;    // [N, K]
  const float* minc;          // [K * S]
  const uint8_t* m_pending;   // [S, B]
  const int* aff_terms;       // [B, MA, 2] (sel, key)
  const int* anti_terms;      // [B, MA, 2]
  const int* pref_terms;      // [B, MA, 2]
  const float* pref_w;        // [B, MA]
  const int* tsc;             // [B, MC, 3] (key, sel, when)
  const int* tsc_skew;        // [B, MC]
  const uint8_t* sym_anti;    // [B, N]
  const float* sym_pref;      // [B, N]
  uint8_t* aff_mask;          // [B, N]
  float* aff_raw;             // [B, N]
  uint8_t* spread_mask;       // [B, N]
  float* spread_raw;          // [B, N]
};

// one pod's terms: (key, selector) pairs, plus a weight or a bound
struct TermList {
  int n;
  int k[kMaxTerms];
  int s[kMaxTerms];
  float w[kMaxTerms];   // merged weight (pref, soft) / maxSkew (hard)
  float mc[kMaxTerms];  // minc (hard)
};

struct PodTerms {
  TermList need, anti, pref, hard, soft;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// add w to row (k, s): merge into an existing row in slot order, else append
__device__ void merge_row(TermList& t, int k, int s, float w) {
  for (int i = 0; i < t.n; ++i) {
    if (t.k[i] == k && t.s[i] == s) {
      t.w[i] = t.w[i] + w;
      return;
    }
  }
  t.k[t.n] = k;
  t.s[t.n] = s;
  t.w[t.n] = w;
  ++t.n;
}

// ascending row order (row = k * S + s): the multi-hot product's order
__device__ void sort_rows(TermList& t) {
  for (int i = 1; i < t.n; ++i) {
    int k = t.k[i], s = t.s[i];
    float w = t.w[i];
    int j = i - 1;
    while (j >= 0 && (t.k[j] > k || (t.k[j] == k && t.s[j] > s))) {
      t.k[j + 1] = t.k[j];
      t.s[j + 1] = t.s[j];
      t.w[j + 1] = t.w[j];
      --j;
    }
    t.k[j + 1] = k;
    t.s[j + 1] = s;
    t.w[j + 1] = w;
  }
}

__device__ void load_terms(const Args& a, int p, PodTerms& t) {
  t.need.n = t.anti.n = t.pref.n = t.hard.n = t.soft.n = 0;
  const int kmax = a.K - 1, smax = a.S - 1;
  if (a.do_aff) {
    for (int i = 0; i < a.MA; ++i) {
      const int sel = a.aff_terms[((size_t)p * a.MA + i) * 2];
      const int k = a.aff_terms[((size_t)p * a.MA + i) * 2 + 1];
      if (sel < 0) continue;
      const int s = clampi(sel, 0, smax);
      const bool boot = a.total[s] == 0.0f && a.m_pending[(size_t)s * a.B + p] != 0;
      if (boot) continue;
      TermList& l = t.need;
      l.k[l.n] = clampi(k, 0, kmax);
      l.s[l.n] = s;
      ++l.n;
    }
    for (int i = 0; i < a.MA; ++i) {
      const int sel = a.anti_terms[((size_t)p * a.MA + i) * 2];
      const int k = a.anti_terms[((size_t)p * a.MA + i) * 2 + 1];
      if (sel < 0) continue;
      TermList& l = t.anti;
      l.k[l.n] = clampi(k, 0, kmax);
      l.s[l.n] = clampi(sel, 0, smax);
      ++l.n;
    }
    for (int i = 0; i < a.MA; ++i) {
      const int sel = a.pref_terms[((size_t)p * a.MA + i) * 2];
      const int k = a.pref_terms[((size_t)p * a.MA + i) * 2 + 1];
      if (sel < 0) continue;
      merge_row(t.pref, clampi(k, 0, kmax), clampi(sel, 0, smax),
                a.pref_w[(size_t)p * a.MA + i]);
    }
    sort_rows(t.pref);
  }
  if (a.do_spread) {
    for (int c = 0; c < a.MC; ++c) {
      const int* tc = a.tsc + ((size_t)p * a.MC + c) * 3;
      const int k = tc[0], sel = tc[1], when = tc[2];
      if (k < 0) continue;
      const int kc = clampi(k, 0, kmax), s = clampi(sel, 0, smax);
      if (when == a.when_dns) {
        TermList& l = t.hard;
        l.k[l.n] = kc;
        l.s[l.n] = s;
        l.w[l.n] = (float)a.tsc_skew[(size_t)p * a.MC + c];
        l.mc[l.n] = a.minc[(size_t)kc * a.S + s];
        ++l.n;
      } else {
        merge_row(t.soft, kc, s, 1.0f);
      }
    }
    sort_rows(t.soft);
  }
}

__global__ void interpod_terms_kernel(Args a) {
  __shared__ PodTerms t;
  const int p = blockIdx.y;
  if (threadIdx.x == 0) load_terms(a, p, t);
  __syncthreads();
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= a.N) return;
  const size_t pn = (size_t)p * a.N + n;
  int dom[kMaxKeys];
  for (int k = 0; k < a.K; ++k) dom[k] = a.node_domains[(size_t)n * a.K + k];
  // counts-by-node entry of row (k, s) at this node
  auto cbn = [&](int k, int s) -> float {
    const int d = dom[k];
    return d >= 0 ? a.counts[(size_t)s * a.D + d] : -1.0f;
  };

  if (a.do_aff) {
    bool ok = a.sym_anti[pn] == 0;
    for (int i = 0; i < t.need.n; ++i)
      if (!(cbn(t.need.k[i], t.need.s[i]) > 0.0f)) ok = false;
    for (int i = 0; i < t.anti.n; ++i)
      if (cbn(t.anti.k[i], t.anti.s[i]) > 0.0f) ok = false;
    a.aff_mask[pn] = ok;
    float raw = 0.0f;
    for (int i = 0; i < t.pref.n; ++i)
      raw = raw + t.pref.w[i] * fmaxf(cbn(t.pref.k[i], t.pref.s[i]), 0.0f);
    a.aff_raw[pn] = raw + a.sym_pref[pn];
  }
  if (a.do_spread) {
    bool ok = true;
    for (int i = 0; i < t.hard.n; ++i) {
      const float cnt = cbn(t.hard.k[i], t.hard.s[i]);
      if ((cnt + 1.0f) - t.hard.mc[i] > t.hard.w[i] || cnt < 0.0f) ok = false;
    }
    a.spread_mask[pn] = ok;
    float raw = 0.0f;
    for (int i = 0; i < t.soft.n; ++i)
      raw = raw + t.soft.w[i] * fmaxf(cbn(t.soft.k[i], t.soft.s[i]), 0.0f);
    a.spread_raw[pn] = raw;
  }
}

__global__ void interpod_norm_kernel(int N, int spread, const float* raw,
                                     const uint8_t* feasible, float* out) {
  __shared__ float warp_hi[kThreads / 32];
  __shared__ float row_hi;
  const size_t row = (size_t)blockIdx.x * N;
  float hi = 0.0f;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    if (feasible[row + n]) {
      const float v = raw[row + n];
      hi = fmaxf(hi, spread ? v : fabsf(v));
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  if ((threadIdx.x & 31) == 0) warp_hi[threadIdx.x >> 5] = hi;
  __syncthreads();
  if (threadIdx.x == 0) {
    float h = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) h = fmaxf(h, warp_hi[w]);
    row_hi = h;
  }
  __syncthreads();
  hi = row_hi;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float v = raw[row + n];
    float s;
    if (spread)
      s = hi > 0.0f ? (1.0f - v / hi) * 100.0f : 100.0f;
    else
      s = hi > 0.0f ? v / hi * 100.0f : 0.0f;
    out[row + n] = s;
  }
}

}  // namespace

extern "C" int interpod_terms_launch(
    int B, int N, int S, int D, int K, int MA, int MC, int do_aff,
    int do_spread, int when_dns,
    const float* counts, const float* total, const int* node_domains,
    const float* minc, const uint8_t* m_pending, const int* aff_terms,
    const int* anti_terms, const int* pref_terms, const float* pref_w,
    const int* tsc, const int* tsc_skew, const uint8_t* sym_anti,
    const float* sym_pref, uint8_t* aff_mask, float* aff_raw,
    uint8_t* spread_mask, float* spread_raw, void* stream) {
  if (B <= 0 || N <= 0 || (!do_aff && !do_spread)) return 0;
  if (MA > kMaxTerms || MC > kMaxTerms || K > kMaxKeys || B > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.B = B; a.N = N; a.S = S; a.D = D; a.K = K; a.MA = MA; a.MC = MC;
  a.do_aff = do_aff; a.do_spread = do_spread; a.when_dns = when_dns;
  a.counts = counts; a.total = total; a.node_domains = node_domains;
  a.minc = minc; a.m_pending = m_pending; a.aff_terms = aff_terms;
  a.anti_terms = anti_terms; a.pref_terms = pref_terms; a.pref_w = pref_w;
  a.tsc = tsc; a.tsc_skew = tsc_skew; a.sym_anti = sym_anti;
  a.sym_pref = sym_pref; a.aff_mask = aff_mask; a.aff_raw = aff_raw;
  a.spread_mask = spread_mask; a.spread_raw = spread_raw;
  dim3 grid((N + kThreads - 1) / kThreads, B);
  interpod_terms_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int interpod_norm_launch(int B, int N, int spread, const float* raw,
                                    const uint8_t* feasible, float* out,
                                    void* stream) {
  if (B <= 0 || N <= 0) return 0;
  interpod_norm_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      N, spread, raw, feasible, out);
  return (int)cudaGetLastError();
}
