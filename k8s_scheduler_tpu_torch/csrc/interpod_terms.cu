// interpod_terms + interpod_norm: the inter-pod affinity and topology-spread
// masks and scores of one rounds-engine round, for every pod of the view.
//
// Replaces (no Pallas kernel existed; these are the XLA-compiled device
// functions): the multi-hot products of k8s_scheduler_tpu/ops/interpod.py
// :358-486 (affinity_mask_batched, affinity_score_batched,
// spread_mask_batched, spread_score_batched) over the [K*S, N]
// counts-by-node table, and the symmetric [P, S] x [S, N] products of the
// pending match table with the placed pods' anti and preferred tables.
//
// interpod_terms_kernel: one block of 256 threads per group of kPods
// consecutive pods; it walks the node axis in chunks of kChunk nodes, four
// consecutive nodes a thread.
//   - Decode, once per block: warp j takes pod p0 + j. Its lanes compact
//     the selectors the pod matches (m_pending[:, p], a column of the
//     [S, B] table read 32 rows at a time, __ballot_sync) into a list in
//     shared memory, ascending; its lane 0 reads the pod's <= MA / MC
//     terms: needed required-affinity terms (a term bootstraps, and is
//     dropped, when nothing matches its selector anywhere and the pod
//     matches it), required anti-affinity terms, preferred terms with
//     duplicate (selector, key) rows merged in slot order and sorted by
//     row (the reference multi-hot's summation order), DoNotSchedule
//     constraints with their minc and maxSkew, ScheduleAnyway rows merged
//     the same way.
//   - Per chunk: the chunk's [N, K] domain ids go to shared memory once
//     and serve all kPods pods. Each thread reads the counts it needs
//     straight from the f32 [S, D] table (count(k, s, n) = counts[s,
//     dom(n, k)], -1 without a domain), and the symmetric terms from the
//     rows of anti_presence [S, N] and pref_sym [S, N] of the pod's
//     matched selectors (an OR and a sum), 4 nodes per load. The four
//     outputs go out as uchar4 / float4 stores.
// The symmetric sum is a sum of integer-valued f32 (counts and integer
// weights), exact in any order while every partial sum stays below 2^24
// (the wrapper checks a bound before the launch), so it equals the
// reference's f32 product bit for bit. The raw preferred score keeps the
// reference's order: the sum over the pod's rows, then one add of the
// symmetric sum.
//
// interpod_norm_kernel: one block per pod row; hi = max over the feasible
// nodes of |raw| (raw for spread), then raw / hi * 100 or
// (1 - raw / hi) * 100 — IEEE division and separately rounded products
// (built with --fmad=false), the reference's arithmetic.
//
// Bound on an H100: bytes — the outputs (1 + 4 + 1 + 4 B per [B, N]
// element), the [S, D] counts, the anti and preferred [S, N] tables, the
// match table and the terms read once. The tables stay in the 50 MB L2,
// where each matched selector's rows are read again per pod.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPods = kWarps;             // pods per block, a warp each to decode
constexpr int kNodesPerThread = 4;
constexpr int kChunk = kThreads * kNodesPerThread;  // nodes per chunk
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
  const uint8_t* anti_presence;  // [S, N]
  const float* pref_sym;      // [S, N]
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

// counts-by-node entries of row (k, s) at the thread's four nodes
__device__ __forceinline__ void counts4(const Args& a, const int* s_dom, int local,
                                        int k, int s, float c[4]) {
  const int4 d = *reinterpret_cast<const int4*>(s_dom + k * kChunk + local);
  const float* row = a.counts + (size_t)s * a.D;
  c[0] = d.x >= 0 ? row[d.x] : -1.0f;
  c[1] = d.y >= 0 ? row[d.y] : -1.0f;
  c[2] = d.z >= 0 ? row[d.z] : -1.0f;
  c[3] = d.w >= 0 ? row[d.w] : -1.0f;
}

// dynamic shared memory: the chunk's domain ids [K][kChunk] (i32), then
// each pod's matched selectors [kPods][S] (u16)
__global__ void __launch_bounds__(kThreads) interpod_terms_kernel(Args a) {
  extern __shared__ __align__(16) int s_dom[];
  uint16_t* s_match = reinterpret_cast<uint16_t*>(s_dom + a.K * kChunk);
  __shared__ PodTerms t[kPods];
  __shared__ int n_match[kPods];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * kPods;
  const int np = min(kPods, a.B - p0);

  // ---- decode: warp j takes pod p0 + j ----
  if (warp < np) {
    const int p = p0 + warp;
    int cnt = 0;
    if (a.do_aff) {
      uint16_t* list = s_match + (size_t)warp * a.S;
      for (int s0 = 0; s0 < a.S; s0 += 32) {
        const int s = s0 + lane;
        const bool hit = s < a.S && a.m_pending[(size_t)s * a.B + p] != 0;
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit) list[cnt + __popc(m & ((1u << lane) - 1u))] = (uint16_t)s;
        cnt += __popc(m);
      }
    }
    if (lane == 0) {
      n_match[warp] = cnt;
      load_terms(a, p, t[warp]);
    }
  }

  // four nodes a thread, vector loads and stores (N % 4 == 0, rows aligned)
  for (int c0 = 0; c0 < a.N; c0 += kChunk) {
    const int cn = min(kChunk, a.N - c0);
    __syncthreads();  // the decode is done / the previous chunk is read
    for (int i = tid; i < cn * a.K; i += kThreads) {
      const int n = i / a.K, k = i - n * a.K;
      s_dom[k * kChunk + n] = a.node_domains[(size_t)c0 * a.K + i];
    }
    __syncthreads();
    const int local = tid * kNodesPerThread;
    if (local >= cn) continue;
    const int n0 = c0 + local;

    for (int j = 0; j < np; ++j) {
      const PodTerms& pt = t[j];
      const size_t out0 = (size_t)(p0 + j) * a.N + n0;
      float c[4];
      if (a.do_aff) {
        bool ok[4] = {true, true, true, true};
        float sym[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const uint16_t* list = s_match + (size_t)j * a.S;
        for (int i = 0; i < n_match[j]; ++i) {
          const size_t at = (size_t)list[i] * a.N + n0;
          const uchar4 an = *reinterpret_cast<const uchar4*>(a.anti_presence + at);
          const float4 pr = *reinterpret_cast<const float4*>(a.pref_sym + at);
          ok[0] &= an.x == 0; ok[1] &= an.y == 0; ok[2] &= an.z == 0; ok[3] &= an.w == 0;
          sym[0] += pr.x; sym[1] += pr.y; sym[2] += pr.z; sym[3] += pr.w;
        }
        for (int i = 0; i < pt.need.n; ++i) {
          counts4(a, s_dom, local, pt.need.k[i], pt.need.s[i], c);
          for (int q = 0; q < 4; ++q) ok[q] &= c[q] > 0.0f;
        }
        for (int i = 0; i < pt.anti.n; ++i) {
          counts4(a, s_dom, local, pt.anti.k[i], pt.anti.s[i], c);
          for (int q = 0; q < 4; ++q) ok[q] &= !(c[q] > 0.0f);
        }
        float raw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int i = 0; i < pt.pref.n; ++i) {
          counts4(a, s_dom, local, pt.pref.k[i], pt.pref.s[i], c);
          for (int q = 0; q < 4; ++q) raw[q] = raw[q] + pt.pref.w[i] * fmaxf(c[q], 0.0f);
        }
        for (int q = 0; q < 4; ++q) raw[q] = raw[q] + sym[q];
        *reinterpret_cast<uchar4*>(a.aff_mask + out0) = make_uchar4(ok[0], ok[1], ok[2], ok[3]);
        *reinterpret_cast<float4*>(a.aff_raw + out0) = make_float4(raw[0], raw[1], raw[2], raw[3]);
      }
      if (a.do_spread) {
        bool ok[4] = {true, true, true, true};
        for (int i = 0; i < pt.hard.n; ++i) {
          counts4(a, s_dom, local, pt.hard.k[i], pt.hard.s[i], c);
          for (int q = 0; q < 4; ++q)
            if ((c[q] + 1.0f) - pt.hard.mc[i] > pt.hard.w[i] || c[q] < 0.0f) ok[q] = false;
        }
        float raw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int i = 0; i < pt.soft.n; ++i) {
          counts4(a, s_dom, local, pt.soft.k[i], pt.soft.s[i], c);
          for (int q = 0; q < 4; ++q) raw[q] = raw[q] + pt.soft.w[i] * fmaxf(c[q], 0.0f);
        }
        *reinterpret_cast<uchar4*>(a.spread_mask + out0) =
            make_uchar4(ok[0], ok[1], ok[2], ok[3]);
        *reinterpret_cast<float4*>(a.spread_raw + out0) =
            make_float4(raw[0], raw[1], raw[2], raw[3]);
      }
    }
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
    const int* tsc, const int* tsc_skew, const uint8_t* anti_presence,
    const float* pref_sym, uint8_t* aff_mask, float* aff_raw,
    uint8_t* spread_mask, float* spread_raw, void* stream) {
  if (B <= 0 || N <= 0 || (!do_aff && !do_spread)) return 0;
  if (MA > kMaxTerms || MC > kMaxTerms || K > kMaxKeys || K < 1 || S < 1 || S > 65535 ||
      N % kNodesPerThread != 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.B = B; a.N = N; a.S = S; a.D = D; a.K = K; a.MA = MA; a.MC = MC;
  a.do_aff = do_aff; a.do_spread = do_spread; a.when_dns = when_dns;
  a.counts = counts; a.total = total; a.node_domains = node_domains;
  a.minc = minc; a.m_pending = m_pending; a.aff_terms = aff_terms;
  a.anti_terms = anti_terms; a.pref_terms = pref_terms; a.pref_w = pref_w;
  a.tsc = tsc; a.tsc_skew = tsc_skew; a.anti_presence = anti_presence;
  a.pref_sym = pref_sym; a.aff_mask = aff_mask; a.aff_raw = aff_raw;
  a.spread_mask = spread_mask; a.spread_raw = spread_raw;
  const size_t smem = (size_t)K * kChunk * sizeof(int)
                      + (do_aff ? (size_t)kPods * S * sizeof(uint16_t) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      interpod_terms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kPods - 1) / kPods;
  interpod_terms_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
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
