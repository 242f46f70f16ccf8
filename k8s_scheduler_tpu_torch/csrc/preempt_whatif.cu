// preempt_whatif: preemption's non-resource what-if.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/ops/preemption.py:246-398
// nonresource_ok_batched — ok[c, n, k]: do scan candidate c's evictable
// non-resource constraints hold on node n once the first k victims of n
// (node_pods[n, :k], ascending priority) are gone?
//   - required anti-affinity (sel, key): count(sel, domain) minus the
//     evicted victims matching sel must reach 0 (no domain: no constraint);
//   - required affinity: a matching pod must remain in the domain, or the
//     bootstrap rule holds (no matching pod left anywhere and the candidate
//     matches its own selector);
//   - symmetric anti-affinity: every owner of an anti term matching the
//     candidate with a live domain at n (row_d summed over n's domains)
//     must be among the evicted victims;
//   - DoNotSchedule spread: (count - evicted) + 1 - min(min over the other
//     domains, count - evicted) <= maxSkew, with the other-domain minimum
//     from the min1/argmin/min2 table; a node without the key fails;
//   - hostPorts: every victim holding a wanted port must be evicted, and no
//     pod placed this cycle may hold one on n (winner_conf).
//
// The reference builds [S, N*MPN] one-hot tables (the owner table alone is
// 500 x 65536 f32 = 131 MB at config #4) and multiplies them by the
// candidates' selector rows. Here one thread owns one (candidate, node):
// it walks the node's victim slots once per term, gathering each victim's
// match bit me[s, e] and its owned anti terms directly, and keeps the
// MPN+1 prefix verdicts as bits of 64-bit words, one word per pass over
// the terms (one pass up to 63 pods per node). Every count is an
// integer-valued f32 below 2^24, so the arithmetic is exact and matches
// the reference bit for bit.
//
// Grid (ceil(N / 256), C2); the candidate's few terms are read through the
// read-only cache (every thread of a block reads the same ones).
//
// Bound on an H100: bytes — the [C2, N, MPN+1] verdicts written once, the
// node tables, and the victims' rows of the [S, E] match table (in L2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWhenDoNotSchedule = 0;  // models/encoding.py WHEN_DO_NOT_SCHEDULE

struct Args {
  int N, MPN, K, S, D, E, MA, MC, MP, MEP, has_aff, has_spread;
  const int* node_pods;       // [N, MPN]
  const int* node_domains;    // [N, K]
  const int* ports;           // [C2, MP]
  const int* exist_ports;     // [E, MEP]
  const uint8_t* winner_conf; // [C2, N]
  const int* anti;            // [C2, MA, 2]
  const int* aff;             // [C2, MA, 2]
  const int* tsc;             // [C2, MC, 3]
  const int* tsc_skew;        // [C2, MC]
  const float* counts;        // [S, D]
  const float* total;         // [S]
  const uint8_t* mp_c;        // [C2, S]
  const uint8_t* me;          // [S, E]
  const int* exist_anti;      // [E, MA, 2]
  const float* row_d;         // [C2, D]
  const float* sp_min1;       // [K*S]
  const int* sp_amin;         // [K*S]
  const float* sp_min2;       // [K*S]
  uint8_t* out;               // [C2, N, MPN+1]
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// counts[s, domain(n, k)], -1 where n has no domain for key k
__device__ __forceinline__ float count_at(const Args& a, int n, int s, int k) {
  const int d = a.node_domains[(size_t)n * a.K + k];
  return d >= 0 ? a.counts[(size_t)s * a.D + clampi(d, 0, a.D - 1)] : -1.0f;
}

// does victim slot j of node n hold a running pod matching selector s?
__device__ __forceinline__ bool vic_match(const Args& a, int n, int j, int s) {
  const int e = a.node_pods[(size_t)n * a.MPN + j];
  return e >= 0 && a.me[(size_t)s * a.E + e];
}

// clear verdict k in the word of prefixes [w0, w0 + 64)
__device__ __forceinline__ void fail(uint64_t& ok, int k, int w0) {
  const unsigned d = (unsigned)(k - w0);
  if (d < 64u) ok &= ~(1ull << d);
}

// does running pod e hold one of candidate c's host ports?
__device__ __forceinline__ bool port_hit(const Args& a, int c, int e) {
  for (int m = 0; m < a.MP; ++m) {
    const int pm = a.ports[(size_t)c * a.MP + m];
    if (pm < 0) continue;
    for (int q = 0; q < a.MEP; ++q)
      if (a.exist_ports[(size_t)e * a.MEP + q] == pm) return true;
  }
  return false;
}

// the verdicts of prefixes [w0, min(M, w0 + 63)] of (c, n) as bits of one
// word; each running count still starts from prefix 0
__device__ uint64_t verdict_word(const Args& a, int c, int n, int w0) {
  const int M = a.MPN;
  const int kend = min(M, w0 + 63);
  uint64_t ok = ~0ull;

  if (a.has_aff) {
    for (int t = 0; t < a.MA; ++t) {  // required anti-affinity
      const int sel = a.anti[((size_t)c * a.MA + t) * 2];
      const int key = a.anti[((size_t)c * a.MA + t) * 2 + 1];
      if (sel < 0) continue;
      const int s = clampi(sel, 0, a.S - 1);
      const float cnt = count_at(a, n, s, clampi(key, 0, a.K - 1));
      if (cnt < -0.5f) continue;
      float cum = 0.0f;
      for (int k = 0; k <= kend; ++k) {
        if (!(cnt - cum <= 0.5f)) fail(ok, k, w0);
        if (k < M && vic_match(a, n, k, s)) cum += 1.0f;
      }
    }
    for (int t = 0; t < a.MA; ++t) {  // required affinity / bootstrap
      const int sel = a.aff[((size_t)c * a.MA + t) * 2];
      const int key = a.aff[((size_t)c * a.MA + t) * 2 + 1];
      if (sel < 0) continue;
      const int s = clampi(sel, 0, a.S - 1);
      const float cnt = count_at(a, n, s, clampi(key, 0, a.K - 1));
      const float tot = a.total[s];
      const bool self = a.mp_c[(size_t)c * a.S + s];
      float cum = 0.0f;
      for (int k = 0; k <= kend; ++k) {
        const bool boot = (tot - cum <= 0.5f) && self;
        if (!(boot || (cnt > -0.5f && cnt - cum > 0.5f))) fail(ok, k, w0);
        if (k < M && vic_match(a, n, k, s)) cum += 1.0f;
      }
    }
    // symmetric: owners of anti terms that match the candidate
    float sym = 0.0f;
    for (int k = 0; k < a.K; ++k) {
      const int d = a.node_domains[(size_t)n * a.K + k];
      sym = sym + (d >= 0 ? a.row_d[(size_t)c * a.D + clampi(d, 0, a.D - 1)] : 0.0f);
    }
    float cum = 0.0f;
    for (int k = 0; k <= kend; ++k) {
      if (!(sym - cum <= 0.5f)) fail(ok, k, w0);
      if (k == M) break;
      const int e = a.node_pods[(size_t)n * M + k];
      if (e < 0) continue;
      float w = 0.0f;
      for (int t = 0; t < a.MA; ++t) {
        const int sv = a.exist_anti[((size_t)e * a.MA + t) * 2];
        const int kv = a.exist_anti[((size_t)e * a.MA + t) * 2 + 1];
        if (sv < 0) continue;
        if (a.node_domains[(size_t)n * a.K + clampi(kv, 0, a.K - 1)] < 0) continue;
        if (a.mp_c[(size_t)c * a.S + clampi(sv, 0, a.S - 1)]) w += 1.0f;
      }
      cum += w;
    }
  }
  if (a.has_spread) {
    for (int t = 0; t < a.MC; ++t) {  // DoNotSchedule skew after eviction
      const int* tc = a.tsc + ((size_t)c * a.MC + t) * 3;
      const int key = tc[0], sel = tc[1], when = tc[2];
      if (key < 0 || when != kWhenDoNotSchedule) continue;
      const int kc = clampi(key, 0, a.K - 1);
      const int s = clampi(sel, 0, a.S - 1);
      const int row = kc * a.S + s;
      const float cnt = count_at(a, n, s, kc);
      const int dn = a.node_domains[(size_t)n * a.K + kc];
      const float mexcl = dn == a.sp_amin[row] ? a.sp_min2[row] : a.sp_min1[row];
      const float skew = (float)a.tsc_skew[(size_t)c * a.MC + t];
      float cum = 0.0f;
      for (int k = 0; k <= kend; ++k) {
        const float after = cnt - cum;
        const float min_after = fminf(mexcl, after);
        if ((after + 1.0f - min_after > skew) || cnt < -0.5f) fail(ok, k, w0);
        if (k < M && vic_match(a, n, k, s)) cum += 1.0f;
      }
    }
  }
  // hostPorts
  bool has_p = false;
  for (int m = 0; m < a.MP; ++m) has_p |= a.ports[(size_t)c * a.MP + m] >= 0;
  if (has_p) {
    if (a.winner_conf[(size_t)c * a.N + n]) return 0;
    int tot = 0;
    for (int j = 0; j < M; ++j) {
      const int e = a.node_pods[(size_t)n * M + j];
      tot += e >= 0 && port_hit(a, c, e);
    }
    int cum = 0;
    for (int k = 0; k <= kend; ++k) {
      if (tot - cum > 0) fail(ok, k, w0);
      if (k == M) break;
      const int e = a.node_pods[(size_t)n * M + k];
      cum += e >= 0 && port_hit(a, c, e);
    }
  }
  return ok;
}

__global__ void whatif_kernel(Args a) {
  const int c = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= a.N) return;
  const int M = a.MPN;
  uint8_t* o = a.out + ((size_t)c * a.N + n) * (M + 1);
  for (int w0 = 0; w0 <= M; w0 += 64) {
    const uint64_t ok = verdict_word(a, c, n, w0);
    const int kend = min(M, w0 + 63);
    for (int k = w0; k <= kend; ++k) o[k] = (ok >> (k - w0)) & 1ull;
  }
}

}  // namespace

extern "C" int preempt_whatif_launch(
    int C2, int N, int MPN, int K, int S, int D, int E, int MA, int MC, int MP,
    int MEP, int has_aff, int has_spread, const int* node_pods,
    const int* node_domains, const int* ports, const int* exist_ports,
    const uint8_t* winner_conf, const int* anti, const int* aff, const int* tsc,
    const int* tsc_skew, const float* counts, const float* total,
    const uint8_t* mp_c, const uint8_t* me, const int* exist_anti,
    const float* row_d, const float* sp_min1, const int* sp_amin,
    const float* sp_min2, uint8_t* out, void* stream) {
  if (C2 <= 0 || N <= 0) return 0;
  Args a{N, MPN, K, S, D, E, MA, MC, MP, MEP, has_aff, has_spread,
         node_pods, node_domains, ports, exist_ports, winner_conf, anti, aff,
         tsc, tsc_skew, counts, total, mp_c, me, exist_anti, row_d, sp_min1,
         sp_amin, sp_min2, out};
  dim3 grid((N + kThreads - 1) / kThreads, C2);
  whatif_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
