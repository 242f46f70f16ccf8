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
// candidates' selector rows.
//
// Design: node-stationary. A CTA owns kThreads consecutive nodes, one a
// thread, and a chunk of kChunk candidates (blockIdx.y), whose term rows
// it stages in shared memory. Each thread first reads what its node
// contributes whatever the candidate: its victims (into its column of
// shared memory, a bit a valid slot), its domain per key, which victims
// hold a host port, and the victims' anti terms whose key has a domain at
// the node (the symmetric term's owners: (slot, selector) pairs). Then it
// walks the chunk's candidates. Per (candidate, term) the victims' match
// bits me[s, e] are gathered once into a word a 32 slots; the prefix
// verdicts change only at a match, so each term evaluates its condition
// (the plain version's f32 arithmetic, op for op) once per run of prefixes
// between matches and clears those bits of the verdict words. Each (c, n)
// record's MPN+1 verdict bytes go to a shared-memory buffer (two, by the
// candidate's parity: one barrier a candidate), from which the CTA writes
// the tile's contiguous span with 16-byte stores. Verdict words: kW = 1
// up to 31 pods a node, 8 up to 255; more is refused.
//
// The time is latency: the node's chain of loads, then each candidate's.
// On config #4's call (C2 = 64, N = 8192, MPN = 8; H100 80GB HBM3 at 700
// W, kernel_variants): 19.3-19.8 us at 4 candidates a CTA against 27.0 at
// 8, 23.2 at 2 and 26.2 at 1 (more CTAs re-read the node tables); the
// floor (node tables read, verdicts written, no term) 8.3-8.7; the me
// gathers, the symmetric walk and the ports 1-3.5 us each. Tried and
// dropped: each candidate's terms gathered in one batch, the node's loads
// batched 8 slots at a time (no gain), a row of threads a candidate over
// node tables staged by the first row (28.4: the staging's latency
// exposed to every row, two waves of 512-thread CTAs).
//
// Every count is an integer-valued f32 below 2^24, so the arithmetic is
// exact and matches the reference bit for bit.
//
// Bound on an H100: bytes — the [C2, N, MPN+1] verdicts written once, the
// node tables, and the victims' rows of the [S, E] match table (in L2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // nodes a CTA
constexpr int kChunk = 4;      // candidates a CTA (1024 CTAs at config #4)
constexpr int kOwnCap = 16;    // owned anti terms a node kept in shared memory
constexpr int kMaxW = 8;       // verdict words: MPN + 1 <= 256
constexpr int kWhenDoNotSchedule = 0;  // models/encoding.py WHEN_DO_NOT_SCHEDULE

struct Args {
  int N, MPN, K, S, D, E, MA, MC, MP, MEP, has_aff, has_spread, C2;
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

// the shared-memory layout of a CTA, in ints (the launcher sizes it)
struct Layout {
  int anti, aff, tsc, skew, ports, vic, dom, own, buf, total;
};

__host__ __device__ inline Layout layout(const Args& a) {
  Layout l;
  l.anti = 0;
  l.aff = l.anti + kChunk * a.MA * 2;
  l.tsc = l.aff + kChunk * a.MA * 2;
  l.skew = l.tsc + kChunk * a.MC * 3;
  l.ports = l.skew + kChunk * a.MC;
  l.vic = l.ports + kChunk * a.MP;
  l.vic = (l.vic + 3) & ~3;
  l.dom = l.vic + a.MPN * kThreads;      // [MPN][kThreads]
  l.own = l.dom + a.K * kThreads;        // [kOwnCap][kThreads]
  l.buf = l.own + kOwnCap * kThreads;    // 2 x kThreads x (MPN+1) bytes
  l.buf = (l.buf + 3) & ~3;
  l.total = l.buf + (2 * kThreads * (a.MPN + 1) + 3) / 4;
  return l;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// clear the verdicts of prefixes lo..hi (inclusive)
template <int kW>
__device__ __forceinline__ void clear(unsigned (&ok)[kW], int lo, int hi) {
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const int a = max(lo - 32 * w, 0), b = min(hi - 32 * w, 31);
    if (a > b) continue;
    const unsigned hi_bits = b == 31 ? ~0u : ((1u << (b + 1)) - 1u);
    ok[w] &= ~(hi_bits & ~((1u << a) - 1u));
  }
}

// A term whose verdict depends on cum, the matching victims among the
// first k: fails(cum) is evaluated once per run of prefixes between two
// matches (m: the match bits), cum counting each match once.
template <int kW, class F>
__device__ __forceinline__ void apply(unsigned (&ok)[kW], const unsigned (&m)[kW], int M,
                                      F fails) {
  float cum = 0.0f;
  int lo = 0;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    unsigned bits = m[w];
    while (bits) {
      const int j = 32 * w + __ffs(bits) - 1;
      bits &= bits - 1u;
      if (fails(cum)) clear(ok, lo, j);
      cum += 1.0f;
      lo = j + 1;
    }
  }
  if (fails(cum)) clear(ok, lo, M);
}

template <int kW>
__global__ void __launch_bounds__(kThreads) whatif_kernel(Args a) {
  extern __shared__ __align__(16) int smem[];
  const Layout L = layout(a);
  int* s_anti = smem + L.anti;
  int* s_aff = smem + L.aff;
  int* s_tsc = smem + L.tsc;
  int* s_skew = smem + L.skew;
  int* s_ports = smem + L.ports;
  int* s_vic = smem + L.vic;
  int* s_dom = smem + L.dom;
  int* s_own = smem + L.own;
  uint8_t* s_buf = reinterpret_cast<uint8_t*>(smem + L.buf);

  const int tid = threadIdx.x;
  const int M = a.MPN;
  const int n0 = blockIdx.x * kThreads;
  const int n = n0 + tid;
  const bool live = n < a.N;
  const int c0 = blockIdx.y * kChunk;
  const int nc = min(kChunk, a.C2 - c0);

  // the chunk's term rows
  for (int i = tid; i < nc * a.MA * 2; i += kThreads) {
    if (a.has_aff) {
      s_anti[i] = a.anti[(size_t)c0 * a.MA * 2 + i];
      s_aff[i] = a.aff[(size_t)c0 * a.MA * 2 + i];
    }
  }
  if (a.has_spread) {
    for (int i = tid; i < nc * a.MC * 3; i += kThreads) s_tsc[i] = a.tsc[(size_t)c0 * a.MC * 3 + i];
    for (int i = tid; i < nc * a.MC; i += kThreads) s_skew[i] = a.tsc_skew[(size_t)c0 * a.MC + i];
  }
  for (int i = tid; i < nc * a.MP; i += kThreads) s_ports[i] = a.ports[(size_t)c0 * a.MP + i];

  // the node's side, whatever the candidate
  unsigned valid[kW], held[kW];  // victim slots; victims holding a host port
#pragma unroll
  for (int w = 0; w < kW; ++w) valid[w] = held[w] = 0;
  int n_own = 0;
  if (live) {
    for (int k = 0; k < a.K; ++k) s_dom[k * kThreads + tid] = a.node_domains[(size_t)n * a.K + k];
    for (int j = 0; j < M; ++j) {
      const int e = a.node_pods[(size_t)n * M + j];
      s_vic[j * kThreads + tid] = e;
      if (e < 0) continue;
      const int w = kW == 1 ? 0 : j >> 5;
      valid[w] |= 1u << (j & 31);
      bool hp = false;
      for (int q = 0; q < a.MEP; ++q) hp |= a.exist_ports[(size_t)e * a.MEP + q] >= 0;
      if (hp) held[w] |= 1u << (j & 31);
      if (!a.has_aff) continue;
      for (int t = 0; t < a.MA; ++t) {  // its anti terms with a domain here
        const int sv = a.exist_anti[((size_t)e * a.MA + t) * 2];
        const int kv = a.exist_anti[((size_t)e * a.MA + t) * 2 + 1];
        if (sv < 0 || s_dom[clampi(kv, 0, a.K - 1) * kThreads + tid] < 0) continue;
        if (n_own < kOwnCap) s_own[n_own * kThreads + tid] = (j << 20) | clampi(sv, 0, a.S - 1);
        ++n_own;
      }
    }
  }
  __syncthreads();

  for (int cc = 0; cc < nc; ++cc) {
    const int c = c0 + cc;
    unsigned ok[kW];
#pragma unroll
    for (int w = 0; w < kW; ++w) ok[w] = ~0u;
    if (live) {
      // the victims matching selector s, one bit a slot
      auto matches = [&](int s, unsigned (&m)[kW]) {
#pragma unroll
        for (int w = 0; w < kW; ++w) {
          m[w] = 0;
          unsigned bits = valid[w];
          while (bits) {
            const int j = 32 * w + __ffs(bits) - 1;
            bits &= bits - 1u;
            if (a.me[(size_t)s * a.E + s_vic[j * kThreads + tid]]) m[w] |= 1u << (j & 31);
          }
        }
      };
      auto count_at = [&](int s, int k) {
        const int d = s_dom[k * kThreads + tid];
        return d >= 0 ? a.counts[(size_t)s * a.D + clampi(d, 0, a.D - 1)] : -1.0f;
      };
      unsigned m[kW];
      if (a.has_aff) {
        for (int t = 0; t < a.MA; ++t) {  // required anti-affinity
          const int sel = s_anti[(cc * a.MA + t) * 2], key = s_anti[(cc * a.MA + t) * 2 + 1];
          if (sel < 0) continue;
          const int s = clampi(sel, 0, a.S - 1);
          const float cnt = count_at(s, clampi(key, 0, a.K - 1));
          if (cnt < -0.5f) continue;
          matches(s, m);
          apply(ok, m, M, [&](float cum) { return !(cnt - cum <= 0.5f); });
        }
        for (int t = 0; t < a.MA; ++t) {  // required affinity / bootstrap
          const int sel = s_aff[(cc * a.MA + t) * 2], key = s_aff[(cc * a.MA + t) * 2 + 1];
          if (sel < 0) continue;
          const int s = clampi(sel, 0, a.S - 1);
          const float cnt = count_at(s, clampi(key, 0, a.K - 1));
          const float tot = __ldg(a.total + s);
          const bool self = __ldg(a.mp_c + (size_t)c * a.S + s) != 0;
          matches(s, m);
          apply(ok, m, M, [&](float cum) {
            const bool boot = (tot - cum <= 0.5f) && self;
            return !(boot || (cnt > -0.5f && cnt - cum > 0.5f));
          });
        }
        // symmetric: the owners of anti terms that match the candidate
        float sym = 0.0f;
        for (int k = 0; k < a.K; ++k) {
          const int d = s_dom[k * kThreads + tid];
          sym = sym + (d >= 0 ? a.row_d[(size_t)c * a.D + clampi(d, 0, a.D - 1)] : 0.0f);
        }
        const auto fails = [&](float cum) { return !(sym - cum <= 0.5f); };
        float cum = 0.0f;
        int lo = 0;
        if (n_own <= kOwnCap) {
          for (int i = 0; i < n_own;) {  // the pairs, by slot
            const int j = s_own[i * kThreads + tid] >> 20;
            float w = 0.0f;
            for (; i < n_own && (s_own[i * kThreads + tid] >> 20) == j; ++i)
              if (__ldg(a.mp_c + (size_t)c * a.S + (s_own[i * kThreads + tid] & 0xfffff)))
                w += 1.0f;
            if (w == 0.0f) continue;
            if (fails(cum)) clear(ok, lo, j);
            cum += w;
            lo = j + 1;
          }
        } else {  // more owned terms than kept: read them again
          for (int j = 0; j < M; ++j) {
            const int e = s_vic[j * kThreads + tid];
            if (e < 0) continue;
            float w = 0.0f;
            for (int t = 0; t < a.MA; ++t) {
              const int sv = a.exist_anti[((size_t)e * a.MA + t) * 2];
              const int kv = a.exist_anti[((size_t)e * a.MA + t) * 2 + 1];
              if (sv < 0 || s_dom[clampi(kv, 0, a.K - 1) * kThreads + tid] < 0) continue;
              if (__ldg(a.mp_c + (size_t)c * a.S + clampi(sv, 0, a.S - 1))) w += 1.0f;
            }
            if (w == 0.0f) continue;
            if (fails(cum)) clear(ok, lo, j);
            cum += w;
            lo = j + 1;
          }
        }
        if (fails(cum)) clear(ok, lo, M);
      }
      if (a.has_spread) {
        for (int t = 0; t < a.MC; ++t) {  // DoNotSchedule skew after eviction
          const int* tc = s_tsc + (cc * a.MC + t) * 3;
          const int key = tc[0], sel = tc[1], when = tc[2];
          if (key < 0 || when != kWhenDoNotSchedule) continue;
          const int kc = clampi(key, 0, a.K - 1);
          const int s = clampi(sel, 0, a.S - 1);
          const int row = kc * a.S + s;
          const float cnt = count_at(s, kc);
          const int dn = s_dom[kc * kThreads + tid];
          const float mexcl = dn == __ldg(a.sp_amin + row) ? __ldg(a.sp_min2 + row)
                                                            : __ldg(a.sp_min1 + row);
          const float skew = (float)s_skew[cc * a.MC + t];
          matches(s, m);
          apply(ok, m, M, [&](float cum) {
            const float after = cnt - cum;
            const float min_after = fminf(mexcl, after);
            return (after + 1.0f - min_after > skew) || cnt < -0.5f;
          });
        }
      }
      // hostPorts
      bool has_p = false;
      for (int q = 0; q < a.MP; ++q) has_p |= s_ports[cc * a.MP + q] >= 0;
      if (has_p) {
        if (a.winner_conf[(size_t)c * a.N + n]) {
#pragma unroll
          for (int w = 0; w < kW; ++w) ok[w] = 0;
        } else {
          float tot = 0.0f;
#pragma unroll
          for (int w = 0; w < kW; ++w) {
            m[w] = 0;
            unsigned bits = held[w];
            while (bits) {
              const int j = 32 * w + __ffs(bits) - 1;
              bits &= bits - 1u;
              const int e = s_vic[j * kThreads + tid];
              bool hit = false;
              for (int q = 0; q < a.MEP; ++q) {
                const int ep = a.exist_ports[(size_t)e * a.MEP + q];
                for (int p = 0; p < a.MP; ++p) {
                  const int pm = s_ports[cc * a.MP + p];
                  hit |= pm >= 0 && ep == pm;
                }
              }
              if (hit) {
                m[w] |= 1u << (j & 31);
                tot += 1.0f;
              }
            }
          }
          apply(ok, m, M, [&](float cum) { return !(tot - cum <= 0.5f); });
        }
      }
      // the record's verdict bytes into this candidate's buffer
      uint8_t* r = s_buf + ((cc & 1) * kThreads + tid) * (M + 1);
      for (int k = 0; k <= M; ++k) r[k] = (ok[kW == 1 ? 0 : k >> 5] >> (k & 31)) & 1u;
    }
    __syncthreads();
    // the tile's span of this candidate's records, 16 bytes a store
    const int len = (min(kThreads, a.N - n0)) * (M + 1);
    uint8_t* dst = a.out + ((size_t)c * a.N + n0) * (M + 1);
    const uint8_t* src = s_buf + (cc & 1) * kThreads * (M + 1);
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 &&
        (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      done = len & ~15;
      for (int i = tid * 16; i < done; i += kThreads * 16)
        *reinterpret_cast<uint4*>(dst + i) = *reinterpret_cast<const uint4*>(src + i);
    }
    for (int i = done + tid; i < len; i += kThreads) dst[i] = src[i];
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
  if (MPN + 1 > 32 * kMaxW) return (int)cudaErrorInvalidValue;
  Args a{N, MPN, K, S, D, E, MA, MC, MP, MEP, has_aff, has_spread, C2,
         node_pods, node_domains, ports, exist_ports, winner_conf, anti, aff,
         tsc, tsc_skew, counts, total, mp_c, me, exist_anti, row_d, sp_min1,
         sp_amin, sp_min2, out};
  const size_t smem = (size_t)layout(a).total * sizeof(int);
  const dim3 grid((N + kThreads - 1) / kThreads, (C2 + kChunk - 1) / kChunk);
  auto kernel = MPN + 1 <= 32 ? whatif_kernel<1> : whatif_kernel<kMaxW>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
