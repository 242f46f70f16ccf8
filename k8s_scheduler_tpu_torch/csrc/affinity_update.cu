// affinity_update: fold one rounds-engine round's accepted placements into
// the inter-pod affinity state.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/ops/interpod.py:489-548
// affinity_update_batched, which sums one-hot products ([S, P] x [P, D] per
// topology key, [S, P] x [P, N] per term slot).
//
// counts_kernel: one thread per (selector s, pod p) of the [S, B] match
// table; an accepted pod that matches s adds 1 to total[s] and to
// counts[s, domain(node, k)] for every key k where its node has a domain.
// terms_kernel: one block per (pod, term slot); an accepted pod's required
// anti term (sel, k) marks anti_presence[sel, m] for every node m in its
// node's k-domain, and its preferred term adds the weight to
// pref_sym[sel, m] over the same kind of domain row. A hostname term
// touches one node, a zone term about N/6; the block scans the node axis.
//
// Exactness: every added value is an integer (1, or the API's int32
// preference weights) and every table entry stays below 2^24, so the f32
// atomic sums are exact whatever order they land in — the same values as
// the reference's f32 products. The anti table is an OR: plain stores of 1.
//
// Bound on an H100: bytes — the [S, B] match table read once, the touched
// table entries written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void counts_kernel(int B, int N, int S, int D, int K,
                              const uint8_t* m_pending, const uint8_t* accepted,
                              const int* node_of, const int* node_domains,
                              float* counts, float* total) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (size_t)S * B) return;
  const int s = (int)(i / B), p = (int)(i % B);
  if (!accepted[p] || !m_pending[i]) return;
  atomicAdd(total + s, 1.0f);
  const int node = clampi(node_of[p], 0, N - 1);
  for (int k = 0; k < K; ++k) {
    const int d = node_domains[(size_t)node * K + k];
    if (d >= 0) atomicAdd(counts + (size_t)s * D + d, 1.0f);
  }
}

__global__ void terms_kernel(int B, int N, int S, int K, int MA,
                             const uint8_t* accepted, const int* node_of,
                             const int* node_domains, const int* anti_terms,
                             const int* pref_terms, const float* pref_w,
                             uint8_t* anti, float* pref) {
  const int p = blockIdx.x, slot = blockIdx.y;
  if (!accepted[p]) return;
  const int node = clampi(node_of[p], 0, N - 1);
  const int* at = anti_terms + ((size_t)p * MA + slot) * 2;
  const int* pt = pref_terms + ((size_t)p * MA + slot) * 2;
  const int a_sel = at[0], a_k = clampi(at[1], 0, K - 1);
  const int p_sel = pt[0], p_k = clampi(pt[1], 0, K - 1);
  const int a_dom = node_domains[(size_t)node * K + a_k];
  const int p_dom = node_domains[(size_t)node * K + p_k];
  const bool do_anti = a_sel >= 0 && a_sel < S && a_dom >= 0;
  const bool do_pref = p_sel >= 0 && p_sel < S && p_dom >= 0;
  if (!do_anti && !do_pref) return;
  const float w = pref_w[(size_t)p * MA + slot];
  for (int m = threadIdx.x; m < N; m += kThreads) {
    if (do_anti && node_domains[(size_t)m * K + a_k] == a_dom)
      anti[(size_t)a_sel * N + m] = 1;
    if (do_pref && node_domains[(size_t)m * K + p_k] == p_dom)
      atomicAdd(pref + (size_t)p_sel * N + m, w);
  }
}

}  // namespace

extern "C" int affinity_update_launch(
    int B, int N, int S, int D, int K, int MA, int do_aff,
    const uint8_t* m_pending, const uint8_t* accepted, const int* node_of,
    const int* node_domains, const int* anti_terms, const int* pref_terms,
    const float* pref_w, float* counts, float* total, uint8_t* anti,
    float* pref, void* stream) {
  if (B <= 0 || N <= 0 || S <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t cells = (size_t)S * B;
  counts_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      B, N, S, D, K, m_pending, accepted, node_of, node_domains, counts, total);
  if (do_aff && MA > 0) {
    if (MA > 65535) return (int)cudaErrorInvalidValue;
    terms_kernel<<<dim3(B, MA), kThreads, 0, st>>>(
        B, N, S, K, MA, accepted, node_of, node_domains, anti_terms, pref_terms,
        pref_w, anti, pref);
  }
  return (int)cudaGetLastError();
}
