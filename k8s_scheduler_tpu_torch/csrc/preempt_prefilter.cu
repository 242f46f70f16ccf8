// preempt_prefilter: the batched prefilter of preemption.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/ops/preemption.py:201-232 — for each of the
// C budgeted candidates, is there a node n and a victim prefix k in
// [1, elig(n)] with req <= free0[n] + prefix_freed[n, k] on every resource,
// under the static gate and node_valid? elig(n) counts the victims strictly
// below the candidate's priority (empty slots hold INT32_MAX and never
// count). The reference materialises the [C, N, MPN+1, R] comparison.
//
// One block of 256 threads per candidate; the threads stride over the
// nodes, count elig from the node's victim priorities, and walk prefixes
// 1..elig until one fits; a thread stops at its first feasible node and the
// block ORs the threads' flags (__syncthreads_or). The fit is one f32 add
// and a compare, as in the reference (no multiply: nothing to contract).
//
// Bound on an H100: bytes — the [C, N] gate once, and the per-node tables
// (victim priorities, prefix sums, free room: ~1.5 MB at config #4), which
// every block re-reads from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxR = 8;  // ops/preempt_prefilter.py MAX_RESOURCES

__global__ void prefilter_kernel(int C, int N, int MPN, int R,
                                 const int* __restrict__ prio,
                                 const float* __restrict__ req,
                                 const uint8_t* __restrict__ cand_ok,
                                 const int* __restrict__ vict_prio,
                                 const float* __restrict__ prefix_freed,
                                 const float* __restrict__ free0,
                                 const uint8_t* __restrict__ gate,
                                 const uint8_t* __restrict__ node_valid,
                                 uint8_t* __restrict__ out) {
  const int c = blockIdx.x;
  float q[kMaxR];
  for (int r = 0; r < R; ++r) q[r] = req[(size_t)c * R + r];
  const int p = prio[c];
  int found = 0;
  if (cand_ok[c]) {
    for (int n = threadIdx.x; n < N && !found; n += kThreads) {
      if (!gate[(size_t)c * N + n] || !node_valid[n]) continue;
      int elig = 0;
      for (int j = 0; j < MPN; ++j) elig += vict_prio[(size_t)n * MPN + j] < p;
      for (int k = 1; k <= elig && !found; ++k) {
        const float* pf = prefix_freed + ((size_t)n * (MPN + 1) + k) * R;
        bool fits = true;
        for (int r = 0; r < R; ++r)
          if (!(q[r] <= free0[(size_t)n * R + r] + pf[r])) fits = false;
        found = fits;
      }
    }
  }
  const int any = __syncthreads_or(found);
  if (threadIdx.x == 0) out[c] = any ? 1 : 0;
}

}  // namespace

extern "C" int preempt_prefilter_launch(int C, int N, int MPN, int R,
                                        const int* prio, const float* req,
                                        const uint8_t* cand_ok,
                                        const int* vict_prio,
                                        const float* prefix_freed,
                                        const float* free0,
                                        const uint8_t* gate,
                                        const uint8_t* node_valid,
                                        uint8_t* out, void* stream) {
  if (C <= 0) return 0;
  if (R > kMaxR) return (int)cudaErrorInvalidValue;
  prefilter_kernel<<<C, kThreads, 0, (cudaStream_t)stream>>>(
      C, N, MPN, R, prio, req, cand_ok, vict_prio, prefix_freed, free0, gate,
      node_valid, out);
  return (int)cudaGetLastError();
}
