// capacity: rank-ordered capacity resolution of one rounds-engine
// acceptance pass, after the (node, rank) sort.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/ops/rounds.py:592-658 resolve_capacity —
// the segmented exclusive prefix of requests within each node's run of the
// sorted claims, the fit test against the node's free room, the scatter of
// the accept flags, and the fold of accepted requests into node_req — and
// the round-end revocation fold (rounds.py:852) with check = 0.
//
// One block of 256 threads per node j. The claims are sorted on
// key = node * 2^rank_bits + rank (dead claims carry node N and sort last),
// so node j's run is [lower_bound(j), lower_bound(j + 1)), found by binary
// search. The block walks its run in 256-claim chunks: a block-wide
// exclusive scan of the requests in f64 (warp shuffles, then the warp
// totals) plus a carry from the earlier chunks gives each claim's
// in-segment prefix, rounded once to f32; the claim fits iff
// prefix + req <= (alloc - node_req) + slack for every resource. A run of
// thousands of claims (a popular node in round 0) costs O(len), not the
// O(len^2) of a per-thread walk back. The accepted requests are summed the
// same way in f64 and added to node_req once (ops/capacity.py
// index_add_exact's fold, exact for the dyadic request sums the encoder
// makes). Every node row of the output is written, so the output needs no
// copy of the input first.
//
// Bound on an H100: bytes — keys, permutation and gathered requests of the
// B claims, and the [N, R] tables, each read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 8;  // ops/capacity.py MAX_RESOURCES

__device__ int lower_bound_node(const long long* key, int B, int rank_bits,
                                long long node) {
  int lo = 0, hi = B;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((key[mid] >> rank_bits) < node)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// exclusive block scan of one f64 per thread; returns the block total too
__device__ double block_excl_scan(double x, double* warp_sums, double* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  __syncthreads();  // warp_sums free for reuse
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  double before = 0.0, all = 0.0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_sums[w];
    all += warp_sums[w];
  }
  *total = all;
  return before + incl - x;
}

__global__ void capacity_kernel(int B, int N, int R, int rank_bits, int check,
                                const long long* s_key, const long long* order,
                                const float* req, const float* node_req,
                                const float* alloc, const float* slack,
                                uint8_t* accepted, float* node_req_out) {
  __shared__ double warp_sums[kWarps];
  __shared__ int any_acc;
  const int j = blockIdx.x;
  const int lo = lower_bound_node(s_key, B, rank_bits, j);
  const int hi = lower_bound_node(s_key, B, rank_bits, (long long)j + 1);
  float room[kMaxR];
  for (int r = 0; r < R; ++r) {
    const size_t jr = (size_t)j * R + r;
    room[r] = (alloc[jr] - node_req[jr]) + slack[jr];
  }
  double carry[kMaxR], folded[kMaxR];
  for (int r = 0; r < R; ++r) carry[r] = folded[r] = 0.0;
  if (threadIdx.x == 0) any_acc = 0;
  for (int base = lo; base < hi; base += kThreads) {
    const int i = base + threadIdx.x;
    const bool valid = i < hi;
    const long long pi = valid ? order[i] : 0;
    float q[kMaxR];
    for (int r = 0; r < R; ++r) q[r] = valid ? req[(size_t)pi * R + r] : 0.0f;
    bool fits = valid;
    for (int r = 0; r < R; ++r) {
      double tot;
      const double excl = block_excl_scan((double)q[r], warp_sums, &tot);
      if (check && !((float)(carry[r] + excl) + q[r] <= room[r])) fits = false;
      carry[r] += tot;
    }
    if (valid) accepted[pi] = fits;
    if (fits) any_acc = 1;
    for (int r = 0; r < R; ++r) {
      double tot;
      block_excl_scan(fits ? (double)q[r] : 0.0, warp_sums, &tot);
      folded[r] += tot;
    }
  }
  __syncthreads();
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    const size_t jr = (size_t)j * R + r;
    node_req_out[jr] = any_acc ? node_req[jr] + (float)folded[r] : node_req[jr];
  }
}

}  // namespace

extern "C" int capacity_launch(int B, int N, int R, int rank_bits, int check,
                               const long long* s_key, const long long* order,
                               const float* req, const float* node_req,
                               const float* alloc, const float* slack,
                               uint8_t* accepted, float* node_req_out,
                               void* stream) {
  if (N <= 0) return 0;
  if (R > kMaxR || R > kThreads) return (int)cudaErrorInvalidValue;
  capacity_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
      B, N, R, rank_bits, check, s_key, order, req, node_req, alloc, slack,
      accepted, node_req_out);
  return (int)cudaGetLastError();
}
