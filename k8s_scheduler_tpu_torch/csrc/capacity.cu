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
// Design: one warp per node, so the work follows the claims. The claims are
// sorted on key = node * 2^rank_bits + rank (dead claims carry node N and
// sort last), so node j's run starts at lower_bound(j). The warp finds it
// with a 32-way cooperative search (each lane probes one of 32 split
// points, __ballot_sync keeps the interval: 3 rounds over 16384 keys), then
// walks the run in steps: the first takes one claim a lane, the later ones
// 8 consecutive claims a lane, so a long run (700 claims on a popular node
// in round 0) takes 3 more steps, each one batch of loads. A node with no
// claim writes its row and leaves after one key load. In a step each lane
// sums its claims' requests in f64, one inclusive warp scan by
// __shfl_up_sync per resource gives the lane its prefix in the run, and
// the lane walks its claims with the fit test, reading their requests
// again (from L1) rather than holding 8 x R of them in registers; each lane
// sums its accepted requests, and the warp adds the lanes' sums once at
// the end. A step ends the run unless every lane's last claim is in it.
// The carry across steps, the room and the sums stay in registers (the
// kernel is instantiated for each R <= 8, so every per-resource array has a
// compile-time size and index: no local memory). No shared memory, no
// barrier. 8192 nodes are 8192 warps, one wave on 132 SMs. A claim fits iff
// f32(carry + excl) + q <= room for every resource, room = (alloc -
// node_req) + slack in f32 in that order; the accepted requests are summed
// in f64 and added to node_req once, rounded once; a row with no accepted
// claim is a bit-copy of its input (keeps -0.0). The threads also clear
// the accept flags of the dead claims, one key each, so the output needs
// no memset first.
//
// Why the summation order may change (capacity_plain takes a global f64
// cumsum and segment-start differences; this kernel sums per run, lane by
// lane and step by step): the encoder's requests are whole millicores
// (multiples of 250, utils/synth.py) and whole multiples of 2^20 bytes, so
// each is an integer far below 2^53 / 2^20 in its unit, and every f64 sum
// of up to 2^20 of them is exact in any order. Exact sums round once to
// the same f32.
//
// With a counter row (ops/rounds.py diag_per_round, i32 [3]; null where the
// caller keeps none) the kernel also adds the pass's live claims and
// capacity rejections to its first two entries, or with check = 0 the
// fold's revocations to its third: each warp counts its run, the warps'
// sums meet in shared memory, and a block adds them with one integer
// atomic a counter (exact in any order).
//
// Bound on an H100: bytes — keys, permutation and gathered requests of the
// B claims, the [N, R] tables, each read once, and the outputs written
// once: about 0.3 us for a round-0 pass. What it costs in practice is one
// launch and one dependent search per node.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 8;  // ops/capacity.py MAX_RESOURCES
constexpr unsigned kAll = 0xffffffffu;

// first index i in [0, B) with (key[i] >> rank_bits) >= node, or B; all
// lanes return it
__device__ __forceinline__ int warp_lower_bound(const long long* key, int B,
                                                int rank_bits, long long node,
                                                int lane) {
  int lo = 0, hi = B;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int p = lo + (int)(((long long)(hi - lo) * (lane + 1)) / 33);
    const unsigned below = __ballot_sync(kAll, (key[p] >> rank_bits) < node);
    const int c = __popc(below);  // lanes [0, c) probed keys below node
    const int p_last = __shfl_sync(kAll, p, c > 0 ? c - 1 : 0);
    const int p_next = __shfl_sync(kAll, p, c < 32 ? c : 31);
    if (c > 0) lo = p_last + 1;
    if (c < 32) hi = p_next;
  }
  const int p = lo + lane;
  const bool below = p < hi && (key[p] >> rank_bits) < node;
  return lo + __popc(__ballot_sync(kAll, below));
}

// node j's run of claims, by its warp: the accept flags and node j's row of
// node_req_out; n_live / n_acc (every lane) count the run's claims and the
// accepted ones
template <int kR>  // R, a compile-time constant: every array in registers
__device__ __forceinline__ void resolve_node(
    int j, int lane, int B, int rank_bits, int check, const long long* __restrict__ s_key,
    const long long* __restrict__ order, const float* __restrict__ req,
    const float* __restrict__ node_req, const float* __restrict__ alloc,
    const float* __restrict__ slack, uint8_t* __restrict__ accepted,
    float* __restrict__ node_req_out, int& n_live, int& n_acc) {
  constexpr int kN = kR > 0 ? kR : 1;
  constexpr int kU = 8;  // claims a lane in a step of a long run
  const float own = lane < kR ? node_req[(size_t)j * kR + lane] : 0.0f;
  const int lo = warp_lower_bound(s_key, B, rank_bits, j, lane);
  if (lo >= B || (s_key[lo] >> rank_bits) != j) {  // no claim: a bit-copy
    if (lane < kR) node_req_out[(size_t)j * kR + lane] = own;
    return;
  }
  float room[kN];
  double carry[kN], part[kN];  // run prefix so far; this lane's accepted sums
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const size_t jr = (size_t)j * kR + r;
    room[r] = (alloc[jr] - node_req[jr]) + slack[jr];
    carry[r] = part[r] = 0.0;
  }
  bool any_acc = false, done = false;
  // the first step takes one claim a lane (most runs are short), the later
  // ones kU consecutive claims a lane, 32 * kU a step
  for (int base = lo, per = 1; !done; base += 32 * per, per = kU) {
    bool valid[kU];
    long long pi[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = base + lane * per + u;
      valid[u] = u < per && i < B && (s_key[i] >> rank_bits) == j;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) pi[u] = valid[u] ? order[base + lane * per + u] : 0;
    // the run goes on past this step iff every lane's last claim is in it
    done = !__all_sync(kAll, valid[0] && (per == 1 || valid[kU - 1]));
    // pass 1: this lane's request sums, then one warp scan a resource for
    // the lane's prefix in the run
    double run[kN];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      double lane_sum = 0.0;
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (valid[u]) lane_sum += (double)req[(size_t)pi[u] * kR + r];
      double incl = lane_sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double y = __shfl_up_sync(kAll, incl, off);
        if (lane >= off) incl += y;
      }
      run[r] = carry[r] + (incl - lane_sum);  // exact (header)
      carry[r] += __shfl_sync(kAll, incl, 31);
    }
    // pass 2: the lane's claims in order, their requests read again (L1)
    bool any = false;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (!valid[u]) continue;
      float q[kN];
      bool fits = true;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        q[r] = req[(size_t)pi[u] * kR + r];
        if (check && !((float)run[r] + q[r] <= room[r])) fits = false;
        run[r] += (double)q[r];
      }
      accepted[pi[u]] = fits;
      any = any || fits;
      n_live += 1;
      n_acc += fits;
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (fits) part[r] += (double)q[r];
    }
    any_acc = any_acc || __any_sync(kAll, any);
  }
  double mine = 0.0;  // the accepted sums over the warp; lane r writes resource r
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    double t = part[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(kAll, t, off);
    if (lane == r) mine = t;
  }
  if (lane < kR)
    node_req_out[(size_t)j * kR + lane] = any_acc ? own + (float)mine : own;
}

template <int kR>
__global__ void __launch_bounds__(kThreads)
capacity_kernel(int B, int N, int rank_bits, int check,
                const long long* __restrict__ s_key,
                const long long* __restrict__ order,
                const float* __restrict__ req,
                const float* __restrict__ node_req,
                const float* __restrict__ alloc,
                const float* __restrict__ slack, uint8_t* __restrict__ accepted,
                float* __restrict__ node_req_out, int* __restrict__ diag) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g < B && (s_key[g] >> rank_bits) >= N) accepted[order[g]] = 0;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int n_live = 0, n_acc = 0;
  if (j < N)
    resolve_node<kR>(j, lane, B, rank_bits, check, s_key, order, req, node_req, alloc,
                     slack, accepted, node_req_out, n_live, n_acc);
  if (diag == nullptr) return;
  // the round's counters (ops/rounds.py diag_per_round): live claims and
  // capacity rejections of a pass, or the revocations of a fold; the
  // warps' sums in shared memory, then one atomic a counter per block
  __shared__ int cnt[2];
  if (threadIdx.x == 0) cnt[0] = cnt[1] = 0;
  __syncthreads();
  n_live = __reduce_add_sync(kAll, n_live);
  n_acc = __reduce_add_sync(kAll, n_acc);
  if (lane == 0 && n_live > 0) {
    atomicAdd(&cnt[0], n_live);
    atomicAdd(&cnt[1], n_acc);
  }
  __syncthreads();
  if (threadIdx.x == 0 && cnt[0] > 0) {
    if (check) {
      atomicAdd(diag, cnt[0]);
      atomicAdd(diag + 1, cnt[0] - cnt[1]);
    } else {
      atomicAdd(diag + 2, cnt[0]);
    }
  }
}

}  // namespace

// the launcher's interface: 2 since it takes the counter row (ops/capacity.py
// refuses a library built from a source without it)
extern "C" int capacity_interface() { return 2; }

extern "C" int capacity_launch(int B, int N, int R, int rank_bits, int check,
                               const long long* s_key, const long long* order,
                               const float* req, const float* node_req,
                               const float* alloc, const float* slack,
                               uint8_t* accepted, float* node_req_out, int* diag,
                               void* stream) {
  if (N <= 0 && B <= 0) return 0;
  if (R < 0 || R > kMaxR) return (int)cudaErrorInvalidValue;
  const long long warps_blocks = ((long long)N + kWarps - 1) / kWarps;
  const long long claim_blocks = ((long long)B + kThreads - 1) / kThreads;
  const long long blocks = warps_blocks > claim_blocks ? warps_blocks : claim_blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  cudaStream_t st = (cudaStream_t)stream;
#define CAPACITY_CASE(r)                                                       \
  case r:                                                                      \
    capacity_kernel<r><<<grid, kThreads, 0, st>>>(B, N, rank_bits, check, s_key, \
                                                  order, req, node_req, alloc,   \
                                                  slack, accepted, node_req_out, \
                                                  diag);                           \
    break;
  switch (R) {
    CAPACITY_CASE(0) CAPACITY_CASE(1) CAPACITY_CASE(2) CAPACITY_CASE(3)
    CAPACITY_CASE(4) CAPACITY_CASE(5) CAPACITY_CASE(6) CAPACITY_CASE(7)
    CAPACITY_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CAPACITY_CASE
  return (int)cudaGetLastError();
}
