// pv_fold: a round's static-PV claims folded into the claim bitmap, the
// whole fixed-point loop in one launch of one thread-block cluster.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/ops/volumes.py:419 fold_pv_claims — a
// while_loop whose body runs, slot by slot: every pending claimant chooses
// its PV against the current bitmap (chosen_pv, or chosen_pv_sdr when
// multi-volume; no intra-pod `mine`, the bitmap already holds the pod's
// earlier slots), the lowest rank per PV wins, winners set the bitmap, and
// a slot resolves when it won or had no choice. The first pass always
// runs; the loop continues while a pass made progress and a slot is still
// pending.
//
// Bound on an H100: latency. The bytes (the claimants' rows and lists, the
// [V] bitmap in and out) take well under a microsecond; the steps (choose,
// then resolve, per slot and pass) depend on one another across every
// claimant, and a choice is a chain of dependent L2 loads (the node's PV
// list merged with the global list, pv_common.cuh pv::choose). On one
// block the choices of every claimant go through one SM's load path, and
// clearing [B] and [V] tables by strided loops costs every call.
//
// Design: one cluster of 16 CTAs (8, the portable size, where the card
// cannot schedule 16). CTA c owns the blocks of 32 pod rows c, c + size,
// c + 2 size, ... (rows = 32 ceil(ceil(B / 32) / size) a CTA at most; dealt
// round-robin because the valid rows come first: contiguous slices left
// the claimants to 10 of 16 CTAs at config #4, two chains of choices a
// thread), and the winner entries of the PVs [c * vs, (c + 1) * vs),
// vs = ceil(V / cluster size), in its shared memory:
//   - at launch each CTA copies its share of the bitmap to the output,
//     sets its winner entries to "none" and compacts its claimants
//     (accepted rows with an unbound static slot, found by warp ballots)
//     into a list in shared memory: row, node, rank and pending slots. No
//     phase strides over all B rows again;
//   - a winner entry is the rank's order-preserving u32, taken by a 32-bit
//     atomicMin into the owning CTA's shared memory (DSMEM); a claimant
//     won its PV iff the entry equals its own key. The entries are
//     double-buffered by the step's parity: while a step resolves, each
//     CTA clears its slice of the other buffer, which the previous step
//     read before the barrier that opened this one. A 64-bit atomicMin on
//     another CTA's shared memory (a step stamp above the rank, so that no
//     entry needed clearing) lost updates on the H100: the edge cases
//     differed on 2, 8 and 16 CTAs, never on one, and a CAS loop or 32-bit
//     keys were exact;
//   - per slot: choose (each claimant's pv::choose against the bitmap,
//     read through L2, and the atomicMin), a cluster barrier, resolve
//     (read the entry, set the bitmap, clear the slot), a cluster barrier
//     that orders the bitmap's stores before the next slot's choices;
//   - the loop condition: in the last slot of a pass each CTA reduces
//     "made progress" and "a slot is pending" over its threads and ORs
//     the two bits into every CTA's word for the pass's parity, so every
//     thread of the cluster reads the same decision after the barrier.
// The bitmap is only ever read with __ldcg (L2), since it is written
// inside the launch.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a --fmad=false ...

#include <cooperative_groups.h>

#include "pv_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 4;  // rows a thread per round of loads
constexpr int kMaxCluster = 16;
constexpr size_t kSmemLimit = 227 * 1024 - 1024;  // dynamic, beside the static words

struct Args {
  pv::Ctx c;
  pv::Sdr sdr;
  int B, rows, vs;
  const int* node_of;
  const uint8_t* accepted;
  const int* rank;
  const uint8_t* claimed_in;
  uint8_t* claimed;  // [V] out
};

// a CTA's dynamic shared memory: two buffers of vs winner keys, then five
// [rows] lists
__host__ __device__ inline size_t smem_bytes(int rows, int vs) {
  return (size_t)vs * 8 + (size_t)rows * 5 * 4;
}

__global__ void __launch_bounds__(kThreads, 1) pv_fold_kernel(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int me = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* win = reinterpret_cast<unsigned*>(smem);  // [2][vs]
  int* c_row = reinterpret_cast<int*>(win + 2 * a.vs);  // [rows] each
  int* c_node = c_row + a.rows;
  unsigned* c_key = reinterpret_cast<unsigned*>(c_node + a.rows);
  int* c_ch = reinterpret_cast<int*>(c_key + a.rows);
  unsigned* c_pend = reinterpret_cast<unsigned*>(c_ch + a.rows);
  __shared__ int wsum[kWarps];
  __shared__ unsigned go[2];  // per pass parity: bit 0 progress, bit 1 pending
  const pv::Ctx& c = a.c;

  // ---- the bitmap's share copied, winner entries cleared, claimants listed ----
  for (int v = me * kThreads + tid; v < c.V; v += csize * kThreads)
    a.claimed[v] = a.claimed_in[v];
  for (int i = tid; i < 2 * a.vs; i += kThreads) win[i] = ~0u;
  if (tid < 2) go[tid] = 0;
  // the rows are dealt round-robin in blocks of 32, so the valid rows,
  // which come first, spread over every CTA; kU rows a thread, their
  // fields in one round of loads, then one block scan of the counts
  auto row_of = [&](int lr) { return ((lr >> 5) * csize + me) * 32 + (lr & 31); };
  int n_cl = 0;
  for (int base = 0; base < a.rows; base += kThreads * kU) {
    unsigned m[kU];
    int row[kU], node[kU], rk[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int lr = base + u * kThreads + tid;
      row[u] = row_of(lr);
      m[u] = 0;
      node[u] = rk[u] = 0;
      if (lr < a.rows && row[u] < a.B) {
        const int b = row[u];
        const bool acc = a.accepted[b];
        node[u] = a.node_of[b];
        rk[u] = a.rank[b];
#pragma unroll
        for (int t = 0; t < pv::kMaxVol; ++t)
          if (t < c.MVol && c.vol_mode[(size_t)b * c.MVol + t] == 1) m[u] |= 1u << t;
        if (!acc) m[u] = 0;
      }
    }
    int n = 0;
#pragma unroll
    for (int u = 0; u < kU; ++u) n += m[u] != 0;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int k = n_cl + incl - n, tot = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) k += wsum[w];
      tot += wsum[w];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (!m[u]) continue;
      c_row[k] = row[u];
      c_node[k] = node[u] < 0 ? 0 : (node[u] > c.N - 1 ? c.N - 1 : node[u]);
      c_key[k] = (unsigned)rk[u] ^ 0x80000000u;
      c_pend[k] = m[u];
      ++k;
    }
    n_cl += tot;
    __syncthreads();  // wsum is rewritten by the next chunk
  }
  cluster.sync();  // every share copied and cleared, every CTA running

  auto entry = [&](int par, int v) {
    return cluster.map_shared_rank(win + par * a.vs + v % a.vs, v / a.vs);
  };
  unsigned step = 0;
  for (int pass = 0;; ++pass) {
    int progress = 0;
    for (int j = 0; j < c.MVol; ++j, ++step) {
      const int par = step & 1;
      // choose against the bitmap as the previous slot left it
      for (int k = tid; k < n_cl; k += kThreads) {
        const unsigned pb = c_pend[k];
        if (!((pb >> j) & 1u)) continue;
        pv::Slots s;
        pv::load_slots(c, c_row[k], s);
        const int ch = pv::choose(c, a.sdr, s, c_node[k], j, pb, a.claimed, nullptr, 0);
        c_ch[k] = ch;
        if (ch >= 0) atomicMin(entry(par, ch), c_key[k]);
      }
      cluster.sync();
      // every thread read the other parity's word before this barrier, and
      // no CTA writes it before the next pass
      if (j == 0 && tid == 0) go[(pass + 1) & 1] = 0;
      // the previous step read the other buffer before this barrier, and
      // the next step writes it after the next one
      for (int i = tid; i < a.vs; i += kThreads) win[(par ^ 1) * a.vs + i] = ~0u;
      // the lowest rank per PV wins; won or choiceless slots resolve
      int left = 0;
      for (int k = tid; k < n_cl; k += kThreads) {
        unsigned pb = c_pend[k];
        if ((pb >> j) & 1u) {
          const int ch = c_ch[k];
          const bool won = ch >= 0 && *entry(par, ch) == c_key[k];
          if (won) {
            a.claimed[ch] = 1;
            progress = 1;
          }
          if (won || ch < 0) c_pend[k] = pb &= ~(1u << j);
        }
        left |= pb != 0;
      }
      if (j == c.MVol - 1) {
        const unsigned f = (__syncthreads_or(progress) ? 1u : 0u) |
                           (__syncthreads_or(left) ? 2u : 0u);
        if (f != 0 && tid < csize) atomicOr(cluster.map_shared_rank(&go[pass & 1], tid), f);
      }
      cluster.sync();  // the bitmap's stores before the next choices
    }
    if (go[pass & 1] != 3u) break;  // the same word in every CTA
  }
  // the last access to another CTA's shared memory precedes the last barrier
}

bool bad_args(const Args& a, int csize) {
  return csize < 1 || csize > kMaxCluster || a.B < 0 || a.rows < 0 || a.vs < 0 ||
         a.rows % 32 != 0 || (long long)a.rows * csize < a.B ||
         (long long)a.vs * csize < a.c.V ||
         (a.c.V > 0 && a.vs < 1) || a.c.MVol < 0 || a.c.MVol > pv::kMaxVol ||
         smem_bytes(a.rows, a.vs) > kSmemLimit;
}

cudaError_t configure(int csize, size_t smem, cudaStream_t st, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  const void* fn = (const void*)pv_fold_kernel;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(csize, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// how many clusters of `csize` CTAs with `smem` bytes each the card can
// hold at once (0: it cannot schedule one)
extern "C" int pv_fold_clusters(int csize, int smem, int* clusters) {
  if (csize < 1 || csize > kMaxCluster || smem < 0 || (size_t)smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(csize, smem, nullptr, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)pv_fold_kernel, &cfg);
}

extern "C" int pv_fold_launch(
    uint8_t* claimed, int B, int N, int V, int Rq, int MVol, int G,
    const int* node_off, const int* node_pv, const int* global_pv,
    const int* pv_class, const float* pv_cap, const uint8_t* req,
    const int* vol_mode, const int* vol_req, const int* vol_class,
    const float* vol_size, const int* node_of, const uint8_t* accepted,
    const int* rank, int multi, const unsigned* sdr_mask, const int* sdr_off,
    const uint8_t* claimed_in, int csize, int rows, int vs, void* stream) {
  Args a{pv::Ctx{N, V, Rq, MVol, G, node_off, node_pv, global_pv, pv_class, pv_cap,
                 req, vol_mode, vol_req, vol_class, vol_size},
         pv::Sdr{sdr_mask, sdr_off, multi}, B, rows, vs, node_of, accepted, rank,
         claimed_in, claimed};
  if (bad_args(a, csize)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(csize, smem_bytes(rows, vs), (cudaStream_t)stream, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, pv_fold_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
