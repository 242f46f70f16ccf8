// static_base: the combined static base of the rounds engine, one f32 [P, N]
// plane written once.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/ops/rounds.py:338
//   sbase = where(static_mask, clip(static_score, -1e6, 1e6), NEG_INF)
// with (static_mask, static_score) = Framework.static_lean
// (k8s_scheduler_tpu/framework/runtime.py:103), optionally ANDed with
// core/cycle.py sampling_mask and resources.fit_mask_single against the
// snapshot's node_requested, and with a bool [P, N] mask operand
// (VolumeBinding's static mask, computed by volume_mask.cu).
//
// mask  = node_valid & NodeUnschedulable & NodeName & toleration-pair lookup
//         & requirement rows (pod_req_id, pod_sel_req_id) & no host-port
//         conflict & [fit] & [sampling window] & [mask operand]
// score = fused multiply-add of the weighted static plugin scores in the
//         framework's order (ImageLocality, NodeAffinity preferred,
//         TaintToleration by default), the same single roundings XLA's
//         contraction gives the reference.
//
// Bound on an H100: bytes. The only [P, N]-sized traffic is the output
// (4 B per element, 537 MB at P=16384, N=8192: 0.16 ms); per-pod values
// and the small deduplicated tables ([Tl, Ts], [Rq, N], [Pf, N], [Is, N])
// stay in L2.
//
// Design: node-stationary tiles. A block of 256 threads owns 2048
// consecutive nodes, 8 a thread in two chunks of 4 (chunk c of thread t at
// tile node 1024 c + 4 t, so that each 16-byte load or store of a warp
// covers one contiguous 512-byte stretch of a row), and walks groups of 32
// pods (the groups over gridDim.y, and a loop past 65535 groups). The
// node-side values (valid, unschedulable, taint set) load once into
// registers for every pod of every group; the tile's room table
// ([R][2048], for the fit filter) and each group's per-pod scalars (ids,
// the sampling window at the tile's first node, requests, the tolerated
// taint sets as one bit each and the TaintToleration score row) are
// staged in shared memory by one coalesced load, so a pod costs each
// thread a few broadcast reads and no table lookup in device memory; a pod
// pinned to no node skips NodeName, a pod with no host port the port test.
// Requirement and mask-operand rows are read as uchar4, score rows as
// float4, and the output leaves as float4 streaming stores (__stcs: the
// plane is far larger than the 50 MB L2), two per pod and thread. The
// launcher takes this path when N is a multiple of 4 and every row pointer
// is aligned for its vector width; otherwise the same kernel runs with
// scalar loads and stores and a guard per node (an N not a multiple of 4,
// a view at an odd offset).
//
// Bit-equality: the mask is a bool AND, its order free; the score keeps the
// per-element __fmaf_rn chain in term order (zero terms included) under
// --fmad=false, then the fminf/fmaxf clip and NEG_INF where masked.
//
// K16 static_rejects (the full outputs' static attribution, beside it):
// k8s_scheduler_tpu/framework/runtime.py:79 Framework.static's
// :223 attribute_rejects over the static filters' masks — for each pod row,
// the valid nodes each static filter rejects first in the framework's
// filter order. It shares this kernel's tiles, staging and per-node tests
// (each into its own flags); the counts leave through shared memory and
// one integer atomic a (row, filter) and block. Bound on an H100: bytes,
// the mask operand's one byte an element where VolumeBinding has one, else
// the per-pod ids and the small tables; without the operand it is bound by
// its [P, N] tests (operations).
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a --fmad=false ...

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kThreads = 256;
constexpr int kPerThread = 8;  // a multiple of 4
constexpr int kTile = kThreads * kPerThread;  // nodes per block
constexpr int kPodGroup = 32;                 // pods per group
constexpr int kMaxGridY = 65535;
constexpr int kMaxTs = 32;  // taint sets held as one bit each

// filter bits (ops/static_base.py mirrors these)
constexpr int kUnsched = 1, kNodeName = 2, kTaint = 4, kAffinity = 8,
              kPorts = 16, kFit = 32, kSample = 64, kMask = 128;
// score term codes
constexpr int kTermImage = 1, kTermPref = 2, kTermTaint = 3;

struct Args {
  float* out;
  int P, N, R;
  const int* pod_node_name;
  const int* pod_tolset;
  const int* pod_req_id;
  const int* pod_sel_req_id;
  const int* pod_pref_id;
  const int* pod_imageset;
  const int* pod_ports;  // [P, MPp]
  int MPp;
  const float* pod_requested;  // [P, R]
  const int* samp_off;         // [P]
  int samp_k, samp_n;
  const uint8_t* node_valid;
  const uint8_t* node_unsched;
  const int* node_taintset;
  const int* node_used_ports;  // [N, MUP]
  int MUP;
  const float* node_room;  // [N, R] allocatable - requested + slack
  const uint8_t* sched;    // [Tl, Ts]
  const float* tscore;     // [Tl, Ts]
  int Tl, Ts;
  const uint8_t* req;  // [Rq, N]
  int Rq;
  const float* pref;  // [Pf, N]
  int Pf;
  const float* img;  // [Is, N]
  int Is;
  const uint8_t* mask;  // [P, N] (kMask)
  int flags;
  int term[3];
  float weight[3];
  int n_terms;
};

struct Pod {  // one pod's scalars, staged per group
  int pin, tl, rid, sid, fid, iid, win, has_port;  // win: (tile0 - off) mod n
  unsigned tol;  // bit t: taint set t tolerated (Ts <= kMaxTs)
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A thread's nodes: kPerThread / 4 chunks of 4 consecutive nodes, chunk c
// at n0 + c * kStride (n0 = tile0 + 4 * threadIdx.x), so that each vector
// load or store of a warp covers one contiguous stretch of the row.
constexpr int kStride = kThreads * 4;
constexpr int kChunks = kPerThread / 4;

__device__ __forceinline__ int node_of(int n0, int i) {
  return n0 + (i >> 2) * kStride + (i & 3);
}

// the thread's kPerThread values of a row; kVec: one aligned 4-wide load a
// chunk (a chunk lies wholly below N or wholly at or past it), else a
// guarded load a node; zero past N
template <bool kVec>
__device__ __forceinline__ void loadn(const uint8_t* row, int n0, int N, bool* v) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int nc = n0 + c * kStride;
    if (kVec) {
      uchar4 x = make_uchar4(0, 0, 0, 0);
      if (nc < N) x = *reinterpret_cast<const uchar4*>(row + nc);
      v[4 * c] = x.x != 0; v[4 * c + 1] = x.y != 0; v[4 * c + 2] = x.z != 0; v[4 * c + 3] = x.w != 0;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[4 * c + i] = nc + i < N && row[nc + i] != 0;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void loadn(const float* row, int n0, int N, float* v) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int nc = n0 + c * kStride;
    if (kVec) {
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (nc < N) x = __ldg(reinterpret_cast<const float4*>(row + nc));
      v[4 * c] = x.x; v[4 * c + 1] = x.y; v[4 * c + 2] = x.z; v[4 * c + 3] = x.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[4 * c + i] = nc + i < N ? __ldg(row + nc + i) : 0.0f;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void loadn(const int* row, int n0, int N, int* v) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int nc = n0 + c * kStride;
    if (kVec) {
      int4 x = make_int4(0, 0, 0, 0);
      if (nc < N) x = __ldg(reinterpret_cast<const int4*>(row + nc));
      v[4 * c] = x.x; v[4 * c + 1] = x.y; v[4 * c + 2] = x.z; v[4 * c + 3] = x.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[4 * c + i] = nc + i < N ? __ldg(row + nc + i) : 0;
    }
  }
}

// one pod's scalars, staged per group (tile0: the tile's first node)
__device__ __forceinline__ Pod stage_pod(const Args& a, int p, int tile0, bool ts_bits) {
  Pod q;
  q.pin = a.pod_node_name[p];
  q.tl = clampi(a.pod_tolset[p], 0, a.Tl - 1);
  q.rid = a.pod_req_id[p] >= 0 ? clampi(a.pod_req_id[p], 0, a.Rq - 1) : -1;
  q.sid = a.pod_sel_req_id[p] >= 0 ? clampi(a.pod_sel_req_id[p], 0, a.Rq - 1) : -1;
  q.fid = a.pod_pref_id[p] >= 0 ? clampi(a.pod_pref_id[p], 0, a.Pf - 1) : -1;
  q.iid = a.pod_imageset[p] >= 0 ? clampi(a.pod_imageset[p], 0, a.Is - 1) : -1;
  q.win = 0;
  if (a.flags & kSample) {  // (tile0 - off) mod n, floor semantics
    q.win = (tile0 - a.samp_off[p]) % a.samp_n;
    if (q.win < 0) q.win += a.samp_n;
  }
  q.has_port = 0;
  if (a.flags & kPorts)
    for (int j = 0; j < a.MPp; ++j) q.has_port |= a.pod_ports[(size_t)p * a.MPp + j] >= 0;
  q.tol = 0;
  if (ts_bits)
    for (int t = 0; t < a.Ts; ++t) q.tol |= (unsigned)(a.sched[(size_t)q.tl * a.Ts + t] != 0) << t;
  return q;
}

// The static filters' tests of one pod at the thread's kPerThread nodes
// from n0, each ANDed into ok (static_base_kernel ANDs them all into one
// mask, static_rejects_kernel each into its own).

// NodeName: the pinned node only (pin >= 0), or no node (pin == -2)
__device__ __forceinline__ void and_node_name(const Pod& q, int n0, bool* ok) {
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (q.pin >= 0) ok[i] = ok[i] && node_of(n0, i) == q.pin;
    if (q.pin == -2) ok[i] = false;
  }
}

// TaintToleration from the staged tolerated-set bits (Ts <= kMaxTs)
__device__ __forceinline__ void and_taint_bits(const Pod& q, const int* ts, bool* ok) {
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) ok[i] = ok[i] && ((q.tol >> ts[i]) & 1u);
}

// ... or from the pod's row of the [Tl, Ts] table
__device__ __forceinline__ void and_taint_rows(const Args& a, const Pod& q, const int* ts,
                                               bool* ok) {
  const uint8_t* row = a.sched + (size_t)q.tl * a.Ts;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) ok[i] = ok[i] && __ldg(row + ts[i]) != 0;
}

// NodeAffinity: the pod's requirement rows (pod_req_id, pod_sel_req_id)
template <bool kVec>
__device__ __forceinline__ void and_requirements(const Args& a, const Pod& q, int n0, bool* ok) {
  bool b[kPerThread];
  if (q.rid >= 0) {
    loadn<kVec>(a.req + (size_t)q.rid * a.N, n0, a.N, b);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) ok[i] = ok[i] && b[i];
  }
  if (q.sid >= 0) {
    loadn<kVec>(a.req + (size_t)q.sid * a.N, n0, a.N, b);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) ok[i] = ok[i] && b[i];
  }
}

// NodePorts: no host port of pod p held at the node by a running pod
__device__ __forceinline__ void and_ports(const Args& a, int p, int n0, bool* ok) {
  for (int j = 0; j < a.MPp; ++j) {
    const int pp = a.pod_ports[(size_t)p * a.MPp + j];
    if (pp < 0) continue;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (node_of(n0, i) >= a.N) continue;
      const int* used = a.node_used_ports + (size_t)node_of(n0, i) * a.MUP;
      for (int u = 0; u < a.MUP; ++u)
        if (used[u] == pp) ok[i] = false;
    }
  }
}

// the mask operand's row of pod p (VolumeBinding's static mask)
template <bool kVec>
__device__ __forceinline__ void and_mask(const Args& a, int p, int n0, bool* ok) {
  bool b[kPerThread];
  loadn<kVec>(a.mask + (size_t)p * a.N, n0, a.N, b);
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) ok[i] = ok[i] && b[i];
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 3) static_base_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* room_s = reinterpret_cast<float*>(smem4);  // [R][kTile] (kFit)
  float* preq_s = room_s + (size_t)a.R * kTile;     // [kPodGroup][R] (kFit)
  __shared__ Pod pods[kPodGroup];
  __shared__ float tsc_s[kPodGroup][kMaxTs];  // the pods' TaintToleration rows

  const int flags = a.flags, N = a.N, R = a.R;
  const int tile0 = blockIdx.x * kTile;
  const int n0 = tile0 + 4 * threadIdx.x;  // the thread's first node
  const bool active = n0 < N;
  const bool ts_bits = a.Ts <= kMaxTs;  // taint lookups from staged rows

  if (flags & kFit) {  // the tile's room, resource-major, one coalesced pass
    const int nodes = min(kTile, N - tile0);
    const float* src = a.node_room + (size_t)tile0 * R;
    for (int k = threadIdx.x; k < nodes * R; k += kThreads)
      room_s[(k % R) * kTile + k / R] = src[k];
  }
  // node-side values, once for every pod
  bool valid[kPerThread], unsched[kPerThread];
  int ts[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) valid[i] = unsched[i] = false, ts[i] = 0;
  if (active) {
    loadn<kVec>(a.node_valid, n0, N, valid);
    loadn<kVec>(a.node_unsched, n0, N, unsched);
    loadn<kVec>(a.node_taintset, n0, N, ts);
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    ts[i] = clampi(ts[i], 0, a.Ts - 1);
    if (flags & kUnsched) valid[i] = valid[i] && !unsched[i];
  }

  const int groups = (a.P + kPodGroup - 1) / kPodGroup;
  for (int gi = blockIdx.y; gi < groups; gi += gridDim.y) {
    const int p0 = gi * kPodGroup;
    const int np = min(kPodGroup, a.P - p0);
    __syncthreads();  // the previous group's staging is consumed
    if (threadIdx.x < np) pods[threadIdx.x] = stage_pod(a, p0 + threadIdx.x, tile0, ts_bits);
    if (ts_bits)
      for (int k = threadIdx.x; k < np * a.Ts; k += kThreads) {
        const int tl = clampi(a.pod_tolset[p0 + k / a.Ts], 0, a.Tl - 1);
        tsc_s[k / a.Ts][k % a.Ts] = a.tscore[(size_t)tl * a.Ts + k % a.Ts];
      }
    if (flags & kFit)
      for (int k = threadIdx.x; k < np * R; k += kThreads)
        preq_s[k] = a.pod_requested[(size_t)p0 * R + k];
    __syncthreads();
    if (!active) continue;

    for (int k = 0; k < np; ++k) {
      const Pod q = pods[k];
      const int p = p0 + k;
      bool ok[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) ok[i] = valid[i];
      if ((flags & kNodeName) && q.pin != -1) {
        and_node_name(q, n0, ok);
      }
      if ((flags & kTaint) && ts_bits) {
        and_taint_bits(q, ts, ok);
      } else if (flags & kTaint) {
        and_taint_rows(a, q, ts, ok);
      }
      if (flags & kAffinity) {
        and_requirements<kVec>(a, q, n0, ok);
      }
      if ((flags & kPorts) && q.has_port) {
        and_ports(a, p, n0, ok);
      }
      if (flags & kFit) {
        for (int r = 0; r < R; ++r) {
          const float need = preq_s[k * R + r];
          const float4* room = reinterpret_cast<const float4*>(room_s + (size_t)r * kTile) +
                               threadIdx.x;
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const float4 x = room[c * kThreads];
            ok[4 * c] = ok[4 * c] && need <= x.x;
            ok[4 * c + 1] = ok[4 * c + 1] && need <= x.y;
            ok[4 * c + 2] = ok[4 * c + 2] && need <= x.z;
            ok[4 * c + 3] = ok[4 * c + 3] && need <= x.w;
          }
        }
      }
      if (flags & kSample) {
        // (n - off) mod n from the pod's window at the tile's first node
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          int w = q.win + (n0 - tile0) + c * kStride;
          if (w >= a.samp_n) w = w - a.samp_n < a.samp_n ? w - a.samp_n : w % a.samp_n;
#pragma unroll
          for (int i = 4 * c; i < 4 * c + 4; ++i) {
            ok[i] = ok[i] && w < a.samp_k;
            w = w + 1 == a.samp_n ? 0 : w + 1;
          }
        }
      }
      if (flags & kMask) {
        and_mask<kVec>(a, p, n0, ok);
      }
      bool any = false;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) any = any || ok[i];
      float s[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) s[i] = 0.0f;
      if (any) {
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          if (t >= a.n_terms) break;
          float v[kPerThread];
#pragma unroll
          for (int i = 0; i < kPerThread; ++i) v[i] = 0.0f;
          if (a.term[t] == kTermImage) {
            if (q.iid >= 0) loadn<kVec>(a.img + (size_t)q.iid * N, n0, N, v);
          } else if (a.term[t] == kTermPref) {
            if (q.fid >= 0) loadn<kVec>(a.pref + (size_t)q.fid * N, n0, N, v);
          } else if (a.term[t] == kTermTaint && ts_bits) {
#pragma unroll
            for (int i = 0; i < kPerThread; ++i) v[i] = tsc_s[k][ts[i]];
          } else if (a.term[t] == kTermTaint) {
            const float* row = a.tscore + (size_t)q.tl * a.Ts;
#pragma unroll
            for (int i = 0; i < kPerThread; ++i) v[i] = __ldg(row + ts[i]);
          }
#pragma unroll
          for (int i = 0; i < kPerThread; ++i) s[i] = __fmaf_rn(a.weight[t], v[i], s[i]);
        }
      }
      float o[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
        o[i] = ok[i] ? fminf(fmaxf(s[i], -1e6f), 1e6f) : kNegInf;
      float* dst = a.out + (size_t)p * N + n0;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int nc = n0 + c * kStride;
        if (kVec) {
          if (nc < N)
            __stcs(reinterpret_cast<float4*>(dst + c * kStride),
                   make_float4(o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]));
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (nc + i < N) __stcs(dst + c * kStride + i, o[4 * c + i]);
        }
      }
    }
  }
}

// K16 static_rejects: per pod row, the valid nodes that each static filter
// rejects first in the framework's filter order (its column), the row's
// counts added to out[p, column]. The tests are static_base_kernel's, each
// into its own flags; a node's first rejector is the smallest column that
// fails among the tests of the flags set (the column order is the filter
// order, so no order needs to be walked). A warp sums a column's nodes
// with one __reduce_add_sync, the warps add into the group's [32][F] table
// in shared memory, and each block adds a row's nonzero counts with one
// integer atomic (exact in any order).
constexpr int kTests = 6;  // ops/static_base.py REJECT_TESTS, in this order
constexpr int kMaxF = 32;  // ops/static_base.py MAX_FILTERS
constexpr int kNoCol = 1 << 30;

struct RejArgs {
  int F;
  int col[kTests];      // each test's column (-1: not a filter of the framework)
  const uint8_t* rows;  // [P] the rows to count (null: every row)
  int* out;             // [P, F], zeroed by the caller
};

__device__ __forceinline__ void reject_at(int c, const bool* base, const bool* t, int* first) {
#pragma unroll
  for (int i = 0; i < kPerThread; ++i)
    if (base[i] && !t[i]) first[i] = min(first[i], c);
}

// the warp's nodes whose first rejector is column c, into the group's row
__device__ __forceinline__ void count_col(int c, const int* first, int* cnt_row) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) n += first[i] == c;
  n = __reduce_add_sync(0xffffffffu, n);
  if ((threadIdx.x & 31) == 0 && n > 0) atomicAdd(cnt_row + c, n);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 3) static_rejects_kernel(Args a, RejArgs r) {
  __shared__ Pod pods[kPodGroup];
  __shared__ uint8_t on_s[kPodGroup];
  __shared__ int cnt_s[kPodGroup][kMaxF];

  const int flags = a.flags, N = a.N, F = r.F;
  const int tile0 = blockIdx.x * kTile;
  const int n0 = tile0 + 4 * threadIdx.x;
  const bool active = n0 < N;  // threads past N take part in the warp sums with no node
  const bool ts_bits = a.Ts <= kMaxTs;
  bool valid[kPerThread], unsched[kPerThread];
  int ts[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) valid[i] = unsched[i] = false, ts[i] = 0;
  if (active) {
    loadn<kVec>(a.node_valid, n0, N, valid);
    loadn<kVec>(a.node_unsched, n0, N, unsched);
    loadn<kVec>(a.node_taintset, n0, N, ts);
  }
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) ts[i] = clampi(ts[i], 0, a.Ts - 1);

  const int groups = (a.P + kPodGroup - 1) / kPodGroup;
  for (int gi = blockIdx.y; gi < groups; gi += gridDim.y) {
    const int p0 = gi * kPodGroup;
    const int np = min(kPodGroup, a.P - p0);
    __syncthreads();  // the previous group's counts are out
    if (threadIdx.x < np) {
      pods[threadIdx.x] = stage_pod(a, p0 + threadIdx.x, tile0, ts_bits);
      on_s[threadIdx.x] = r.rows ? r.rows[p0 + threadIdx.x] : 1;
    }
    for (int k = threadIdx.x; k < np * kMaxF; k += kThreads) cnt_s[k / kMaxF][k % kMaxF] = 0;
    __syncthreads();

    for (int k = 0; k < np; ++k) {
      if (!on_s[k]) continue;  // a row that counts nothing (uniform)
      const Pod q = pods[k];
      const int p = p0 + k;
      int first[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) first[i] = kNoCol;
      if (active) {
        bool t[kPerThread];
        if (flags & kUnsched) {
#pragma unroll
          for (int i = 0; i < kPerThread; ++i) t[i] = !unsched[i];
          reject_at(r.col[0], valid, t, first);
        }
        if ((flags & kNodeName) && q.pin != -1) {
#pragma unroll
          for (int i = 0; i < kPerThread; ++i) t[i] = true;
          and_node_name(q, n0, t);
          reject_at(r.col[1], valid, t, first);
        }
        if (flags & kTaint) {
#pragma unroll
          for (int i = 0; i < kPerThread; ++i) t[i] = true;
          if (ts_bits) and_taint_bits(q, ts, t);
          else and_taint_rows(a, q, ts, t);
          reject_at(r.col[2], valid, t, first);
        }
        if (flags & kAffinity) {
#pragma unroll
          for (int i = 0; i < kPerThread; ++i) t[i] = true;
          and_requirements<kVec>(a, q, n0, t);
          reject_at(r.col[3], valid, t, first);
        }
        if ((flags & kPorts) && q.has_port) {
#pragma unroll
          for (int i = 0; i < kPerThread; ++i) t[i] = true;
          and_ports(a, p, n0, t);
          reject_at(r.col[4], valid, t, first);
        }
        if (flags & kMask) {
#pragma unroll
          for (int i = 0; i < kPerThread; ++i) t[i] = true;
          and_mask<kVec>(a, p, n0, t);
          reject_at(r.col[5], valid, t, first);
        }
      }
      const int bits[kTests] = {kUnsched, kNodeName, kTaint, kAffinity, kPorts, kMask};
#pragma unroll
      for (int j = 0; j < kTests; ++j)
        if (flags & bits[j]) count_col(r.col[j], first, cnt_s[k]);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < np * F; k += kThreads) {
      const int v = cnt_s[k / F][k % F];
      if (v > 0) atomicAdd(r.out + (size_t)(p0 + k / F) * F + k % F, v);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// the launchers' common parameters (ops/static_base.py _common_args)
#define STATIC_PARAMS                                                            \
  int P, int N, int R, const int *pod_node_name, const int *pod_tolset,            \
      const int *pod_req_id, const int *pod_sel_req_id, const int *pod_pref_id,    \
      const int *pod_imageset, const int *pod_ports, int MPp,                       \
      const float *pod_requested, const int *samp_off, int samp_k, int samp_n,      \
      const uint8_t *node_valid, const uint8_t *node_unsched,                       \
      const int *node_taintset, const int *node_used_ports, int MUP,                \
      const float *node_room, const uint8_t *sched, const float *tscore, int Tl,    \
      int Ts, const uint8_t *req, int Rq, const float *pref, int Pf,                \
      const float *img, int Is, int flags, int term0, int term1, int term2,         \
      float w0, float w1, float w2, int n_terms, void *stream, const uint8_t *mask

namespace {

Args pack_args(float* out, STATIC_PARAMS) {
  Args a;
  a.out = out; a.P = P; a.N = N; a.R = R;
  a.pod_node_name = pod_node_name; a.pod_tolset = pod_tolset;
  a.pod_req_id = pod_req_id; a.pod_sel_req_id = pod_sel_req_id;
  a.pod_pref_id = pod_pref_id; a.pod_imageset = pod_imageset;
  a.pod_ports = pod_ports; a.MPp = MPp; a.pod_requested = pod_requested;
  a.samp_off = samp_off; a.samp_k = samp_k; a.samp_n = samp_n;
  a.node_valid = node_valid; a.node_unsched = node_unsched;
  a.node_taintset = node_taintset; a.node_used_ports = node_used_ports;
  a.MUP = MUP; a.node_room = node_room;
  a.sched = sched; a.tscore = tscore; a.Tl = Tl; a.Ts = Ts;
  a.req = req; a.Rq = Rq; a.pref = pref; a.Pf = Pf; a.img = img; a.Is = Is;
  a.mask = mask;
  a.flags = flags;
  a.term[0] = term0; a.term[1] = term1; a.term[2] = term2;
  a.weight[0] = w0; a.weight[1] = w1; a.weight[2] = w2;
  a.n_terms = n_terms;
  (void)stream;
  return a;
}

// the vector path: every row 4-node aligned for its width
bool vector_path(const Args& a) {
  return a.N % 4 == 0 && aligned(a.pref, 16) && aligned(a.img, 16) &&
         aligned(a.node_taintset, 16) && aligned(a.req, 4) && aligned(a.mask, 4) &&
         aligned(a.node_valid, 4) && aligned(a.node_unsched, 4);
}

dim3 grid_of(const Args& a) {
  const int groups = (a.P + kPodGroup - 1) / kPodGroup;
  return dim3((a.N + kTile - 1) / kTile, groups < kMaxGridY ? groups : kMaxGridY);
}

}  // namespace

extern "C" int static_base_launch(float* out, STATIC_PARAMS) {
  if (P <= 0 || N <= 0) return 0;
  Args a = pack_args(out, P, N, R, pod_node_name, pod_tolset, pod_req_id, pod_sel_req_id,
                     pod_pref_id, pod_imageset, pod_ports, MPp, pod_requested, samp_off,
                     samp_k, samp_n, node_valid, node_unsched, node_taintset,
                     node_used_ports, MUP, node_room, sched, tscore, Tl, Ts, req, Rq, pref,
                     Pf, img, Is, flags, term0, term1, term2, w0, w1, w2, n_terms, stream,
                     mask);
  const bool vec = vector_path(a) && aligned(out, 16);
  const size_t smem = (flags & kFit) ? (size_t)R * (kTile + kPodGroup) * sizeof(float) : 0;
  const dim3 grid = grid_of(a);
  cudaError_t err;
  if (vec) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(static_base_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    static_base_kernel<true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  } else {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(static_base_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    static_base_kernel<false><<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// K16: `cols` [kTests] each test's column, `rows` [P] or null, `out` [P, F]
// zeroed; the inputs take neither fit nor sampling (the reference's
// Framework.static has neither)
extern "C" int static_rejects_launch(int* out, STATIC_PARAMS, int F, const int* cols,
                                     const uint8_t* rows) {
  if (P <= 0 || N <= 0) return 0;
  if (F < 1 || F > kMaxF || (flags & (kFit | kSample))) return (int)cudaErrorInvalidValue;
  Args a = pack_args(nullptr, P, N, R, pod_node_name, pod_tolset, pod_req_id,
                     pod_sel_req_id, pod_pref_id, pod_imageset, pod_ports, MPp,
                     pod_requested, samp_off, samp_k, samp_n, node_valid, node_unsched,
                     node_taintset, node_used_ports, MUP, node_room, sched, tscore, Tl, Ts,
                     req, Rq, pref, Pf, img, Is, flags, term0, term1, term2, w0, w1, w2,
                     n_terms, stream, mask);
  RejArgs r;
  r.F = F; r.rows = rows; r.out = out;
  const int bits[kTests] = {kUnsched, kNodeName, kTaint, kAffinity, kPorts, kMask};
  for (int j = 0; j < kTests; ++j) {
    r.col[j] = cols[j];
    if ((flags & bits[j]) && (cols[j] < 0 || cols[j] >= F)) return (int)cudaErrorInvalidValue;
  }
  const dim3 grid = grid_of(a);
  if (vector_path(a))
    static_rejects_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, r);
  else
    static_rejects_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, r);
  return (int)cudaGetLastError();
}
