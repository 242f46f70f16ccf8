// static_rejects (K16): the static filters' first-rejector counts of the
// full outputs and the diagnosis program, and on request the chain's
// remainder as a bool [P, N] plane.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/framework/runtime.py:79 Framework.static's
// :223 attribute_rejects over the static filters' masks, as
// k8s_scheduler_tpu/core/cycle.py uses it over every pod row of a full
// cycle and over each window of the diagnosis program (:1488-1495, whose
// start mask is node_valid & every static filter: the remainder below).
//
//   rejects[p, col(t)] = the valid nodes n that test t rejects for pod p
//                        and no test of a smaller column does (rows[p];
//                        0 on the rows that `rows` leaves out)
//   survivors[p, n]    = node_valid[n] & every test passes (every row)
//
// With a per-pod base (base_rows, base_ids) the chain starts from
// node_valid[n] & base_rows[base_ids[p], n] instead of node_valid[n]: the
// diagnosis program's windows with the carried HTTP-extender verdicts
// (k8s_scheduler_tpu/core/cycle.py:1482-1485, base = node_valid &
// emask[ids]), the verdict plane's rows read in place (no gather).
//
// The tests (ops/static_base.py REJECT_TESTS, in this order):
// NodeUnschedulable, NodeName, TaintToleration, NodeAffinity (the pod's
// requirement rows), NodePorts (the pod's host ports against the ports
// held at the node) and the mask operand (VolumeBinding's static mask);
// each at its filter's column of the framework's order.
//
// Bound on an H100: bytes, the mask operand's and the per-pod base's byte
// a pair where there is one and the survivors plane's where it is asked for; without either, the
// per-pod ids and the tables (a few MB: under a microsecond), and the
// kernel runs at the cost of its launches (mark, pack, count) and of the
// latency of a pod row's loads.
//
// Design: bit-sliced words. A test's verdict on 32 consecutive nodes is one
// u32 and a column's count a __popc.
//   mark_kernel, pack_kernel: the node-side tables as words [2 + Tl +
//     Rq][W], W = ceil(N / 32): node_valid, !node_unschedulable, for each
//     toleration set the nodes whose taint set it tolerates
//     (sched[tl][taintset[n]], any Ts), and the requirement rows; of a
//     table of more than kPackAll rows only those some pod names, listed
//     by mark_kernel (a volume snapshot's table holds a row for each PV's
//     node affinity: 5012 rows at config #4, 4 of them named by pods); a
//     thread a node, a warp ballot a word. Bits past N are 0.
//   count_kernel: a warp a pod row, lane l on words l, l + 32, ..., four
//     words' loads in flight before their tests; the pod's scalars are
//     read once. A word's tests: NodeUnschedulable one load, NodeName one
//     bit of one word, TaintToleration the pod's toleration row,
//     NodeAffinity two rows ANDed, NodePorts (a pod with ports only) a node
//     a lane and a ballot a word, the mask operand and the per-pod base's
//     row (ANDed into the valid word) 16-byte streaming loads
//     turned into bits (a warp's 32 words as two whole 512-byte stretches,
//     the halves exchanged by shuffles). The chain walks the tests in
//     column order from the valid word: fail = rem & ~ok, count[rank] +=
//     __popc(fail), rem &= ok. The counts stay in registers over the row;
//     the warp sums each with one __reduce_add_sync and lane c stores
//     column c: a plain store, no atomics (a row is one warp's).
//     The remainder leaves as 32 bytes a word (16-byte streaming stores,
//     the warp's as two whole 512-byte stretches) where it is asked for.
// Where the framework's columns follow the tests' order (the default) the
// chain takes the tests as they are (kInOrder); otherwise each rank picks
// its test. The vector path needs N a multiple of 16 and the mask operand
// and the survivors plane 16-byte aligned; else the same kernel loads and
// stores a byte at a time with a guard.
//
// Counts are integer sums, exact in any order.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a ...

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // count_kernel: a warp a pod row
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4;  // words a lane loads before it tests them
constexpr int kMaxGrid = 8192;
constexpr int kPackThreads = 256;
constexpr int kPackRows = 64;  // pack_kernel's grid rows; a block walks the rows
constexpr int kPackAll = 64;   // a table of at most this many rows is packed whole
constexpr int kTests = 6;  // ops/static_base.py REJECT_TESTS
constexpr int kMaxF = 32;  // ops/static_base.py MAX_FILTERS

// filter bits (ops/static_base.py)
constexpr int kUnsched = 1, kNodeName = 2, kTaint = 4, kAffinity = 8, kPorts = 16,
              kMask = 128;
constexpr int kBits[kTests] = {kUnsched, kNodeName, kTaint, kAffinity, kPorts, kMask};

struct Args {
  int P, N, W, flags;
  const int* pod_node_name;   // [P]
  const int* pod_tolset;      // [P]
  const int* pod_req_id;      // [P]
  const int* pod_sel_req_id;  // [P]
  const int* pod_ports;       // [P, MPp]
  int MPp;
  const uint8_t* node_valid;    // [N]
  const uint8_t* node_unsched;  // [N]
  const int* node_taintset;     // [N]
  const int* node_used_ports;   // [N, MUP]
  int MUP;
  const uint8_t* sched;  // [Tl, Ts]
  int Tl, Ts;
  const uint8_t* req;  // [Rq, N]
  int Rq;
  const uint8_t* mask;  // [P, N] (kMask)
  const uint8_t* rows;  // [P] the rows to count (null: every row)
  int F;
  int order[kTests];  // the test at each rank, -1 past the last
  int col[kTests];    // each rank's column, -1 past the last
  int* used;          // [Tl + Rq + 1] the rows the pods name, then their count
  int* list;          // [Tl + Rq] the rows the pods name (null: pack every row)
  uint32_t* words;    // [2 + Tl + Rq][W]
  int* out;           // [P, F]
  uint8_t* surv;      // [P, N] (null: not asked for)
  const uint8_t* base_rows;  // [Pb, N] the per-pod base's rows (null: node_valid alone)
  const int* base_ids;       // [P] each pod's row of base_rows
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// 4 bytes, each zero or not, as 4 bits (byte i at bit i)
__device__ __forceinline__ unsigned bits4(unsigned x) {
  x = (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;  // 0x80 where nonzero
  return ((x >> 7) * 0x10204080u) >> 28;
}

__device__ __forceinline__ unsigned bits16(uint4 v) {
  return bits4(v.x) | bits4(v.y) << 4 | bits4(v.z) << 8 | bits4(v.w) << 12;
}

// 4 bits as 4 bytes of 0 or 1
__device__ __forceinline__ unsigned bytes4(unsigned nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ uint4 bytes16(unsigned m) {  // the low 16 bits of m
  return make_uint4(bytes4(m & 15u), bytes4((m >> 4) & 15u), bytes4((m >> 8) & 15u),
                    bytes4((m >> 12) & 15u));
}

// mark_kernel (a table of more than kPackAll rows): the toleration sets and
// requirement rows the pods name, listed once each (used [Tl + Rq + 1],
// zeroed by the caller: a flag a row, then the list's length; list [Tl +
// Rq]); only those are packed (a volume snapshot's table holds a row for
// each PV's node affinity, which no pod names)
__device__ __forceinline__ void mark(const Args& a, int row) {
  if (atomicExch(a.used + row, 1) == 0) a.list[atomicAdd(a.used + a.Tl + a.Rq, 1)] = row;
}

__global__ void __launch_bounds__(kPackThreads) mark_kernel(Args a) {
  for (int p = blockIdx.x * kPackThreads + threadIdx.x; p < a.P;
       p += gridDim.x * kPackThreads) {
    if (a.flags & kTaint) mark(a, clampi(a.pod_tolset[p], 0, a.Tl - 1));
    if ((a.flags & kAffinity) && a.Rq > 0) {
      const int r0 = a.pod_req_id[p], r1 = a.pod_sel_req_id[p];
      if (r0 >= 0) mark(a, a.Tl + min(r0, a.Rq - 1));
      if (r1 >= 0) mark(a, a.Tl + min(r1, a.Rq - 1));
    }
  }
}

// pack_kernel: the word tables' rows at the block's nodes: node_valid and
// !node_unschedulable, then every toleration set and requirement row, or
// with marks the listed ones
__global__ void __launch_bounds__(kPackThreads) pack_kernel(Args a) {
  const int n = blockIdx.x * kPackThreads + threadIdx.x;
  const int rows = 2 + (a.list ? a.used[a.Tl + a.Rq] : a.Tl + a.Rq);
  for (int j = blockIdx.y; j < rows; j += gridDim.y) {
    const int r = j < 2 || !a.list ? j : 2 + a.list[j - 2];
    bool v = false;
    if (n < a.N) {
      if (r == 0) {
        v = a.node_valid[n] != 0;
      } else if (r == 1) {
        v = a.node_unsched[n] == 0;
      } else if (r < 2 + a.Tl) {
        if (a.Ts > 0)
          v = a.sched[(size_t)(r - 2) * a.Ts + clampi(a.node_taintset[n], 0, a.Ts - 1)] != 0;
      } else {
        v = a.req[(size_t)(r - 2 - a.Tl) * a.N + n] != 0;
      }
    }
    const unsigned w = __ballot_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0 && n < a.N) a.words[(size_t)r * a.W + (n >> 5)] = w;
  }
}

// NodePorts at the 32 words from w0, a node a lane: the word of lane j's
// word w0 + j (every lane of the warp takes part; the caller's pod has a
// port)
__device__ __forceinline__ unsigned port_word(const Args& a, int p, int w0, int lane) {
  unsigned mine = ~0u;
  const int last = max(0, min(32, a.W - w0));
  const int* pp = a.pod_ports + (size_t)p * a.MPp;
  for (int j = 0; j < last; ++j) {
    const int n = (w0 + j) * 32 + lane;
    bool ok = true;
    if (n < a.N) {
      const int* used = a.node_used_ports + (size_t)n * a.MUP;
      for (int s = 0; s < a.MPp; ++s) {
        const int q = pp[s];
        if (q < 0) continue;
        for (int u = 0; u < a.MUP; ++u)
          if (used[u] == q) ok = false;
      }
    }
    const unsigned b = __ballot_sync(0xffffffffu, ok);
    if (lane == j) mine = b;
  }
  return mine;
}

// The mask operand's and the survivors plane's bytes of the warp's 32
// words from word w0 (lane l's word w0 + l): with kVec (N a multiple of 16,
// the row 16-byte aligned) as two 512-byte stretches, lane l's 16 bytes at
// 16 l of each (whole sectors a warp instruction), the halves of the
// words exchanged by shuffles; else a byte at a time, a lane its own word.
template <bool kVec>
__device__ __forceinline__ unsigned mask_words(const uint8_t* row, int w0, int N, int lane) {
  const int b0 = 32 * w0 + 16 * lane;
  if (kVec) {
    const unsigned m1 = b0 < N ? bits16(__ldcs(reinterpret_cast<const uint4*>(row + b0))) : 0u;
    const unsigned m2 =
        b0 + 512 < N ? bits16(__ldcs(reinterpret_cast<const uint4*>(row + b0 + 512))) : 0u;
    const int src = (2 * lane) & 31;  // word l's halves: lanes 2l, 2l + 1 of m1, then m2
    const unsigned lo1 = __shfl_sync(0xffffffffu, m1, src);
    const unsigned hi1 = __shfl_sync(0xffffffffu, m1, src + 1);
    const unsigned lo2 = __shfl_sync(0xffffffffu, m2, src);
    const unsigned hi2 = __shfl_sync(0xffffffffu, m2, src + 1);
    return lane < 16 ? lo1 | hi1 << 16 : lo2 | hi2 << 16;
  }
  const int n0 = 32 * (w0 + lane);
  unsigned m = 0;
  for (int i = 0; i < 32 && n0 + i < N; ++i) m |= (unsigned)(row[n0 + i] != 0) << i;
  return m;
}

template <bool kVec>
__device__ __forceinline__ void store_words(uint8_t* row, int w0, int N, int lane, unsigned m) {
  if (kVec) {
    const int b0 = 32 * w0 + 16 * lane;
    const unsigned lo = __shfl_sync(0xffffffffu, m, lane >> 1);  // word l / 2
    const unsigned hi = __shfl_sync(0xffffffffu, m, 16 + (lane >> 1));
    if (b0 < N) __stcs(reinterpret_cast<uint4*>(row + b0), bytes16(lane & 1 ? lo >> 16 : lo));
    if (b0 + 512 < N)
      __stcs(reinterpret_cast<uint4*>(row + b0 + 512), bytes16(lane & 1 ? hi >> 16 : hi));
    return;
  }
  const int n0 = 32 * (w0 + lane);
  for (int i = 0; i < 32 && n0 + i < N; ++i) row[n0 + i] = (m >> i) & 1u;
}

// one pod row's scalars and table rows
struct PodRow {
  int pin;              // NodeName: -1 none, -2 no node, else the node
  bool ports;           // NodePorts: the pod names a host port
  const uint32_t* trow;  // its toleration set's words (kTaint)
  const uint32_t* rrow;  // its requirement rows' words (null: none)
  const uint32_t* srow;
  const uint8_t* mrow;  // its row of the mask operand (null: none)
  const uint8_t* brow;  // its row of the per-pod base (null: none)
};

// the tests of one pod row at word w (NodePorts and the mask operand are
// the warp's, the caller's)
__device__ __forceinline__ void word_tests(const Args& a, const PodRow& q, int w,
                                           const uint32_t* sched_w, unsigned (&ok)[kTests]) {
  const bool on = w < a.W;
#pragma unroll
  for (int t = 0; t < kTests; ++t) ok[t] = ~0u;
  if (on && (a.flags & kUnsched)) ok[0] = sched_w[w];
  if (q.pin == -2) ok[1] = 0u;
  else if (q.pin >= 0) ok[1] = (q.pin >> 5) == w ? 1u << (q.pin & 31) : 0u;
  if (on && (a.flags & kTaint)) ok[2] = q.trow[w];
  if (on && q.rrow) ok[3] = q.rrow[w];
  if (on && q.srow) ok[3] &= q.srow[w];
}

template <bool kVec, bool kInOrder>
__global__ void __launch_bounds__(kThreads) count_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int W = a.W, N = a.N, flags = a.flags;
  const uint32_t* valid_w = a.words;
  const uint32_t* sched_w = a.words + W;
  const uint32_t* taint_w = a.words + 2 * (size_t)W;
  const uint32_t* req_w = a.words + (size_t)(2 + a.Tl) * W;

  for (int p = blockIdx.x * kWarps + (threadIdx.x >> 5); p < a.P; p += gridDim.x * kWarps) {
    const bool counted = a.rows == nullptr || a.rows[p] != 0;  // uniform in the warp
    int* out = a.out + (size_t)p * a.F;
    if (!counted && a.surv == nullptr) {
      if (lane < a.F) out[lane] = 0;
      continue;
    }
    PodRow q;
    q.pin = (flags & kNodeName) ? a.pod_node_name[p] : -1;
    q.trow = taint_w + (size_t)((flags & kTaint) ? clampi(a.pod_tolset[p], 0, a.Tl - 1) : 0) * W;
    q.rrow = q.srow = nullptr;
    if ((flags & kAffinity) && a.Rq > 0) {
      const int r0 = a.pod_req_id[p], r1 = a.pod_sel_req_id[p];
      if (r0 >= 0) q.rrow = req_w + (size_t)min(r0, a.Rq - 1) * W;
      if (r1 >= 0) q.srow = req_w + (size_t)min(r1, a.Rq - 1) * W;
    }
    q.ports = false;
    if (flags & kPorts)
      for (int s = 0; s < a.MPp; ++s) q.ports |= a.pod_ports[(size_t)p * a.MPp + s] >= 0;
    q.mrow = (flags & kMask) ? a.mask + (size_t)p * N : nullptr;
    q.brow = a.base_rows ? a.base_rows + (size_t)a.base_ids[p] * N : nullptr;
    uint8_t* surv = a.surv ? a.surv + (size_t)p * N : nullptr;

    unsigned cnt[kTests];
#pragma unroll
    for (int k = 0; k < kTests; ++k) cnt[k] = 0;
    // kChunk words a lane at a time: lane l's word c is w0 + 32 c + l, and
    // every load of the chunk is in flight before the first test
    for (int w0 = 0; w0 < W; w0 += 32 * kChunk) {
      unsigned base[kChunk], ok[kChunk][kTests];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int w = w0 + 32 * c + lane;
        base[c] = w < W ? valid_w[w] : 0u;
        word_tests(a, q, w, sched_w, ok[c]);
      }
      if (q.brow)
#pragma unroll
        for (int c = 0; c < kChunk; ++c) base[c] &= mask_words<kVec>(q.brow, w0 + 32 * c, N, lane);
      if (q.mrow)
#pragma unroll
        for (int c = 0; c < kChunk; ++c) ok[c][5] = mask_words<kVec>(q.mrow, w0 + 32 * c, N, lane);
      if (q.ports)
#pragma unroll
        for (int c = 0; c < kChunk; ++c) ok[c][4] = port_word(a, p, w0 + 32 * c, lane);
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        // the chain, in column order
        unsigned rem = base[c];
#pragma unroll
        for (int k = 0; k < kTests; ++k) {
          unsigned o = ~0u;
          if (kInOrder) {
            o = ok[c][k];
          } else {
#pragma unroll
            for (int t = 0; t < kTests; ++t)
              if (a.order[k] == t) o = ok[c][t];
          }
          cnt[k] += __popc(rem & ~o);
          rem &= o;
        }
        if (surv) store_words<kVec>(surv, w0 + 32 * c, N, lane, rem);
      }
    }
    unsigned tot[kTests];
#pragma unroll
    for (int k = 0; k < kTests; ++k) tot[k] = __reduce_add_sync(0xffffffffu, cnt[k]);
    if (lane < a.F) {
      int v = 0;
#pragma unroll
      for (int k = 0; k < kTests; ++k)
        if (a.col[k] == lane) v = (int)tot[k];
      out[lane] = counted ? v : 0;
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <bool kVec, bool kInOrder>
cudaError_t launch_count(const Args& a, cudaStream_t st) {
  const int blocks = (a.P + kWarps - 1) / kWarps;
  count_kernel<kVec, kInOrder><<<blocks < kMaxGrid ? blocks : kMaxGrid, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// `cols` [6] each test's column (-1: not a filter of the framework); `rows`
// [P] or null; `used` [Tl + Rq + 1] zeroed and `list` [Tl + Rq] scratch
// where Tl + Rq > kPackAll (else null: every row packed), `words` [2 + Tl
// + Rq, ceil(N / 32)] scratch; `out` [P, F] (every element written);
// `survivors` [P, N] or null; `base_rows` [Pb, N] and `base_ids` [P] (each
// in [0, Pb)) or both null. The inputs take neither fit nor sampling (the
// reference's Framework.static has neither).
extern "C" int static_rejects_launch(
    int P, int N, int flags, const int* pod_node_name, const int* pod_tolset,
    const int* pod_req_id, const int* pod_sel_req_id, const int* pod_ports, int MPp,
    const uint8_t* node_valid, const uint8_t* node_unsched, const int* node_taintset,
    const int* node_used_ports, int MUP, const uint8_t* sched, int Tl, int Ts,
    const uint8_t* req, int Rq, const uint8_t* mask, int F, const int* cols,
    const uint8_t* rows, int* used, int* list, uint32_t* words, int* out,
    uint8_t* survivors, const uint8_t* base_rows, const int* base_ids, int Pb,
    void* stream) {
  if (P <= 0) return 0;
  if (N < 0 || F < 1 || F > kMaxF || ((flags & kTaint) && (Tl < 1 || Ts < 1)) ||
      ((base_rows != nullptr) != (base_ids != nullptr)) || (base_rows && Pb < 1) ||
      ((Tl + Rq > kPackAll) != (list != nullptr)) ||
      (flags & ~(kUnsched | kNodeName | kTaint | kAffinity | kPorts | kMask)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.P = P; a.N = N; a.W = (N + 31) / 32; a.flags = flags;
  a.pod_node_name = pod_node_name; a.pod_tolset = pod_tolset; a.pod_req_id = pod_req_id;
  a.pod_sel_req_id = pod_sel_req_id; a.pod_ports = pod_ports; a.MPp = MPp;
  a.node_valid = node_valid; a.node_unsched = node_unsched; a.node_taintset = node_taintset;
  a.node_used_ports = node_used_ports; a.MUP = MUP;
  a.sched = sched; a.Tl = Tl; a.Ts = Ts; a.req = req; a.Rq = Rq;
  a.mask = mask; a.rows = rows; a.F = F; a.used = used; a.list = list; a.words = words;
  a.out = out;
  a.surv = survivors;
  a.base_rows = base_rows;
  a.base_ids = base_ids;
  // the tests the flags name, by column: the chain's ranks
  int n = 0;
  unsigned taken = 0;  // the columns named so far
  for (int t = 0; t < kTests; ++t) {
    if (!(flags & kBits[t])) continue;
    if (cols[t] < 0 || cols[t] >= F || (taken >> cols[t]) & 1u) return (int)cudaErrorInvalidValue;
    taken |= 1u << cols[t];
    int k = n++;
    for (; k > 0 && cols[a.order[k - 1]] > cols[t]; --k) a.order[k] = a.order[k - 1];
    a.order[k] = t;
  }
  bool in_order = true;  // the ranks are the tests' own order
  for (int k = 1; k < n; ++k) in_order = in_order && a.order[k - 1] < a.order[k];
  for (int k = 0; k < kTests; ++k) {
    if (in_order) {  // rank k is test k, absent or not
      a.order[k] = k;
      a.col[k] = (flags & kBits[k]) ? cols[k] : -1;
    } else {
      if (k >= n) a.order[k] = -1;
      a.col[k] = k < n ? cols[a.order[k]] : -1;
    }
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    const int marks = (P + kPackThreads - 1) / kPackThreads;
    if (list) mark_kernel<<<marks < kMaxGrid ? marks : kMaxGrid, kPackThreads, 0, st>>>(a);
    const int rows_total = 2 + Tl + Rq;
    const dim3 grid((N + kPackThreads - 1) / kPackThreads,
                    rows_total < kPackRows ? rows_total : kPackRows);
    pack_kernel<<<grid, kPackThreads, 0, st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = N % 16 == 0 && (!(flags & kMask) || aligned(mask, 16)) &&
                   (!survivors || aligned(survivors, 16)) &&
                   (!base_rows || aligned(base_rows, 16));
  const cudaError_t err = vec ? (in_order ? launch_count<true, true>(a, st)
                                          : launch_count<true, false>(a, st))
                              : (in_order ? launch_count<false, true>(a, st)
                                          : launch_count<false, false>(a, st));
  return (int)err;
}
