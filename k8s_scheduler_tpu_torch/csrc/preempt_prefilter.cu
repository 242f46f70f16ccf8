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
// Design: node-stationary. A CTA owns kNodes consecutive nodes, one a
// thread, and a chunk of kChunk candidates (blockIdx.y): at config #4
// (N = 8192, C = 256) 64 x 8 = 512 CTAs. It stages its nodes' tables once,
// the tile's contiguous rows read with 16-byte loads, the three tables'
// loads in flight together: the victim priorities and each prefix's room free0[n] +
// prefix_freed[n, k] (the reference's one f32 add), transposed so that a
// thread's node is one column of shared memory. Each thread then turns its
// node's rooms into their prefix maxima over k and notes whether the
// rooms were monotone in k. It has read the chunk's gate bytes of its node
// first (one batch of independent loads, coalesced along N, into a word of
// bits, their latency hidden by the staging) and walks its gated
// candidates, with no warp sync in the walk: elig from the staged
// priorities (reused, with the prefix maxima at elig in registers, while
// consecutive candidates share a priority); the
// candidate is ruled out unless q <= the prefix maxima at elig on every
// resource, and where the rooms are monotone that test is the fit at elig,
// exact. Elsewhere (no monotonicity is assumed: the prefixes come from
// XLA's chunked cumsum order) the prefixes 1..elig are walked in order
// from L2. A thread keeps its verdicts as a word of bits; a warp ORs its
// threads' words (`__reduce_or_sync`) into shared memory once; the CTA writes 1
// once per found candidate after the chunk (the launcher zeroes the output
// first). Candidates with cand_ok false are skipped by every thread alike. Where the staged tables
// do not fit in shared memory (many pods a node and many resources), every
// walk reads them from L2 (kStaged false).
//
// Earlier designs of PR 13 (its runs 1, 3 and 4): every prefix walked
// from shared memory (21 us above the floor on config #4's call); a
// staging whose element indices were divisions by the row length (most of
// a 19-20 us floor); the gate read after the staging, the rooms' maxima
// carried through shared memory, a skip of candidates another warp found
// (its shuffle cost more than it saved) and a shared store a found
// candidate (a 15 us floor).
//
// Bound on an H100: bytes — the [C, N] gate once and the per-node tables
// (victim priorities, prefix sums, free room: ~1.5 MB at config #4); each
// chunk's CTAs read the node tables again from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNodes = 128;  // nodes a CTA, one a thread
constexpr int kChunk = 32;   // candidates a CTA: one word of gate bits
constexpr unsigned kChunkMask = kChunk == 32 ? 0xffffffffu : (1u << kChunk) - 1;
constexpr int kPitch = kNodes + 1;  // a staged row: the transposing stores miss bank conflicts
constexpr int kBatch = 8;    // 16-byte loads in flight a thread while staging
constexpr int kMaxR = 8;     // ops/preempt_prefilter.py MAX_RESOURCES
constexpr int kSmemMax = 232448;  // shared memory a CTA may take on sm_90

struct Args {
  int C, N, MPN, R;
  const int* prio;            // [C]
  const float* req;           // [C, R]
  const uint8_t* cand_ok;     // [C]
  const int* vict_prio;       // [N, MPN]
  const float* prefix_freed;  // [N, MPN+1, R]
  const float* free0;         // [N, R]
  const uint8_t* gate;        // [C, N]
  const uint8_t* node_valid;  // [N]
  uint8_t* out;               // [C], zeroed by the launcher
};

// shared memory of a CTA in 4-byte words: the chunk's requests and
// priorities, its candidates and found flags as two words, then (staged)
// the nodes' free room, victim priorities and prefix maxima of the room
__host__ __device__ inline int cand_words(int R) { return kChunk * (R + 1) + 2; }
__host__ __device__ inline int node_words(int MPN, int R) {
  return kNodes * R + kPitch * (MPN + MPN * R);
}

// Stages a tile's contiguous rows src[0, nn * row) into shared memory in
// two steps, so that the loads of several tables are in flight together:
// load() issues up to B 16-byte loads a thread, store(f) hands each word to
// f(t, col, word) for node t of the tile and column col of its row. The
// (t, col) cursor moves by additions: no division per element, which cost
// more than the loads (PR 13's run 3). tail(f) stages what the vector loads
// leave (a row count not a multiple of 4, or a source not 16-byte aligned).
template <int B>
struct RowStager {
  const uint32_t* src;
  int nv, total, row, dt, dc, t0, c0, base;
  uint4 v[B];

  __device__ RowStager(const uint32_t* src_, int nn, int row_)
      : src(src_), total(nn * row_), row(row_), base(threadIdx.x) {
    nv = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? total / 4 : 0;
    dt = 4 * kNodes / row;  // one step of the cursor: kNodes vectors
    dc = 4 * kNodes % row;
    t0 = 4 * threadIdx.x / row;
    c0 = 4 * threadIdx.x % row;
  }
  __device__ bool more() const { return base < nv; }
  __device__ void load() {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int u = 0; u < B; ++u)
      if (base + u * kNodes < nv) v[u] = __ldg(s4 + base + u * kNodes);
  }
  template <typename F>
  __device__ void store(F f) {
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (base + u * kNodes < nv) {
        const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        int t = t0, c = c0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f(t, c, w[e]);
          if (++c == row) c = 0, ++t;
        }
      }
      t0 += dt;
      c0 += dc;
      if (c0 >= row) c0 -= row, ++t0;
    }
    base += B * kNodes;
  }
  template <typename F>
  __device__ void tail(F f) {
    for (int i = 4 * nv + threadIdx.x; i < total; i += kNodes) f(i / row, i % row, __ldg(src + i));
  }
};

// does q fit node n at some prefix 1..elig? (the tables from L2: free0 +
// prefix_freed, the reference's one f32 add, in prefix order)
__device__ __forceinline__ bool walk_l2(const Args& a, int n, int elig, const float* q) {
  const int R = a.R;
  for (int k = 1; k <= elig; ++k) {
    bool fits = true;
    for (int r = 0; r < R; ++r)
      if (!(q[r] <= a.free0[(size_t)n * R + r] +
                        a.prefix_freed[((size_t)n * (a.MPN + 1) + k) * R + r]))
        fits = false;
    if (fits) return true;
  }
  return false;
}

template <bool kStaged>
__global__ void __launch_bounds__(kNodes) prefilter_kernel(Args a) {
  extern __shared__ __align__(16) int smem[];
  const int R = a.R, MPN = a.MPN, N = a.N;
  float* s_q = reinterpret_cast<float*>(smem);  // [kChunk][R]
  int* s_p = smem + kChunk * R;                 // [kChunk]
  unsigned* s_word = reinterpret_cast<unsigned*>(s_p + kChunk);  // [2]: candidates, found
  float* s_free = reinterpret_cast<float*>(s_word + 2);          // [kNodes][R]
  int* s_prio = reinterpret_cast<int*>(s_free + kNodes * R);     // [MPN][kPitch]
  float* s_pm = reinterpret_cast<float*>(s_prio + MPN * kPitch);  // [MPN][R][kPitch]

  const int tid = threadIdx.x, lane = tid & 31;
  const int n0 = blockIdx.x * kNodes, c0 = blockIdx.y * kChunk;
  const int nn = min(kNodes, N - n0);  // nodes of this tile
  const int n = n0 + tid;

  // the chunk's gate bytes of this thread's node, one batch of loads whose
  // latency the staging below hides
  const bool live = n < N && a.node_valid[n];
  unsigned gbits = 0;
  if (live) {
#pragma unroll
    for (int cc = 0; cc < kChunk; ++cc)
      if (c0 + cc < a.C) gbits |= (unsigned)(a.gate[(size_t)(c0 + cc) * N + n] != 0) << cc;
  }
  // the chunk's candidates (past C: not a candidate), cand_ok as a word
  for (int i = tid; i < kChunk * R; i += kNodes) {
    const int c = c0 + i / R;
    s_q[i] = c < a.C ? a.req[(size_t)c0 * R + i] : 0.0f;
  }
  if (tid < kChunk) {
    const int c = c0 + tid;
    s_p[tid] = c < a.C ? a.prio[c] : 0;
    const unsigned ok = __ballot_sync(kChunkMask, c < a.C && a.cand_ok[c]);
    if (tid == 0) s_word[0] = ok, s_word[1] = 0u;
  }
  if (kStaged) {  // the tile's node tables, read as contiguous rows
    const int row = (MPN + 1) * R;  // one node's prefix sums; prefix 0 never counts
    RowStager<2> sf(reinterpret_cast<const uint32_t*>(a.free0 + (size_t)n0 * R), nn, R);
    RowStager<2> sv(reinterpret_cast<const uint32_t*>(a.vict_prio + (size_t)n0 * MPN), nn, MPN);
    RowStager<kBatch> sx(reinterpret_cast<const uint32_t*>(a.prefix_freed + (size_t)n0 * row),
                         nn, row);
    auto free_f = [&](int t, int r, uint32_t w) { s_free[t * R + r] = __uint_as_float(w); };
    auto prio_f = [&](int t, int j, uint32_t w) { s_prio[j * kPitch + t] = (int)w; };
    auto pf_f = [&](int t, int kr, uint32_t w) {
      if (kr >= R) s_pm[(kr - R) * kPitch + t] = __uint_as_float(w);
    };
    while (sf.more() || sv.more() || sx.more()) {
      sf.load();
      sv.load();
      sx.load();
      sf.store(free_f);
      sv.store(prio_f);
      sx.store(pf_f);
    }
    sf.tail(free_f);
    sv.tail(prio_f);
    sx.tail(pf_f);
  }
  __syncthreads();
  // each thread forms its node's rooms free0 + prefix_freed (the
  // reference's one f32 add), turns them into prefix maxima over k and
  // notes whether they were monotone (then a fit at some k <= elig is a fit
  // at elig; else the maxima only rule nodes out)
  bool mono = false;
  if (kStaged && live) {
    mono = true;
    for (int r = 0; r < R; ++r) {
      float prev = 0.0f;
      for (int k = 0; k < MPN; ++k) {
        float* cur = &s_pm[(k * R + r) * kPitch + tid];
        const float room = s_free[tid * R + r] + *cur;
        if (k > 0 && !(room >= prev)) mono = false;
        prev = k == 0 ? room : fmaxf(room, prev);
        *cur = prev;
      }
    }
  }
  const unsigned cands = s_word[0];
  gbits &= cands;

  // this thread's gated candidates in order, with no warp sync inside the
  // loop; elig and the prefix maxima at elig kept while consecutive
  // candidates share a priority (the queue order groups them)
  int last_p = 0, elig = -1;
  float pm[kMaxR];
  unsigned mine = 0;
  for (unsigned m = gbits; m; m &= m - 1) {
    const int cc = __ffs(m) - 1;
    bool found = false;
    const int p = s_p[cc];
    const float* q = s_q + cc * R;
    if (elig < 0 || p != last_p) {
      elig = 0;
      for (int j = 0; j < MPN; ++j)
        elig += (kStaged ? s_prio[j * kPitch + tid] : a.vict_prio[(size_t)n * MPN + j]) < p;
      last_p = p;
      if (kStaged && elig > 0) {
#pragma unroll
        for (int r = 0; r < kMaxR; ++r)
          if (r < R) pm[r] = s_pm[((elig - 1) * R + r) * kPitch + tid];
      }
    }
    if (!kStaged) {
      found = walk_l2(a, n, elig, q);
    } else if (elig > 0) {
      found = true;  // q within the prefix maxima up to elig
#pragma unroll
      for (int r = 0; r < kMaxR; ++r)
        if (r < R && !(q[r] <= pm[r])) found = false;
      if (found && !mono) found = walk_l2(a, n, elig, q);
    }
    mine |= (unsigned)found << cc;
  }
  const unsigned found_w = __reduce_or_sync(0xffffffffu, mine);
  if (lane == 0 && found_w) atomicOr(&s_word[1], found_w);
  __syncthreads();
  if (tid < kChunk && ((s_word[1] >> tid) & 1u)) a.out[c0 + tid] = 1;
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
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)C, s);
  if (err != cudaSuccess || N <= 0) return (int)err;
  Args a{C, N, MPN, R, prio, req, cand_ok, vict_prio, prefix_freed, free0, gate,
         node_valid, out};
  const dim3 grid((N + kNodes - 1) / kNodes, (C + kChunk - 1) / kChunk);
  const size_t staged = 4 * (size_t)(cand_words(R) + node_words(MPN, R));
  if (staged <= (size_t)kSmemMax) {
    if (staged > 48 * 1024) {
      err = cudaFuncSetAttribute(prefilter_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)staged);
      if (err != cudaSuccess) return (int)err;
    }
    prefilter_kernel<true><<<grid, kNodes, staged, s>>>(a);
  } else {
    prefilter_kernel<false><<<grid, kNodes, 4 * cand_words(R), s>>>(a);
  }
  return (int)cudaGetLastError();
}

// the staged tables' shared memory a CTA takes, in bytes (0: read from L2)
extern "C" int preempt_prefilter_smem(int MPN, int R) {
  const size_t staged = 4 * (size_t)(cand_words(R) + node_words(MPN, R));
  return staged <= (size_t)kSmemMax ? (int)staged : 0;
}
