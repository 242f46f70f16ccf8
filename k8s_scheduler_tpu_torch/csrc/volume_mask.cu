// volume_mask: VolumeBinding's per (pod, node) feasibility, one bool [B, N]
// plane written once.
//
// Replaces (no Pallas kernel existed; these are the XLA-compiled device
// functions): k8s_scheduler_tpu/ops/volumes.py:159 volume_mask (the static
// variant: bound-PV affinity, static-or-dynamic per unbound slot, missing
// claims) and :208 volume_mask_unbound (the per-round residue: unbound
// slots only, against the live claim bitmap), both with _hall_ok (:109),
// Hall's condition over the slot subsets of multi-volume pods.
//
// The reference spends this in dense count products, [P, V] x [V, N] per
// slot and per slot subset (about 3 TFLOP each at 16384 pods x 11264 PVs x
// 8192 nodes), for a count that is short and sparse: a node admits a
// handful of available PVs of a few kinds. Here each block takes kPods
// pods x a tile of kTile nodes, 16 consecutive nodes a thread:
//   - the pods' slot rows are decoded once into shared memory;
//   - the tile's node-list entries are staged in shared memory as PV
//     types, (class, capacity + 1e-3) keys, a claimed PV as none;
//   - when the tile holds at most 16 types and no node more than 15 PVs of
//     one type (the usual case; up to 2 slots a pod), each thread packs
//     its nodes' lists into per-node histograms over the types, one 4-bit
//     count per type in a 64-bit word held in registers, and lane j of
//     the first warp works out for pod j which types serve each slot
//     subset (a nibble mask) and what the global list adds; a node's count
//     for a subset is then the nibble sum of its histogram under the mask,
//     with no walk;
//   - otherwise each thread walks its nodes' lists and the global list in
//     device memory;
//   - a pod with no slot the variant tests (no volume; in the unbound
//     variant no unbound slot) takes a block-uniform fast path: its row
//     tile is all ones, one 16-byte store a thread; otherwise the thread
//     reads the requirement rows its slots need as 16 bytes (bound-PV
//     affinity, dynamic provisioning) and its sixteen verdicts go out as
//     one 16-byte store.
// A mode-1 slot needs a static PV (count > 0) or dynamic provisioning at
// the node; every subset needs count >= its slots that need a static PV;
// above 6 slots the dominance groups (membership table from the caller,
// on the raw candidate sets) need count(anchor) >= the group's needy
// members; in the static variant a mode-0 slot needs its PV's
// nodeAffinity and a mode-2 slot fails. Counts are integers, so the mask
// is exact in any order (the lists are counted, not merged).
//
// Bound on an H100: bytes — the [B, N] output written once, the pod rows,
// the node offsets, the short lists and the requirement rows read.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a --fmad=false ...

#include <math.h>

#include "pv_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kNodesPerThread = 16;
constexpr int kTile = kThreads * kNodesPerThread;  // nodes per block
constexpr int kPods = 32;                          // pods per block
constexpr int kStage = 2 * kTile;                  // list entries staged

struct Args {
  pv::Ctx c;
  uint8_t* out;              // [B, N]
  int B, unbound, multi, vec;
  const uint8_t* claimed;    // [V] or null (static variant)
  const unsigned* sub_mask;  // [n_sub]: MVol singletons, then Hall subsets
  int n_sub;
  const uint8_t* member;     // [B, MVol, MVol] (anchor, member) or null
};

// bit q: row[n0 + q] != 0, for the nv <= 16 nodes from n0
__device__ __forceinline__ unsigned row_bits(const uint8_t* row, int n0, int nv, bool vec) {
  unsigned bits = 0;
  if (vec) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + n0);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < kNodesPerThread; ++q)
      bits |= (unsigned)(((w[q >> 2] >> (8 * (q & 3))) & 0xffu) != 0) << q;
  } else {
    for (int q = 0; q < nv; ++q) bits |= (unsigned)(row[n0 + q] != 0) << q;
  }
  return bits;
}

// requirement row `rid` at the thread's nodes (pv::req_at, 16 at a time)
__device__ __forceinline__ unsigned req_bits(const pv::Ctx& c, int rid, int n0, int nv,
                                             bool vec, unsigned fill) {
  if (rid < 0) return fill;
  const int r = rid < c.Rq ? rid : c.Rq - 1;
  return row_bits(c.req + (size_t)r * c.N, n0, nv, vec);
}

__device__ __forceinline__ void store_bits(uint8_t* out, unsigned bits, int nv, bool vec) {
  if (vec) {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < kNodesPerThread; ++q) w[q >> 2] |= ((bits >> q) & 1u) << (8 * (q & 3));
    *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int q = 0; q < nv; ++q) out[q] = (bits >> q) & 1u;
  }
}

// capacity + 1e-3 of PV v as a slot sees it: -inf once claimed
__device__ __forceinline__ float usable_cap(const Args& a, int v) {
  if (a.claimed != nullptr && pv::claimed_at(a.claimed, v)) return -INFINITY;
  return a.c.pv_cap[v] + 1e-3f;
}

// no type: a claimed PV, an empty slot of the type table (a real key
// equal to it would have a NaN capacity, which serves no slot either)
constexpr unsigned long long kNoType = ~0ull;

// PV v's type key: (class, bits of capacity + 1e-3), kNoType once claimed
__device__ __forceinline__ unsigned long long type_key(const Args& a, int v) {
  if (a.claimed != nullptr && pv::claimed_at(a.claimed, v)) return kNoType;
  return ((unsigned long long)(unsigned)a.c.pv_class[v] << 32)
         | __float_as_uint(a.c.pv_cap[v] + 1e-3f);
}

__device__ __forceinline__ unsigned key_hash(unsigned long long k) {
  return ((unsigned)k ^ (unsigned)(k >> 32) * 0x9e3779b9u) * 2654435761u >> 27;
}

// the slot of `key` in the 32-slot open-addressed type table, inserting
// it; -1 when the table is full
__device__ int insert_type(unsigned long long* table, unsigned long long key) {
  const unsigned h = key_hash(key);
  for (int i = 0; i < 32; ++i) {
    const int s = (h + i) & 31;
    const unsigned long long prev = atomicCAS(table + s, kNoType, key);
    if (prev == kNoType || prev == key) return s;
  }
  return -1;
}

__device__ __forceinline__ int find_type(const unsigned long long* table,
                                         unsigned long long key) {
  const unsigned h = key_hash(key);
  int s = h & 31;
  while (table[s] != key) s = (s + 1) & 31;
  return s;
}

// sum of the sixteen 4-bit counts of x (at most 240)
__device__ __forceinline__ int nibble_sum(unsigned long long x) {
  x = (x & 0x0f0f0f0f0f0f0f0full) + ((x >> 4) & 0x0f0f0f0f0f0f0f0full);
  return (int)((x * 0x0101010101010101ull) >> 56);
}

// one pod's slots, MAXV of them in registers
template <int MAXV>
struct PodSlots {
  int mode[MAXV], rid[MAXV], cls[MAXV];
  float size[MAXV];
};

template <int MAXV>
__device__ __forceinline__ void load_pod(const pv::Slots& from, PodSlots<MAXV>& s) {
#pragma unroll
  for (int t = 0; t < MAXV; ++t) {
    s.mode[t] = from.mode[t];
    s.rid[t] = from.rid[t];
    s.cls[t] = from.cls[t];
    s.size[t] = from.size[t];
  }
}

// bit t: a PV of class `cls` and usable capacity `cap` serves slot t
template <int MAXV>
__device__ __forceinline__ unsigned serves(const PodSlots<MAXV>& s, int cls, float cap) {
  unsigned bits = 0;
#pragma unroll
  for (int t = 0; t < MAXV; ++t)
    if (s.mode[t] == 1 && cls == s.cls[t] && cap >= s.size[t]) bits |= 1u << t;
  return bits;
}

template <int MAXSUB>
__device__ __forceinline__ void count_pv(unsigned bits, const unsigned* sub, int* cnt) {
  if (bits) {
#pragma unroll
    for (int k = 0; k < MAXSUB; ++k)
      if (bits & sub[k]) ++cnt[k];
  }
}

// VolumeBinding's verdict at node bit q from the per-subset counts
template <int MAXV, int MAXSUB>
__device__ __forceinline__ bool verdict(const Args& a, const PodSlots<MAXV>& s,
                                        const unsigned* dyn, int q, const int* cnt,
                                        const unsigned* sub, int p) {
  const pv::Ctx& c = a.c;
  // every slot loop has a constant bound, so the arrays stay in registers
  bool good = true;
  unsigned needy = 0;
#pragma unroll
  for (int t = 0; t < MAXV; ++t) {
    if (s.mode[t] != 1) continue;
    const bool dyn_t = (dyn[t] >> q) & 1u;
    const int n_t = t < MAXSUB ? cnt[t < MAXSUB ? t : 0] : 0;
    good = good && (n_t > 0 || dyn_t);
    if (!dyn_t) needy |= 1u << t;
  }
  if (a.multi) {
#pragma unroll
    for (int k = 0; k < MAXSUB; ++k)
      if (k >= c.MVol && k < a.n_sub) good = good && cnt[k] >= __popc(sub[k] & needy);
    if (a.member != nullptr) {
      const uint8_t* mem = a.member + (size_t)p * c.MVol * c.MVol;
#pragma unroll
      for (int gi = 0; gi < MAXV; ++gi) {
        if (gi >= c.MVol) continue;
        int need = 0;
        for (int t = 0; t < c.MVol; ++t)
          need += (mem[gi * c.MVol + t] != 0) && ((needy >> t) & 1u);
        const int avail = gi < MAXSUB ? cnt[gi < MAXSUB ? gi : 0] : 0;
        good = good && avail >= need;
      }
    }
  }
  return good;
}

// MAXV: slots a pod has (>= MVol); MAXSUB: subset counters (>= n_sub)
template <int MAXV, int MAXSUB>
__global__ void __launch_bounds__(kThreads) volume_mask_kernel(Args a) {
  constexpr bool kHist = MAXSUB <= 4;  // the type-histogram path
  constexpr int kH = kHist ? kNodesPerThread : 1;
  extern __shared__ __align__(16) unsigned long long s_stage[];  // [kStage] type keys
  __shared__ pv::Slots s_slots[kPods];
  __shared__ int s_tested[kPods];
  __shared__ int s_off[kTile + 1];
  __shared__ unsigned s_sub[MAXSUB];
  __shared__ unsigned long long s_table[32];  // open-addressed type keys
  __shared__ int s_type[32];                  // slot -> type id
  __shared__ int s_tcls[16];
  __shared__ float s_tcap[16];
  __shared__ int s_ntypes, s_hist;            // s_hist: the histogram path holds
  __shared__ unsigned long long s_mask[kHist ? kPods : 1][MAXSUB];
  __shared__ int s_gcnt[kHist ? kPods : 1][MAXSUB];
  const pv::Ctx& c = a.c;
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_base = blockIdx.x * kTile;
  const int p0 = blockIdx.y * kPods;
  const int np = min(kPods, a.B - p0);
  const int tn = min(kTile, c.N - n_base);

  for (int i = tid; i < kPods * pv::kMaxVol; i += kThreads) {
    const int j = i / pv::kMaxVol, t = i - j * pv::kMaxVol;
    pv::Slots& s = s_slots[j];
    if (j < np && t < c.MVol) {
      const size_t at = (size_t)(p0 + j) * c.MVol + t;
      s.mode[t] = c.vol_mode[at];
      s.rid[t] = c.vol_req[at];
      s.cls[t] = c.vol_class[at];
      s.size[t] = c.vol_size[at];
    } else {
      s.mode[t] = -1; s.rid[t] = -1; s.cls[t] = -1; s.size[t] = 0.0f;
    }
  }
  for (int i = tid; i <= tn; i += kThreads) s_off[i] = c.node_off[n_base + i];
  for (int k = tid; k < MAXSUB; k += kThreads) s_sub[k] = k < a.n_sub ? a.sub_mask[k] : 0u;
  if (tid < 32) s_table[tid] = kNoType;
  if (tid == 0) s_hist = kHist;
  __syncthreads();
  if (tid < kPods) {
    bool tested = false;
    for (int t = 0; t < c.MVol; ++t) {
      const int m = s_slots[tid].mode[t];
      tested = tested || m == 1 || (!a.unbound && m >= 0);
    }
    s_tested[tid] = tested;
  }
  // the tile's list entries as type keys, when they fit the stage
  const int e0 = s_off[0], n_entries = s_off[tn] - e0;
  if (kHist && n_entries <= kStage) {
    for (int e = tid; e < n_entries; e += kThreads) {
      const unsigned long long key = type_key(a, c.node_pv[e0 + e]);
      s_stage[e] = key;
      if (key != kNoType && insert_type(s_table, key) < 0) s_hist = 0;
    }
  } else if (tid == 0) {
    s_hist = 0;
  }
  __syncthreads();
  if (kHist && tid < 32) {  // type ids in slot order; at most 16 types
    const unsigned long long key = s_table[lane];
    const unsigned used = __ballot_sync(0xffffffffu, key != kNoType);
    const int id = __popc(used & ((1u << lane) - 1u));
    s_type[lane] = id;
    if (__popc(used) <= 16 && key != kNoType) {
      s_tcls[id] = (int)(unsigned)(key >> 32);
      s_tcap[id] = __uint_as_float((unsigned)key);
    }
    if (lane == 0) {
      s_ntypes = __popc(used);
      if (__popc(used) > 16) s_hist = 0;
    }
  }
  __syncthreads();

  const int local = tid * kNodesPerThread;
  const int n0 = n_base + local;
  const int nv = max(0, min(kNodesPerThread, c.N - n0));
  // this thread's nodes as 4-bit counts per type (the histogram path)
  unsigned long long H[kH];
#pragma unroll
  for (int q = 0; q < kH; ++q) {
    H[q] = 0ull;
    if (kHist && s_hist && q < nv) {
      for (int e = s_off[local + q]; e < s_off[local + q + 1]; ++e) {
        const unsigned long long key = s_stage[e - e0];
        if (key == kNoType) continue;
        const int sh = 4 * s_type[find_type(s_table, key)];
        if (((H[q] >> sh) & 0xfull) == 0xfull) s_hist = 0;  // a 16th of one type
        H[q] += 1ull << sh;
      }
    }
  }
  // lane j: pod j's nibble mask of the types serving each subset, and the
  // global list's count per subset
  if (kHist && s_hist && tid < np) {
    PodSlots<MAXV> s;
    load_pod(s_slots[tid], s);
    unsigned long long m[MAXSUB];
    int g[MAXSUB];
#pragma unroll
    for (int k = 0; k < MAXSUB; ++k) { m[k] = 0ull; g[k] = 0; }
    for (int i = 0; i < s_ntypes; ++i) {
      const unsigned bits = serves(s, s_tcls[i], s_tcap[i]);
#pragma unroll
      for (int k = 0; k < MAXSUB; ++k)
        if (bits & s_sub[k]) m[k] |= 0xfull << (4 * i);
    }
    for (int gi = 0; gi < c.G; ++gi) {
      const int v = c.global_pv[gi];
      count_pv<MAXSUB>(serves(s, c.pv_class[v], usable_cap(a, v)), s_sub, g);
    }
#pragma unroll
    for (int k = 0; k < MAXSUB; ++k) { s_mask[tid][k] = m[k]; s_gcnt[tid][k] = g[k]; }
  }
  __syncthreads();
  const bool hist = kHist && s_hist;  // block-uniform from here

  if (local >= tn) return;
  const unsigned all = (1u << nv) - 1u;
  const bool vec = a.vec;
  for (int j = 0; j < np; ++j) {
    const int p = p0 + j;
    unsigned ok = all;
    if (s_tested[j]) {  // block-uniform
      PodSlots<MAXV> s;
      load_pod(s_slots[j], s);
      bool any1 = false;
      unsigned dyn[MAXV];
#pragma unroll
      for (int t = 0; t < MAXV; ++t) {
        dyn[t] = 0u;
        if (s.mode[t] == 1) {
          any1 = true;
          dyn[t] = s.rid[t] == -2 ? 0u : req_bits(c, s.rid[t], n0, nv, vec, all);
        } else if (!a.unbound) {
          if (s.mode[t] == 0) ok &= req_bits(c, s.rid[t], n0, nv, vec, all);
          else if (s.mode[t] >= 2) ok = 0u;
        }
      }
      if (any1 && hist) {
        unsigned long long m[MAXSUB];
        int g[MAXSUB];
#pragma unroll
        for (int k = 0; k < MAXSUB; ++k) {
          m[k] = s_mask[kHist ? j : 0][k];
          g[k] = s_gcnt[kHist ? j : 0][k];
        }
#pragma unroll
        for (int q = 0; q < kH; ++q) {
          if (q >= nv || !((ok >> q) & 1u)) continue;
          int cnt[MAXSUB];
#pragma unroll
          for (int k = 0; k < MAXSUB; ++k) cnt[k] = nibble_sum(H[q] & m[k]) + g[k];
          if (!verdict<MAXV, MAXSUB>(a, s, dyn, q, cnt, s_sub, p)) ok &= ~(1u << q);
        }
      } else if (any1) {
        for (int q = 0; q < nv; ++q) {
          if (!((ok >> q) & 1u)) continue;
          int cnt[MAXSUB];
#pragma unroll
          for (int k = 0; k < MAXSUB; ++k) cnt[k] = 0;
          for (int e = s_off[local + q]; e < s_off[local + q + 1]; ++e) {
            const int v = c.node_pv[e];
            count_pv<MAXSUB>(serves(s, c.pv_class[v], usable_cap(a, v)), s_sub, cnt);
          }
          for (int gi = 0; gi < c.G; ++gi) {
            const int v = c.global_pv[gi];
            count_pv<MAXSUB>(serves(s, c.pv_class[v], usable_cap(a, v)), s_sub, cnt);
          }
          if (!verdict<MAXV, MAXSUB>(a, s, dyn, q, cnt, s_sub, p)) ok &= ~(1u << q);
        }
      }
    }
    store_bits(a.out + (size_t)p * c.N + n0, ok, nv, vec);
  }
}

template <int MAXV, int MAXSUB>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t st) {
  const size_t smem = MAXSUB <= 4 ? (size_t)kStage * sizeof(unsigned long long) : 0;
  cudaError_t err = cudaFuncSetAttribute(volume_mask_kernel<MAXV, MAXSUB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  volume_mask_kernel<MAXV, MAXSUB><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int volume_mask_launch(
    uint8_t* out, int B, int N, int V, int Rq, int MVol, int G,
    const int* node_off, const int* node_pv, const int* global_pv,
    const int* pv_class, const float* pv_cap, const uint8_t* req,
    const int* vol_mode, const int* vol_req, const int* vol_class,
    const float* vol_size, const uint8_t* claimed, int unbound, int multi,
    const unsigned* sub_mask, int n_sub, const uint8_t* member, int vec, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (MVol > pv::kMaxVol || n_sub > pv::kMaxSub || (B + kPods - 1) / kPods > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.c = pv::Ctx{N, V, Rq, MVol, G, node_off, node_pv, global_pv, pv_class, pv_cap,
                req, vol_mode, vol_req, vol_class, vol_size};
  a.out = out; a.B = B; a.unbound = unbound; a.multi = multi; a.vec = vec;
  a.claimed = claimed; a.sub_mask = sub_mask; a.n_sub = n_sub; a.member = member;
  dim3 grid((N + kTile - 1) / kTile, (B + kPods - 1) / kPods);
  cudaStream_t st = (cudaStream_t)stream;
  // up to 2 slots: 2 singletons and 1 pair; else the widest instance
  if (MVol <= 2 && n_sub <= 4) return (int)launch<2, 4>(a, grid, st);
  return (int)launch<pv::kMaxVol, pv::kMaxSub>(a, grid, st);
}
