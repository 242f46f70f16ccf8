// dyn_round: the rounds engine's per-round dynamic feasibility (K14
// dyn_mask) and claim base (K15 dyn_score), one [B, N] pass each.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/framework/runtime.py:202 Framework.dyn_batched
// and :242 score_anchor, as k8s_scheduler_tpu/ops/rounds.py:577-581 uses
// them, with the batched hooks of NodeResourcesFit, NodePorts and
// NodeResourcesBalancedAllocation (k8s_scheduler_tpu/framework/plugins.py,
// k8s_scheduler_tpu/ops/resources.py):
//
//   K14  feasible[b, n] = vsbase[b, n] > NEG_INF / 2
//                         & [fit]   every r: req[b, r] <= (alloc[n, r] - nreq[n, r])
//                                              + fma(alloc[n, r], 1e-5, 1e-5)
//                         & [ports] no port id q >= 0 of pod b with claimed[n, q]
//                         & every bool plane (K3's affinity and spread masks,
//                           K10's volume mask, any other filter's)
//        mask[b, n]     = feasible[b, n] & act[b]
//   K15  base[b, n]     = vsbase[b, n] + the term program's weighted sum,
//        each term the fit score's sum (LeastAllocated / MostAllocated), the
//        balanced factor 1 - std (over one resource the folded constant
//        100 * w, a bare value: ROADMAP C7), or an f32 plane (the K3 norms), folded as
//        ops/dyn_round.py dyn_score_plain folds them (a held bare product,
//        the weight folded into a product's constant, an fma where the
//        constant is not 1; where BalancedAllocation's product meets a held
//        one, its multiply fuses and the held one is rounded) and added as
//        commit.add_static adds them (a lone bare product fuses into the
//        add). With no static row it is the score anchor: a lone product is
//        rounded once.
//
// K17 dyn_rejects, the first-rejector counts over the same parts, is
// csrc/dyn_rejects.cu.
//
// K14 writes both planes when the caller gives act (the round: the K3
// norms take `feasible`, as the reference's do, and the claim pass takes
// `mask`); without act it writes `mask` alone, which is then `feasible`.
//
// Bound on an H100: bytes. Round 0 of config #4 runs B = 16384 pod rows
// against N = 8192 nodes: K14 reads vsbase (4 B an element) and one byte a
// plane and writes one or two, K15 reads vsbase and 4 B a plane and writes
// 4; the pod rows and the [N, R] node tables are read once a tile.
//
// Design: node-stationary tiles, as K1 (static_base.cu). A block of 256
// threads owns 1024 consecutive nodes, 4 a thread (one 16-byte load or
// store a pod row of an f32 plane, 4 bytes of a bool plane), and walks
// groups of 32 pod rows (the groups over gridDim.y). Per tile the node
// side is staged once in shared memory, resource-major: K14 the room
// (allocatable - requested) + slack, K15 the allocatable and requested
// columns; per group the rows' requests, act flags and whether a row names
// a host port. A pod with no port skips the port test; a port test reads
// the [N, Q] bitmap through L2 (the pods that name ports are few). K15
// computes each node's used fractions once for both resource scores (one
// true division each, the resources a score reads; its loops over the
// resources unrolled to 4 where R <= 4, else 8), then folds the term
// program, whose shape (held product or not) is the same for every element
// and so lives in the program, not in registers. On an H100 80GB HBM3 at
// 700 W, config #4's round 0: the used fractions take about half of K15's
// time (without them 0.81 ms against 1.71 unrolled to 8, 1.19 to 4; the
// division and the sqrt alone 0.1 ms each). The launcher takes the
// vector path when N is a multiple of 4 and every plane pointer is aligned
// for its width; otherwise the same kernel runs with a guard per node.
//
// Bit-equality: the masks are bool ANDs, their order free. The arithmetic
// is the plain version's, op for op, under --fmad=false: the slack's fma
// (ops/resources.py _fma's f64 product plus one rounding, equal to
// __fmaf_rn short of an f64 tie), room's two separate roundings, the used
// fraction as a true division then the clamp to [0, 1], the fit sum's
// rounded `x * 100` adds when every weight is 1 and its fmas otherwise,
// the balanced mean as total * (f32 reciprocal of the count), the squares
// fused only when every resource takes part, sqrtf correctly rounded (the
// plain version's f64 sqrt rounded to f32 is the same value), 1 - std.
// Never --use_fast_math: the divisions and sqrtf must stay IEEE.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a --fmad=false ...

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kThreads = 256;
constexpr int kTile = kThreads * 4;  // nodes per block
constexpr int kPodGroup = 32;        // pod rows per group
constexpr int kMaxGridY = 128;
constexpr int kScoreGridY = 512;  // K15: 1.67 ms at 512 groups a column, 1.71 at 128
constexpr int kMaxR = 8;       // ops/dyn_round.py MAX_RESOURCES
constexpr int kMaxPlanes = 8;  // MAX_PLANES
constexpr int kMaxTerms = 8;   // MAX_TERMS

// flag bits and term codes (ops/dyn_round.py mirrors these)
constexpr int kMaskFit = 1, kMaskPorts = 2, kMaskAct = 4;
constexpr int kMost = 1, kFitOnes = 2, kBalAll = 4, kStatic = 8;
// kTermConst: BalancedAllocation over one resource, folded to 100 * w (c)
constexpr int kTermFit = 1, kTermBalanced = 2, kTermPlane = 3, kTermConst = 4;
constexpr int kBare = 0, kProduct = 1, kPreferred = 2;  // a term's form

struct MaskArgs {
  int B, N, R, MP, Q, flags, n_planes;
  const float* vsbase;    // [B, N]
  const uint8_t* act;     // [B] (kMaskAct)
  const float* req;       // [B, R] (kMaskFit)
  const float* alloc;     // [N, R] (kMaskFit)
  const float* nreq;      // [N, R] (kMaskFit)
  const int* ids;         // [B, MP] port ids, -1 pad (kMaskPorts)
  const uint8_t* claimed;  // [N, Q] (kMaskPorts)
  const uint8_t* planes[kMaxPlanes];  // [B, N] each
  uint8_t* mask;          // [B, N]
  uint8_t* feas;          // [B, N] (kMaskAct)
};

struct ScoreArgs {
  int B, N, R, n_terms, flags;
  const float* vsbase;  // [B, N] (kStatic)
  const float* req;     // [B, R]
  const float* alloc;   // [N, R]
  const float* nreq;    // [N, R]
  const float* planes[kMaxPlanes];  // [B, N] each
  int code[kMaxTerms], plane[kMaxTerms], prod[kMaxTerms];
  float c[kMaxTerms];
  float w100[kMaxR];  // the fit sum's constants (0: resource not scored)
  unsigned bal;       // the balanced factor's resources, one bit each
  unsigned used;      // the resources either score reads
  float rn;           // f32(1 / count of bal's resources)
  int fit, balanced;  // the program has such a term
  float* out;         // [B, N]
};

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// a thread's 4 consecutive values of a row at n0; kVec: one aligned load,
// else a guarded load a node; zero past N
template <bool kVec>
__device__ __forceinline__ void load4(const float* row, int n0, int N, float (&v)[4]) {
  if (kVec) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(row + n0));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = n0 + i < N ? __ldg(row + n0 + i) : 0.0f;
  }
}

template <bool kVec>
__device__ __forceinline__ void load4(const uint8_t* row, int n0, int N, bool (&v)[4]) {
  if (kVec) {
    const uchar4 x = __ldg(reinterpret_cast<const uchar4*>(row + n0));
    v[0] = x.x != 0; v[1] = x.y != 0; v[2] = x.z != 0; v[3] = x.w != 0;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = n0 + i < N && __ldg(row + n0 + i) != 0;
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(uint8_t* row, int n0, int N, const bool (&v)[4]) {
  if (kVec) {
    *reinterpret_cast<uchar4*>(row + n0) = make_uchar4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n0 + i < N) row[n0 + i] = v[i];
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* row, int n0, int N, const float (&v)[4]) {
  if (kVec) {
    __stcs(reinterpret_cast<float4*>(row + n0), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n0 + i < N) __stcs(row + n0 + i, v[i]);
  }
}

// the tile's room (allocatable - requested) + slack, resource-major, once
// for every pod row (kMaskFit)
__device__ __forceinline__ void stage_room(const MaskArgs& a, int tile0, float* room_s) {
  const int nodes = min(kTile, a.N - tile0);
  const size_t base = (size_t)tile0 * a.R;
  for (int k = threadIdx.x; k < nodes * a.R; k += kThreads) {
    const float al = a.alloc[base + k];
    room_s[(k % a.R) * kTile + k / a.R] = (al - a.nreq[base + k]) + __fmaf_rn(al, 1e-5f, 1e-5f);
  }
}

// a group's act flags, whether a row names a host port, and its requests
__device__ __forceinline__ void stage_group(const MaskArgs& a, int b0, int nb, float* req_s,
                                            uint8_t* act_s, uint8_t* port_s) {
  if (threadIdx.x < nb) {
    const int b = b0 + threadIdx.x;
    act_s[threadIdx.x] = (a.flags & kMaskAct) ? a.act[b] : 1;
    uint8_t any = 0;
    if (a.flags & kMaskPorts)
      for (int j = 0; j < a.MP; ++j) any |= a.ids[(size_t)b * a.MP + j] >= 0;
    port_s[threadIdx.x] = any;
  }
  if (a.flags & kMaskFit)
    for (int k = threadIdx.x; k < nb * a.R; k += kThreads)
      req_s[k] = a.req[(size_t)b0 * a.R + k];
}

// the parts' tests of row k of the group (pod row b) at the thread's 4
// nodes from n0, each ANDed into f
template <bool kVec>
__device__ __forceinline__ void and_plane(const uint8_t* plane, size_t row, int n0, int N,
                                          bool (&f)[4]) {
  bool m[4];
  load4<kVec>(plane + row, n0, N, m);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = f[i] && m[i];
}

__device__ __forceinline__ void and_fit(const MaskArgs& a, const float* req_s,
                                        const float* room_s, int k, bool (&f)[4]) {
  for (int r = 0; r < a.R; ++r) {
    const float need = req_s[k * a.R + r];
    const float4 room = reinterpret_cast<const float4*>(room_s + (size_t)r * kTile)[threadIdx.x];
    f[0] = f[0] && need <= room.x;
    f[1] = f[1] && need <= room.y;
    f[2] = f[2] && need <= room.z;
    f[3] = f[3] && need <= room.w;
  }
}

__device__ __forceinline__ void and_ports(const MaskArgs& a, int b, int n0, bool (&f)[4]) {
  for (int j = 0; j < a.MP; ++j) {
    const int q = __ldg(a.ids + (size_t)b * a.MP + j);
    if (q < 0) continue;  // a pad slot names no port
    const int qq = min(q, a.Q - 1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n0 + i < a.N && __ldg(a.claimed + (size_t)(n0 + i) * a.Q + qq)) f[i] = false;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) dyn_mask_kernel(MaskArgs a) {
  extern __shared__ float smem[];
  float* room_s = smem;                           // [R][kTile] (kMaskFit)
  float* req_s = room_s + (size_t)a.R * kTile;    // [kPodGroup][R] (kMaskFit)
  __shared__ uint8_t act_s[kPodGroup], port_s[kPodGroup];

  const int N = a.N, flags = a.flags;
  const int tile0 = blockIdx.x * kTile;
  const int n0 = tile0 + 4 * threadIdx.x;  // the thread's first node
  if (flags & kMaskFit) stage_room(a, tile0, room_s);
  const int groups = (a.B + kPodGroup - 1) / kPodGroup;
  for (int gi = blockIdx.y; gi < groups; gi += gridDim.y) {
    const int b0 = gi * kPodGroup;
    const int nb = min(kPodGroup, a.B - b0);
    __syncthreads();  // the previous group's staging is consumed (and the room staged)
    stage_group(a, b0, nb, req_s, act_s, port_s);
    __syncthreads();
    if (n0 >= N) continue;

    for (int k = 0; k < nb; ++k) {
      const int b = b0 + k;
      const size_t row = (size_t)b * N;
      float sb[4];
      load4<kVec>(a.vsbase + row, n0, N, sb);
      bool f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = sb[i] > kNegInf * 0.5f;
#pragma unroll
      for (int j = 0; j < kMaxPlanes; ++j) {
        if (j >= a.n_planes) break;
        and_plane<kVec>(a.planes[j], row, n0, N, f);
      }
      if (flags & kMaskFit) and_fit(a, req_s, room_s, k, f);
      if (port_s[k]) and_ports(a, b, n0, f);
      if (flags & kMaskAct) {
        store4<kVec>(a.feas + row, n0, N, f);
#pragma unroll
        for (int i = 0; i < 4; ++i) f[i] = f[i] && act_s[k];
      }
      store4<kVec>(a.mask + row, n0, N, f);
    }
  }
}

// the fit score's weighted sum of one node (its score is this times the
// program's constant): rounded `x * 100` adds when every weight is 1, else
// fmas with the weights' constants; the first term a plain product
template <int kR>
__device__ __forceinline__ float fit_sum(const ScoreArgs& a, const float (&frac)[kR]) {
  float acc = 0.0f;
  bool first = true;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= a.R || a.w100[r] == 0.0f) continue;  // a zero weight adds an exact 0
    const float x = (a.flags & kMost) ? frac[r] : 1.0f - frac[r];
    if (first) acc = x * a.w100[r];
    else acc = (a.flags & kFitOnes) ? acc + x * a.w100[r] : __fmaf_rn(x, a.w100[r], acc);
    first = false;
  }
  return acc;
}

// 1 - std of the used fractions of bal's resources
template <int kR>
__device__ __forceinline__ float balanced_factor(const ScoreArgs& a, const float (&frac)[kR]) {
  float tot = 0.0f;
#pragma unroll
  for (int r = 0; r < kR; ++r)
    if (r < a.R && ((a.bal >> r) & 1)) tot = tot + frac[r];
  const float mean = tot * a.rn;
  // the masked sum is not contracted; over every resource the mask folds
  // away and the squares fuse into the sum
  float var = 0.0f;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= a.R || !((a.bal >> r) & 1)) continue;
    const float d = frac[r] - mean;
    var = (a.flags & kBalAll) ? __fmaf_rn(d, d, var) : var + d * d;
  }
  return 1.0f - sqrtf(var * a.rn);
}

// kR: the resources the loops over them are unrolled to (4 or 8): the
// frac[kR] registers and the per-resource tests of an unroll to 8 held a
// config #4 round 0 (R = 4) at 1.71 ms against 1.19 unrolled to 4
template <bool kVec, int kR>
__global__ void __launch_bounds__(kThreads) dyn_score_kernel(ScoreArgs a) {
  extern __shared__ float smem[];
  // the node columns as [R][4][kThreads]: node 4 t + i of the tile at
  // [r][i][t], so that a warp's reads of one (r, i) hit 32 banks
  float* alloc_s = smem;                          // [R][4][kThreads]
  float* nreq_s = alloc_s + (size_t)a.R * kTile;  // [R][4][kThreads]
  float* req_s = nreq_s + (size_t)a.R * kTile;    // [kPodGroup][R]

  const int N = a.N, R = a.R;
  const int tile0 = blockIdx.x * kTile;
  const int n0 = tile0 + 4 * threadIdx.x;
  const bool res = a.fit || a.balanced;
  if (res) {  // the tile's node columns, once for every pod row
    const int nodes = min(kTile, N - tile0);
    const size_t base = (size_t)tile0 * R;
    for (int k = threadIdx.x; k < nodes * R; k += kThreads) {
      const int n = k / R;
      const int j = (k % R) * kTile + (n & 3) * kThreads + (n >> 2);
      alloc_s[j] = a.alloc[base + k];
      nreq_s[j] = a.nreq[base + k];
    }
  }
  const int groups = (a.B + kPodGroup - 1) / kPodGroup;
  for (int gi = blockIdx.y; gi < groups; gi += gridDim.y) {
    const int b0 = gi * kPodGroup;
    const int nb = min(kPodGroup, a.B - b0);
    __syncthreads();
    if (res)
      for (int k = threadIdx.x; k < nb * R; k += kThreads)
        req_s[k] = a.req[(size_t)b0 * R + k];
    __syncthreads();
    if (n0 >= N) continue;

    for (int k = 0; k < nb; ++k) {
      const size_t row = (size_t)(b0 + k) * N;
      float fx[4], bx[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fx[i] = bx[i] = 0.0f;
        if (!res) continue;
        // (node requested + request) / allocatable, 1 where allocatable is 0,
        // clamped to [0, 1]: each resource a score reads, once for both
        float frac[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          frac[r] = 0.0f;
          if (r >= R || !((a.used >> r) & 1)) continue;
          const int j = r * kTile + i * kThreads + threadIdx.x;
          const float al = alloc_s[j];
          const float after = nreq_s[j] + req_s[k * R + r];
          frac[r] = clamp01(al > 0.0f ? after / fmaxf(al, 1e-9f) : 1.0f);
        }
        if (a.fit) fx[i] = fit_sum<kR>(a, frac);
        if (a.balanced) bx[i] = balanced_factor<kR>(a, frac);
      }
      // the term program: each add fuses a multiply feeding it — the held
      // bare product's while there is one, else the new term's
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, hx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float hc = 0.0f;
      bool have = false, held = false;
#pragma unroll
      for (int t = 0; t < kMaxTerms; ++t) {
        if (t >= a.n_terms) break;
        float x[4];
        if (a.code[t] == kTermFit) {
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] = fx[i];
        } else if (a.code[t] == kTermBalanced) {
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] = bx[i];
        } else if (a.code[t] == kTermConst) {  // a bare value (prod is kBare)
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] = a.c[t];
        } else {
          load4<kVec>(a.planes[a.plane[t]] + row, n0, N, x);
        }
        const float c = a.c[t];
        const bool prod = a.prod[t] != kBare;
        if (!have) {
          have = true;
          if (prod) {
            held = true;
            hc = c;
#pragma unroll
            for (int i = 0; i < 4; ++i) hx[i] = x[i];
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i] = x[i];
          }
        } else if (held && a.prod[t] == kPreferred) {  // the new term's multiply fuses
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] = __fmaf_rn(x[i], c, hx[i] * hc);
          held = false;
        } else if (held) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] = __fmaf_rn(hx[i], hc, prod ? x[i] * c : x[i]);
          held = false;
        } else if (prod) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] = __fmaf_rn(x[i], c, acc[i]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] = acc[i] + x[i];
        }
      }
      float o[4];
      if (a.flags & kStatic) {
        float sb[4];
        load4<kVec>(a.vsbase + row, n0, N, sb);
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i] = held ? __fmaf_rn(hx[i], hc, sb[i]) : sb[i] + acc[i];
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i] = held ? hx[i] * hc : acc[i];
      }
      store4<kVec>(a.out + row, n0, N, o);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

dim3 grid_of(int B, int N, int max_y) {
  const int groups = (B + kPodGroup - 1) / kPodGroup;
  return dim3((N + kTile - 1) / kTile, groups < max_y ? groups : max_y);
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t stream, const void* args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  void* argv[] = {const_cast<void*>(args)};
  return cudaLaunchKernel((const void*)kernel, grid, dim3(kThreads), argv, smem, stream);
}

}  // namespace

extern "C" int dyn_mask_launch(int B, int N, int R, int MP, int Q, int flags,
                               const float* vsbase, const uint8_t* act, const float* req,
                               const float* alloc, const float* nreq, const int* ids,
                               const uint8_t* claimed, const void* const* planes,
                               int n_planes, uint8_t* mask, uint8_t* feas, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (R > kMaxR || n_planes > kMaxPlanes) return (int)cudaErrorInvalidValue;
  MaskArgs a;
  a.B = B; a.N = N; a.R = R; a.MP = MP; a.Q = Q; a.flags = flags; a.n_planes = n_planes;
  a.vsbase = vsbase; a.act = act; a.req = req; a.alloc = alloc; a.nreq = nreq;
  a.ids = ids; a.claimed = claimed; a.mask = mask; a.feas = feas;
  bool vec = N % 4 == 0 && aligned(vsbase, 16) && aligned(mask, 4) &&
             (!(flags & kMaskAct) || aligned(feas, 4));
  for (int j = 0; j < kMaxPlanes; ++j) {
    a.planes[j] = j < n_planes ? static_cast<const uint8_t*>(planes[j]) : nullptr;
    if (j < n_planes) vec = vec && aligned(planes[j], 4);
  }
  const size_t smem = (flags & kMaskFit) ? (size_t)R * (kTile + kPodGroup) * sizeof(float) : 0;
  const cudaError_t err =
      vec ? launch(dyn_mask_kernel<true>, grid_of(B, N, kMaxGridY), smem, (cudaStream_t)stream, &a)
          : launch(dyn_mask_kernel<false>, grid_of(B, N, kMaxGridY), smem, (cudaStream_t)stream,
                   &a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int dyn_score_launch(int B, int N, int R, int n_terms, int flags,
                                const float* vsbase, const float* req, const float* alloc,
                                const float* nreq, const void* const* planes,
                                const int* code, const int* plane, const float* c,
                                const int* prod, const float* w100, unsigned bal, float rn,
                                float* out, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (R > kMaxR || n_terms > kMaxTerms) return (int)cudaErrorInvalidValue;
  ScoreArgs a;
  a.B = B; a.N = N; a.R = R; a.n_terms = n_terms; a.flags = flags;
  a.vsbase = vsbase; a.req = req; a.alloc = alloc; a.nreq = nreq; a.out = out;
  a.bal = bal; a.rn = rn; a.fit = 0; a.balanced = 0;
  bool vec = N % 4 == 0 && aligned(out, 16) && (!(flags & kStatic) || aligned(vsbase, 16));
  for (int t = 0; t < kMaxTerms; ++t) {
    const bool on = t < n_terms;
    a.code[t] = on ? code[t] : 0;
    a.plane[t] = on ? plane[t] : 0;
    a.c[t] = on ? c[t] : 0.0f;
    a.prod[t] = on ? prod[t] : 0;
    if (on && code[t] == kTermFit) a.fit = 1;
    if (on && code[t] == kTermBalanced) a.balanced = 1;
    if (on && code[t] == kTermPlane) {
      if (plane[t] < 0 || plane[t] >= kMaxPlanes) return (int)cudaErrorInvalidValue;
      vec = vec && aligned(planes[plane[t]], 16);
    }
  }
  for (int j = 0; j < kMaxPlanes; ++j) a.planes[j] = static_cast<const float*>(planes[j]);
  a.used = 0;
  for (int r = 0; r < kMaxR; ++r) {
    a.w100[r] = r < R && a.fit ? w100[r] : 0.0f;
    if (r < R && (a.w100[r] != 0.0f || (a.balanced && ((bal >> r) & 1)))) a.used |= 1u << r;
  }
  if (!a.balanced) a.bal = 0;
  const size_t smem =
      (a.fit || a.balanced) ? (size_t)R * (2 * kTile + kPodGroup) * sizeof(float) : 0;
  const dim3 grid = grid_of(B, N, kScoreGridY);
  const cudaStream_t st = (cudaStream_t)stream;
  const bool r4 = R <= 4;
  const cudaError_t err =
      vec ? (r4 ? launch(dyn_score_kernel<true, 4>, grid, smem, st, &a)
                : launch(dyn_score_kernel<true, 8>, grid, smem, st, &a))
          : (r4 ? launch(dyn_score_kernel<false, 4>, grid, smem, st, &a)
                : launch(dyn_score_kernel<false, 8>, grid, smem, st, &a));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
