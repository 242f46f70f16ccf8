// dyn_rejects (K17): the dynamic filters' first-rejector counts of a window
// of pod rows, the rounds cycle's final window and the diagnosis program's.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/framework/runtime.py:223 attribute_rejects
// over :202 dyn_batched's per-filter masks, as
// k8s_scheduler_tpu/core/cycle.py:638-665 (the rounds cycle's final window)
// and :1488-1495 (the diagnosis program's windows) use it:
//
//   rejects[b, c] = the nodes n with start[b, n] whose first failing part,
//                   in column order, is the part of column c, for the rows
//                   b with rows[b] (every row without rows)
//
// the parts (ops/dyn_round.py, K14's): bool [B, N] planes (K3's affinity
// and spread masks, K10's volume mask), NodeResourcesFit
//   every r: req[b, r] <= (alloc[n, r] - nreq[n, r]) + fma(alloc[n, r], 1e-5, 1e-5)
// and NodePorts (no port id q >= 0 of pod b with claimed[n, q]).
//
// Bound on an H100: bytes, the start mask and each plane (a byte an
// element of the rows counted); the node tables and the pod rows are
// small. Where few rows count (the final window), the launch, the room's
// staging and a row's load latency are the time.
//
// Design: node-stationary tiles of 4096 nodes, 16 a thread: each row of the
// start mask and of each plane is one 16-byte streaming load a thread
// (__ldcs: read once), turned into a 16-bit mask; the fit test compares the
// row's R requests with the room of the thread's 16 nodes, staged once a
// block in shared memory (resource-major, each thread's 4 float4 of a
// resource side by side: no bank conflict) while the row's loads are in
// flight, and the predicates become the same 16 bits; the port test runs
// for a row with ports only. The chain
// walks the parts in column order: fail = rem & ~ok, count[rank] +=
// __popc(fail), rem &= ok. A warp sums each rank's count of its 512 nodes
// with one __reduce_add_sync and adds it into the row's entry in shared
// memory; each block adds a row's nonzero counts to the output with one
// integer atomic a (row, column). Blocks walk groups of 8 rows (the grid
// sized to about two blocks an SM, so that the room is staged few times);
// a block stages its room at its first group that counts a row, and skips
// groups that count none (the final window counts its unplaced pods
// alone: 256 of 2048 rows at config #4).
// The vector path needs N a multiple of 16 and every plane 16-byte
// aligned; else the same kernel loads a byte at a time with a guard.
//
// Bit-equality: the masks are bool ANDs, their order free; the counts are
// integer sums, exact in any order; the room is K14's (csrc/dyn_round.cu)
// op for op under --fmad=false: the difference and the slack's fma
// rounded separately, then their sum.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a --fmad=false ...

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNodes = 16;  // a thread's nodes: one 16-byte load a row and array
constexpr int kTile = kThreads * kNodes;
constexpr int kRows = 8;  // pod rows a group
constexpr int kTargetBlocks = 264;  // about two blocks an SM of an H100
constexpr int kMaxGridY = 65535;
constexpr int kMaxR = 8;       // ops/dyn_round.py MAX_RESOURCES
constexpr int kMaxPlanes = 8;  // MAX_PLANES
constexpr int kMaxParts = kMaxPlanes + 2;
constexpr int kMaxF = 32;  // ops/dyn_round.py MAX_FILTERS
constexpr int kFit = kMaxPlanes, kPort = kMaxPlanes + 1;  // part kinds past the planes

struct Args {
  int B, N, R, MP, Q, F, n_parts;
  const uint8_t* start;  // [B, N]
  const uint8_t* rows;   // [B] (null: every row)
  const float* req;      // [B, R] (a fit part)
  const float* alloc;    // [N, R]
  const float* nreq;     // [N, R]
  const int* ids;        // [B, MP] port ids, -1 pad (a port part)
  const uint8_t* claimed;  // [N, Q]
  int kind[kMaxParts];     // each rank's part: plane j (0..7), kFit or kPort
  const uint8_t* plane[kMaxParts];  // [B, N] a plane rank's plane
  int col[kMaxParts];      // each rank's column
  int* out;                // [B, F], zeroed by the caller
};

// 4 bytes, each zero or not, as 4 bits (byte i at bit i)
__device__ __forceinline__ unsigned bits4(unsigned x) {
  x = (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;  // 0x80 where nonzero
  return ((x >> 7) * 0x10204080u) >> 28;
}

__device__ __forceinline__ unsigned bits16(uint4 v) {
  return bits4(v.x) | bits4(v.y) << 4 | bits4(v.z) << 8 | bits4(v.w) << 12;
}

// the scalar path: a row's 16 bytes from node n0 as 16 bits, a guarded
// byte at a time; zero past N
__device__ __forceinline__ unsigned load16(const uint8_t* row, int n0, int N) {
  unsigned m = 0;
  for (int i = 0; i < kNodes && n0 + i < N; ++i) m |= (unsigned)(row[n0 + i] != 0) << i;
  return m;
}

// the tile's room, resource-major: resource r's float4 j of thread t (its
// nodes 4j..4j+3) at room4[(r * 4 + j) * kThreads + t]; read coalesced,
// eight loads in flight, (node, resource) stepped without a division
__device__ __forceinline__ void stage_room(const Args& a, int tile0, float* room_s) {
  const int R = a.R, total = min(kTile, a.N - tile0) * R;
  if (R == 0) return;
  const float* al = a.alloc + (size_t)tile0 * R;
  const float* nr = a.nreq + (size_t)tile0 * R;
  const int di = kThreads / R, dr = kThreads % R;
  int i = threadIdx.x / R, r = threadIdx.x % R;  // element k = i * R + r
#pragma unroll 8
  for (int k = threadIdx.x; k < total; k += kThreads) {
    const float x = __ldg(al + k);
    room_s[((r * 4 + (i % kNodes) / 4) * kThreads + i / kNodes) * 4 + i % 4] =
        (x - __ldg(nr + k)) + __fmaf_rn(x, 1e-5f, 1e-5f);
    i += di;
    r += dr;
    if (r >= R) r -= R, ++i;
  }
}

// NodeResourcesFit at the thread's 16 nodes: need [R] the row's requests
__device__ __forceinline__ unsigned fit16(const float4* room4, const float* need, int R) {
  float q[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) q[r] = r < R ? need[r] : 0.0f;
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bool f0 = true, f1 = true, f2 = true, f3 = true;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r >= R) break;
      const float4 v = room4[(r * 4 + j) * kThreads + threadIdx.x];
      f0 = f0 && q[r] <= v.x;
      f1 = f1 && q[r] <= v.y;
      f2 = f2 && q[r] <= v.z;
      f3 = f3 && q[r] <= v.w;
    }
    m |= ((unsigned)f0 | (unsigned)f1 << 1 | (unsigned)f2 << 2 | (unsigned)f3 << 3) << (4 * j);
  }
  return m;
}

// NodePorts at the thread's 16 nodes from n0 (a row that names a port)
__device__ __forceinline__ unsigned port16(const Args& a, int b, int n0) {
  unsigned m = 0xffffu;
  for (int s = 0; s < a.MP; ++s) {
    const int q = __ldg(a.ids + (size_t)b * a.MP + s);
    if (q < 0) continue;  // a pad slot names no port
    const int qq = min(q, a.Q - 1);
    for (int i = 0; i < kNodes && n0 + i < a.N; ++i)
      if (__ldg(a.claimed + (size_t)(n0 + i) * a.Q + qq)) m &= ~(1u << i);
  }
  return m;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2) dyn_rejects_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* room_s = reinterpret_cast<float*>(smem4);  // [R][4][kThreads] float4 (a fit part)
  __shared__ float req_s[kRows][kMaxR];
  __shared__ uint8_t act_s[kRows], port_s[kRows];
  __shared__ int cnt_s[kRows][kMaxParts];

  const int N = a.N, n_parts = a.n_parts;
  const bool fit = a.req != nullptr, ports = a.ids != nullptr;
  const int tile0 = blockIdx.x * kTile;
  const int n0 = tile0 + kNodes * threadIdx.x;
  const bool on = n0 < N;  // threads past N take part in the warp sums with no node
  const int lane = threadIdx.x & 31;
  bool staged = !fit;  // the room, staged at the first group that counts a row
  const int groups = (a.B + kRows - 1) / kRows;
  for (int gi = blockIdx.y; gi < groups; gi += gridDim.y) {
    const int b0 = gi * kRows;
    const int nb = min(kRows, a.B - b0);
    __syncthreads();  // the previous group's counts are out
    if (threadIdx.x < nb) {
      const int b = b0 + threadIdx.x;
      act_s[threadIdx.x] = a.rows ? a.rows[b] : 1;
      uint8_t any = 0;
      if (ports)
        for (int s = 0; s < a.MP; ++s) any |= a.ids[(size_t)b * a.MP + s] >= 0;
      port_s[threadIdx.x] = any;
    }
    if (fit)
      for (int k = threadIdx.x; k < nb * a.R; k += kThreads)
        req_s[k / a.R][k % a.R] = a.req[(size_t)b0 * a.R + k];
    for (int k = threadIdx.x; k < kRows * kMaxParts; k += kThreads)
      cnt_s[k / kMaxParts][k % kMaxParts] = 0;
    const bool counts = __syncthreads_or(threadIdx.x < nb && act_s[threadIdx.x]);
    if (!counts) continue;  // (uniform) no row of the group counts
    if (!staged) {
      stage_room(a, tile0, room_s);
      staged = true;
      __syncthreads();
    }

    for (int k = 0; k < nb; ++k) {
      if (!act_s[k]) continue;  // a row that counts nothing (uniform)
      const size_t row = (size_t)(b0 + k) * N;
      unsigned st = 0, pl[kMaxParts];
#pragma unroll
      for (int r = 0; r < kMaxParts; ++r) pl[r] = 0u;
      // every load of the row in flight together, the fit test while they
      // are, then the bits
      uint4 raw[kMaxParts + 1];
      if (on && kVec) {
        raw[0] = __ldcs(reinterpret_cast<const uint4*>(a.start + row + n0));
#pragma unroll
        for (int r = 0; r < kMaxParts; ++r)
          if (r < n_parts && a.kind[r] < kMaxPlanes)
            raw[r + 1] = __ldcs(reinterpret_cast<const uint4*>(a.plane[r] + row + n0));
      }
      const unsigned fm =
          fit && on ? fit16(reinterpret_cast<const float4*>(room_s), req_s[k], a.R) : ~0u;
      if (on && kVec) {
        st = bits16(raw[0]);
#pragma unroll
        for (int r = 0; r < kMaxParts; ++r)
          if (r < n_parts && a.kind[r] < kMaxPlanes) pl[r] = bits16(raw[r + 1]);
      } else if (on) {
        st = load16(a.start + row, n0, N);
#pragma unroll
        for (int r = 0; r < kMaxParts; ++r)
          if (r < n_parts && a.kind[r] < kMaxPlanes) pl[r] = load16(a.plane[r] + row, n0, N);
      }
      const unsigned pm = port_s[k] && on ? port16(a, b0 + k, n0) : ~0u;
      // the chain, in column order
      unsigned rem = st;
      int cnt[kMaxParts];
#pragma unroll
      for (int r = 0; r < kMaxParts; ++r) {
        if (r >= n_parts) break;
        const int kind = a.kind[r];
        const unsigned o = kind == kFit ? fm : (kind == kPort ? pm : pl[r]);
        cnt[r] = __popc(rem & ~o);
        rem &= o;
      }
#pragma unroll
      for (int r = 0; r < kMaxParts; ++r) {
        if (r >= n_parts) break;
        const int n = __reduce_add_sync(0xffffffffu, cnt[r]);
        if (lane == 0 && n > 0) atomicAdd(&cnt_s[k][r], n);
      }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < nb * n_parts; k += kThreads) {
      const int v = cnt_s[k / n_parts][k % n_parts];
      if (v > 0) atomicAdd(a.out + (size_t)(b0 + k / n_parts) * a.F + a.col[k % n_parts], v);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// the C interface of the earlier K17 (csrc/dyn_round.cu): the planes and their
// columns, the fit part's operands (req null: none), the port part's (ids
// null or Q = 0: none) and their columns, the start mask, `rows` [B] or
// null, `out` [B, F] zeroed
extern "C" int dyn_rejects_launch(int B, int N, int R, int MP, int Q, const float* req,
                                  const float* alloc, const float* nreq, const int* ids,
                                  const uint8_t* claimed, const void* const* planes,
                                  int n_planes, const int* plane_col, int fit_col,
                                  const uint8_t* start, int port_col, int F,
                                  const uint8_t* rows, int* out, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (R > kMaxR || n_planes < 0 || n_planes > kMaxPlanes || F < 1 || F > kMaxF)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.B = B; a.N = N; a.R = req ? R : 0; a.MP = MP; a.Q = Q; a.F = F;
  a.start = start; a.rows = rows; a.out = out;
  a.req = req; a.alloc = alloc; a.nreq = nreq;
  a.ids = ids && Q > 0 ? ids : nullptr; a.claimed = claimed;
  // the parts, sorted by column: the chain's ranks
  int kind[kMaxParts], col[kMaxParts], n = 0;
  unsigned taken = 0;  // the columns named so far
  for (int j = 0; j < n_planes; ++j) kind[n] = j, col[n++] = plane_col[j];
  if (a.req) kind[n] = kFit, col[n++] = fit_col;
  if (a.ids) kind[n] = kPort, col[n++] = port_col;
  a.n_parts = n;
  for (int i = 0; i < n; ++i) {
    if (col[i] < 0 || col[i] >= F || (taken >> col[i]) & 1u) return (int)cudaErrorInvalidValue;
    taken |= 1u << col[i];
    int k = i;
    for (; k > 0 && a.col[k - 1] > col[i]; --k) a.kind[k] = a.kind[k - 1], a.col[k] = a.col[k - 1];
    a.kind[k] = kind[i];
    a.col[k] = col[i];
  }
  bool vec = N % 16 == 0 && aligned(start, 16);
  for (int r = 0; r < kMaxParts; ++r) {
    const bool is_plane = r < n && a.kind[r] < kMaxPlanes;
    a.plane[r] = is_plane ? static_cast<const uint8_t*>(planes[a.kind[r]]) : nullptr;
    if (is_plane) vec = vec && aligned(a.plane[r], 16);
    if (r >= n) a.kind[r] = -1, a.col[r] = 0;
  }
  const int tiles = (N + kTile - 1) / kTile;
  const int groups = (B + kRows - 1) / kRows;
  int gy = (kTargetBlocks + tiles - 1) / tiles;
  gy = gy < groups ? gy : groups;
  gy = gy < kMaxGridY ? gy : kMaxGridY;
  const dim3 grid(tiles, gy);
  const size_t smem = (size_t)a.R * kTile * sizeof(float);
  const cudaStream_t st = (cudaStream_t)stream;
  const void* kernel = vec ? (const void*)dyn_rejects_kernel<true>
                           : (const void*)dyn_rejects_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  void* argv[] = {&a};
  const cudaError_t err = cudaLaunchKernel(kernel, grid, dim3(kThreads), argv, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
