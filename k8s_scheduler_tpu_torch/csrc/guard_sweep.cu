// guard_sweep: the round-end participant-table sweep of the rounds engine,
// after the (group, rank) sort.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/ops/rounds.py:342-514 guards_ok with
// _seg_scan_tables (:178) — stacked int prefix counts of the role columns
// per group, the per-role tests, and the per-pod AND (.at[pods].min).
//
// The table holds L = slots * B entries; entry e of the slot-major table is
// claimant e % B in emit slot e / B, whose role is role_tab[e / B]. It is
// sorted on key * 2^rank_bits + rank (`s_packed`, permutation `perm`). A
// group is a run of equal keys; a pod's run is a run of equal `s_packed`
// within it (the ranks are a permutation of the claimants, so equal packed
// keys are one pod's, and the sort's tie order never matters). For every
// entry the test needs, per role, the count of that role's entries in the
// group strictly before the entry's pod run. Of the seven counts only the
// arrivals (MATCH or SPREAD, against a spread cap) need their value; the
// six others are tested against zero, so an OR of the role bits carries
// them. Entries keyed GK_INVALID are padding; the rounds engine's padding
// key is the largest, so the padding sorts last.
//
// Bound on an H100: bytes — the valid prefix of the sorted keys and of the
// permutation, read once, and the ok bytes; at config #4 the prefix is
// under 5% of the table, so no pass over all L keys (a list of group
// starts, say) is affordable. What a call costs is the chain of dependent
// steps of one CTA, and how many entries one SM works through.
//
// Design: a fill kernel sets ok to 1 (a memset node in its place was 1.5-2
// us slower on the H100 on the calls of a later round: the sweep's byte
// stores then waited), then the sweep. CTA t owns the tile of kTile
// entries [t * kTile, (t + 1) * kTile) and every group whose first entry
// lies in it:
//   - it reads the tile's first and last keys and the key before it, and
//     leaves at once when no group starts in the tile (a tile inside the
//     padding, or inside a group that started earlier), so the CTAs past
//     the valid prefix read two or three keys each;
//   - tiles are small (256 entries, 128 threads) so that the valid prefix
//     spreads over many SMs: with 1024-entry tiles the sweep's per-entry
//     work on 17 SMs set the time of the round-0 call;
//   - it sweeps its tile in chunks of kChunk entries, kPer a thread: the
//     first chunk is the tile and a look-ahead of 128 entries, so a group
//     that crosses the tile's end by fewer ends within it (without a
//     look-ahead, most working CTAs at config #4 swept a second chunk for
//     a few entries, a second chain of dependent steps); a longer group is
//     followed chunk by chunk to its end by the one CTA where it starts,
//     with its prefix carried in registers, so no count ever crosses CTAs;
//   - a chunk's keys and permutation are read in one round of loads, its
//     roles (a table of a few words, cached) and the caps of its spread
//     entries in a second;
//   - per chunk, a block-wide segmented scan (restarting at every group
//     start: per thread, then shuffles within the warp, then over the
//     warps' totals in shared memory) gives each entry its group's OR of
//     role bits and its arrivals strictly before it; a pod run's head is
//     found by s_packed equality, walking back over the chunk's keys in
//     shared memory (a run holds at most one pod's entries, one a slot),
//     or is carried when the run began in the previous chunk;
//   - a failed test clears ok[pod], a plain byte store (the AND); the
//     fill kernel before the sweep, not a CTA of it, sets the ones, so no
//     clear can be overwritten.
// Index arithmetic is 32-bit (L < 2^31): one u32 division an entry gives
// its slot and pod.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;  // ops/guard_sweep.py TILE
// a chunk is the tile and a look-ahead of kChunk - kTile entries into the
// next: a group that crosses the tile's end by fewer entries ends within
// the first chunk
constexpr int kPer = 3;
constexpr int kChunk = kThreads * kPer;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kNone = -0x7fffffffffffffffLL - 1;  // no entry

// role bits (ops/guard_sweep.py RB_*)
constexpr int kMatch = 1, kAnti = 2, kBoot = 4, kGmatch = 8, kSpread = 16,
              kPort = 32, kPv = 64;

struct Args {
  int L, B, rank_bits, slots;
  long long gk_invalid;
  const long long* s_packed;  // [L] sorted
  const long long* perm;      // [L] into the slot-major table
  const int* role_tab;        // [slots]
  const int* caps;            // [L] in table order, or null
  uint8_t* ok;                // [B], set to 1 before the kernel
};

// a scan element: whether a group starts within it, and the OR of the
// role bits and the arrivals since that start (or since its beginning)
struct Seg {
  unsigned f, bits, arr;
};

__device__ __forceinline__ Seg op(const Seg& a, const Seg& b) {
  return b.f ? b : Seg{a.f, a.bits | b.bits, a.arr + b.arr};
}

__device__ __forceinline__ Seg shfl_up(const Seg& s, int d) {
  return Seg{__shfl_up_sync(kFull, s.f, d), __shfl_up_sync(kFull, s.bits, d),
             __shfl_up_sync(kFull, s.arr, d)};
}

// the role's bit in the six columns tested against zero, and whether it
// counts as an arrival
__device__ __forceinline__ unsigned col_bits(int role) {
  return (role == kMatch || role == kAnti || role == kBoot || role == kGmatch ||
          role == kPort || role == kPv) ? (unsigned)role : 0u;
}

__device__ __forceinline__ bool passes(int role, unsigned bits, unsigned arr,
                                       bool capped, int cap) {
  switch (role) {
    case kAnti: return !(bits & kMatch);
    case kMatch: return !(bits & kAnti);
    case kBoot: return !(bits & (kBoot | kGmatch));
    case kSpread: return !capped || (long long)arr < (long long)cap;
    case kPort: return !(bits & kPort);
    case kPv: return !(bits & kPv);
  }
  return true;
}

__global__ void __launch_bounds__(kThreads) guard_kernel(Args g) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * kTile;
  const int t1 = min(g.L, t0 + kTile);
  const int rb = g.rank_bits;
  const long long inv = g.gk_invalid;
  const long long k_first = g.s_packed[t0] >> rb;
  const long long k_last = g.s_packed[t1 - 1] >> rb;
  const bool has_prev = t0 > 0;
  const long long k_prev = has_prev ? g.s_packed[t0 - 1] >> rb : 0;
  // no group starts here: the padding, or a group that started earlier
  if ((k_first == inv && k_last == inv) || (has_prev && k_last == k_prev)) return;

  __shared__ long long sp_s[kChunk];
  __shared__ unsigned xb_s[kChunk], xa_s[kChunk];
  __shared__ Seg wagg[kWarps];
  __shared__ Seg carry_s;
  __shared__ unsigned head_s[2];
  __shared__ int more_s;
  Seg carry{0, 0, 0};  // the open group's inclusive prefix at the chunk start
  unsigned hb = 0, ha = 0;  // the head prefix of the run open at the chunk start
  for (int p = t0;; p += kChunk) {
    const int i0 = p + tid * kPer;
    // the keys and the permutation in one round of loads
    const long long before = p > 0 ? g.s_packed[p - 1] : kNone;
    long long prev = i0 > 0 && i0 - 1 < g.L ? g.s_packed[i0 - 1] : kNone;
    long long sp[kPer];
    int e[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const bool in = i0 + q < g.L;
      sp[q] = in ? g.s_packed[i0 + q] : kNone;
      e[q] = in ? (int)g.perm[i0 + q] : 0;
    }
    bool mine[kPer], gs[kPer];
    unsigned bits[kPer], arr[kPer];
    int pod[kPer], role[kPer], cap[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = i0 + q;
      const long long key = sp[q] >> rb;
      mine[q] = i < g.L && key != inv && (!has_prev || key != k_prev) &&
                (i < t1 || key == k_last);
      gs[q] = i >= g.L || prev == kNone || key != (prev >> rb);
      prev = sp[q];
      const unsigned slot = (unsigned)e[q] / (unsigned)g.B;
      pod[q] = e[q] - (int)(slot * (unsigned)g.B);
      role[q] = mine[q] ? g.role_tab[slot] : 0;
      cap[q] = role[q] == kSpread && g.caps != nullptr ? g.caps[e[q]] : 0;
      bits[q] = col_bits(role[q]);
      arr[q] = role[q] == kMatch || role[q] == kSpread;
    }
    // ---- the group scan ----
    Seg agg{0, 0, 0};
#pragma unroll
    for (int q = 0; q < kPer; ++q) agg = op(agg, Seg{gs[q], bits[q], arr[q]});
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Seg o = shfl_up(agg, d);
      if (lane >= d) agg = op(o, agg);
    }
    Seg excl = shfl_up(agg, 1);
    if (lane == 0) excl = Seg{0, 0, 0};
    if (lane == 31) wagg[warp] = agg;
    __syncthreads();
    Seg run = carry;
    for (int w = 0; w < warp; ++w) run = op(run, wagg[w]);
    run = op(run, excl);
    const int base = tid * kPer;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      sp_s[base + q] = sp[q];
      xb_s[base + q] = gs[q] ? 0u : run.bits;
      xa_s[base + q] = gs[q] ? 0u : run.arr;
      run = op(run, Seg{gs[q], bits[q], arr[q]});
    }
    __syncthreads();
    // ---- each entry's pod run head, and its test ----
    unsigned last_hb = 0, last_ha = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (!mine[q]) continue;
      int j = base + q;
      while (j > 0 && sp_s[j - 1] == sp[q]) --j;
      const bool carried = j == 0 && sp[q] == before;
      const unsigned b = carried ? hb : xb_s[j], a = carried ? ha : xa_s[j];
      if (!passes(role[q], b, a, g.caps != nullptr, cap[q])) g.ok[pod[q]] = 0;
      last_hb = b;
      last_ha = a;
    }
    if (tid == kThreads - 1) {
      carry_s = run;
      head_s[0] = last_hb;
      head_s[1] = last_ha;
      more_s = mine[kPer - 1] && p + kChunk < g.L;
    }
    __syncthreads();
    if (!more_s) return;
    carry = carry_s;
    hb = head_s[0];
    ha = head_s[1];
    __syncthreads();  // the chunk's shared memory is rewritten
  }
}

// ok = 1: 16 bytes a thread where ok is 16-byte aligned
__global__ void fill_ones(uint8_t* ok, int B) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) * 16;
  if (i + 16 <= B && (reinterpret_cast<uintptr_t>(ok) & 15) == 0) {
    *reinterpret_cast<uint4*>(ok + i) =
        make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
  } else {
    for (int k = i; k < B && k < i + 16; ++k) ok[k] = 1;
  }
}

}  // namespace

// the entries a CTA owns (ops/guard_sweep.py TILE)
extern "C" int guard_sweep_tile() { return kTile; }

extern "C" int guard_sweep_launch(int L, int B, int rank_bits, int slots, long long gk_invalid,
                                  const long long* s_packed, const long long* perm,
                                  const int* role_tab, const int* caps, uint8_t* ok,
                                  void* stream) {
  if (B <= 0) return 0;
  if (L < 0 || slots < 0 || (long long)slots * B != L || rank_bits < 0 || rank_bits > 62)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  fill_ones<<<(B + 16 * 256 - 1) / (16 * 256), 256, 0, st>>>(ok, B);
  if (L > 0) {
    Args a{L, B, rank_bits, slots, gk_invalid, s_packed, perm, role_tab, caps, ok};
    guard_kernel<<<(unsigned)((L + kTile - 1) / kTile), kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
