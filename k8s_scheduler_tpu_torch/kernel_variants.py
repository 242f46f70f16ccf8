"""Where the port's kernels spend their time on the card: device times of
the small kernels on the main path, and timed variants of K13
`scan_commit`, K9 `preempt_claim`, K4 `affinity_update`, K6 `guard_sweep`,
K12 `pv_fold`, K11 `pv_choice`, K8 `preempt_whatif`, K7 `preempt_prefilter`,
K15 `dyn_score`, K5 `capacity`, K1 `static_base`, K16 `static_rejects` and
K17 `dyn_rejects`, built from edited copies of their sources, on full-size
inputs recorded from the main path.

    python3 -m k8s_scheduler_tpu_torch.kernel_variants [--csrc DIR] [--out PATH]
        [--kernels scan_commit,small,preempt_claim,affinity_update,guard_sweep,pv_fold,
                   pv_choice,preempt_whatif,preempt_prefilter,dyn_score,capacity,
                   static_base,rejects]

`--csrc` names the directory whose `scan_commit.cu`, `preempt_claim.cu`,
`affinity_update.cu`, `guard_sweep.cu`, `pv_fold.cu`, `pv_choice.cu`,
`preempt_whatif.cu`, `preempt_prefilter.cu`, `dyn_round.cu`, `capacity.cu`,
`static_base.cu`, `static_rejects.cu` and `dyn_rejects.cu` are varied
(default: the package's own `csrc/`; an
earlier checkout's `csrc/` times that design on the same inputs, K13, K4,
K6 and K12 through their earlier C interfaces where they differ,
`prev_scan_commit`, `prev_affinity_update`, `prev_guard_sweep` and
`prev_pv_fold`). `--kernels`
picks sections (default all). Each variant is a list of text edits; a
variant whose anchors are not in the source is reported as not
applicable. The variants that skip work compute wrong results on
purpose: they are timed, never compared. The edited copies are built
into `_build/variants/`.

Inputs, BASELINE config #4's cluster size (5000 nodes, 12000 running,
10000 pending; P=16384, N=8192), as `chip_smoke.py` makes them:
  K13    the scan cycle's packed inputs of config #4's workload (seed 202,
         10000 steps): the kernel, its floor (the barriers, the record
         exchange and the argmax without the node work), the counts
         committed by read-modify-write, the portable 8 CTAs (the
         wrapper's `cluster=8`), and a copy that sums clock64() per phase
         of a step in every thread and prints each CTA's slowest thread
         per phase;
         kernel time by torch.profiler (the wrapper reads device values,
         so no CUDA graph), ms and us a step;
  K15    the recorded calls of the rounds cycle (round 0, the later
         rounds' mean, the score anchors' mean): the kernel, the first
         design's unroll of the resource loops to 8, 128 pod groups a
         column of blocks, at most 40 registers, and without the division,
         the sqrt or the used fractions at all (the loads, the term fold and
         the stores);
  small  every call of K4, K5, K6 `guard_sweep`, K14 `dyn_mask` and K15
         `dyn_score` (one rounds cycle of config #4's workload, seed 202;
         K15's first call is round 0's, most of its calls are score
         anchors of one node row), K7-K9 (the preemption pass after it),
         K11 `pv_choice` and K12 `pv_fold` (one rounds cycle of the same
         workload with local and zonal volumes, seed 201; K9 also in the
         pass after it): the first call by CUDA events around eager calls
         and as device time, and the device time's mean over the calls;
  K9     the two recorded passes: the kernel, its floor (the cluster
         barrier and the exchange of records without the node work), 8
         CTAs against 16 (the portable cluster, also held against the
         plain version), the victim tables from L2 against shared memory;
  K4     the recorded calls (round 0 and the mean): the kernel, the domain
         pass alone, without the match scan, the copy alone;
  K6     the recorded calls of the rounds cycle (round 0 and the mean): the
         kernel, the read of the valid prefix alone (keys, permutation,
         roles and caps, no scan), the fill with an empty launch, the fill
         alone, a memset in place of the fill, chunks of the tile without
         the look-ahead, the first design's 1024-entry tiles on 256
         threads, 256 and 64 threads a 256-entry tile, the role table
         staged in shared memory;
  K12    the recorded calls of the volume cycle (round 0 and the mean) and
         a contended batch beside round 0 (`contended_fold_args`: every
         pod with an unbound slot accepted at a seeded node, several
         passes): the kernel, its floor (the launch, the compaction, the
         barriers and the loop condition without `choose`), 8 CTAs (the
         portable cluster), the launch alone, the launch with the copy,
         the compaction and the first barrier, contiguous row slices
         instead of blocks of rows dealt round-robin, one row a thread a
         round of loads, 512 and 128 threads a CTA;
  K11    the recorded calls of the volume cycle (round 0 and the mean): the
         kernel, its latency floor (the launch, the gate and one dependent
         chain node_of -> node_off -> the first list entry -> its claimed
         flag, no choice), 128 and 256 threads a CTA;
  K8     the recorded call of the preemption pass after config #4's cycle,
         slice 1's (no affinity tables, `slice1_whatif_call`) and the first
         widened to 72 pods a node (`wide_whatif`): the kernel, its floor
         (the launch, one read of the node tables and the verdicts
         written, no term), without the me gathers, without the symmetric
         walk, without the ports, byte stores from each thread instead of
         the staged 16-byte span, 64 and 256 nodes and 1, 2 and 8
         candidates a CTA;
  K7     the recorded call of the preemption pass after config #4's cycle
         and slice 1's (`slice1_prefilter_call`): the kernel, its floor
         (the launch, the staged node tables and the gate read, no fit
         walk), the node tables read from L2 instead of staged, the staged
         rows without their padding (bank conflicts), 64 and 256 nodes and
         16 candidates a CTA, every gated node walked from L2 (no
         monotone test), one 16-byte load of the prefix table in flight
         while staging, elig
         counted for every candidate;
  K5     every `capacity` call of one rounds cycle of config #4's workload
         (seed 202): the round-0 pass, a late pass and the round-0
         revocation fold are timed alone, the mean over all recorded calls
         too;
  K1     slice 1's inputs (config #2's pending mix, seed 101; fit and node
         sampling) and the volume phase's (config #4 with local and zonal
         PVs, seed 201; VolumeBinding's mask operand), beside
         `torch.empty(P, N).fill_(-1e9)`, the write floor;
  K16    the full rounds cycle's call of config #4's workload (seed 202,
         every pod row), its first 2048 rows with the survivors plane (a
         diagnosis window's shape), and the same cycle with local and zonal
         volumes (seed 201, the mask operand): the kernel, its floor
         (every launch, the marks, the packing and the valid words, the
         chain and the warp sums and stores, no test), the count launch
         alone (no marks, no packing), a lane's words one at a time (no
         chunk of four), 4 and 16 warps (pod rows) a block;
  K17    the same cycles' final-window calls: the kernel, its floor (the
         launch, the room staged, the warp sums and the flush, no load or
         test), the loads and the chain without the fit test, no room
         staged, one and four blocks an SM, groups of 32 rows, 128 threads
         a block.

Device times come from calls captured in a CUDA graph and replayed between
CUDA events (`device_ms`: a small kernel's wrapper takes longer on the host
than the kernel on the card, so events around eager calls measure the
host); K13's from torch.profiler (`kernel_ms`). K1 times are CUDA events
around eager calls, the variants in turn, the best of three turns. With
the package's own sources, the kernels are first held against their plain
versions on every input, `utils/kernel_cases.py`'s edge cases included
(K13 also at full size, about 60-80 s of plain scan, unless
`--no-full-plain`, and the variants that compute the same function
too). Prints one line per variant with its ms and
the card's name and power limit, and writes the table as JSON to `--out`
(default `_build/kernel_variants.json` in the package). Needs a CUDA
device."""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

N_NODES, N_EXISTING, N_PENDING = 5000, 12000, 10000

# {variant: [(anchor, replacement), ...]}; "today" is the kernel as it stands
_ROW = ("if (threadIdx.x < R) node_req_out[(size_t)j * R + threadIdx.x] = "
        "node_req[(size_t)j * R + threadIdx.x];")
_HI = "  const int hi = lower_bound_node(s_key, B, rank_bits, (long long)j + 1);\n"
_OWN = "if (lane < kR) node_req_out[(size_t)j * kR + lane] = own;"
CAPACITY_VARIANTS = {
    # the earlier design: a block per node
    "today": [],
    "searches only": [(
        _HI, _HI + f"  if (lo <= hi) {{ {_ROW} return; }}\n")],
    "early exit on an empty run": [(
        _HI, _HI + f"  if (lo == hi) {{ {_ROW} return; }}\n")],
    "no fold scan": [(
        "      block_excl_scan(fits ? (double)q[r] : 0.0, warp_sums, &tot);",
        "      tot = fits ? (double)q[r] : 0.0;")],
    "empty blocks": [(
        "  const int j = blockIdx.x;\n",
        f"  const int j = blockIdx.x;\n  if (j >= 0) {{ {_ROW} return; }}\n")],
    # csrc/capacity.cu as it stands: a warp per node
    "warp: search only": [(
        "  if (lo >= B || (s_key[lo] >> rank_bits) != j) {",
        f"  if (lo >= 0) {{ {_OWN} return; }}\n"
        "  if (lo >= B || (s_key[lo] >> rank_bits) != j) {")],
    "warp: 4 claims a lane": [("constexpr int kU = 8;", "constexpr int kU = 4;")],
    "warp: 3 blocks an SM": [("__global__ void __launch_bounds__(kThreads)\ncapacity_kernel(",
                              "__global__ void __launch_bounds__(kThreads, 3)\ncapacity_kernel(")],
    "warp: empty warps": [(
        "  const int lo = warp_lower_bound(",
        f"  if (j >= 0) {{ {_OWN} return; }}\n  const int lo = warp_lower_bound(")],
}
STATIC_BASE_VARIANTS = {
    # the earlier design: one element a thread
    "today": [],
    "store only": [(
        "    bool ok = valid;",
        "    a.out[(size_t)p * a.N + n] = kNegInf;\n    continue;\n    bool ok = valid;")],
    "mask without score": [(
        "    float out = kNegInf;\n    if (ok) {",
        "    float out = ok ? 0.0f : kNegInf;\n    if (false) {")],
    "float4 stores, store only": [(
        "    bool ok = valid;",
        "    if (4 * n < a.N) reinterpret_cast<float4*>(a.out + (size_t)p * a.N)[n] ="
        " make_float4(kNegInf, kNegInf, kNegInf, kNegInf);\n    continue;\n"
        "    bool ok = valid;")],
    # csrc/static_base.cu as it stands: node-stationary tiles
    "tile: store only": [(
        "      const Pod q = pods[k];",
        "      if (kVec) { for (int c = 0; c < kPerThread; c += 4) __stcs("
        "reinterpret_cast<float4*>(a.out + (size_t)(p0 + k) * N + n0 + c / 4 * kStride), "
        "make_float4(kNegInf, kNegInf, kNegInf, kNegInf)); continue; }\n"
        "      const Pod q = pods[k];")],
    "tile: mask without score": [("      if (any) {", "      if (false) {")],
    "tile: no node name": [("      if ((flags & kNodeName) && q.pin != -1) {",
                            "      if (false) {")],
    "tile: no taint test": [("      if ((flags & kTaint) && ts_bits) {", "      if (false) {"),
                            ("      } else if (flags & kTaint) {", "      } else if (false) {")],
    "tile: no requirement rows": [("      if (flags & kAffinity) {", "      if (false) {")],
    "tile: no fit": [("      if (flags & kFit) {\n        for", "      if (false) {\n        for")],
    "tile: no sampling": [("      if (flags & kSample) {\n        // (n - off)",
                           "      if (false) {\n        // (n - off)")],
    "tile: 4 nodes a thread": [("constexpr int kPerThread = 8;", "constexpr int kPerThread = 4;")],
    "tile: 64-pod groups": [("constexpr int kPodGroup = 32;", "constexpr int kPodGroup = 64;")],
}

_NODE_WORK = ("      const Rec k = node_key<R, MB>(a, s, ln, n0 + ln, gate, ok + ln * (M + 1), "
              "ports, q, p);\n      if (before(k, best)) best = k;")
CLAIM_VARIANTS = {
    "today": [],
    # csrc/preempt_claim.cu as it stands: a cluster of 16 CTAs
    "cluster: floor (barrier and exchange, no node work)": [(_NODE_WORK, "      (void)ln;")],
    "cluster: 8 CTAs": [("constexpr int kClusterWant = 16;", "constexpr int kClusterWant = 8;")],
    "cluster: victim tables from L2": [("constexpr bool kStageTables = true;",
                                        "constexpr bool kStageTables = false;")],
}
_DOMAIN_LAUNCH = ("    domain_kernel<<<(unsigned)((terms + kThreads - 1) / kThreads), kThreads, "
                  "0, st>>>(a);")
_MATCH_SCAN = "    for (int i = tid; i < a.B / 16; i += kThreads) {"
AFFINITY_UPDATE_VARIANTS = {
    "today": [],
    # csrc/affinity_update.cu as it stands: a domain pass, then a row fold
    "fold: domain pass alone": [("  fold_kernel<<<S, kThreads, smem, st>>>(a);",
                                 "  (void)smem;")],
    "fold: no match scan": [(_MATCH_SCAN, _MATCH_SCAN.replace("< a.B / 16", "< 0"))],
    "fold: copy alone (no domain pass, no match scan)": [
        (_DOMAIN_LAUNCH, ""), (_MATCH_SCAN, _MATCH_SCAN.replace("< a.B / 16", "< 0"))],
}

_GUARD_LAUNCH = ("    guard_kernel<<<(unsigned)((L + kTile - 1) / kTile), kThreads, 0, "
                 "st>>>(a);")
_GUARD_FILL = "  fill_ones<<<(B + 16 * 256 - 1) / (16 * 256), 256, 0, st>>>(ok, B);\n"
GUARD_VARIANTS = {
    "today": [],
    # csrc/guard_sweep.cu as it stands: a fill kernel, then a CTA per tile
    "tile: read of the valid prefix alone (keys, permutation, roles, caps)": [(
        "    // ---- the group scan ----\n",
        "    {\n      unsigned x = 0;\n      for (int q = 0; q < kPer; ++q)\n"
        "        x ^= (unsigned)sp[q] ^ (unsigned)e[q] ^ (unsigned)role[q] ^ (unsigned)pod[q]"
        " ^ (unsigned)cap[q];\n"
        "      if (x == 0x9e3779b9u) g.ok[0] = 0;\n      return;\n    }\n")],
    "tile: the fill and an empty launch": [(
        "  const int t0 = blockIdx.x * kTile;\n", "  if (g.L >= 0) return;\n"
        "  const int t0 = blockIdx.x * kTile;\n")],
    "tile: the fill alone": [(_GUARD_LAUNCH, "    (void)a;")],
    "tile: a memset in place of the fill": [(
        _GUARD_FILL, "  cudaError_t e = cudaMemsetAsync(ok, 1, (size_t)B, st);\n"
        "  if (e != cudaSuccess) return (int)e;\n")],
    "tile: no look-ahead (chunks of the tile)": [("constexpr int kPer = 3;",
                                                  "constexpr int kPer = 2;")],
    "tile: 1024 entries on 256 threads, look-ahead 256 (the first tile)": [
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
        ("constexpr int kTile = 256;", "constexpr int kTile = 1024;"),
        ("constexpr int kPer = 3;", "constexpr int kPer = 5;")],
    "tile: 256 threads, 2 entries a thread (look-ahead 256)": [
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
        ("constexpr int kPer = 3;", "constexpr int kPer = 2;")],
    "tile: 64 threads, 5 entries a thread (look-ahead 64)": [
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 64;"),
        ("constexpr int kPer = 3;", "constexpr int kPer = 5;")],
    "tile: roles staged in shared memory": [
        ("  // no group starts here: the padding, or a group that started earlier\n",
         "  __shared__ int role_s[256];\n"
         "  const bool shared = g.slots <= 256;\n"
         "  for (int i = tid; shared && i < g.slots; i += kThreads) role_s[i] = g.role_tab[i];\n"
         "  // no group starts here: the padding, or a group that started earlier\n"),
        ("  if ((k_first == inv && k_last == inv) || (has_prev && k_last == k_prev)) return;\n",
         "  if ((k_first == inv && k_last == inv) || (has_prev && k_last == k_prev)) return;\n"
         "  __syncthreads();\n"),
        ("      role[q] = mine[q] ? g.role_tab[slot] : 0;",
         "      role[q] = !mine[q] ? 0 : (shared ? role_s[slot] : g.role_tab[slot]);")],
}
GUARD_EXACT = ("today", "tile: a memset in place of the fill",
               "tile: no look-ahead (chunks of the tile)",
               "tile: 1024 entries on 256 threads, look-ahead 256 (the first tile)",
               "tile: 256 threads, 2 entries a thread (look-ahead 256)",
               "tile: 64 threads, 5 entries a thread (look-ahead 64)",
               "tile: roles staged in shared memory")
_CHOOSE = ("        const int ch = pv::choose(c, a.sdr, s, c_node[k], j, pb, a.claimed, "
           "nullptr, 0);")
FOLD_VARIANTS = {
    "today": [],
    # csrc/pv_fold.cu as it stands: a cluster of 16 CTAs
    "cluster: floor (launch, compaction, barriers, loop condition; no choose)": [
        (_CHOOSE, "        const int ch = -1;\n        (void)s;")],
    "cluster: the launch alone": [("  const pv::Ctx& c = a.c;\n",
                                   "  const pv::Ctx& c = a.c;\n  if (a.B >= 0) return;\n")],
    "cluster: launch, copy, compaction and the first barrier": [(
        "  cluster.sync();  // every share copied and cleared, every CTA running\n",
        "  cluster.sync();  // every share copied and cleared, every CTA running\n"
        "  if (a.B >= 0) return;\n")],
    "cluster: contiguous row slices": [(
        "return ((lr >> 5) * csize + me) * 32 + (lr & 31);", "return me * a.rows + lr;")],
    "cluster: one row a thread per round of loads": [("constexpr int kU = 4;",
                                                      "constexpr int kU = 1;")],
    "cluster: 512 threads": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "cluster: 128 threads": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
}

_SCAN_NODE_WORK = "      const bool f = node_mask(a, s, pod, ln, n, sb_cur[i], minc, total);"
SCAN_VARIANTS = {
    "today": [],
    # csrc/scan_commit.cu as it stands: a cluster of 16 CTAs
    "cluster: floor (barriers, exchange and argmax, no node work)": [
        (_SCAN_NODE_WORK, "      const bool f = false;")],
    "cluster: counts committed by read-modify-write": [(
        "              atomicAdd(s.rep + (size_t)sl * a.D + min(dom[k], a.D - 1), 1.0f);",
        "              s.rep[(size_t)sl * a.D + min(dom[k], a.D - 1)] += 1.0f;")],
}


DYN_SCORE_VARIANTS = {
    "today": [],
    "resources unrolled to 8 (the first design)": [("  const bool r4 = R <= 4;",
                                                    "  const bool r4 = false;")],
    "128 pod groups a column of blocks": [("constexpr int kScoreGridY = 512;",
                                           "constexpr int kScoreGridY = 128;")],
    "at most 40 registers": [
        ("__global__ void __launch_bounds__(kThreads) dyn_score_kernel(",
         "__global__ void __launch_bounds__(kThreads, 6) dyn_score_kernel(")],
    "no division": [("after / fmaxf(al, 1e-9f)", "after * al")],
    "no sqrt": [("return 1.0f - sqrtf(var * a.rn);", "return 1.0f - var * a.rn;")],
    "no fractions (loads, fold and stores)": [("        if (!res) continue;\n",
                                               "        continue;\n")],
}
_PV_GATE = "  const int beg = c.node_off[node], end = c.node_off[node + 1];\n"
PV_CHOICE_VARIANTS = {
    "today": [],
    # csrc/pv_choice.cu as it stands: 64 threads a CTA, one walk a claimant
    "floor (launch, gate, node_of -> node_off -> first entry -> claimed; no choice)": [(
        _PV_GATE, _PV_GATE + "  if (B > 0) {\n    const int v0 = beg < end ? c.node_pv[beg] : 0;\n"
        "    o[0] = pv::claimed_at(claimed, v0) ? 1 : -1;\n    return;\n  }\n")],
    "128 threads a CTA": [("constexpr int kThreads = 64;", "constexpr int kThreads = 128;")],
    "256 threads a CTA": [("constexpr int kThreads = 64;", "constexpr int kThreads = 256;")],
}
PV_CHOICE_EXACT = ("today", "128 threads a CTA", "256 threads a CTA")

_WI_AFF = "      unsigned m[kW];\n      if (a.has_aff) {\n"
_WI_SPREAD = "      if (a.has_spread) {\n        for (int t = 0; t < a.MC; ++t) {"
_WI_PORTS = "      if (has_p) {\n"
_WI_HELD = "      for (int q = 0; q < a.MEP; ++q) hp |= "
_WI_OWNERS = "      if (!a.has_aff) continue;\n"
_WI_ME = "            if (a.me[(size_t)s * a.E + s_vic[j * kThreads + tid]]) m[w] |= 1u << (j & 31);"
_WI_CHUNK = "constexpr int kChunk = 4;"
WHATIF_VARIANTS = {
    "today": [],
    # csrc/preempt_whatif.cu as it stands: 128 nodes x 4 candidates a CTA
    "floor (launch, the node tables read once, the verdicts written; no term)": [
        (_WI_AFF, _WI_AFF.replace("a.has_aff", "false")),
        (_WI_SPREAD, _WI_SPREAD.replace("a.has_spread", "false")),
        (_WI_PORTS, _WI_PORTS.replace("has_p", "false"))],
    "no me gathers (match bits made up)": [
        (_WI_ME, "            m[w] |= (unsigned)(j & 1) << (j & 31);")],
    "no symmetric walk (nor its owners read)": [
        (_WI_OWNERS, "      continue;\n"),
        ("          for (int i = 0; i < n_own;) {", "          for (int i = 0; i < 0;) {"),
        ("        for (int k = 0; k < a.K; ++k) {\n          const int d = s_dom",
         "        for (int k = 0; k < 0; ++k) {\n          const int d = s_dom")],
    "no ports": [(_WI_PORTS, _WI_PORTS.replace("has_p", "false")),
                 (_WI_HELD, _WI_HELD.replace("q < a.MEP", "q < 0"))],
    "byte stores from each thread (no shared-memory span)": [
        ("      uint8_t* r = s_buf + ((cc & 1) * kThreads + tid) * (M + 1);",
         "      uint8_t* r = a.out + ((size_t)c * a.N + n) * (M + 1);"),
        ("    const int len = (min(kThreads, a.N - n0)) * (M + 1);", "    const int len = 0;")],
    "64 nodes a CTA": [("constexpr int kThreads = 128;", "constexpr int kThreads = 64;")],
    "256 nodes a CTA": [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;")],
    "1 candidate a CTA": [(_WI_CHUNK, "constexpr int kChunk = 1;")],
    "2 candidates a CTA": [(_WI_CHUNK, "constexpr int kChunk = 2;")],
    "8 candidates a CTA (the first shape)": [(_WI_CHUNK, "constexpr int kChunk = 8;")],
}
WHATIF_EXACT = ("today", "byte stores from each thread (no shared-memory span)",
                "64 nodes a CTA", "256 nodes a CTA", "1 candidate a CTA", "2 candidates a CTA",
                "8 candidates a CTA (the first shape)")

_PF_WALK = "  for (unsigned m = gbits; m; m &= m - 1) {\n"
PREFILTER_VARIANTS = {
    "today": [],
    # csrc/preempt_prefilter.cu as it stands: 128 nodes x 32 candidates a CTA
    "floor (launch, the staged tables, the gate read; no fit walk)": [
        (_PF_WALK, "  mine = gbits;\n  for (unsigned m = 0; m; m &= m - 1) {\n")],
    "tables from L2 (nothing staged)": [
        ("  if (staged <= (size_t)kSmemMax) {", "  if (false) {")],
    "no padded pitch (bank conflicts in the staging)": [
        ("constexpr int kPitch = kNodes + 1;", "constexpr int kPitch = kNodes;")],
    "64 nodes a CTA": [("constexpr int kNodes = 128;", "constexpr int kNodes = 64;")],
    "256 nodes a CTA": [("constexpr int kNodes = 128;", "constexpr int kNodes = 256;")],
    "16 candidates a CTA": [("constexpr int kChunk = 32;", "constexpr int kChunk = 16;")],
    "every gated node walked from L2 (no monotone test)": [
        ("      if (found && !mono) found = walk_l2(a, n, elig, q);",
         "      if (found) found = walk_l2(a, n, elig, q);")],
    "one 16-byte load of the prefix table in flight a thread while staging": [
        ("constexpr int kBatch = 8;", "constexpr int kBatch = 1;")],
    "elig counted for every candidate (no reuse across a priority)": [
        ("    if (elig < 0 || p != last_p) {", "    if (true) {")],
}
PREFILTER_EXACT = ("today", "tables from L2 (nothing staged)",
                   "no padded pitch (bank conflicts in the staging)", "64 nodes a CTA",
                   "256 nodes a CTA", "16 candidates a CTA",
                   "every gated node walked from L2 (no monotone test)",
                   "one 16-byte load of the prefix table in flight a thread while staging",
                   "elig counted for every candidate (no reuse across a priority)")

# the variants that compute the kernel's function: held against it
STATIC_REJECT_VARIANTS = {
    "today": [],
    "floor (every launch, packing, valid words, chain, sums and stores; no test)": [
        ("        word_tests(a, q, w, sched_w, ok[c]);",
         "        for (int t = 0; t < kTests; ++t) ok[c][t] = ~0u;"),
        ("      if (q.mrow)\n", "      if (false)\n"), ("      if (q.ports)\n", "      if (false)\n")],
    "count launch alone (no marks, no packing)": [
        ("    if (list) mark_kernel<<<marks < kMaxGrid ? marks : kMaxGrid, kPackThreads, 0, "
         "st>>>(a);", "    (void)marks;"),
        ("    pack_kernel<<<grid, kPackThreads, 0, st>>>(a);", "    (void)grid;")],
    "words one at a time (no chunk)": [("constexpr int kChunk = 4;", "constexpr int kChunk = 1;")],
    "4 warps a block": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "16 warps a block": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
}
STATIC_REJECT_EXACT = ("today", "words one at a time (no chunk)", "4 warps a block",
                       "16 warps a block")
DYN_REJECT_VARIANTS = {
    "today": [],
    "floor (launch, room staged, warp sums and flush; no load or test)": [
        ("      if (on && kVec) {\n        raw[0] =", "      if (false) {\n        raw[0] ="),
        ("      if (on && kVec) {\n        st = bits16", "      if (false) {\n        st = bits16"),
        ("      } else if (on) {\n        st = load16(",
         "      } else if (false) {\n        st = load16("),
        ("          fit && on ? fit16(", "          false ? fit16("),
        ("      const unsigned pm = port_s[k] && on ?", "      const unsigned pm = false ?")],
    "loads and chain, no fit test": [("          fit && on ? fit16(", "          false ? fit16(")],
    "no room staged (the fit test on unset shared memory)": [
        ("      stage_room(a, tile0, room_s);", "      (void)tile0;")],
    "one block an SM": [("constexpr int kTargetBlocks = 264;",
                         "constexpr int kTargetBlocks = 132;")],
    "four blocks an SM": [("constexpr int kTargetBlocks = 264;",
                           "constexpr int kTargetBlocks = 528;")],
    "groups of 32 rows": [("constexpr int kRows = 8;", "constexpr int kRows = 32;")],
    "128 threads a block": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
}
DYN_REJECT_EXACT = ("today", "one block an SM", "four blocks an SM", "groups of 32 rows",
                    "128 threads a block")
DYN_SCORE_EXACT = ("today", "resources unrolled to 8 (the first design)",
                   "128 pod groups a column of blocks", "at most 40 registers")


def _scan_phase_marks() -> list:
    """Edits that time each phase of a K13 step with clock64() in every
    thread and print, for each CTA, the largest cycle sum of each phase
    over its threads (device printf): the split of a step that variants
    skipping work cannot give, since they change which node wins."""
    def mark(i):
        return f"    {{ const long long t = clock64(); ph[{i}] += t - tc; tc = t; }}\n"

    loop = "  for (int rank = 0; rank < nv; ++rank) {\n    const int par = rank & 1;"
    end = "  __syncthreads();\n  for (int i = tid; i < nn * R; i += kThreads)\n    a.node_req["
    names = ("staging", "spread minimum", "masks", "maxima", "scores", "winner", "commit")
    fmt = " ".join(f"{n} %lld" for n in names)
    return [
        ("#include <stdint.h>", "#include <stdint.h>\n#include <cstdio>"),
        (loop, "  long long ph[7] = {0, 0, 0, 0, 0, 0, 0}, tc = clock64();\n" + loop),
        ("    const int pflags = pod[a.r_flags];",
         mark(0) + "    const int pflags = pod[a.r_flags];"),
        ("    // ---- masks and raw affinity / spread scores of this thread's nodes ----",
         mark(1) + "    // ---- masks and raw affinity / spread scores of this thread's nodes ----"),
        ("    // ---- the two normalisation maxima over the cluster's feasible nodes",
         mark(2) + "    // ---- the two normalisation maxima over the cluster's feasible nodes"),
        ("    // ---- scores and this thread's best (score, -index) ----",
         mark(3) + "    // ---- scores and this thread's best (score, -index) ----"),
        ("    // ---- the winner: per warp, over the warps, over the cluster ----",
         mark(4) + "    // ---- the winner: per warp, over the warps, over the cluster ----"),
        ("    // ---- the commit ----", mark(5) + "    // ---- the commit ----"),
        ("    p_next = p_after;\n  }", mark(6) + "    p_next = p_after;\n  }"),
        (end, "  __shared__ unsigned long long phmax[7];\n"
              "  if (tid < 7) phmax[tid] = 0;\n  __syncthreads();\n"
              "  for (int i = 0; i < 7; ++i) atomicMax(&phmax[i], (unsigned long long)ph[i]);\n"
              "  __syncthreads();\n"
              f'  if (tid == 0) printf("scan_commit phase cycles, slowest thread of CTA %d: '
              f'{fmt} steps %d\\n", me, phmax[0], phmax[1], phmax[2], phmax[3], phmax[4], '
              f'phmax[5], phmax[6], nv);\n' + end),
    ]


SCAN_VARIANTS["cluster: phase clocks"] = _scan_phase_marks()

VARIANT_OF: dict[str, str] = {}  # edited source -> "kernel, variant"


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def device_ms(fn, reps: int) -> float:
    """Mean device ms per call of fn, from one CUDA graph of `reps` calls
    replayed between two CUDA events: the device's time for the calls'
    kernels back to back, without the host time of the Python wrappers
    that launch them (a K5 call takes longer on the host than on the card,
    so events around eager calls would time the host)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def time_ms(fn, reps: int) -> float:
    """Mean device ms per call over `reps` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_variants(name: str, csrc: Path, variants: dict) -> dict:
    """{variant: loaded library or None (anchors missing)}; builds in
    parallel, one nvcc each."""
    from .ops import kernel_build as kb

    text = (csrc / f"{name}.cu").read_text()
    out_dir = kb.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = {}
    for v, edits in variants.items():
        if not all(a in text for a, _ in edits):
            srcs[v] = None
            continue
        t = text
        for a, b in edits:
            t = t.replace(a, b, 1)
        path = out_dir / f"{name}-{len(srcs)}.cu"
        path.write_text(t)
        srcs[v] = path
        VARIANT_OF[str(path)] = f"{name}, {v}"
    libs, errs = {}, []

    def one(v, path):
        try:
            libs[v] = kb.build_cuda_library(name, path, include=csrc)
        except BaseException as e:  # re-raised below
            errs.append(e)

    threads = [threading.Thread(target=one, args=(v, p)) for v, p in srcs.items() if p]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errs:
        raise errs[0]
    import ctypes

    return {v: (ctypes.CDLL(str(libs[v])) if p else None) for v, p in srcs.items()}


def with_library(name: str, lib, fn):
    """Run fn() with kernel `name`'s wrapper launching from `lib`."""
    from .ops import kernel_build as kb

    saved = kb._libs.get(name)
    kb._libs[name] = lib
    try:
        return fn()
    finally:
        if saved is None:
            kb._libs.pop(name, None)
        else:
            kb._libs[name] = saved


# the small kernels of the main path timed on the device: the module under
# ops/ and its CUDA wrapper
SMALL_KERNELS = {
    "affinity_update": ("affinity_update", "affinity_update_cuda"),
    "capacity": ("capacity", "capacity_cuda"),
    "guard_sweep": ("guard_sweep", "guard_sweep_cuda"),
    "preempt_prefilter": ("preempt_prefilter", "preempt_prefilter_cuda"),
    "preempt_whatif": ("preempt_whatif", "preempt_whatif_cuda"),
    "preempt_claim": ("preempt_claim", "preempt_claim_cuda"),
    "pv_choice": ("pv_choice", "pv_choice_cuda"),
    "pv_fold": ("pv_fold", "pv_fold_cuda"),
    "dyn_mask": ("dyn_round", "dyn_mask_cuda"),
    "dyn_score": ("dyn_round", "dyn_score_cuda"),
}


def cuda_fn(name: str):
    """Kernel `name`'s CUDA wrapper (SMALL_KERNELS)."""
    import importlib

    mod, fn = SMALL_KERNELS[name]
    return getattr(importlib.import_module(f".ops.{mod}", __package__), fn)


def record_small_calls(dev) -> dict:
    """{kernel: [args of each call]} of the small kernels on the main path:
    K4 `affinity_update`, K5 `capacity`, K6 `guard_sweep`, K14 `dyn_mask`
    and K15 `dyn_score` (the round's and the score anchor's calls) over one
    rounds cycle of config #4's workload (seed 202), K7-K9 in the preemption pass after
    it, K11 `pv_choice` and K12 `pv_fold` over one rounds cycle of the
    same workload with local and zonal volumes (seed 201), and K9 in the
    preemption pass after that cycle too."""
    from .core.cycle import build_cycle_fn, build_preemption_fn
    from .models import SnapshotEncoder
    from .utils import synth

    calls: dict = {k: [] for k in SMALL_KERNELS}

    def rec(name):
        fn = cuda_fn(name)

        def call(*args):
            calls[name].append(args)
            return fn(*args)
        return call

    enc = SnapshotEncoder(device=dev)
    nodes, existing, pending = synth.config4_workload((201, 202), N_NODES, N_EXISTING,
                                                      N_PENDING)
    snap = enc.encode(nodes, pending[202], existing)
    d = build_cycle_fn(commit_mode="rounds", outputs="latency", device=dev,
                       affinity_update_fn=rec("affinity_update"),
                       capacity_fn=rec("capacity"),
                       guard_sweep_fn=rec("guard_sweep"), dyn_mask_fn=rec("dyn_mask"),
                       dyn_score_fn=rec("dyn_score"))(snap)
    build_preemption_fn(device=dev, prefilter_fn=rec("preempt_prefilter"),
                        whatif_fn=rec("preempt_whatif"),
                        claim_fn=rec("preempt_claim"))(snap, d)
    ex, pods, pvcs, pvs, classes = synth.config4_volumes(nodes, existing, pending[201],
                                                         seed=201)
    vsnap = enc.encode(nodes, pods, ex, pvcs=pvcs, pvs=pvs, storage_classes=classes)
    d = build_cycle_fn(commit_mode="rounds", outputs="latency", device=dev,
                       pv_choice_fn=rec("pv_choice"), pv_fold_fn=rec("pv_fold"))(vsnap)
    build_preemption_fn(device=dev, claim_fn=rec("preempt_claim"))(vsnap, d)
    torch.cuda.synchronize()
    return calls


def time_small_kernels(calls: dict) -> dict:
    """{kernel: {timing: ms}}: each small kernel's first recorded call timed
    with CUDA events around eager calls (the host's time where the wrapper
    takes longer than the kernel) and as device time (`device_ms`), and the
    device time's mean over every recorded call."""
    out = {}
    for name, cs in calls.items():
        fn = cuda_fn(name)
        row = {"calls": len(cs),
               "first call, events": time_ms(lambda: fn(*cs[0]), 20),
               "first call, device": device_ms(lambda: fn(*cs[0]), 20),
               "mean over the calls, device": sum(
                   device_ms(lambda: fn(*c), 5) for c in cs) / len(cs)}
        out[name] = row
        print(f"  small kernel {name:18s} " + "  ".join(
            f"{k} {v:.4f} ms" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()), flush=True)
    return out


def time_claim_variants(dev, csrc: Path, calls: list, check: bool) -> dict:
    """K9's variants (CLAIM_VARIANTS) in device time on the recorded
    passes; with the package's own source, K9 first held against
    `claim_loop_plain` bit for bit on them and on its seeded edge cases."""
    from .ops import preempt_claim as k9
    from .ops import preemption as pre

    libs = build_variants("preempt_claim", csrc, CLAIM_VARIANTS)
    if check:
        from .utils import kernel_cases

        cases = kernel_cases.claim_cases(dev)
        inputs = list(cases.items()) + [(f"pass {i}", c[0]) for i, c in enumerate(calls)]

        def hold(tag):
            for case, x in inputs:
                (nk, ck), (np_, cp_) = k9.preempt_claim_cuda(x), pre.claim_loop_plain(x)
                if not (torch.equal(nk, np_) and all(
                        torch.equal(getattr(ck, f), getattr(cp_, f)) for f in vars(ck))):
                    raise RuntimeError(f"preempt_claim ({tag}) differs from "
                                       f"claim_loop_plain ({case})")

        hold("16 CTAs")
        shapes = {tag: k9.claim_shape(x) for tag, x in inputs}
        print(f"preempt_claim equal to claim_loop_plain bit for bit on {len(calls)} passes "
              f"and {len(cases)} edge cases; launch shapes {json.dumps(shapes)}", flush=True)
        # the portable cluster, the kernel's shape on a card that cannot
        # schedule 16 CTAs, is exact too
        with_library("preempt_claim", libs["cluster: 8 CTAs"], lambda: hold("8 CTAs"))
        shape8 = with_library("preempt_claim", libs["cluster: 8 CTAs"],
                              lambda: k9.claim_shape(calls[0][0]))
        print(f"preempt_claim with 8 CTAs (launch shape {json.dumps(shape8)}) equal to "
              "claim_loop_plain on the same inputs", flush=True)
    out = {}
    for v, lib in libs.items():
        if lib is None:
            out[v] = "not applicable"
            continue
        row = {f"pass {i} ({int(c[0].n_live)} live)": with_library(
            "preempt_claim", lib, lambda: device_ms(lambda: k9.preempt_claim_cuda(*c), 20))
            for i, c in enumerate(calls)}
        out[v] = row
        print(f"  preempt_claim {v:52s} "
              + "  ".join(f"{k} {ms:.4f} ms" for k, ms in row.items()), flush=True)
    return out


def prev_affinity_update(lib, snap, state, m_pending, accepted, node_of):
    """K4 through the earlier C interface (`affinity_update_launch`, the
    design before the domain pass and row fold): the four tables cloned,
    then updated in place by the library's kernels."""
    import ctypes

    from .ops import interpod as ip
    from .ops.kernel_build import ptr, raise_on_error, stream_of

    fn = lib.affinity_update_launch
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 12
    fn.restype = ctypes.c_int
    S, D = state.counts.shape
    out = ip.AffinityState(state.counts.clone(), state.total.clone(),
                           state.anti_presence.clone(), state.pref_sym.clone())
    dev = state.counts.device
    raise_on_error("affinity_update", fn(
        snap.P, snap.N, S, D, snap.node_domains.shape[1], snap.pod_anti_terms.shape[1],
        int(bool(snap.has_inter_pod_affinity)), ptr(m_pending), ptr(accepted), ptr(node_of),
        ptr(snap.node_domains), ptr(snap.pod_anti_terms), ptr(snap.pod_pref_aff),
        ptr(snap.pod_pref_aff_w), ptr(out.counts), ptr(out.total), ptr(out.anti_presence),
        ptr(out.pref_sym), stream_of(dev)))
    return out


def affinity_update_with(lib):
    """K4's wrapper for library `lib`: the package's interface, or the
    earlier one (`prev_affinity_update`) for a library without it."""
    from .ops import affinity_update as au

    if hasattr(lib, "affinity_update_fold"):
        return lambda *args: with_library("affinity_update", lib,
                                          lambda: au.affinity_update_cuda(*args))
    return lambda *args: prev_affinity_update(lib, *args)


def states_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("counts", "total", "anti_presence", "pref_sym"))


def time_affinity_update_variants(dev, csrc: Path, calls: list, check: bool) -> dict:
    """K4's variants (AFFINITY_UPDATE_VARIANTS) in device time on the
    recorded calls of one cycle: the round-0 call and the mean over the
    calls; with the package's own source, K4 first held against
    `affinity_update_plain` on them and on its seeded edge cases."""
    from .ops import affinity_update as au

    libs = build_variants("affinity_update", csrc, AFFINITY_UPDATE_VARIANTS)
    if check:
        from .utils import kernel_cases

        edge = {t: kernel_cases.affinity_update_args(r, dev)
                for t, r in kernel_cases.affinity_update_raw_cases().items()}
        for tag, c in list(edge.items()) + [(f"call {i}", c) for i, c in enumerate(calls)]:
            if not states_equal(au.affinity_update_cuda(*c), au.affinity_update_plain(*c)):
                raise RuntimeError(f"affinity_update differs from its plain version ({tag})")
        print(f"affinity_update equal to affinity_update_plain on {len(calls)} recorded calls "
              f"and {len(edge)} edge cases", flush=True)
    out = {}
    for v, lib in libs.items():
        if lib is None:
            out[v] = "not applicable"
            continue
        fn = affinity_update_with(lib)
        row = {"round 0": device_ms(lambda: fn(*calls[0]), 20),
               "mean over the calls": sum(device_ms(lambda: fn(*c), 5)
                                          for c in calls) / len(calls)}
        out[v] = row
        print(f"  affinity_update {v:40s} "
              + "  ".join(f"{k} {ms:.4f} ms" for k, ms in row.items()), flush=True)
    st = calls[0][1]
    tables = (st.counts, st.total, st.anti_presence, st.pref_sym)
    out["the four old tables cloned by torch (a copy floor)"] = device_ms(
        lambda: [t.clone() for t in tables], 20)
    print(f"  affinity_update the four old tables cloned by torch "
          f"{out['the four old tables cloned by torch (a copy floor)']:.4f} ms", flush=True)
    return out


def prev_guard_sweep(lib, s_packed, perm, rank_bits, B, role_tab, caps, gk_invalid):
    """K6 through the earlier C interface (`guard_sweep_launch` with a
    group list and its counter, the design before the tile sweep): its
    scratch allocated and the counter zeroed as its wrapper did."""
    import ctypes

    from .ops.kernel_build import ptr, raise_on_error, stream_of

    fn = lib.guard_sweep_launch
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    L, dev = s_packed.shape[0], s_packed.device
    seg_list = torch.empty(L, dtype=torch.int32, device=dev)
    n_seg = torch.zeros(1, dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    raise_on_error("guard_sweep", fn(
        L, B, rank_bits, role_tab.shape[0], gk_invalid, ptr(s_packed), ptr(perm),
        ptr(role_tab), ptr(caps), ptr(seg_list), ptr(n_seg), ptr(ok), stream_of(dev)))
    return ok


def guard_sweep_with(lib):
    """K6's wrapper for library `lib`: the package's interface, or the
    earlier one (`prev_guard_sweep`) for a library with the group list."""
    from .ops import guard_sweep as gs

    if hasattr(lib, "guard_sweep_tile"):
        return lambda *args: with_library("guard_sweep", lib,
                                          lambda: gs.guard_sweep_cuda(*args))
    return lambda *args: prev_guard_sweep(lib, *args)


def prev_pv_fold(lib, snap, tables, pv_claimed, accepted, node_of, rank):
    """K12 through the one-block design's C interface (`pv_fold_launch`
    with its winner, choice and pending tables as scratch): the bitmap
    cloned, then folded in place by the library's kernel."""
    import ctypes

    from .ops import volumes
    from .ops.kernel_build import ptr, raise_on_error, stream_of
    from .ops.volume_mask import CTX_ARGTYPES, ctx_args, ctx_dims, sdr_tables

    fn = lib.pv_fold_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + CTX_ARGTYPES + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    B, MVol = snap.pod_vol_mode.shape
    V, dev = snap.pv_avail.shape[0], snap.device
    claimed = pv_claimed.clone()
    masks, off = sdr_tables(MVol, str(dev))
    scratch = [torch.empty(n, dtype=torch.int32, device=dev) for n in (V, B, B)]
    raise_on_error("pv_fold", fn(
        ptr(claimed), B, *ctx_dims(snap, tables), *[ptr(t) for t in ctx_args(
            "pv_fold", snap, tables)], ptr(node_of), ptr(accepted), ptr(rank),
        int(volumes._multi(snap)), ptr(masks), ptr(off), *[ptr(t) for t in scratch],
        stream_of(dev)))
    return claimed


def pv_fold_with(lib, cluster=None):
    """K12's wrapper for library `lib`: the package's interface (on a
    cluster of `cluster` CTAs, default the wrapper's), or the one-block
    design's (`prev_pv_fold`) for a library without it."""
    from .ops import pv_fold as k12

    if hasattr(lib, "pv_fold_clusters"):
        kw = {} if cluster is None else {"cluster": cluster}
        return lambda *args: with_library("pv_fold", lib,
                                          lambda: k12.pv_fold_cuda(*args, **kw))
    return lambda *args: prev_pv_fold(lib, *args)


def contended_fold_args(args, n_nodes: int = N_NODES, seed: int = 11):
    """A contended K12 batch beside a recorded call: every valid pod with an
    unbound slot accepted, at a node drawn from `seed`, against the call's
    bitmap and ranks (several passes)."""
    snap, tables, claimed, _, _, rank = args
    gen = torch.Generator(device=snap.device).manual_seed(seed)
    many = snap.pod_valid & (snap.pod_vol_mode == 1).any(dim=1)
    node = torch.randint(0, n_nodes, (snap.P,), generator=gen, device=snap.device,
                         dtype=torch.int32)
    return (snap, tables, claimed, many, node, rank)


def time_guard_sweep_variants(dev, csrc: Path, calls: list, check: bool) -> dict:
    """K6's variants (GUARD_VARIANTS) in device time on the recorded calls
    of one rounds cycle (the round-0 call and the mean over the calls);
    with the package's own source, K6 first held against
    `guard_sweep_plain` on them and on its seeded edge cases."""
    from .ops import guard_sweep as gs

    libs = build_variants("guard_sweep", csrc, GUARD_VARIANTS)
    if check:
        from .utils import kernel_cases

        edge = kernel_cases.guard_cases(dev)
        for v in GUARD_EXACT:
            fn = guard_sweep_with(libs[v])
            for tag, c in list(edge.items()) + [(f"call {i}", c) for i, c in enumerate(calls)]:
                if not torch.equal(fn(*c), gs.guard_sweep_plain(*c)):
                    raise RuntimeError(f"guard_sweep ({v}) differs from guard_sweep_plain "
                                       f"({tag})")
        print(f"guard_sweep ({', '.join(GUARD_EXACT)}) equal to guard_sweep_plain on "
              f"{len(calls)} recorded calls and {len(edge)} edge cases", flush=True)
    valid, longest = [], []
    for c in calls:
        keys = c[0] >> c[2]
        run = torch.unique_consecutive(keys[keys != c[6]], return_counts=True)[1]
        valid.append(int(run.sum()))
        longest.append(int(run.max()) if run.numel() else 0)
    L = calls[0][0].shape[0]
    out = {"calls": {"n": len(calls), "L": L, "valid": valid, "longest group": longest}}
    print(f"guard_sweep: {len(calls)} calls of L = {L}, valid entries {valid}, longest "
          f"group {longest}", flush=True)
    for v, lib in libs.items():
        if lib is None:
            out[v] = "not applicable"
            continue
        fn = guard_sweep_with(lib)
        row = {"round 0": device_ms(lambda: fn(*calls[0]), 20),
               "mean over the calls": sum(device_ms(lambda: fn(*c), 10)
                                          for c in calls) / len(calls)}
        out[v] = row
        print(f"  guard_sweep {v:66s} "
              + "  ".join(f"{k} {ms:.4f} ms" for k, ms in row.items()), flush=True)
    return out


def time_pv_fold_variants(dev, csrc: Path, calls: list, check: bool) -> dict:
    """K12's variants (FOLD_VARIANTS, and today's kernel on the portable 8
    CTAs) in device time on the recorded calls of one volume cycle (round
    0, the mean over the calls) and on a contended batch beside round 0
    (`contended_fold_args`); with the package's own source, K12 first held
    against `pv_fold_plain` on them and on its seeded edge cases, on 16
    CTAs and on 8."""
    from .ops import pv_fold as k12
    from .ops import volumes

    libs = build_variants("pv_fold", csrc, FOLD_VARIANTS)
    cont = contended_fold_args(calls[0])
    runs = {v: pv_fold_with(lib) for v, lib in libs.items() if lib is not None}
    if "today" in runs and hasattr(libs["today"], "pv_fold_clusters"):
        runs["cluster: 8 CTAs"] = pv_fold_with(libs["today"], cluster=k12.CLUSTER_PORTABLE)
    if check:
        from .utils import kernel_cases

        edge = kernel_cases.fold_cases(dev)
        inputs = (list(edge.items()) + [(f"call {i}", c) for i, c in enumerate(calls)]
                  + [("contended batch", cont)])
        exact = ("today", "cluster: 8 CTAs", "cluster: contiguous row slices",
                 "cluster: one row a thread per round of loads", "cluster: 512 threads",
                 "cluster: 128 threads")
        for v in exact:
            for tag, c in inputs:
                if not torch.equal(runs[v](*c), volumes.pv_fold_plain(*c)):
                    raise RuntimeError(f"pv_fold ({v}) differs from pv_fold_plain ({tag})")
        print(f"pv_fold ({', '.join(exact)}) equal to pv_fold_plain on {len(calls)} "
              f"recorded calls, the contended batch and {len(edge)} edge cases", flush=True)
    shapes = []
    for c in calls + [cont]:
        snap, tables, claimed, acc, node, rank = c
        rows = acc & (snap.pod_vol_mode == 1).any(dim=1)
        shapes.append({"B": snap.P, "claimants": int(rows.sum()), "passes":
                       volumes.fold_pv_claims_passes(snap, tables.req, claimed, acc, node,
                                                     rank)[1]})
    out = {"calls": shapes[:-1], "contended batch": shapes[-1]}
    print(f"pv_fold: calls {json.dumps(shapes[:-1])}; contended batch "
          f"{json.dumps(shapes[-1])}", flush=True)
    for v, fn in runs.items():
        row = {"round 0": device_ms(lambda: fn(*calls[0]), 20),
               "mean over the calls": sum(device_ms(lambda: fn(*c), 5)
                                          for c in calls) / len(calls),
               "contended batch": device_ms(lambda: fn(*cont), 10)}
        out[v] = row
        print(f"  pv_fold {v:72s} "
              + "  ".join(f"{k} {ms:.4f} ms" for k, ms in row.items()), flush=True)
    for v in libs:
        if libs[v] is None:
            out[v] = "not applicable"
    return out


def prev_static_rejects(lib, x, rows=None):
    """The earlier K16 (`static_rejects_kernel` of csrc/static_base.cu, on
    K1's tiles and per-node tests) through its C interface: K1's launcher
    arguments after the output, then F, the columns and `rows`; no
    survivors plane."""
    import ctypes

    from .ops import static_base as sb
    from .ops.kernel_build import checked, raise_on_error

    fn = lib.static_rejects_launch
    if fn.argtypes is None:
        # K1's interface before the extender operands (its last two)
        fn.argtypes = sb._ARGTYPES[:-2] + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    P, N = x.shape
    dev = x.node_valid.device
    args, _keep = sb._common_args(x, "static_rejects")
    args = args[:-2]
    rw = None if rows is None else checked("static_rejects", rows, torch.bool, (P,), dev)
    out = torch.zeros((P, x.n_filters), dtype=torch.int32, device=dev)
    raise_on_error("static_rejects (the earlier design)", fn(
        sb._ptr(out), *args, x.n_filters, (ctypes.c_int * len(sb.REJECT_TESTS))(*x.columns),
        sb._ptr(rw)))
    return out


def rejects_equal(a, b) -> bool:
    """Two K16 / K17 results equal: counts, or (counts, survivors)."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))
    return torch.equal(a, b)


def record_reject_calls(dev) -> dict:
    """{input: K16's or K17's arguments}: the full rounds cycle's K16 call
    (every pod row) and K17 call (the final window) on config #4's workload
    (seed 202) and with local and zonal volumes (seed 201), and K16 on the
    first 2048 rows of the first with the survivors plane."""
    from .core.cycle import build_cycle_fn
    from .models import SnapshotEncoder
    from .ops import dyn_round as dr
    from .ops import static_base as sb
    from .utils import synth

    enc = SnapshotEncoder(device=dev)
    nodes, existing, pending = synth.config4_workload((201, 202), N_NODES, N_EXISTING,
                                                      N_PENDING)
    ex, pods, pvcs, pvs, classes = synth.config4_volumes(nodes, existing, pending[201],
                                                         seed=201)
    snaps = {"config #4": enc.encode(nodes, pending[202], existing),
             "volumes": enc.encode(nodes, pods, ex, pvcs=pvcs, pvs=pvs,
                                   storage_classes=classes)}
    calls: dict = {"static_rejects": {}, "dyn_rejects": {}}
    for tag, snap in snaps.items():
        def k16(*a, tag=tag):
            calls["static_rejects"][tag] = a
            return sb.static_rejects_cuda(*a)

        def k17(*a, tag=tag):
            calls["dyn_rejects"][tag] = a
            return dr.dyn_rejects_cuda(*a)

        build_cycle_fn(commit_mode="rounds", device=dev, static_rejects_fn=k16,
                       dyn_rejects_fn=k17)(snap)
    x = calls["static_rejects"]["config #4"][0]
    pods = {f.name: getattr(x, f.name)[:2048] for f in dataclasses.fields(x)
            if f.name.startswith("pod_") or f.name == "samp_off"}
    calls["static_rejects"]["2048 rows, survivors"] = (
        dataclasses.replace(x, **pods), None, True)
    torch.cuda.synchronize()
    return calls


def time_reject_variants(dev, csrc: Path, check: bool) -> dict:
    """K16's and K17's variants (STATIC_REJECT_VARIANTS, DYN_REJECT_VARIANTS)
    in device time on `record_reject_calls`' inputs; the exact variants
    held against the kernel there, and with the package's own sources the
    kernels first held against their plain versions on them and on
    `kernel_cases.static_reject_cases` / `dyn_reject_cases`."""
    from .ops import dyn_round as dr
    from .ops import static_base as sb

    calls = record_reject_calls(dev)
    kernels = {"static_rejects": (sb.static_rejects_cuda, sb.static_rejects_plain,
                                  STATIC_REJECT_VARIANTS, STATIC_REJECT_EXACT),
               "dyn_rejects": (dr.dyn_rejects_cuda, dr.dyn_rejects_plain,
                               DYN_REJECT_VARIANTS, DYN_REJECT_EXACT)}

    if check:
        from .utils import kernel_cases

        edge = {"static_rejects": [(x, r) for x, r in
                                   kernel_cases.static_reject_cases(dev).values()],
                "dyn_rejects": list(kernel_cases.dyn_reject_cases(dev).values())}
        for name, (fn, plain, _, _) in kernels.items():
            for a in list(calls[name].values()) + edge[name]:
                if not rejects_equal(fn(*a), plain(*a)):
                    raise RuntimeError(f"{name} differs from its plain version")
            print(f"{name} equal to its plain version on {len(calls[name])} inputs and "
                  f"{len(edge[name])} edge cases", flush=True)
    table = {}
    for name, (fn, _, variants, exact) in kernels.items():
        libs = build_variants(name, csrc, variants)
        inputs = calls[name]
        want = {t: fn(*a) for t, a in inputs.items()}
        shapes = {t: list(a[0].shape) for t, a in inputs.items()}
        out = {"inputs": shapes}
        print(f"{name}: inputs {json.dumps(shapes)}", flush=True)
        for v, lib in libs.items():
            if lib is None:
                out[v] = "not applicable"
                continue

            def run(a, lib=lib):
                return with_library(name, lib, lambda: fn(*a))
            if v in exact:
                for t, a in inputs.items():
                    if not rejects_equal(run(a), want[t]):
                        raise RuntimeError(f"{name} variant {v!r} differs ({t})")
            row = {t: device_ms(lambda: run(a), 20) for t, a in inputs.items()}
            out[v] = row
            print(f"  {name} {v:80s} "
                  + "  ".join(f"{k} {ms:.4f} ms" for k, ms in row.items()), flush=True)
        table[name] = out
    return table


def static_base_cases(dev):
    """{case: StaticBaseInputs} of slice 1 and the volume phase."""
    from .core.cycle import sampling_window
    from .framework.interfaces import CycleContext
    from .framework.runtime import Framework
    from .models import SnapshotEncoder
    from .ops import static_base as sb
    from .utils import synth

    fw = Framework.from_config()
    enc = SnapshotEncoder(device=dev)
    nodes, existing, pending = synth.config4_cluster_config2_pending(
        (101,), N_NODES, N_EXISTING, N_PENDING)
    snap = enc.encode(nodes, pending[101], existing)
    cases = {"slice 1": sb.static_base_inputs(
        fw, CycleContext(snap), fit=True, sampling=sampling_window(snap, 0))}
    nodes, existing, pending = synth.config4_workload((201,), N_NODES, N_EXISTING,
                                                      N_PENDING)
    ex, pods, pvcs, pvs, classes = synth.config4_volumes(nodes, existing, pending[201],
                                                         seed=201)
    snap = enc.encode(nodes, pods, ex, pvcs=pvcs, pvs=pvs, storage_classes=classes)
    cases["volumes"] = sb.static_base_inputs(
        fw, CycleContext(snap), fit=True, sampling=sampling_window(snap, 0))
    return cases


def kernel_ms(fn, reps: int, name: str) -> float:
    """Mean device ms per call of fn's kernels whose name holds `name`,
    from torch.profiler's CUDA activities: for a wrapper that reads device
    values on the host (K13's exactness bound), which a CUDA graph cannot
    capture."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    if not ks:
        raise RuntimeError(f"torch.profiler saw no kernel named {name!r}")
    return sum(e.time_range.elapsed_us() for e in ks) / 1e3 / reps


def prev_scan_commit(lib, x):
    """K13 through the one-block design's C interface (`scan_commit_launch`
    with every operand an argument): the carried state cloned, then
    updated in place by the library's kernel."""
    import ctypes

    from .ops import interpod as ip
    from .ops import scan_commit as sc
    from .ops.kernel_build import ptr, raise_on_error, stream_of

    fn = lib.scan_commit_launch
    fn.argtypes = ([ctypes.c_int] * 15 + [ctypes.c_float] * (4 + sc.MAX_RESOURCES + 2)
                   + [ctypes.c_int] + [ctypes.c_void_p] * 28)
    fn.restype = ctypes.c_int
    P, N = x.shape
    st = x.state
    S, D = st.counts.shape
    dev = x.sbase.device
    out = (torch.empty(P, dtype=torch.int32, device=dev), x.node_requested.clone(),
           x.ports.clone(), st.counts.clone(), st.total.clone(), st.anti_presence.clone(),
           st.pref_sym.clone())
    terms = list(x.terms) + [(0, 0.0)] * (4 - len(x.terms))
    R = x.pod_requested.shape[1]
    ins = (x.sbase, x.order, x.pod_valid, x.pod_nominated, x.pod_requested,
           x.node_allocatable, x.slack, x.pod_port_ids, x.aff_terms, x.aff_self,
           x.anti_terms, x.pref_terms, x.pref_w, x.tsc, x.tsc_skew, x.node_domains,
           x.dom_ptr, x.dom_list, x.sel_ptr, x.sel_list)
    raise_on_error("scan_commit", fn(
        P, N, R, x.pod_port_ids.shape[1], x.aff_terms.shape[1], x.tsc.shape[1],
        x.node_domains.shape[1], S, D, x.ports.shape[1], x.flags,
        *[t for t, _ in terms], *[w for _, w in terms],
        *(list(x.fit_w100) + [0.0] * (sc.MAX_RESOURCES - R)), x.fit_rwsum, x.bal_rn,
        sum(1 << r for r, on in enumerate(x.bal_cols) if on),
        *[ptr(t.contiguous()) for t in ins], *[ptr(t) for t in out], stream_of(dev)))
    return sc.ScanResult(out[0], out[1], out[2], ip.AffinityState(*out[3:]))


def scan_with(lib, cluster=None):
    """K13's wrapper for library `lib`: the package's interface (on a
    cluster of `cluster` CTAs, default the wrapper's), or the one-block
    design's (`prev_scan_commit`) for a library without it."""
    from .ops import scan_commit as sc

    if hasattr(lib, "scan_commit_clusters"):
        kw = {} if cluster is None else {"cluster": cluster}
        return lambda x: with_library("scan_commit", lib, lambda: sc.scan_commit_cuda(x, **kw))
    return lambda x: prev_scan_commit(lib, x)


def scans_equal(a, b) -> bool:
    """Two scan commits' seven outputs equal (`torch.equal`, as the smoke's
    full-size comparison), and their claim bitmaps where VolumeBinding
    runs."""
    return (torch.equal(a.assignment, b.assignment)
            and torch.equal(a.node_requested, b.node_requested)
            and torch.equal(a.ports, b.ports)
            and states_equal(a.state, b.state)
            and (a.pv_claimed is None) == (b.pv_claimed is None)
            and (a.pv_claimed is None or torch.equal(a.pv_claimed, b.pv_claimed)))


def scan_full_inputs(dev, seed: int = 202):
    """K13's full-size ScanInputs: config #4's workload (seed 202, the
    smoke's first timed scan seed), K1's static base, packed as the scan
    cycle packs them."""
    from .core.cycle import sampling_window
    from .framework.interfaces import CycleContext
    from .framework.runtime import Framework
    from .models import SnapshotEncoder
    from .ops import scan_commit as sc
    from .ops import static_base as sb
    from .utils import synth

    fw = Framework.from_config()
    nodes, existing, pending = synth.config4_workload((seed,), N_NODES, N_EXISTING, N_PENDING)
    snap = SnapshotEncoder(device=dev).encode(nodes, pending[seed], existing)
    ctx = CycleContext(snap)
    base = sb.static_base_cuda(sb.static_base_inputs(fw, ctx, fit=True,
                                                     sampling=sampling_window(snap, 0)))
    return sc.scan_commit_inputs(fw, ctx, base, fw.extra_init(ctx))


def time_scan_variants(dev, csrc: Path, check: bool, full_plain: bool = True) -> dict:
    """K13's variants (SCAN_VARIANTS, and today's kernel on the portable 8
    CTAs) in kernel time (torch.profiler) on the full-size inputs: ms and
    us a step. With the package's own source, the kernel is first held
    against `scan_commit_plain` on its seeded edge cases and (with
    `full_plain`) at full size, and so is every variant that computes the
    same function (8 CTAs, the counts by read-modify-write)."""
    from .ops import scan_commit as sc
    from .utils import kernel_cases

    libs = build_variants("scan_commit", csrc, SCAN_VARIANTS)
    x = scan_full_inputs(dev)
    nv = int(x.pod_valid.sum())
    runs = {v: scan_with(lib) for v, lib in libs.items() if lib is not None}
    if "today" in runs and hasattr(libs["today"], "scan_commit_clusters"):
        runs["cluster: 8 CTAs"] = scan_with(libs["today"], cluster=sc.CLUSTER_PORTABLE)
    if check:
        cases = kernel_cases.scan_cases(dev)
        exact = ("today", "cluster: 8 CTAs", "cluster: counts committed by read-modify-write")
        for tag, xc in cases.items():
            want = sc.scan_commit_plain(xc)
            for v in exact:
                if v == "cluster: 8 CTAs" and xc.shape[1] > sc.MAX_NODES_PORTABLE:
                    continue  # above the portable cluster's limit
                if not scans_equal(runs[v](xc), want):
                    raise RuntimeError(f"scan_commit ({v}) differs from scan_commit_plain "
                                       f"({tag})")
        shapes = {tag: {k: v for k, v in sc.scan_shape(xc).items() if k != "layout"}
                  for tag, xc in cases.items()}
        print(f"scan_commit ({', '.join(exact)}; 8 CTAs where N <= "
              f"{sc.MAX_NODES_PORTABLE}) equal to scan_commit_plain on {len(cases)} edge "
              f"cases; launch "
              f"shapes {json.dumps(shapes)}",
              flush=True)
    if check and full_plain:
        t0 = time.time()
        want = sc.scan_commit_plain(x)
        plain_s = time.time() - t0
        for v in exact:
            if not scans_equal(runs[v](x), want):
                raise RuntimeError(f"scan_commit ({v}) differs from scan_commit_plain at "
                                   "full size")
        print(f"scan_commit ({', '.join(exact)}) equal to scan_commit_plain at full size "
              f"({nv} steps; plain {plain_s:.1f} s)", flush=True)
    valid = x.pod_valid
    fl = sc.pod_flags(x)[valid]
    nsel = (x.sel_ptr[1:] - x.sel_ptr[:-1])[valid]
    mix = {"steps": nv, "hard spread": int((fl & sc.POD_HARD > 0).sum()),
           "affinity maximum exchanged": int((fl & sc.POD_AFF_NORM > 0).sum()),
           "spread maximum exchanged": int((fl & sc.POD_SPR_NORM > 0).sum()),
           "with matched selectors": int((nsel > 0).sum()),
           "with required or anti terms": int(((x.aff_terms[..., 0] >= 0)
                                                | (x.anti_terms[..., 0] >= 0)).any(1)[valid].sum())}
    print(f"scan_commit full-size steps: {json.dumps(mix)}", flush=True)
    out = {"steps": mix}
    for v in libs:
        if libs[v] is None:
            out[v] = "not applicable"
    for v, fn in runs.items():
        ms = kernel_ms(lambda: fn(x), 3, "scan_kernel")
        out[v] = {"ms": ms, "us a step": 1e3 * ms / nv}
        print(f"  scan_commit {v:62s} {ms:.3f} ms  {1e3 * ms / nv:.3f} us a step", flush=True)
    if "today" in runs and hasattr(libs["today"], "scan_commit_clusters"):
        out["launch shape"] = {k: v for k, v in sc.scan_shape(x).items() if k != "layout"}
    return out


def time_capacity_variants(dev, csrc: Path, calls: list, check: bool) -> dict:
    """K5's variants (CAPACITY_VARIANTS) in device time on the recorded
    calls of one rounds cycle; with the package's own source, K5 first
    held against `capacity_plain` on them and on its seeded edge cases."""
    from .ops import capacity as cap

    cap_libs = build_variants("capacity", csrc, CAPACITY_VARIANTS)
    table = {"capacity": {}}
    N = calls[0][4].shape[0]
    folds = [i for i, c in enumerate(calls) if c[7] is False]
    passes = [i for i, c in enumerate(calls) if c[7] is not False]
    picks = {"round-0 pass": passes[0], "late pass": passes[-1],
             "round-0 revocation fold": folds[0]}
    shape = {}
    for tag, i in picks.items():
        s_key, _, rank_bits = calls[i][:3]
        node = s_key >> rank_bits
        live = node < N
        runs = torch.unique_consecutive(node[live], return_counts=True)[1]
        shape[tag] = {"call": i, "B": s_key.shape[0], "live": int(live.sum()),
                      "nodes with claims": int(runs.numel()),
                      "longest run": int(runs.max()) if runs.numel() else 0}
    table["capacity_calls"] = {"n": len(calls), "passes": len(passes),
                               "folds": len(folds), "picked": shape}
    print(f"capacity: {len(calls)} calls ({len(passes)} passes, {len(folds)} folds); "
          f"{json.dumps(shape)}", flush=True)
    if check:  # the package's kernels against their plain versions
        from .utils import kernel_cases

        edge = [a for a, _ in kernel_cases.capacity_cases(dev).values()]
        for c in calls + edge:
            (ak, nk), (ap, np_) = cap.capacity_cuda(*c), cap.capacity_plain(*c)
            if not (torch.equal(ak, ap) and torch.equal(nk.view(torch.int32),
                                                        np_.view(torch.int32))):
                raise RuntimeError("capacity differs from capacity_plain")
        print(f"capacity equal to capacity_plain bit for bit on the {len(calls)} calls "
              f"and {len(edge)} edge cases", flush=True)
    for v, lib in cap_libs.items():
        if lib is None:
            table["capacity"][v] = "not applicable"
            continue
        row = {}
        for tag, i in picks.items():
            row[tag] = with_library("capacity", lib, lambda: device_ms(
                lambda: cap.capacity_cuda(*calls[i]), 50))
        row["mean over the cycle's calls"] = sum(
            with_library("capacity", lib, lambda: device_ms(
                lambda: cap.capacity_cuda(*c), 10))
            for c in calls) / len(calls)
        row["round-0 pass, back to back (host-bound)"] = with_library(
            "capacity", lib, lambda: time_ms(lambda: cap.capacity_cuda(*calls[0]), 50))
        table["capacity"][v] = row
        print(f"  capacity {v:32s} " + "  ".join(f"{k} {ms:.4f} ms" for k, ms in row.items()),
              flush=True)
    return table


def time_dyn_score_variants(dev, csrc: Path, calls: list, check: bool) -> dict:
    """K15's variants (DYN_SCORE_VARIANTS) in device time on the recorded
    calls of one rounds cycle: round 0's, the mean over the later rounds'
    and over the score anchors'. The exact variants are held against the
    kernel on every call; with the package's own source the kernel is first
    held against `dyn_score_plain` on them and on `dyn_cases`."""
    from .ops import dyn_round as dr

    libs = build_variants("dyn_round", csrc, DYN_SCORE_VARIANTS)
    rounds = [c for c in calls if c[0] is not None]
    anchors = [c for c in calls if c[0] is None]
    if check:
        from .utils import kernel_cases

        edge = [x[k] for x in kernel_cases.dyn_cases(dev).values() for k in ("score", "anchor")
                if x[k] is not None]
        for c in calls + edge:
            if not torch.equal(dr.dyn_score_cuda(*c).view(torch.int32),
                               dr.dyn_score_plain(*c).view(torch.int32)):
                raise RuntimeError("dyn_score differs from dyn_score_plain")
        print(f"dyn_score equal to dyn_score_plain bit for bit on the {len(calls)} calls "
              f"and {len(edge)} edge cases", flush=True)
    want = [dr.dyn_score_cuda(*c) for c in calls]
    table = {}
    for v, lib in libs.items():
        if lib is None:
            table[v] = "not applicable"
            continue
        if v in DYN_SCORE_EXACT:
            got = with_library("dyn_round", lib, lambda: [dr.dyn_score_cuda(*c) for c in calls])
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got, want)):
                raise RuntimeError(f"dyn_score variant {v!r} differs from the kernel")
        row = {"round 0": with_library("dyn_round", lib, lambda: device_ms(
                   lambda: dr.dyn_score_cuda(*rounds[0]), 10)),
               "later rounds, mean": sum(with_library("dyn_round", lib, lambda: device_ms(
                   lambda: dr.dyn_score_cuda(*c), 10)) for c in rounds[1:]) / max(
                       len(rounds) - 1, 1),
               "anchors, mean": sum(with_library("dyn_round", lib, lambda: device_ms(
                   lambda: dr.dyn_score_cuda(*c), 20)) for c in anchors[:8]) / max(
                       min(len(anchors), 8), 1)}
        table[v] = row
        print(f"  dyn_score {v:40s} " + "  ".join(f"{k} {ms:.4f} ms" for k, ms in row.items()),
              flush=True)
    return {"dyn_score": table}


def time_pv_choice_variants(dev, csrc: Path, calls: list, check: bool) -> dict:
    """K11's variants (PV_CHOICE_VARIANTS) in device time on the recorded
    calls of one volume cycle (round 0, the mean over the calls); with the
    package's own source, K11 and its exact variants first held against
    `pv_choice_plain` on them and on `kernel_cases.pv_choice_cases`."""
    from .ops import pv_choice as k11
    from .ops import volumes

    libs = build_variants("pv_choice", csrc, PV_CHOICE_VARIANTS)
    if check:
        from .utils import kernel_cases

        edge = kernel_cases.pv_choice_cases(dev)
        inputs = list(edge.items()) + [(f"call {i}", c) for i, c in enumerate(calls)]
        for v in PV_CHOICE_EXACT:
            for tag, c in inputs:
                got = with_library("pv_choice", libs[v], lambda: k11.pv_choice_cuda(*c))
                if not torch.equal(got, volumes.pv_choice_plain(*c)):
                    raise RuntimeError(f"pv_choice ({v}) differs from pv_choice_plain ({tag})")
        print(f"pv_choice ({', '.join(PV_CHOICE_EXACT)}) equal to pv_choice_plain on "
              f"{len(calls)} recorded calls and {len(edge)} edge cases", flush=True)
    shapes = [{"B": c[0].P, "claimants": int((c[4] & (c[0].pod_vol_mode == 1).any(dim=1)).sum()),
               "MVol": c[0].pod_vol_mode.shape[1], "G": c[1].global_pv.shape[0]} for c in calls]
    out = {"calls": shapes}
    print(f"pv_choice: calls {json.dumps(shapes)}", flush=True)
    for v, lib in libs.items():
        if lib is None:
            out[v] = "not applicable"
            continue

        def fn(c, lib=lib):
            return with_library("pv_choice", lib, lambda: k11.pv_choice_cuda(*c))
        row = {"round 0": device_ms(lambda: fn(calls[0]), 20),
               "mean over the calls": sum(device_ms(lambda: fn(c), 10)
                                          for c in calls) / len(calls)}
        out[v] = row
        print(f"  pv_choice {v:80s} "
              + "  ".join(f"{k} {ms:.4f} ms" for k, ms in row.items()), flush=True)
    return out


def wide_whatif(wi, nodes: int = 512, reps: int = 9):
    """K8's inputs cut to their first `nodes` nodes, each node's victim
    slots repeated `reps` times: more than 63 pods per node, so the what-if
    takes more than one 64-prefix word (and more than one 32-bit one)."""
    return dataclasses.replace(
        wi, node_pods=wi.node_pods[:nodes].repeat(1, reps).contiguous(),
        node_domains=wi.node_domains[:nodes].contiguous(),
        winner_conf=wi.winner_conf[:, :nodes].contiguous())


def slice1_whatif_call(dev):
    """K8's inputs of the preemption pass after one rounds cycle of slice
    1's workload (config #2's pending mix on config #4's cluster, seed
    101): no affinity or spread tables."""
    from .core.cycle import build_cycle_fn, build_preemption_fn
    from .models import SnapshotEncoder
    from .ops import preemption
    from .utils import synth

    nodes, existing, pending = synth.config4_cluster_config2_pending(
        (101,), N_NODES, N_EXISTING, N_PENDING)
    snap = SnapshotEncoder(device=dev).encode(nodes, pending[101], existing)
    d = build_cycle_fn(commit_mode="rounds", outputs="latency", device=dev)(snap)
    seen = []

    def rec(x):
        seen.append(x)
        return preemption.nonresource_ok_plain(x)
    build_preemption_fn(device=dev, whatif_fn=rec)(snap, d)
    torch.cuda.synchronize()
    return seen[0]


def slice1_prefilter_call(dev):
    """K7's arguments in the preemption pass after one rounds cycle of
    slice 1's workload (seed 101)."""
    from .core.cycle import build_cycle_fn, build_preemption_fn
    from .models import SnapshotEncoder
    from .ops import preemption
    from .utils import synth

    nodes, existing, pending = synth.config4_cluster_config2_pending(
        (101,), N_NODES, N_EXISTING, N_PENDING)
    snap = SnapshotEncoder(device=dev).encode(nodes, pending[101], existing)
    d = build_cycle_fn(commit_mode="rounds", outputs="latency", device=dev)(snap)
    seen = []

    def rec(*args):
        seen.append(args)
        return preemption.prefilter_plain(*args)
    build_preemption_fn(device=dev, prefilter_fn=rec)(snap, d)
    torch.cuda.synchronize()
    return seen[0]


def time_prefilter_variants(dev, csrc: Path, calls: list, check: bool) -> dict:
    """K7's variants (PREFILTER_VARIANTS) in device time on the recorded
    call of the preemption pass after config #4's rounds cycle and on
    slice 1's (`slice1_prefilter_call`); the exact variants held against
    the kernel there, and with the package's own source K7 first held
    against `prefilter_plain` on them and on `kernel_cases.prefilter_cases`."""
    from .ops import preempt_prefilter as k7
    from .ops import preemption

    libs = build_variants("preempt_prefilter", csrc, PREFILTER_VARIANTS)
    inputs = {"config #4": calls[0], "slice 1": slice1_prefilter_call(dev)}
    if check:
        from .utils import kernel_cases

        edge = kernel_cases.prefilter_cases(dev)
        for tag, a in list(edge.items()) + list(inputs.items()):
            if not torch.equal(k7.preempt_prefilter_cuda(*a), preemption.prefilter_plain(*a)):
                raise RuntimeError(f"preempt_prefilter differs from prefilter_plain ({tag})")
        print(f"preempt_prefilter equal to prefilter_plain on {len(inputs)} inputs and "
              f"{len(edge)} edge cases", flush=True)
    want = {t: k7.preempt_prefilter_cuda(*a) for t, a in inputs.items()}
    shapes = {t: list(a[1].shape) + list(a[3].shape) for t, a in inputs.items()}
    out = {"inputs [C, R, N, MPN]": shapes}
    print(f"preempt_prefilter: inputs {json.dumps(shapes)}", flush=True)
    for v, lib in libs.items():
        if lib is None:
            out[v] = "not applicable"
            continue

        def fn(a, lib=lib):
            return with_library("preempt_prefilter", lib, lambda: k7.preempt_prefilter_cuda(*a))
        if check and v in PREFILTER_EXACT:
            for t, a in inputs.items():
                if not torch.equal(fn(a), want[t]):
                    raise RuntimeError(f"preempt_prefilter variant {v!r} differs ({t})")
        row = {t: device_ms(lambda: fn(a), 50) for t, a in inputs.items()}
        out[v] = row
        print(f"  preempt_prefilter {v:62s} "
              + "  ".join(f"{k} {ms:.4f} ms" for k, ms in row.items()), flush=True)
    return out


def time_whatif_variants(dev, csrc: Path, calls: list, check: bool) -> dict:
    """K8's variants (WHATIF_VARIANTS) in device time on the recorded call
    of the preemption pass after config #4's rounds cycle, on slice 1's
    (no affinity tables, `slice1_whatif_call`) and on the first one widened
    to 72 pods a node (`wide_whatif`); the exact variants held against the
    kernel there, and with the package's own source K8 first held against
    `nonresource_ok_plain` on them and on `kernel_cases.whatif_cases`."""
    from .ops import preempt_whatif as k8
    from .ops import preemption

    libs = build_variants("preempt_whatif", csrc, WHATIF_VARIANTS)
    inputs = {"config #4": calls[0][0], "slice 1": slice1_whatif_call(dev),
              "config #4, 72 pods a node": wide_whatif(calls[0][0])}
    if check:
        from .utils import kernel_cases

        edge = kernel_cases.whatif_cases(dev)
        for tag, x in list(edge.items()) + list(inputs.items()):
            if not torch.equal(k8.preempt_whatif_cuda(x), preemption.nonresource_ok_plain(x)):
                raise RuntimeError(f"preempt_whatif differs from nonresource_ok_plain ({tag})")
        print(f"preempt_whatif equal to nonresource_ok_plain on {len(inputs)} inputs and "
              f"{len(edge)} edge cases", flush=True)
    want = {t: k8.preempt_whatif_cuda(x) for t, x in inputs.items()}
    shapes = {t: list(x.winner_conf.shape) + [x.node_pods.shape[1] + 1]
              for t, x in inputs.items()}
    out = {"inputs [C2, N, MPN+1]": shapes}
    print(f"preempt_whatif: inputs {json.dumps(shapes)}", flush=True)
    for v, lib in libs.items():
        if lib is None:
            out[v] = "not applicable"
            continue

        def fn(x, lib=lib):
            return with_library("preempt_whatif", lib, lambda: k8.preempt_whatif_cuda(x))
        if check and v in WHATIF_EXACT:
            for t, x in inputs.items():
                if not torch.equal(fn(x), want[t]):
                    raise RuntimeError(f"preempt_whatif variant {v!r} differs ({t})")
        row = {t: device_ms(lambda: fn(x), 20) for t, x in inputs.items()}
        out[v] = row
        print(f"  preempt_whatif {v:75s} "
              + "  ".join(f"{k} {ms:.4f} ms" for k, ms in row.items()), flush=True)
    return out


def time_static_base_variants(dev, csrc: Path, check: bool) -> dict:
    """K1's variants (STATIC_BASE_VARIANTS) by CUDA events, best of three
    turns, on slice 1's and the volume phase's inputs beside a fill of the
    plane; with the package's own source, K1 first held against
    `static_base_plain` on them and on its seeded edge cases."""
    from .ops import static_base as sb

    sb_libs = build_variants("static_base", csrc, STATIC_BASE_VARIANTS)
    table = {"static_base": {}}
    cases = static_base_cases(dev)
    if check:
        from .utils import kernel_cases

        for x in list(cases.values()) + list(kernel_cases.static_base_edge_inputs(dev).values()):
            k_out, p_out = sb.static_base_cuda(x), sb.static_base_plain(x)
            if not torch.equal(k_out.view(torch.int32), p_out.view(torch.int32)):
                raise RuntimeError("static_base differs from static_base_plain")
        print("static_base equal to static_base_plain bit for bit on both cases and the "
              "edge cases", flush=True)
    for tag, x in cases.items():
        P, N = x.shape
        fill = device_ms(lambda: torch.empty((P, N), device=dev).fill_(-1e9), 20)
        table["static_base"].setdefault("torch.empty(P, N).fill_(-1e9)", {})[tag] = fill
        print(f"  static_base {tag} [{P}, {N}] fill floor {fill:.4f} ms", flush=True)
    # K1 runs 0.2-2 ms a call, far longer than its wrapper on the host:
    # CUDA events around eager calls, the variants in turn, best of 3 turns
    built = {v: lib for v, lib in sb_libs.items() if lib is not None}
    best: dict = {v: {} for v in built}
    for _ in range(3):
        for v, lib in built.items():
            for tag, x in cases.items():
                ms = with_library("static_base", lib, lambda: time_ms(
                    lambda: sb.static_base_cuda(x), 10))
                best[v][tag] = min(ms, best[v].get(tag, ms))
    for v in sb_libs:
        row = best.get(v, "not applicable")
        table["static_base"][v] = row
        if isinstance(row, dict):
            print(f"  static_base {v:32s} "
                  + "  ".join(f"{k} {ms:.4f} ms" for k, ms in row.items()), flush=True)
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--no-full-plain", action="store_true",
                    help="skip K13's full-size comparison with its plain version "
                         "(about 70 s; chip_smoke.py makes it too)")
    ap.add_argument("--kernels", default="all",
                    help="comma list of sections: small, preempt_claim, affinity_update, "
                         "guard_sweep, pv_fold, pv_choice, preempt_whatif, preempt_prefilter, "
                         "dyn_score, "
                         "capacity, static_base, rejects (K16 and K17), scan_commit "
                         "(default all)")
    args = ap.parse_args(argv)
    want = set(args.kernels.split(",")) if args.kernels != "all" else None

    def on(name):
        return want is None or name in want

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from .ops import kernel_build as kb

    dev = torch.device("cuda")
    csrc = args.csrc or kb.CSRC_DIR
    smi = _smi()
    print(f"device: {smi} | csrc {csrc}", flush=True)
    table = {"device": smi, "csrc": str(csrc)}
    own = csrc == kb.CSRC_DIR
    out = args.out or kb.BUILD_DIR / "kernel_variants.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    if on("scan_commit"):
        table["scan_commit"] = time_scan_variants(dev, csrc, own, not args.no_full_plain)
        out.write_text(json.dumps(table, indent=1))
    if any(on(k) for k in ("small", "preempt_claim", "affinity_update", "capacity",
                           "guard_sweep", "pv_fold", "dyn_score", "pv_choice",
                           "preempt_whatif", "preempt_prefilter")):
        small = record_small_calls(dev)
        print("small kernels on recorded main-path calls: "
              + json.dumps({k: len(v) for k, v in small.items()}), flush=True)
        if on("small"):
            table["small kernels"] = time_small_kernels(small)
            out.write_text(json.dumps(table, indent=1))
        if on("preempt_claim"):
            table["preempt_claim"] = time_claim_variants(dev, csrc, small["preempt_claim"], own)
        if on("affinity_update"):
            table["affinity_update"] = time_affinity_update_variants(
                dev, csrc, small["affinity_update"], own)
        if on("guard_sweep"):
            table["guard_sweep"] = time_guard_sweep_variants(dev, csrc, small["guard_sweep"],
                                                             own)
        if on("pv_fold"):
            table["pv_fold"] = time_pv_fold_variants(dev, csrc, small["pv_fold"], own)
        if on("pv_choice"):
            table["pv_choice"] = time_pv_choice_variants(dev, csrc, small["pv_choice"], own)
        if on("preempt_whatif"):
            table["preempt_whatif"] = time_whatif_variants(dev, csrc, small["preempt_whatif"],
                                                           own)
        if on("preempt_prefilter"):
            table["preempt_prefilter"] = time_prefilter_variants(
                dev, csrc, small["preempt_prefilter"], own)
        if on("dyn_score"):
            table.update(time_dyn_score_variants(dev, csrc, small["dyn_score"], own))
        out.write_text(json.dumps(table, indent=1))
        calls = small.pop("capacity")
        del small
        if on("capacity"):
            table.update(time_capacity_variants(dev, csrc, calls, own))
        del calls
    if on("static_base"):
        table.update(time_static_base_variants(dev, csrc, own))
        out.write_text(json.dumps(table, indent=1))
    if on("rejects"):
        table.update(time_reject_variants(dev, csrc, own))
    for src, text in kb.build_logs.items():
        usage = [ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln]
        if src in VARIANT_OF:
            print(f"  ptxas {VARIANT_OF[src]}: " + " | ".join(usage), flush=True)
    out.write_text(json.dumps(table, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
