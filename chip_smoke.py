#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`k8s_scheduler_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py [--prev-csrc DIR]

(`--durable-child DIR` is internal: phase 12 starts the script again with
it, as the active of its failover check; so is `--compile-child DIR
--compile-role cold|warm`, phase 13's two processes on one kernel cache.)

Drives the port's main path — `SnapshotEncoder.encode` then the rounds-
engine latency cycle `build_cycle_fn(commit_mode="rounds", outputs=
"latency")(snapshot)`, and the scan engine's (`commit_mode="scan"`,
`build_cycle_fn`'s default), then the full outputs (`outputs="full"`,
`build_cycle_fn`'s default) and the diagnosis program — on
three workloads at BASELINE config #4's cluster size (5000 nodes, 12000
running pods, 10000 pending pods, padded P=16384, N=8192):

  slice 1  config #2's constraint mix on the pending side (node selectors,
           taints and tolerations; no inter-pod affinity);
  affinity config #4's own workload: running pods with inter-pod affinity
           and topology spread, pending pods with required affinity,
           anti-affinity, spread, selectors, tolerations, four priorities;
           the preemption phase then runs DefaultPreemption after each of
           its cycles, which makes config #4 whole, and the scan phase runs
           the same snapshots through the scan engine;
  volumes  config #4's workload with local and zonal persistent volumes,
           cycles and preemption, in the rounds engine and in the scan;

and the device-carry latency path serving runs (`encode_packed`, the
carried static base, the packed cycle and preemption, and off the
decision path `build_diagnosis_fn`) over churn frames of config #4's
workload, with and without volumes (phases 8 and 9), and the serving host
over them: the port's `Scheduler` driven through its informer handlers
and `schedule_cycle()` (phase 10), then with HTTP extenders and their
verdicts through every program (phase 11), then with durable state, the
admission front door, spans, the black box and a fault plan, and a
failover to a standby (phase 12), then a warm restart from the persistent
kernel cache, the profiling pass, the watchtower and the fuzz
differential against the oracle (phase 13).

Phases:

  1. device   — the card's name and power limit;
  2. build    — nvcc builds every csrc/*.cu at once (one process per
                source; with --prev-csrc, also an earlier design's
                sources of PREV_KERNELS (K9, K4, K6, K12, K11, K8,
                K7, and K1 / K14 / K15 with the earlier K16 / K17 in
                `static_base.cu` and `dyn_round.cu`),
                timed beside the kernels as prev_device_ms), Triton
                compiles K2 `claim_pass` meanwhile; then K5 `capacity`, K1
                `static_base`, K9 `preempt_claim`, K4 `affinity_update` and
                K13 `scan_commit` against their plain
                versions, bit for bit, on the seeded edge cases of
                `utils/kernel_cases.py` (node runs across 32 and 256 claims,
                every claim dead, R = 1 and 8, a revocation fold; each
                filter bit alone, 0-3 score terms, N = 8 and 13, misaligned
                rows, P = 65537; K9 at N = 13, 8193 and 8199, the winner in
                the last node slice, equal keys in two slices, one node
                taken by consecutive ranks, PDB budgets spent, ports that
                block, n_live 0 and C2, R = 1 and 8, MB = 4, wrapping
                priority sums; K4 with nodes without a domain, empty term
                slots, one selector for many pods, preferred sums near
                2^24, MA = 1 and 4, B = 13, no accepted pod, no inter-pod
                affinity; K13 at N = 13, 8193 and 8199, the winner in the
                last slice, equal best scores in two slices, a -0.0 / +0.0
                tie, nominated nodes in another slice and infeasible, a pod
                no node fits, a hard spread minimum in other slices' zone,
                matched selectors counted in a zone other slices read,
                affinity bootstrapped by total == 0, anti-affinity and host
                ports between consecutive pods, pad pods interleaved, R = 1
                and 8, and with volumes: V = 31, 32 and 33 (the claim
                bitmap's word edges), a node with an empty PV list, only
                global PVs, two pods contending for one PV, two 8-slot pods
                under the dominance groups, dynamic provisioning and
                requirement id -2, a nominated node the volume mask
                rejects, a gang that unwinds after claiming (the claim
                bitmaps equal too); each case's cluster and slice printed;
                K14 `dyn_mask`
                and K15 `dyn_score`, K15 also as the score anchor, on
                `dyn_cases`: zero allocatable, an exact fit at the slack,
                full nodes, R = 1 and 8, Q = 0, pad port slots, every row
                NEG_INF, B = 1 and 13, N = 13 and 8199, no term, a lone
                BalancedAllocation, weights other than 1, R = 1 under both
                resource scores, BalancedAllocation over one of four
                resources); K11 `pv_choice` on `pv_choice_cases` (a node
                list over the kernel's register cap, global PVs, MVol = 1
                and 8, every PV claimed, inactive rows, node_of out of
                range, dynamic provisioning, capacities at the + 1e-3
                edge; three draws each) and K8 `preempt_whatif` on
                `whatif_cases` (72 pods a node, nodes without a domain,
                candidates without terms, winner ports, affinity or spread
                alone, ScheduleAnyway, counts at their thresholds, the
                bootstrap rule) and K7 `preempt_prefilter` on
                `prefilter_cases` (no victim below the priority, every
                candidate infeasible, cand_ok false, the only fit on the
                last node at N = 8199 and 13, an exact fit at equality,
                negative free room, R = 1 and 8, MPN = 1 and 16, C = 1 and
                256, node_valid false on the only fit, prefix rooms out of
                order, tables read from L2); K16 `static_rejects` (with
                and without its survivors plane) on
                `static_reject_cases` and K17 `dyn_rejects` on
                `dyn_reject_cases` (a filter without a mask between two
                with one, every node rejected by the first filter, rows all
                false and all true, F = 1, 9 and 32, columns out of the
                filters' order, one part of each kind alone, a start mask
                all false, N = 8, 13, 31, 32, 33 and 8199, misaligned rows,
                P = 2049, pods pinned to nodes 31 and 32, Ts = 33, a row
                whose every node survives, a fit part alone at N = 33), and K13's
                full mode on the scan cases' full inputs (the per-step
                rejects too);
  3. slice 1  — a warm cycle, the same cycle on the plain versions (same
                decisions required; K14 / K15 held against their plain
                versions on every call of it), K1/K2 against their plain versions
                with timings (K1 beside `torch.empty(P, N).fill_(-1e9)`),
                then three timed cycles whose placements are
                checked (capacity, static masks, unplaced => infeasible),
                launch counts read around them;
  4. affinity — the same on config #4's workload, with K3-K6 held against
                their plain versions at full size (bit-equal; K3 also on a
                preferred / ScheduleAnyway variant; K4 on every round and
                K5 on every pass and revocation fold of the cycle, timed on
                the device), cycles
                under resource scores over three resources and under the
                fit score over them as the one dynamic score against their
                plain-versions cycles, K1 on the phase's snapshot, and each
                timed placement also checked for anti-affinity (both
                directions), required affinity or its bootstrap, and
                DoNotSchedule skew at the round each pod was placed in;
                K14 / K15 on every call of the cycle, timed on round 0's
                (device time, plain, bound, the two stages' round-0 peak
                memory against the plain versions'), and round 0 of a
                variant whose pods name host ports (NodePorts' fold, one
                `dyn_batched`, `rounds_commit(max_rounds=1)`) under
                `torch.cuda.set_sync_debug_mode("error")`;
  5. preemption — `build_preemption_fn()` (K7 `preempt_prefilter`, K8
                `preempt_whatif`, K9 `preempt_claim`) on the affinity
                phase's snapshots and decisions: the kernels' preemption
                equal to the plain-versions preemption, K7-K9 each equal to
                its plain version at full size on each seed's real inputs
                (K8 also with them cut to 512 nodes of 72 pods, and timed
                both ways against the earlier design with --prev-csrc; K7
                timed in device time on config #4's call, slice 1's and the
                PDB variant's, beside the earlier design),
                and every nomination valid (unplaced, may preempt, not
                gang-dropped; victims a contiguous lower-priority run on its
                node that makes it fit after the earlier nominations there;
                static gate; at most scan_budget nominations); at least one
                preemptor; then the same on a variant with one PDB per app
                (GP = 500), counting nominations that needed a violation,
                and on slice 1's workload (no affinity tables);
  6. scan     — the affinity phase's snapshots through `build_cycle_fn(
                commit_mode="scan")`: K13 `scan_commit` equal to its plain
                version (`scan_commit_plain`) on the packed inputs of one
                seed at full size (assignment, node_requested, the port
                bitmap and the four affinity tables bit-equal; both
                timed; the kernel alone by torch.profiler, its us a step
                and its cluster size printed, and with --prev-csrc the
                earlier design's, equal too), and on a seeded variant of
                the same cluster with the pending set cut to its first 2048
                pods and given
                preferred terms, ScheduleAnyway constraints, nominated
                nodes and host ports (also under a profile whose one
                dynamic score is BalancedAllocation, and under resource
                scores over three resources, and over four on 512 pods), three timed cycles with
                one K13 launch each whose placements are checked (capacity,
                static masks; anti-affinity both ways, required affinity or
                its bootstrap and DoNotSchedule skew, each at the pod's own
                step, by a host replay in rank order), DefaultPreemption after
                each equal to the plain versions' pass (and K9 to
                `claim_loop_plain` on each pass) with every nomination
                valid, a second scan cycle over the pods one seed's scan
                left unplaced (its placements running), and one scan cycle
                on slice 1's workload (K13 equal to its plain version on
                its packed inputs; resource-
                only dynamic filters: unplaced => infeasible against the
                final state);
  7. volumes  — config #4's workload with local and zonal persistent
                volumes (`utils/synth.config4_volumes`: two local PVs per
                node, a quarter of them bound to running pods, 1000 pre-
                bound zonal pairs; 40% of the pending pods mount one or two
                PVCs): the kernels' cycle equal to the plain-versions
                cycle, K1 `static_base` with VolumeBinding's static
                mask as its operand equal to its plain version at full
                size, K3 `interpod_terms`, K10 `volume_mask` (static and
                unbound) equal to its plain version on round 0's inputs,
                K11 `pv_choice` and K12 `pv_fold` on every round's (K12
                also on a contended batch that takes several passes; K5,
                K14 and K15 on every call of the cycle; K11 timed on round
                0 and over the rounds, with --prev-csrc beside the earlier
                design), three timed cycles whose
                placements are checked as in the affinity phase and for
                volumes (bound claims on their PVs' nodes; a matching of
                the claimed PVs to placed unbound slots: no PV claimed
                twice, every slot served statically or dynamically), K10
                once per cycle plus once per round, K11 and K12 once per
                round, then DefaultPreemption after each cycle (K10 once
                per pass), equal to its plain versions (K9 to
                `claim_loop_plain` on each pass), nominations valid
                and through the volume gate; then the scan leg: the gang
                edge case's full scan cycle equal to the plain versions'
                (its claims released by one K12 refold), K13's volume
                instance equal to `scan_commit_plain` (assignment,
                node_requested, ports, the affinity tables and the claim
                bitmap) on seed 202's first 2048 pending pods with full
                N and V, in the latency mode and in the full mode (the
                VolumeBinding column too), its us a step
                at full size with
                VolumeBinding on and off on one snapshot, three timed scan
                cycles with one launch each of the volume instance whose
                placements are checked as the scan phase's and for volumes
                from the scan's own claim bitmap, and DefaultPreemption
                after each equal to the plain versions';
  8. carry    — the device-carry latency path that serving runs, on config
                #4's workload and again with `config4_volumes`: a full
                `SnapshotEncoder.encode_packed` (the encoder sized by
                `pad_existing` and `pad_pods_per_node` for the phase; one
                upload a buffer from its pinned arena),
                `build_stable_state_fn`, `CarryKeeper` (carry_init: K1 over
                every row), then 4 churn frames, each binding the previous
                frame's first 500 placements into the running set (their
                slots refilled by fresh draws of config #4's mix) and
                replacing 200 other slots, each encoded by the delta path
                with the existing-set fold (a frame that takes the full
                path fails the phase unless a pad or interning rule of the
                reference demands it) and by a second encoder that full-
                encodes every frame: the two frames' host buffers equal
                bit for bit, the delta's dirty slots a superset of the full
                encode's row comparison, each frame's path, delta_profile
                and encode ms beside the full encode's logged; the keeper's update (K1 on
                the dirty bucket's rows, scattered into the carried static
                base), `build_packed_cycle_carry_fn` and
                `build_packed_preemption_fn`, launch counts read around
                them; on every frame the carried sbase / mp equal to a
                fresh carry_init bit for bit, the decisions equal to
                `build_cycle_fn(commit_mode="rounds")` on the frame's
                snapshot and the preemption equal to `build_preemption_fn`'s;
                dirty counts, encode and upload ms, the carry's, cycle's
                and preemption's events ms against the fresh cycle's, and
                (torch.profiler) carry_init against the update and the
                cycles' device time and busy share; on the last frame the
                diagnosis program (phase 9);
  9. full outputs and diagnosis — `build_cycle_fn(outputs="full")` at
                config #4 (seed 202) in the rounds engine, with and without
                `config4_volumes`: K16 over every pod row and K17 over the
                final window of unplaced pods, one launch each; every
                CycleResult field equal to the plain-versions full cycle's,
                the decisions equal to the latency cycle's,
                sum(accepted_per_round) equal to the placements before the
                gang unwind; events and device ms (torch.profiler) against
                the latency cycle; in the scan engine, K13's full mode:
                decisions equal to the latency cycle's at full size, the
                kernel's us a step against the latency instance's in the
                same call, and equal to its plain version on the 2048-pod
                variant (the plain scan at full size would take a minute);
                then, on the last carry frame of each variant,
                `build_diagnosis_fn` fed the carry cycle's assignment,
                node_requested and pv_claimed: equal to the program on the
                plain versions, rows nonzero only for valid unplaced pods,
                one K16 (its survivors plane the window's start mask) and
                one K17 launch a 2048-pod window and no K1, the first
                three unplaced pods' FailedScheduling lines, events ms a
                frame and a window; K16 and K17 held against their plain
                versions on every recorded call of the full cycles and
                the diagnosis windows, and timed by CUDA-graph replays on
                the full cycle's and a diagnosis window's calls (with
                --prev-csrc beside the earlier design on the same calls);
 10. serving  — the port's `Scheduler` over config #4's workload (seed
                202) through the informer handlers (5000 `on_node_add`,
                12000 bound `on_pod_add`, 10000 pending `on_pod_add`), a
                logical clock, and a binder that confirms each bind: 5
                `schedule_cycle()`s on the carry path with 500 arrivals
                and 200 deletes of running pods between cycles, then 2
                cycles of a second Scheduler with `commitMode: scan` (the
                packed path); each beside a `forced_sync=True` twin fed
                the same events, whose bindings, nominations, evictions
                and CycleStats must be equal; every cycle's bindings
                checked by `check_placements` on its frame; the hand
                kernels' names in torch.profiler's trace of one cycle;
                the decision path's host syncs (`set_sync_debug_mode`
                from the cycle's start to its decision fetch) listed by
                site, none allowed in the serving layer itself; per cycle
                the wall ms and its split (encode, dispatch, decision
                fetch, apply and bind, diagnosis lag), the carry update's
                and cycle's events ms, the fetch bytes and placed /
                unschedulable / nominated; launch counts over the serving
                cycles (`serving_launches` in the kernel table); after
                each Scheduler's cycles the port's HTTP server on port 0
                answers /healthz, /metrics and /debug/flightrecorder with
                200, and /metrics' scheduled attempts equal the binds the
                stand-in API server recorded.
 11. extenders — HTTP-extender verdicts through every program, on config
                #4 (seed 202) with seeded verdict planes (7 in 8 pairs pass,
                scores 0-10 x 3, and x 200000 past K1's 1e6 clip): K1's
                extender instances (rounds and scan, both score scales), K18
                `extender_merge` (verdicts and the sampling window, each
                alone, ragged tiles) and K16's per-pod base (a 2048-row
                window, N=13 and 8176 too) held bit for bit against their
                plain versions at 16384 x 8192 and timed; the planes'
                upload timed; `build_cycle_fn` with the verdicts in both
                engines (both scales) against its twin on K1's plain
                version, every placement on a node the filter passed; then
                the serving leg: a webhook extender in a child process
                (filter: a hash of pod and node not 0 mod 8; prioritize: the
                hash mod 11, weight 3) and the port's `Scheduler` over
                config #4's 5000 nodes and 12000 running pods, with a cut
                of the pending set (EXT_PENDING pods and EXT_HUGE that fit
                nowhere): 1 + EXT_CHURN carry-path cycles with
                `carryVerdicts` (`ExtenderVerdictKeeper`: a sweep, then
                updates of the replicas that arrive) and 2 packed-path
                cycles without, each beside a `forced_sync` twin, every
                binding valid and on a node the filter passed, the
                diagnosis from each window's node_valid & emask.
 12. durable  — the port's `Scheduler` on the carry path over config #4
                (seed 202): 5000 nodes and 12000 running pods through the
                informer handlers, the 10000 pending pods submitted through
                `AdmissionController.submit` in 4 batches, one before each
                of 4 cycles, binds confirmed by `self_confirming_front_door`'s
                informer play; the active with a `DurableState` in a
                temporary directory (snapshotIntervalSeconds 0), spans at
                rate 1.0, a `BlackBox` under <stateDir>/blackbox and the plan
                DURABLE_PLAN (a transport `device_error` in cycle 2, a 20 ms
                `fetch_delay` in cycle 3), its decisions equal cycle by
                cycle to a twin's without any of them (run first, in the
                same call), the transport fault absorbed by the retry, every
                binding valid, no pod bound twice, no acked pod lost; then
                the same active in a child process on the card
                (`--durable-child`), SIGKILLed after its second cycle's
                flush, its digests equal to the in-process active's; a
                standby `Scheduler` on its directory restores the child's
                last digest in its constructor, requeues the in-flight pods
                and runs the rest of the backlog equal to the twin, under
                the same checks; the `stateless` rung forced at the end
                seals a clean snapshot and dumps a bundle that
                `load_bundle` reads. Printed: journal records and bytes,
                journaling ms on the serving thread a cycle, the snapshot's
                ms, the standby's restore ms, submit-to-ack and
                submit-to-bind p50 / p99, the cycles' wall against the
                twin's, the bundle's bytes.
 13. compile  — (a) two child processes (`--compile-child`) on one empty
                `compileCacheDir`, each a `Scheduler` over config #4 (seed
                202) that loads every CUDA library (a thread each) and the
                Triton kernels, then serves COMPILE_CYCLES carry cycles
                and prints a digest of each cycle's bindings: the cold one,
                with `faultSpec` cache_torn@n=1, runs nvcc for all 15
                sources and lands one torn entry; the warm one must run
                nvcc once (the torn entry, refused loudly), take the other
                14 from the cache, build no Triton kernel and give the cold
                one's digests. (b) In the warm one: `profile_cycle(
                repeats=3)` (per-plugin ms on the card, both histograms
                filled), `trace_cycle` on a third carry cycle (the trace's
                bytes and device-kernel events), the watchtower armed
                before the cycles (`arm_watchtower`, the built-in rules
                scaled by 0.01), its three endpoints answering 200, and a
                black-box bundle with `alerts` and `metrics_history`. (c)
                Here: the clean corpus files replay clean on the card, the
                tiebreak file with its bug fails with `divergence/binds`
                through K13's last-max instance (`scan_commit_tie_last`;
                it and K9's, built together under the bug, are first held
                against the mutated plain versions on K13's and K9's
                seeded edge cases), the tenant file is refused (ROADMAP
                A12), then seeded `run_case` traces (plain, durable,
                incremental in turn) for FUZZ_SECONDS with zero failures.
                The first log line of phase 1 says whether grpc and
                google.protobuf import on this machine.
 14. cli      — the port's CLI as child processes on the card, `python -m
                k8s_scheduler_tpu_torch` (runpy under `--cli-child`, which
                counts the multi-cycle batches' launches and host syncs),
                each fed over gRPC by the port's `SchedulerAgent`: slice 1's
                cluster (5000 nodes, 12000 running pods, Update RPCs of
                1000 nodes or 2000 pods), then CLI_GROUPS arrival groups of
                its pending mix (250-2500 pods, one Cycle RPC each, then two
                idle ones), a gang of 8 (minMember 4) split 5 | 3 over
                groups 1 and 2; three children in turn, `--multi-cycle-k 1`,
                `--multi-cycle-k 4 --speculative-dispatch 0` and `4 ... 1`,
                each with a state dir (a black box) and the watchtower.
                Checked: the three bind streams equal each other and an
                in-process `forced_sync` K = 1 twin's; every binding valid
                (capacity, selectors, taints; the gang whole); a batch ran
                more than one inner cycle and the batches launched K1, K2,
                K5, K6, K14, K15; the speculative child adopted a batch;
                no host sync inside the batch loop's lines or the serving
                layer; /healthz 200 and ok, /metrics with the multi-cycle
                families; SIGTERM exits 0 with a black-box bundle. Printed:
                time to serving, gRPC Update / Cycle ms p50 / p99, each
                Cycle's ms, inner cycles run a batch, device ms an inner
                cycle, the speculation ledger, the batches' launches
                (`multicycle_launches` in the kernel table).

The second-to-last lines are the kernel table (JSON; each kernel's `ms`
by CUDA events around eager wrapper calls, its `device_ms` from a CUDA
graph of the calls replayed between events — K13's from torch.profiler)
and the card's `nvidia-smi` name and power limit; the last line is the
result JSON.
Exits non-zero, printing no result, without a CUDA device, without the
port's package beside it, or when any check fails.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32 (non-tensor)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
SCAN_CUT = 2048  # pending pods of the scan kernel's variant comparisons
RESOURCES_3 = ("cpu", "memory", "ephemeral-storage")  # a weight sum of 3
N_NODES, N_EXISTING, N_PENDING = 5000, 12000, 10000
WARM_SEED, TIMED_SEEDS = 101, (102, 103, 104)
AFF_WARM_SEED, AFF_TIMED_SEEDS = 201, (202, 203, 204)
PDB_SEED = 17  # config4_pdbs draw of the PDB variant
EXACT_F32 = 2**24  # integer-valued f32 sums are exact below this
# timed against --prev-csrc
CARRY_FRAMES, CARRY_REPLACED, CARRY_BOUND = 4, 200, 500  # the carry phase's churn
CARRY_SEED = 205
CARRY_MPN = 16  # pad_pods_per_node: the running pods a node holds after the churn
PREV_KERNELS = ("preempt_claim", "affinity_update", "guard_sweep", "pv_fold",
                "pv_choice", "preempt_whatif", "preempt_prefilter", "static_base",
                "dyn_round")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(torch, fn, reps: int) -> float:
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(nbytes_: int, ops: int) -> tuple[float, str]:
    """(least ms on the card, what bounds it): bytes over HBM bandwidth vs
    operations over the f32 peak."""
    tb, to = nbytes_ / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"


def scan_bytes(torch, x, rk) -> int:
    """Bytes K13 must move on this run's data, each read once and each
    written once: the static base rows and the per-pod operands of the
    valid pods (the kernel skips pad pods), the node tables, and of the
    carried affinity state only the rows the valid pods' terms and matched
    selectors read or write."""
    P = x.shape[0]
    valid = x.pod_valid
    nv = int(valid.sum())
    per_pod = (x.sbase, x.order, x.pod_nominated, x.pod_requested, x.pod_port_ids,
               x.aff_terms, x.aff_self, x.anti_terms, x.pref_terms, x.pref_w, x.tsc,
               x.tsc_skew)
    b = sum(nbytes(t) // P * nv for t in per_pod) + nbytes(x.pod_valid)
    b += nbytes(x.node_allocatable, x.node_requested, x.slack, x.ports, x.node_domains,
                x.dom_ptr, x.dom_list, x.sel_ptr, x.sel_list, x.state.total)
    b += nbytes(rk.assignment, rk.node_requested, rk.ports, rk.state.total)

    def sels(t):  # the selectors of the valid pods' terms
        t = t[valid]
        return set(t[t >= 0].tolist())

    matched = set(x.sel_list.tolist())
    term_sels = (sels(x.aff_terms[..., 0]) | sels(x.anti_terms[..., 0])
                 | sels(x.pref_terms[..., 0]) | sels(x.tsc[..., 1]))
    anti_w, pref_w = sels(x.anti_terms[..., 0]), sels(x.pref_terms[..., 0])
    st = x.state
    row = {n: nbytes(getattr(st, n)) // getattr(st, n).shape[0]
           for n in ("counts", "anti_presence", "pref_sym")}
    # counts: read for terms, written for matched selectors; the anti and
    # preferred tables: read for matched selectors, written for terms
    b += row["counts"] * (len(term_sels | matched) + len(matched))
    b += row["anti_presence"] * (len(matched | anti_w) + len(anti_w))
    b += row["pref_sym"] * (len(matched | pref_w) + len(pref_w))
    return b


def same_decisions(torch, a, b) -> dict:
    return {f: torch.equal(getattr(a, f), getattr(b, f))
            for f in ("assignment", "node_requested", "unschedulable", "gang_dropped")}


class Recorder:
    """Wraps a function: records the arguments of chosen calls (by call
    index; `keep=None`: every call) and the latest result, and returns the
    result."""

    def __init__(self, fn, keep=(0,)):
        self.fn, self.calls, self.args = fn, 0, {}
        self.keep = None if keep is None else set(keep)
        self.last = None

    def recorded(self) -> bool:
        return set(self.args) == (set(range(self.calls)) if self.keep is None
                                  else self.keep)

    def __call__(self, *args):
        if self.keep is None or self.calls in self.keep:
            self.args[self.calls] = args
        self.calls += 1
        self.last = self.fn(*args)
        return self.last


def resource_profile(resources):
    """The default profile with NodeResourcesFit and BalancedAllocation
    scoring `resources`."""
    from k8s_scheduler_tpu_torch.config import Profile, SchedulerConfiguration

    args = {"score_resources": tuple(resources)}
    return SchedulerConfiguration(profiles=[Profile(plugin_config={
        "NodeResourcesFit": args, "NodeResourcesBalancedAllocation": args})])


def fit_only_profile(resources):
    """The default profile with NodeResourcesFit scoring `resources` as the
    one dynamic score, the static scores on."""
    from k8s_scheduler_tpu_torch.config import (PluginSet, Plugins, Profile,
                                                SchedulerConfiguration)

    score = PluginSet(disabled=["NodeResourcesBalancedAllocation", "InterPodAffinity",
                                "PodTopologySpread"])
    return SchedulerConfiguration(profiles=[Profile(
        plugins=Plugins(score=score),
        plugin_config={"NodeResourcesFit": {"score_resources": tuple(resources)}})])


def preferred_variant(torch, snap, gen):
    """`snap` with preferred inter-pod terms (the pod's first required
    affinity term, and in 30% of pods that term again as a duplicate slot,
    else its first anti term), integer weights in [-100, 100], and half its
    spread constraints ScheduleAnyway — seeded, on the card."""
    from k8s_scheduler_tpu_torch.models import encoding as enc_mod

    dev = snap.device
    dup = torch.rand(snap.P, generator=gen, device=dev) < 0.3
    first = snap.pod_aff_terms[:, 0]
    pref = snap.pod_aff_terms.clone()
    pref[:, -1] = torch.where(dup[:, None], first, snap.pod_anti_terms[:, 0])
    soft = torch.rand(snap.pod_tsc.shape[:2], generator=gen, device=dev) < 0.5
    tsc = snap.pod_tsc.clone()
    tsc[..., 2] = torch.where(soft, enc_mod.WHEN_SCHEDULE_ANYWAY, tsc[..., 2])
    w = torch.randint(-100, 101, snap.pod_pref_aff_w.shape, generator=gen, device=dev)
    bound_ = enc_mod.pref_raw_bound(pref.cpu(), w.float().cpu(), tsc.cpu(),
                                    snap.exist_pref_aff.cpu(), snap.exist_pref_aff_w.cpu())
    return dataclasses.replace(snap, pod_pref_aff=pref, pod_tsc=tsc,
                               pod_pref_aff_w=w.float(), pref_raw_bound=bound_)


def scan_variant(torch, snap, gen):
    """`preferred_variant(snap)` with, besides, a nominated node for 10% of
    the pods and one host port (of the Q pending port ids) for 5% — the
    scan kernel's paths config #4's workload leaves cold; seeded, on the
    card."""
    dev = snap.device
    P, n_real = snap.P, int(snap.num_nodes)
    v = preferred_variant(torch, snap, gen)
    i32 = torch.int32
    nom = torch.where(torch.rand(P, generator=gen, device=dev) < 0.1,
                      torch.randint(0, n_real, (P,), generator=gen, device=dev, dtype=i32),
                      torch.full((), -1, dtype=i32, device=dev))
    ports = snap.pod_port_ids.clone()
    port = torch.randint(0, snap.num_distinct_ports, (P,), generator=gen, device=dev,
                         dtype=i32)
    ports[:, 0] = torch.where(torch.rand(P, generator=gen, device=dev) < 0.05, port,
                              ports[:, 0])
    return dataclasses.replace(v, pod_nominated=nom, pod_port_ids=ports)


def check_placements(torch, snap, d, fw, kernels_plain, volume_kernels=None,
                     unplaced_infeasible=True):
    """Placement validity with the port's plain functions: the final
    node_requested, capacity of every node that received pods, static
    masks, and (`unplaced_infeasible`) no unplaced pod feasible against the
    final state. `volume_kernels` (VolumeBinding's functions; default the
    plain versions) may hand over the cycle's own final claim bitmap as the
    fold of all placements."""
    from k8s_scheduler_tpu_torch.core.cycle import sampling_window
    from k8s_scheduler_tpu_torch.framework.interfaces import (CycleContext, DynKernels,
                                                              VolumeKernels)
    from k8s_scheduler_tpu_torch.ops import static_base as sb
    from k8s_scheduler_tpu_torch.ops.capacity import index_add_exact
    from k8s_scheduler_tpu_torch.ops.resources import fit_slack

    P = snap.P
    a = d.assignment
    placed = snap.pod_valid & (a >= 0)
    n_real = int(snap.num_nodes)
    check(tuple(a.shape) == (P,) and a.dtype == torch.int32, "assignment shape")
    check(bool(((a >= -1) & (a < n_real)).all()), "assignment out of range")
    check(not bool((~snap.pod_valid & (a >= 0)).any()), "padding pod placed")
    check(bool(torch.isfinite(d.node_requested).all()), "node_requested not finite")
    req = snap.pod_requested
    expect = index_add_exact(snap.node_requested, a[placed], req[placed])
    check(torch.equal(expect, d.node_requested),
          "node_requested != running requests + placed requests")
    # a node that received pods this cycle ends within its allocatable
    # (the running workload alone may already exceed it)
    alloc = snap.node_allocatable
    over = (d.node_requested > alloc + fit_slack(alloc)).any(dim=1)
    check(not bool(over[a[placed].long()].any()), "a node that received pods is over capacity")
    ctx = CycleContext(snap, kernels_plain, volume_kernels=volume_kernels or VolumeKernels.plain(),
                       dyn_kernels=DynKernels.plain())
    sbase = sb.static_base_plain(sb.static_base_inputs(
        fw, ctx, fit=True, sampling=sampling_window(snap, 0)))
    smask = sbase > sb.NEG_INF / 2
    pidx = torch.nonzero(placed, as_tuple=True)[0]
    check(bool(smask[pidx, a[pidx].long()].all()), "a placed pod's static mask is false at its node")
    extra = fw.extra_update_batched(ctx, fw.extra_init(ctx), placed, torch.where(placed, a, 0))
    if unplaced_infeasible:
        feasible, _ = fw.dyn_batched(ctx, d.node_requested, extra, sbase)
        open_ = snap.pod_valid & (a < 0) & ~d.gang_dropped
        n_open_feasible = int((feasible.any(dim=1) & open_).sum())
        check(n_open_feasible == 0, f"{n_open_feasible} unplaced pods still have a feasible node")
    return ctx, extra


def check_affinity(torch, snap, d, ctx, final_extra):
    """Inter-pod constraints of every placement, with the port's plain
    functions over the final state (and, for spread, the state at the start
    of the round the pod was placed in):
      - required anti-affinity: no other pod matching the term in the pod's
        domain, and no running pod's anti term covering its node;
      - required affinity: a matching pod in the domain, or the pod matches
        its own term (bootstrap);
      - DoNotSchedule: the key present, and count + same-round lower-rank
        arrivals + 1 - min <= maxSkew at the pod's round.
    Returns counts of the checked terms."""
    from k8s_scheduler_tpu_torch.models import encoding as enc
    from k8s_scheduler_tpu_torch.ops import interpod as ip

    P, N = snap.P, snap.N
    a, rnd = d.assignment, d.placed_round
    placed = snap.pod_valid & (a >= 0)
    mp = ctx.matched_pending  # [S, P]
    state0 = ctx.initial_affinity_state()
    final = next(v for v in final_extra.values() if isinstance(v, ip.AffinityState))
    S, D = final.counts.shape
    K = snap.node_domains.shape[1]
    check(float(final.pref_sym.abs().max()) < EXACT_F32 and
          float(final.counts.max()) < EXACT_F32,
          "affinity tables left the exact f32 integer range")
    pid = torch.arange(P, device=a.device)
    node_dom = snap.node_domains[a.clamp(0, N - 1).long()]  # [P, K]

    def term_dom(terms_k):
        return node_dom.gather(1, terms_k.clamp(0, K - 1).long()[:, None])[:, 0]

    n_anti = n_aff = n_spread = 0
    for t in range(snap.pod_anti_terms.shape[1]):
        sel = snap.pod_anti_terms[:, t, 0]
        dd = term_dom(snap.pod_anti_terms[:, t, 1])
        on = placed & (sel >= 0) & (dd >= 0)
        scl = sel.clamp(0, S - 1).long()
        others = final.counts[scl, dd.clamp(0, D - 1).long()] - mp[scl, pid].float()
        check(not bool((on & (others > 0)).any()), "required anti-affinity violated")
        n_anti += int(on.sum())
    blocked = (mp.T.float() @ state0.anti_presence.float()) > 0  # [P, N]
    check(not bool((placed & blocked[pid, a.clamp(0, N - 1).long()]).any()),
          "a running pod's anti-affinity term covers a placed pod")
    for t in range(snap.pod_aff_terms.shape[1]):
        sel = snap.pod_aff_terms[:, t, 0]
        dd = term_dom(snap.pod_aff_terms[:, t, 1])
        scl = sel.clamp(0, S - 1).long()
        on = placed & (sel >= 0) & ~mp[scl, pid]
        found = (dd >= 0) & (final.counts[scl, dd.clamp(0, D - 1).long()] > 0)
        check(not bool((on & ~found).any()), "required affinity unsatisfied")
        n_aff += int((placed & (sel >= 0)).sum())
    # DoNotSchedule, round by round
    state = state0
    rank = snap.pod_order.long()
    for r in range(int(rnd.max()) + 1):
        minc = ip.spread_minc(snap, state)
        in_r = placed & (rnd == r)
        for c in range(snap.pod_tsc.shape[1]):
            k, sel, when = (snap.pod_tsc[:, c, i] for i in range(3))
            hard = in_r & (k >= 0) & (when == enc.WHEN_DO_NOT_SCHEDULE)
            if not bool(hard.any()):
                continue
            dd = term_dom(k)
            check(not bool((hard & (dd < 0)).any()), "spread key absent at a placed pod's node")
            rows = torch.nonzero(hard, as_tuple=True)[0]
            kr, sr, dr = k[rows].clamp(0, K - 1).long(), sel[rows].long(), dd[rows].long()
            q_dom = snap.node_domains.T[kr][:, a.clamp(0, N - 1).long()]  # [n, P]
            arrivals = (mp[sr] & in_r[None, :] & (q_dom == dr[:, None])
                        & (rank[None, :] < rank[rows][:, None])).sum(dim=1)
            cnt = state.counts[sr, dr]
            skew = snap.pod_tsc_skew[rows, c].float()
            check(bool((cnt + arrivals + 1 - minc[kr * S + sr] <= skew).all()),
                  f"DoNotSchedule skew exceeded in round {r}")
            n_spread += len(rows)
        state = ip.affinity_update_batched(snap, state, mp, in_r, torch.where(in_r, a, 0))
    return n_anti, n_aff, n_spread


def timed_cycles(torch, kb, cycle, snaps, seeds):
    """Cycles on `seeds` with the launch counts set to 0 just before and
    read just after; (results, launches)."""
    results = []
    kb.reset_launch_counts()
    for s in seeds:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        start.record()
        d = cycle(snaps[s])
        end.record()
        torch.cuda.synchronize()
        results.append((s, d, start.elapsed_time(end), (time.time() - t0) * 1e3))
    return results, dict(kb.launch_counts)


def encode_all(torch, enc, nodes, existing, pending):
    snaps, ms = {}, {}
    for s, pods in pending.items():
        t0 = time.time()
        snaps[s] = enc.encode(nodes, pods, existing)
        torch.cuda.synchronize()
        ms[str(s)] = round((time.time() - t0) * 1e3, 1)
    return snaps, ms


def kernel_entry(name, route, source, replaces, launches, err, ms, device_ms_, plain_ms,
                 nbytes_, ops, library_ms=None, **extra):
    """One kernel's line of the JSON table: `ms` by CUDA events around
    eager wrapper calls, `device_ms` the device's time for the calls (a
    CUDA-graph replay, `kernel_variants.device_ms`, unless said otherwise)."""
    b, by = bound(nbytes_, ops)
    return {"name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "device_ms": device_ms_,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": library_ms, **extra}


def profiled_device_ms(torch, fn, reps: int) -> float:
    """Mean device ms per call of fn's kernels, from torch.profiler's CUDA
    activities: for a wrapper that reads device values on the host (K13's
    exactness bound), which a CUDA graph cannot capture."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def bits_equal(torch, a, b) -> bool:
    """Equal bit for bit (-0.0 is not 0.0)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def dyn_outputs_equal(torch, dr, kind, args) -> bool:
    """K14 (`kind` "mask") or K15 ("score") against its plain version on
    one call's arguments, bit for bit."""
    if kind == "mask":
        (mk, fk), (mp, fp) = dr.dyn_mask_cuda(*args), dr.dyn_mask_plain(*args)
        return torch.equal(mk, mp) and torch.equal(fk, fp)
    return bits_equal(torch, dr.dyn_score_cuda(*args), dr.dyn_score_plain(*args))


def dyn_recorders(dr):
    """Recorders of every K14 and K15 call of a cycle on the plain versions."""
    return Recorder(dr.dyn_mask_plain, keep=None), Recorder(dr.dyn_score_plain, keep=None)


def dyn_calls_equal(torch, dr, recs, tag) -> tuple[int, int]:
    """Each recorded call of a cycle through K14 and K15 against the plain
    versions, bit for bit: (mask calls, score calls, anchors among them)."""
    for kind, rec in zip(("mask", "score"), recs):
        check(rec.calls > 0 and rec.recorded(), f"{tag}: dyn_{kind} calls not recorded")
        for i, args in sorted(rec.args.items()):
            check(dyn_outputs_equal(torch, dr, kind, args),
                  f"dyn_{kind} differs from its plain version ({tag}, call {i})")
    anchors = sum(a[0] is None for a in recs[1].args.values())
    return len(recs[0].args), len(recs[1].args), anchors


def dyn_edge_checks(torch, dev) -> dict:
    """K14 and K15 (and K15 as the score anchor) against their plain
    versions on every `utils/kernel_cases.dyn_cases` case: {tag: [B, N]}."""
    from k8s_scheduler_tpu_torch.ops import dyn_round as dr
    from k8s_scheduler_tpu_torch.utils import kernel_cases as kc

    out = {}
    for tag, x in kc.dyn_cases(dev).items():
        check(dyn_outputs_equal(torch, dr, "mask", x["mask"]), f"dyn_mask differs on {tag!r}")
        check(dyn_outputs_equal(torch, dr, "score", x["score"]), f"dyn_score differs on {tag!r}")
        if x["anchor"] is not None:
            check(dyn_outputs_equal(torch, dr, "score", x["anchor"]),
                  f"dyn_score (anchor) differs on {tag!r}")
        out[tag] = list(x["mask"][0].shape)
    return out


def dyn_bytes(torch, dr, m_args, s_args) -> tuple[int, int, int, int]:
    """(K14 bytes, ops, K15 bytes, ops) of one round's calls: each input read
    once, each output written once."""
    vsbase, parts, act = m_args
    B, N = vsbase.shape
    b14 = nbytes(vsbase, act) + B * N * (2 if act is not None else 1)
    n_parts = 0
    for p in parts:
        n_parts += 1
        b14 += nbytes(*p) if isinstance(p, tuple) else nbytes(p)
    prog, planes, res, _, _, _, _ = dr.score_program(s_args[1])
    b15 = nbytes(s_args[0], *planes) + B * N * 4 + (nbytes(*res) if res is not None else 0)
    R = res[1].shape[1] if res is not None else 0
    return b14, B * N * (1 + n_parts + R), b15, B * N * (8 * R + 4 * len(prog) + 2)


def dyn_peak_mib(torch, fn_mask, fn_score, m_args, s_args) -> float:
    """Peak device memory (MiB) above what was allocated before, of one
    round's two stages on `m_args` / `s_args` (the score's planes given)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = (fn_mask(*m_args), fn_score(*s_args))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak / 2**20


def ports_variant(torch, snap, gen):
    """`snap` with host ports (of the Q pending port ids) named by 5% of the
    pods, one to three each with pad slots between them — the port paths
    of K14 and of NodePorts' fold that config #4's workload leaves cold;
    seeded, on the card."""
    dev, P, Q = snap.device, snap.P, snap.num_distinct_ports
    ports = snap.pod_port_ids.clone()
    MP = ports.shape[1]
    named = torch.rand(P, generator=gen, device=dev) < 0.05
    for j in range(0, min(MP, 5), 2):  # slots 0, 2, 4: slot 1 and 3 stay pads
        ids = torch.randint(0, Q, (P,), generator=gen, device=dev, dtype=torch.int32)
        ports[:, j] = torch.where(named & (torch.rand(P, generator=gen, device=dev) < 0.7),
                                  ids, ports[:, j])
    return dataclasses.replace(snap, pod_port_ids=ports)


def round_without_sync(torch, fw, snap) -> str:
    """Round 0 of the rounds engine (`rounds_commit` with max_rounds=1: no
    stop test) and, before it, one round-0 `dyn_batched` and NodePorts'
    `extra_update_batched` alone, under torch.cuda.set_sync_debug_mode(
    "error"): no operation may wait for the device. The inputs (context
    tables, static base, extra state) are made before; the dyn_batched
    after the fold is then held against the plain versions'. Returns a
    summary."""
    import traceback

    from k8s_scheduler_tpu_torch.core import cycle as cy
    from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext, DynKernels
    from k8s_scheduler_tpu_torch.ops import rounds as ro
    from k8s_scheduler_tpu_torch.ops import static_base as sb

    ctx = CycleContext(snap)
    sbase = sb.static_base(sb.static_base_inputs(fw, ctx, fit=True,
                                                 sampling=cy.sampling_window(snap, 0)))
    extra = fw.extra_init(ctx)
    mp = ctx.matched_pending
    pv_choice_fn = cy._make_pv_choice_fn(ctx)
    node_of = (torch.arange(snap.P, device=snap.device) % max(int(snap.num_nodes), 1)).int()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ext = fw.extra_update_batched(ctx, extra, snap.pod_valid, node_of)
        mask, base = fw.dyn_batched(ctx, snap.node_requested, ext, sbase, snap.pod_valid)
        res = ro.rounds_commit(
            snap=snap, sbase=sbase, m_pending=mp,
            dyn_batched_view_fn=lambda vs, vmp, nr, e, vsb, act: fw.dyn_batched(
                ctx.view(vs, vmp), nr, e, vsb, act),
            update_batched_view_fn=lambda vs, vmp, e, acc, node: fw.extra_update_batched(
                ctx.view(vs, vmp), e, acc, node),
            extra=extra, max_rounds=1, score_anchor_fn=lambda nr: fw.score_anchor(ctx, nr),
            pv_choice_fn=pv_choice_fn)
    except RuntimeError:
        log("  a host sync under set_sync_debug_mode('error'):\n" + traceback.format_exc())
        raise
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ctx_p = CycleContext(snap, dyn_kernels=DynKernels.plain())
    ctx_p._cache.update(ctx._cache)  # the tables and the affinity state's owner
    mask_p, base_p = fw.dyn_batched(ctx_p, snap.node_requested, ext, sbase, snap.pod_valid)
    check(torch.equal(mask, mask_p) and bits_equal(torch, base, base_p),
          "dyn_batched after NodePorts' fold differs from the plain versions'")
    return (f"feasible pairs {int(mask.sum())}, (node, port) claims folded "
            f"{int(ext['NodePorts'].sum()) if 'NodePorts' in ext else 0} of "
            f"{int((snap.pod_port_ids >= 0).sum())} named ports, equal to the plain "
            f"versions; round 0 placed {int((res.assignment >= 0).sum())}")


def prev_ms(torch, kb, prev_libs, name, fn, reps, timer=None):
    """fn's device ms (`timer`, else CUDA events around eager calls) with
    kernel `name` launched from the earlier design's library
    (`--prev-csrc`), or None without one."""
    from k8s_scheduler_tpu_torch.kernel_variants import with_library

    if name not in prev_libs:
        return None
    timer = timer or (lambda f, r: time_ms(torch, f, r))
    return with_library(name, prev_libs[name], lambda: timer(fn, reps))


def claim_edge_checks(torch, dev) -> dict:
    """K9 against `claim_loop_plain` on the seeded edge cases
    (`utils/kernel_cases.claim_cases`): nominations and carry bit-equal;
    {case: the launch's shape}."""
    from k8s_scheduler_tpu_torch.ops import preempt_claim as k9
    from k8s_scheduler_tpu_torch.ops import preemption as pre
    from k8s_scheduler_tpu_torch.utils.kernel_cases import claim_cases

    shapes = {}
    for tag, x in claim_cases(dev).items():
        (nk, ck), (np_, cp_) = k9.preempt_claim_cuda(x), pre.claim_loop_plain(x)
        check(torch.equal(nk, np_) and all(torch.equal(getattr(ck, f), getattr(cp_, f))
                                           for f in vars(ck)),
              f"preempt_claim differs from claim_loop_plain ({tag})")
        shapes[tag] = k9.claim_shape(x)
    return shapes


def claims_equal(torch, rec, tag) -> int:
    """K9 against `claim_loop_plain` on every pass `rec` (a Recorder of the
    claim stage) saw, nominations and carry bit-equal; the pass count."""
    from k8s_scheduler_tpu_torch.ops import preempt_claim as k9
    from k8s_scheduler_tpu_torch.ops import preemption as pre

    for i, (x,) in sorted(rec.args.items()):
        (nk, ck), (np_, cp_) = k9.preempt_claim_cuda(x), pre.claim_loop_plain(x)
        check(torch.equal(nk, np_) and all(torch.equal(getattr(ck, f), getattr(cp_, f))
                                           for f in vars(ck)),
              f"{tag}: preempt_claim differs from claim_loop_plain (pass {i})")
    return len(rec.args)


def affinity_update_edge_checks(torch, dev) -> list[str]:
    """K4 against `affinity_update_plain` on the seeded edge cases
    (`utils/kernel_cases.affinity_update_raw_cases`), twice each (a call
    must leave nothing that changes the next), tables bit-equal and below
    2^24."""
    from k8s_scheduler_tpu_torch.kernel_variants import states_equal
    from k8s_scheduler_tpu_torch.ops import affinity_update as au
    from k8s_scheduler_tpu_torch.utils import kernel_cases

    cases = kernel_cases.affinity_update_raw_cases()
    for tag, raw in cases.items():
        args = kernel_cases.affinity_update_args(raw, dev)
        for _ in range(2):
            got = au.affinity_update_cuda(*args)
            check(states_equal(got, au.affinity_update_plain(*args)),
                  f"affinity_update differs from its plain version ({tag})")
            check(float(got.pref_sym.abs().max()) < EXACT_F32,
                  f"pref_sym left the exact f32 range ({tag})")
    return list(cases)


def scan_edge_checks(torch, dev) -> dict:
    """K13 against `scan_commit_plain` on the seeded edge cases
    (`utils/kernel_cases.scan_cases`, the volume cases included): all seven
    outputs and the claim bitmap equal; {case: the launch's cluster and
    slice}."""
    from k8s_scheduler_tpu_torch.kernel_variants import scans_equal
    from k8s_scheduler_tpu_torch.ops import scan_commit as sc
    from k8s_scheduler_tpu_torch.utils.kernel_cases import scan_cases

    shapes = {}
    for tag, x in scan_cases(dev).items():
        check(scans_equal(sc.scan_commit_cuda(x), sc.scan_commit_plain(x)),
              f"scan_commit differs from scan_commit_plain ({tag})")
        shape = sc.scan_shape(x)
        shapes[tag] = [shape["cluster"], shape["slice"]]
    return shapes


def scan_full_edge_checks(torch, dev) -> dict:
    """K13's full mode against `scan_commit_plain`'s on the seeded edge
    cases' full inputs (`utils/kernel_cases.scan_cases(full=True)`): the
    seven outputs and the per-step rejects equal; {case: rejects counted}."""
    from k8s_scheduler_tpu_torch.kernel_variants import scans_equal
    from k8s_scheduler_tpu_torch.ops import scan_commit as sc
    from k8s_scheduler_tpu_torch.utils.kernel_cases import scan_cases

    out = {}
    for tag, x in scan_cases(dev, full=True).items():
        rk, rp = sc.scan_commit_cuda(x), sc.scan_commit_plain(x)
        check(scans_equal(rk, rp) and torch.equal(rk.rejects, rp.rejects),
              f"scan_commit's full mode differs from scan_commit_plain's ({tag})")
        out[tag] = int(rk.rejects.sum())
    return out


def reject_edge_checks(torch, dev) -> dict:
    """K16 `static_rejects` (with and without its survivors plane) and K17
    `dyn_rejects` against their plain versions on the seeded edge cases
    (`utils/kernel_cases.static_reject_cases`, `dyn_reject_cases`), bit for
    bit; {case: [rows, F, nodes counted]}."""
    from k8s_scheduler_tpu_torch.kernel_variants import rejects_equal
    from k8s_scheduler_tpu_torch.ops import dyn_round as dr
    from k8s_scheduler_tpu_torch.ops import static_base as sb
    from k8s_scheduler_tpu_torch.utils.kernel_cases import (dyn_reject_cases,
                                                            static_reject_cases)

    out = {}
    for tag, (x, rows) in static_reject_cases(dev).items():
        k = sb.static_rejects_cuda(x, rows)
        check(torch.equal(k, sb.static_rejects_plain(x, rows)),
              f"static_rejects differs from its plain version ({tag})")
        check(rejects_equal(sb.static_rejects_cuda(x, rows, True),
                            sb.static_rejects_plain(x, rows, True)),
              f"static_rejects with its survivors plane differs from its plain version "
              f"({tag})")
        out[f"K16 {tag}"] = [*k.shape, int(k.sum())]
    for tag, args in dyn_reject_cases(dev).items():
        k = dr.dyn_rejects_cuda(*args)
        check(torch.equal(k, dr.dyn_rejects_plain(*args)),
              f"dyn_rejects differs from its plain version ({tag})")
        out[f"K17 {tag}"] = [*k.shape, int(k.sum())]
    return out


def capacity_calls_equal(torch, cap, calls, tag) -> tuple[int, int]:
    """K5 against `capacity_plain` on every recorded call, outputs bit-equal;
    (passes, revocation folds)."""
    folds = 0
    for i, args in sorted(calls.items()):
        # the round's counter row, if the call had one, fresh for each side
        rows = [None, None] if len(args) < 9 or args[8] is None else [
            torch.zeros_like(args[8]), torch.zeros_like(args[8])]
        (ak, nk), (ap, np_) = (cap.capacity_cuda(*args[:8], rows[0]),
                               cap.capacity_plain(*args[:8], rows[1]))
        check(bits_equal(torch, ak, ap) and bits_equal(torch, nk, np_)
              and (rows[0] is None or torch.equal(rows[0], rows[1])),
              f"capacity differs from its plain version ({tag}, call {i})")
        folds += args[7] is False
    return len(calls) - folds, folds


def capacity_edge_checks(torch, cap, dev) -> list[str]:
    """K5 against `capacity_plain` on the seeded edge cases
    (`utils/kernel_cases.capacity_cases`)."""
    from k8s_scheduler_tpu_torch.utils.kernel_cases import capacity_cases

    cases = capacity_cases(dev)
    for tag, (args, _) in cases.items():
        capacity_calls_equal(torch, cap, {0: args}, tag)
    return list(cases)


def static_base_edge_checks(torch, sb, dev) -> list[str]:
    """K1 against `static_base_plain` on the seeded edge cases
    (`utils/kernel_cases.static_base_edge_inputs`), bit-equal."""
    from k8s_scheduler_tpu_torch.utils.kernel_cases import static_base_edge_inputs

    cases = static_base_edge_inputs(dev)
    for tag, x in cases.items():
        compare_static_base(torch, sb, x, tag)
    return list(cases)


def guard_prefix_bytes(torch, tile, args) -> int:
    """Bytes K6's design must move on these inputs: the valid entries' keys
    and permutation (and caps, for their spread entries), the role table,
    the ok bytes, and the two or three keys each tile without a valid entry
    reads before it leaves."""
    s_packed, perm, rank_bits, B, role_tab, caps, gk_invalid = args
    L = s_packed.shape[0]
    valid = (s_packed >> rank_bits) != gk_invalid
    idx = torch.nonzero(valid).flatten()
    work = int(torch.unique(idx // tile).numel())
    n_caps = 0
    if caps is not None:
        n_caps = int((role_tab[perm[idx] // B] == 16).sum())  # RB_SPREAD
    return (int(valid.sum()) * 16 + n_caps * 4 + role_tab.numel() * 4 + B
            + (-(-L // tile) - work) * 24)


def guard_edge_checks(torch, dev) -> list[str]:
    """K6 against `guard_sweep_plain` on the seeded edge cases
    (`utils/kernel_cases.guard_cases`), each twice (a call after a call)."""
    from k8s_scheduler_tpu_torch.ops import guard_sweep as gs
    from k8s_scheduler_tpu_torch.utils.kernel_cases import guard_cases

    cases = guard_cases(dev)
    for tag, args in cases.items():
        want = gs.guard_sweep_plain(*args)
        for _ in range(2):
            check(torch.equal(gs.guard_sweep_cuda(*args), want),
                  f"guard_sweep differs from its plain version ({tag})")
    return list(cases)


def pv_choice_edge_checks(torch, dev) -> list[str]:
    """K11 against `pv_choice_plain` on the seeded edge cases
    (`utils/kernel_cases.pv_choice_cases`, three draws each)."""
    from k8s_scheduler_tpu_torch.ops import pv_choice as k11
    from k8s_scheduler_tpu_torch.ops import volumes as vol
    from k8s_scheduler_tpu_torch.utils.kernel_cases import pv_choice_cases

    cases = pv_choice_cases(dev)
    for tag, args in cases.items():
        check(torch.equal(k11.pv_choice_cuda(*args), vol.pv_choice_plain(*args)),
              f"pv_choice differs from its plain version ({tag})")
    return list(cases)


def prefilter_edge_checks(torch, dev) -> dict:
    """K7 against `prefilter_plain` on the seeded edge cases
    (`utils/kernel_cases.prefilter_cases`); {case: [C, N, MPN, R] and the
    launch's shape}. The launcher's shared memory a CTA is checked against
    `preempt_prefilter.launch_shape`."""
    from k8s_scheduler_tpu_torch.ops import preempt_prefilter as k7
    from k8s_scheduler_tpu_torch.ops import preemption as pre
    from k8s_scheduler_tpu_torch.utils.kernel_cases import prefilter_cases

    lib = k7._library()
    lib.preempt_prefilter_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    shapes = {}
    for tag, args in prefilter_cases(dev).items():
        want = pre.prefilter_plain(*args)
        check(torch.equal(k7.preempt_prefilter_cuda(*args), want),
              f"preempt_prefilter differs from its plain version ({tag})")
        C, R = args[1].shape
        N, MPN = args[3].shape
        shape = k7.launch_shape(C, N, MPN, R)
        check(lib.preempt_prefilter_smem(MPN, R) == (shape["smem"] if shape["staged"] else 0),
              f"preempt_prefilter: the launcher's shared memory is not launch_shape's ({tag})")
        shapes[tag] = [[C, N, MPN, R], shape["grid"], "staged" if shape["staged"] else "L2",
                       int(want.sum())]
    return shapes


def whatif_edge_checks(torch, dev) -> dict:
    """K8 against `nonresource_ok_plain` on the seeded edge cases
    (`utils/kernel_cases.whatif_cases`); {case: [C2, N, MPN+1]}."""
    from k8s_scheduler_tpu_torch.ops import preempt_whatif as k8
    from k8s_scheduler_tpu_torch.ops import preemption as pre
    from k8s_scheduler_tpu_torch.utils.kernel_cases import whatif_cases

    shapes = {}
    for tag, x in whatif_cases(dev).items():
        want = pre.nonresource_ok_plain(x)
        check(torch.equal(k8.preempt_whatif_cuda(x), want),
              f"preempt_whatif differs from its plain version ({tag})")
        shapes[tag] = list(want.shape)
    return shapes


def fold_edge_checks(torch, dev) -> dict:
    """K12 against `pv_fold_plain` on the seeded edge cases
    (`utils/kernel_cases.fold_cases`), on 16 CTAs and on the portable 8;
    {case: [clusters launched]}."""
    from k8s_scheduler_tpu_torch.ops import pv_fold as k12
    from k8s_scheduler_tpu_torch.ops import volumes as vol
    from k8s_scheduler_tpu_torch.utils.kernel_cases import fold_cases

    shapes = {}
    for tag, args in fold_cases(dev).items():
        want = vol.pv_fold_plain(*args)
        B, V = args[0].P, args[0].pv_avail.shape[0]
        for cl in (k12.CLUSTER, k12.CLUSTER_PORTABLE):
            check(torch.equal(k12.pv_fold_cuda(*args, cluster=cl), want),
                  f"pv_fold differs from its plain version ({tag}, {cl} CTAs)")
        shapes[tag] = [k12.fold_shape(B, V, cl)["cluster"]
                       for cl in (k12.CLUSTER, k12.CLUSTER_PORTABLE)]
    return shapes


def check_preemption(torch, snap, d, r, gate_fn, scan_budget):
    """Nominations checked with the port's plain functions, without the
    reference: every nominated pod was left unplaced by the cycle, may
    preempt and was not gang-dropped; per node, the victims are a prefix
    of node_pods and split, in rank order, into one non-empty run per
    nominated pod (each run's greedy smallest end where its victims are all
    below the pod's priority and the pod fits on the post-cycle requests
    minus the victims so far plus the pods nominated there before it; the
    last run ends at the prefix); no victim elsewhere; the nominated node
    passes the static gate; at most scan_budget nominations. Returns
    (nominations, victims, nominations that needed a PDB violation)."""
    from k8s_scheduler_tpu_torch.ops import preemption as pre
    from k8s_scheduler_tpu_torch.ops.resources import fit_slack

    nom = r.nominated
    ids = torch.nonzero(nom >= 0, as_tuple=True)[0]
    n_nom = int(ids.numel())
    check(int(r.num_preemptors) == n_nom, "num_preemptors != nominated count")
    check(n_nom <= scan_budget, f"{n_nom} nominations > scan_budget {scan_budget}")
    check(bool(((nom >= -1) & (nom < int(snap.num_nodes))).all()), "nomination out of range")
    check(bool((d.assignment[ids] < 0).all()), "a nominated pod was placed by the cycle")
    check(bool(snap.pod_can_preempt[ids].all() & snap.pod_valid[ids].all()),
          "a nominated pod may not preempt")
    check(not bool(d.gang_dropped[ids].any()), "a gang-dropped pod was nominated")
    if n_nom:
        gate = gate_fn(ids.to(torch.int32))
        check(bool(gate[torch.arange(n_nom), nom[ids].long()].all()),
              "a nominated node fails the static gate")
    vt = pre.victim_tables(snap)
    E = snap.exist_valid.shape[0]
    vict = r.victims.clone()
    check(not bool((vict & ~snap.exist_valid).any()), "a padding slot is a victim")
    base = (snap.node_allocatable - d.node_requested).cpu()
    slack = fit_slack(snap.node_allocatable).cpu()
    order = ids[torch.argsort(snap.pod_order[ids])].tolist()  # rank order
    prio = snap.pod_priority.cpu()
    req = snap.pod_requested.cpu()
    freed = vt.prefix_freed.cpu()
    vprio = vt.vict_prio.cpu()
    pods_of = vt.node_pods.cpu()
    vpdb = vt.vict_pdb.cpu()
    vict_c = vict.cpu()
    allowed = snap.pdb_allowed.cpu()
    used = torch.zeros_like(allowed)
    k_at: dict[int, int] = {}
    nominated_req: dict[int, torch.Tensor] = {}
    last_on = {}
    for p in order:
        last_on[int(nom[p])] = p
    n_viol = 0
    for p in order:
        b = int(nom[p])
        row = pods_of[b]
        on_node = vict_c[row.clamp(0, E - 1).long()] & (row >= 0)
        K = int(on_node.sum())
        check(bool(on_node[:K].all()), f"victims on node {b} are not a prefix of node_pods")
        k0 = k_at.get(b, 0)
        nreq = nominated_req.get(b, torch.zeros_like(base[b]))
        free = (base[b] - nreq) + slack[b]  # the claim loop's operation order
        ends = [k for k in range(k0 + 1, row.shape[0] + 1)
                if int(vprio[b, k - 1]) < int(prio[p])
                and bool((req[p] <= free + freed[b, k]).all())]
        if last_on[b] == p:
            check(K in ends, f"pod {p}'s run on node {b} does not end at the victim prefix")
            k1 = K
        else:
            check(bool(ends), f"pod {p} has no run on node {b}")
            k1 = ends[0]
        run = vpdb[b, k0:k1]  # [run, MB]
        viol = False
        for j in range(run.shape[0]):
            for g in run[j][run[j] >= 0].tolist():
                ordinal = int((run[: j + 1] == g).any(dim=1).sum())
                viol |= ordinal > int(allowed[g] - used[g])
        for g in run[run >= 0].tolist():
            used[g] += 1
        n_viol += int(viol)
        k_at[b] = k1
        nominated_req[b] = nreq + req[p]
    n_vict = sum(k_at.values())
    check(n_vict == int(vict_c.sum()), "a victim lies outside the nominated nodes' runs")
    return n_nom, n_vict, n_viol


def whatif_bytes(torch, wi) -> int:
    """The bytes K8 must move on these inputs: the verdicts written once;
    the node and candidate tables read once; of the [S, D] count and
    [S, E] match tables only the rows of selectors the candidates' terms
    name; the running pods' anti terms where there is affinity, and their
    ports and the winner-port rows only for candidates with host ports."""
    C2, N = wi.winner_conf.shape
    MPN = wi.node_pods.shape[1]
    b = C2 * N * (MPN + 1) + nbytes(wi.node_pods, wi.node_domains, wi.ports)
    placed = int(torch.unique(wi.node_pods[wi.node_pods >= 0]).numel())
    with_ports = int((wi.ports >= 0).any(dim=1).sum())
    if with_ports:
        b += with_ports * N + placed * wi.exist_ports.shape[1] * 4
    sels = []
    if wi.has_affinity:
        sels += [wi.anti[..., 0].reshape(-1), wi.aff[..., 0].reshape(-1)]
        b += nbytes(wi.anti, wi.aff, wi.row_d) + placed * wi.exist_anti[0].numel() * 4
    if wi.has_spread:
        hard = (wi.tsc[..., 0] >= 0) & (wi.tsc[..., 2] == 0)
        sels.append(wi.tsc[..., 1][hard])
        b += nbytes(wi.tsc, wi.tsc_skew, wi.sp_min1, wi.sp_amin, wi.sp_min2)
    if sels:
        s = torch.cat(sels)
        rows = int(torch.unique(s[s >= 0]).numel())
        b += rows * (wi.counts.shape[1] * 4 + wi.me.shape[1]) + nbytes(wi.total, wi.mp_c)
    return b


def preemption_phase(torch, kb, fw, dev, nodes, existing, pending, snaps, decisions,
                     cycle_ms, cycle_k, smi, slice1_case, prev_libs):
    """Phase 5 (module docstring), plus the same checks on slice 1's first
    timed snapshot and decision (no affinity or spread: K8's path without
    the affinity tables). Returns {"kernels": entries, "ms": [...]}."""
    from k8s_scheduler_tpu_torch.core.cycle import _preemption_gate_rows, build_preemption_fn
    from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext
    from k8s_scheduler_tpu_torch.kernel_variants import device_ms, wide_whatif
    from k8s_scheduler_tpu_torch.models import SnapshotEncoder
    from k8s_scheduler_tpu_torch.ops import preempt_claim as k9
    from k8s_scheduler_tpu_torch.ops import preempt_prefilter as k7
    from k8s_scheduler_tpu_torch.ops import preempt_whatif as k8
    from k8s_scheduler_tpu_torch.ops import preemption as pre
    from k8s_scheduler_tpu_torch.utils import synth

    pre_k = build_preemption_fn(fw, device=dev)

    def plain_run(snap, d):
        """The plain-versions preemption, recording each stage's inputs."""
        rec = {"prefilter": Recorder(pre.prefilter_plain),
               "whatif": Recorder(pre.nonresource_ok_plain),
               "claim": Recorder(pre.claim_loop_plain)}
        fn = build_preemption_fn(fw, device=dev, prefilter_fn=rec["prefilter"],
                                 whatif_fn=rec["whatif"], claim_fn=rec["claim"])
        t0 = time.time()
        out = fn(snap, d)
        torch.cuda.synchronize()
        return out, {k: v.args[0] for k, v in rec.items()}, (time.time() - t0) * 1e3

    def same(a, b):
        return {f: torch.equal(getattr(a, f), getattr(b, f))
                for f in ("nominated", "victims", "num_preemptors")}

    def stages_equal(args, tag):
        pf, wi, cl = args["prefilter"], args["whatif"][0], args["claim"][0]
        check(torch.equal(k7.preempt_prefilter_cuda(*pf), pre.prefilter_plain(*pf)),
              f"{tag}: preempt_prefilter differs from its plain version")
        check(torch.equal(k8.preempt_whatif_cuda(wi), pre.nonresource_ok_plain(wi)),
              f"{tag}: preempt_whatif differs from its plain version")
        wide = wide_whatif(wi)
        check(torch.equal(k8.preempt_whatif_cuda(wide), pre.nonresource_ok_plain(wide)),
              f"{tag}: preempt_whatif differs from its plain version at "
              f"{wide.node_pods.shape[1]} pods per node")
        (nk, ck), (np_, cp_) = k9.preempt_claim_cuda(cl), pre.claim_loop_plain(cl)
        check(torch.equal(nk, np_) and all(torch.equal(getattr(ck, f), getattr(cp_, f))
                                           for f in vars(ck)),
              f"{tag}: preempt_claim differs from its plain version (nominations or carry)")
        return int(cl.n_live.item())

    def run_seed(tag, snap, d, rk):
        rp, args, plain_ms = plain_run(snap, d)
        eq = same(rk, rp)
        check(all(eq.values()), f"{tag}: kernels' preemption differs from the plain one: {eq}")
        n_live = stages_equal(args, tag)
        gate_fn = _preemption_gate_rows(fw, CycleContext(snap))
        n_nom, n_vict, n_viol = check_preemption(torch, snap, d, rk, gate_fn,
                                                 pre.DEFAULT_SCAN_BUDGET)
        return args, n_live, n_nom, n_vict, n_viol, plain_ms

    # warm-up on the warm seed (allocator, first launches)
    t0 = time.time()
    pre_k(snaps[AFF_WARM_SEED], decisions[AFF_WARM_SEED])
    torch.cuda.synchronize()
    log(f"phase preemption warm-up: {(time.time() - t0) * 1e3:.1f} ms")

    # the preemption main path: counts set to 0 just before, read just after
    timed = []
    kb.reset_launch_counts()
    for s in AFF_TIMED_SEEDS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        start.record()
        r = pre_k(snaps[s], decisions[s])
        end.record()
        torch.cuda.synchronize()
        timed.append((s, r, start.elapsed_time(end), (time.time() - t0) * 1e3))
    launches = dict(kb.launch_counts)
    log(f"phase preemption launches over {len(AFF_TIMED_SEEDS)} passes: {json.dumps(launches)}")
    for k in ("preempt_prefilter", "preempt_whatif", "preempt_claim", "affinity_update"):
        check(launches[k] > 0, f"kernel {k} was not launched on the preemption path")
    check(launches["preempt_claim"] == len(AFF_TIMED_SEEDS),
          "the claim loop took more than one launch per pass")

    stage_args = None
    ms = []
    for s, r, dev_ms, host_ms in timed:
        args, n_live, n_nom, n_vict, n_viol, plain_ms = run_seed(f"seed {s}", snaps[s],
                                                                 decisions[s], r)
        check(n_nom > 0, f"seed {s}: no preemptor on config #4's workload")
        stage_args = stage_args or args
        ms.append(round(dev_ms, 2))
        log(f"phase preemption seed {s}: cycle device {cycle_ms[s]:.1f} ms, preemption "
            f"device {dev_ms:.2f} ms (host {host_ms:.1f} ms, plain versions "
            f"{plain_ms:.1f} ms host); unschedulable {int(decisions[s].unschedulable.sum())}, "
            f"{n_live} live candidates, {n_nom} nominations, {n_vict} victims, "
            f"{n_viol} with a PDB violation; kernels == plain, K7-K9 == plain, "
            f"nominations valid | {smi}")

    # K7-K9 against their plain versions: timings on the first timed seed
    pf, wi, cl = stage_args["prefilter"], stage_args["whatif"][0], stage_args["claim"][0]
    C, R = pf[1].shape
    N, MPN = pf[3].shape
    C2 = wi.ports.shape[0]
    k7_ms = time_ms(torch, lambda: k7.preempt_prefilter_cuda(*pf), 20)
    k7_plain = time_ms(torch, lambda: pre.prefilter_plain(*pf), 3)
    k7_bytes = nbytes(*pf) + C
    gated = pf[6] & pf[7][None, :]
    elig = (pf[3][None] < pf[0][:, None, None]).sum(dim=2)
    k7_ops = int(gated.sum()) * MPN + 2 * R * int((elig * gated).sum())
    k8_ms = time_ms(torch, lambda: k8.preempt_whatif_cuda(wi), 20)
    k8_dev = device_ms(lambda: k8.preempt_whatif_cuda(wi), 20)
    wide = wide_whatif(wi)
    k8_wide = device_ms(lambda: k8.preempt_whatif_cuda(wide), 20)
    k8_prev = prev_ms(torch, kb, prev_libs, "preempt_whatif",
                      lambda: k8.preempt_whatif_cuda(wi), 20, device_ms)
    k8_prev_wide = prev_ms(torch, kb, prev_libs, "preempt_whatif",
                           lambda: k8.preempt_whatif_cuda(wide), 20, device_ms)
    k8_plain = time_ms(torch, lambda: pre.nonresource_ok_plain(wi), 2)
    k8_bytes = whatif_bytes(torch, wi)
    n_terms = C2 + int((wi.ports >= 0).any(dim=1).sum())  # symmetric, ports
    for tab in (wi.anti, wi.aff):
        if tab is not None:
            n_terms += int((tab[..., 0] >= 0).sum())
    if wi.tsc is not None:
        n_terms += int(((wi.tsc[..., 0] >= 0) & (wi.tsc[..., 2] == 0)).sum())
    k8_ops = n_terms * N * (MPN + 1) * 4  # per prefix: match, count, compare
    k9_ms = time_ms(torch, lambda: k9.preempt_claim_cuda(cl), 20)
    k9_dev = device_ms(lambda: k9.preempt_claim_cuda(cl), 20)
    k9_prev = prev_ms(torch, kb, prev_libs, "preempt_claim",
                      lambda: k9.preempt_claim_cuda(cl), 20, device_ms)
    k9_shape = k9.claim_shape(cl)
    k9_plain = time_ms(torch, lambda: pre.claim_loop_plain(cl), 2)
    n_live = int(cl.n_live.item())
    t = cl.tables
    k9_bytes = (n_live * N * (MPN + 2) + nbytes(t.node_pods, t.vict_prio, t.vict_start,
                                               t.vict_pdb, t.prefix_freed, t.prefix_prio,
                                               cl.alloc, cl.node_requested, cl.slack,
                                               cl.node_valid, cl.pdb_allowed)
                + C2 * 4 + N * 4 + N * R * 4)
    k9_ops = n_live * N * (MPN + 1) * (2 * R + 4)
    k8_prev_txt = ("not built" if k8_prev is None else
                   f"{k8_prev:.4f} ms device, {k8_prev_wide:.4f} widened")
    log(f"phase kernel preempt_whatif: [{C2}, {N}, {MPN + 1}] equal True (also at "
        f"{wide.node_pods.shape[1]} pods per node on 512 nodes); kernel "
        f"{k8_ms:.3f} ms ({k8_dev:.4f} ms device, {k8_wide:.4f} widened; earlier design: "
        f"{k8_prev_txt}), plain {k8_plain:.3f} ms, bound {bound(k8_bytes, k8_ops)[0]:.4f} ms")
    log(f"phase kernel preempt_claim: {n_live} live ranks over [{N}] nodes, one cluster "
        f"launch of {k9_shape['cluster']} CTAs (victim tables in shared memory "
        f"{k9_shape['staged']}, {k9_shape['smem']} B a CTA); equal True (nominations, "
        f"carry); kernel {k9_ms:.3f} ms, {k9_dev:.4f} ms device ("
        f"{1e3 * k9_dev / max(n_live, 1):.2f} us a step; earlier design: "
        f"{'not built' if k9_prev is None else f'{k9_prev:.4f} ms device'}), plain "
        f"{k9_plain:.3f} ms, bound {bound(k9_bytes, k9_ops)[0]:.4f} ms")
    del stage_args, wi, cl, wide

    # the PDB variant: one budget per app over the running pods
    t0 = time.time()
    pdbs = synth.config4_pdbs(seed=PDB_SEED)
    psnap = SnapshotEncoder(device=dev).encode(nodes, pending[AFF_TIMED_SEEDS[0]], existing,
                                               pdbs=pdbs)
    torch.cuda.synchronize()
    enc_ms = (time.time() - t0) * 1e3
    pd = cycle_k(psnap)
    pdb_args, n_live, n_nom, n_vict, n_viol, _ = run_seed("PDB variant", psnap, pd,
                                                          pre_k(psnap, pd))
    covered = int((psnap.exist_pdb[:, 0] >= 0).sum())
    log(f"phase preemption PDB variant: GP={psnap.pdb_allowed.shape[0]} budgets over "
        f"{covered} running pods (encode {enc_ms:.0f} ms); {n_live} live candidates, "
        f"{n_nom} nominations, {n_vict} victims, {n_viol} nominations with a PDB "
        f"violation; kernels == plain, K7-K9 == plain, nominations valid")
    check(n_nom > 0, "PDB variant: no preemptor")
    snap1, d1 = slice1_case
    s1_args, n_live, n_nom, n_vict, _, _ = run_seed("slice-1 workload", snap1, d1,
                                                    pre_k(snap1, d1))
    log(f"phase preemption on slice 1's workload (no affinity/spread): {n_live} live "
        f"candidates, {n_nom} nominations, {n_vict} victims; kernels == plain, K7-K9 == "
        f"plain, nominations valid")

    # K7 in device time on the three calls, and the earlier design on them
    k7_calls = {"config #4": pf, "slice 1": s1_args["prefilter"],
                "PDB variant": pdb_args["prefilter"]}
    k7_devs = {t: device_ms(lambda: k7.preempt_prefilter_cuda(*a), 50)
               for t, a in k7_calls.items()}
    k7_prevs = {t: prev_ms(torch, kb, prev_libs, "preempt_prefilter",
                           lambda: k7.preempt_prefilter_cuda(*a), 50, device_ms)
                for t, a in k7_calls.items()}
    k7_dev = k7_devs["config #4"]
    k7_shape = k7.launch_shape(C, N, MPN, R)
    log(f"phase kernel preempt_prefilter: [{C}, {N}, {MPN + 1}] x {R} equal True, grid "
        f"{k7_shape['grid']}, {k7_shape['smem']} B of shared memory a CTA; kernel "
        f"{k7_ms:.3f} ms, device " + ", ".join(
            f"{t} {ms:.4f} ms (earlier design: "
            f"{'not built' if k7_prevs[t] is None else f'{k7_prevs[t]:.4f} ms'})"
            for t, ms in k7_devs.items())
        + f"; plain {k7_plain:.3f} ms, bound {bound(k7_bytes, k7_ops)[0]:.4f} ms; feasible "
        + json.dumps({t: int(k7.preempt_prefilter_cuda(*a).sum())
                      for t, a in k7_calls.items()}))
    del pf, k7_calls, pdb_args, s1_args

    src = "k8s_scheduler_tpu_torch/csrc/"
    ref = "k8s_scheduler_tpu/ops/preemption.py:"
    entries = {
        "preempt_prefilter": kernel_entry(
            "preempt_prefilter", "cuda", src + "preempt_prefilter.cu", ref + "201",
            launches["preempt_prefilter"], 0.0, k7_ms, k7_dev, k7_plain, k7_bytes, k7_ops,
            slice1_device_ms=k7_devs["slice 1"], pdb_device_ms=k7_devs["PDB variant"],
            prev_device_ms=k7_prevs["config #4"], prev_slice1_device_ms=k7_prevs["slice 1"],
            prev_pdb_device_ms=k7_prevs["PDB variant"]),
        "preempt_whatif": kernel_entry(
            "preempt_whatif", "cuda", src + "preempt_whatif.cu", ref + "246",
            launches["preempt_whatif"], 0.0, k8_ms, k8_dev, k8_plain, k8_bytes, k8_ops,
            prev_device_ms=k8_prev, wide_device_ms=k8_wide, prev_wide_device_ms=k8_prev_wide),
        "preempt_claim": kernel_entry(
            "preempt_claim", "cuda", src + "preempt_claim.cu", ref + "402",
            launches["preempt_claim"], 0.0, k9_ms, k9_dev, k9_plain, k9_bytes, k9_ops,
            prev_device_ms=k9_prev, cluster=k9_shape["cluster"]),
    }
    return {"kernels": entries, "ms": ms}


def max_matching(cands: list[list[int]]) -> tuple[int, dict[int, int]]:
    """Maximum bipartite matching of left vertices (their candidate right
    vertices) by augmenting paths: (size, right -> left)."""
    owner: dict[int, int] = {}

    def augment(u, seen):
        for v in cands[u]:
            if v in seen:
                continue
            seen.add(v)
            if v not in owner or augment(owner[v], seen):
                owner[v] = u
                return True
        return False

    sys.setrecursionlimit(max(10000, 4 * len(cands)))
    return sum(augment(u, set()) for u in range(len(cands))), owner


def check_volumes(torch, snap, d, tables, claimed):
    """Volume validity of every placement, from the cycle's final claim
    bitmap (the last K12 fold's output), with the port's plain functions:
      - a bound claim (mode 0) is placed only where its PV's nodeAffinity
        admits the node;
      - the static PVs the cycle claimed and the placed pods' unbound slots
        (mode 1) admit a matching in which every claimed PV has its own
        slot (no PV claimed twice, none claimed for nobody) and every slot
        that cannot ride dynamic provisioning at its node has a PV of its
        class and size that the node admits.
    Returns (bound slots, unbound slots, claims, slots riding dynamic)."""
    from k8s_scheduler_tpu_torch.ops import volumes as vol

    a = d.assignment
    placed = snap.pod_valid & (a >= 0)
    node = a.clamp(min=0)
    mode, rid = snap.pod_vol_mode, snap.pod_vol_req
    req = tables.req
    at = req[rid.clamp(0, req.shape[0] - 1).long(), node[:, None].long()]  # [P, MVol]
    bound = placed[:, None] & (mode == 0)
    check(bool((~bound | (rid < 0) | at).all()), "a bound claim placed off its PV's affinity")
    dyn = vol._dyn_at_node(snap, req, a)  # [P, MVol]
    unb = placed[:, None] & (mode == 1)
    pv_ok = vol.pv_node_table(snap, req)  # [V, N] available and admitted
    check(not bool((claimed & ~snap.pv_avail).any()), "an unavailable PV was claimed")
    new = torch.nonzero(claimed, as_tuple=True)[0]
    col = {int(v): i for i, v in enumerate(new.tolist())}
    rows = torch.nonzero(unb, as_tuple=True)
    cls, cap = snap.pv_class[new], snap.pv_capacity[new] + vol._CAP_EPS
    p_ids, j_ids = rows
    cand = ((cls[None, :] == snap.pod_vol_class[p_ids, j_ids][:, None])
            & (cap[None, :] >= snap.pod_vol_size[p_ids, j_ids][:, None])
            & pv_ok[new][:, node[p_ids].long()].T)  # [slots, claims]
    lists = [torch.nonzero(r, as_tuple=True)[0].tolist() for r in cand.cpu()]
    needy = (~dyn[p_ids, j_ids]).cpu().tolist()
    n_all, owner = max_matching(lists)
    check(n_all == len(col), f"{len(col) - n_all} claimed PVs have no placed slot of their own")
    n_needy, _ = max_matching([c if nd else [] for c, nd in zip(lists, needy)])
    check(n_needy == sum(needy), f"{sum(needy) - n_needy} placed unbound slots lack a "
          "static PV and cannot ride dynamic provisioning")
    return int(bound.sum()), len(lists), len(col), len(lists) - sum(needy)


def volume_edge_fixtures():
    """Small clusters that reach what the volume cell does not: eight slots
    (the capped subset enumeration, dominance groups), PVs without
    nodeAffinity (the global list), zone-wide available PVs, bound and
    missing claims, Immediate classes and dynamic provisioning. Each is
    (nodes, pods, encode kwargs)."""
    from k8s_scheduler_tpu_torch.models import MakeNode, MakePod
    from k8s_scheduler_tpu_torch.models import api as A

    gib, zone = 2**30, "topology.kubernetes.io/zone"

    def term(*zones):
        return (A.NodeSelectorTerm((A.NodeSelectorRequirement(zone, "In", zones),)),)

    def joint(sizes, caps, prov=False):
        pvs = [A.PersistentVolume(f"pv-{v}", capacity=c * gib, storage_class="local")
               for v, c in enumerate(caps)]
        pvcs = [A.PersistentVolumeClaim(f"c{j}", storage_class="local", request=z * gib)
                for j, z in enumerate(sizes)]
        pod = MakePod("w").req({"cpu": "1"})
        for j in range(len(sizes)):
            pod = pod.volume(f"c{j}")
        local = A.StorageClass("local", A.VOLUME_BINDING_WAIT, provisioner=prov)
        return ([MakeNode("n0").capacity({"cpu": "8"}).obj()], [pod.obj()],
                dict(pvcs=pvcs, pvs=pvs, storage_classes=[local]))

    nodes = [MakeNode(f"{z}-n{i}").capacity({"cpu": "8"}).labels({zone: z}).obj()
             for z in ("z0", "z1", "z2") for i in range(3)]
    classes = [A.StorageClass("local", A.VOLUME_BINDING_WAIT, provisioner=False),
               A.StorageClass("ebs", A.VOLUME_BINDING_WAIT, allowed_topologies=term("z2")),
               A.StorageClass("imm")]
    pvs = [A.PersistentVolume(f"pv-{i}", capacity=(4 + 3 * (i % 3)) * gib,
                              storage_class="local", node_affinity=term(f"z{i % 3}"))
           for i in range(7)]
    pvs += [A.PersistentVolume("pv-free", capacity=8 * gib, storage_class="local"),
            A.PersistentVolume("pv-b", capacity=gib, storage_class="ebs",
                               node_affinity=term("z1"), claim_ref="default/b")]
    pvcs = [A.PersistentVolumeClaim(f"l{j}", storage_class="local", request=(2 + j) * gib)
            for j in range(12)]
    pvcs += [A.PersistentVolumeClaim("b", storage_class="ebs", request=gib, volume_name="pv-b"),
             A.PersistentVolumeClaim("e", storage_class="ebs", request=gib),
             A.PersistentVolumeClaim("i", storage_class="imm", request=gib)]
    mix = [("l0",), ("l1", "l2"), ("l3", "b"), ("e",), ("l4", "e"), ("i",), ("ghost",),
           ("l5", "l6", "l7"), ("b",), ("l8",), ("l9", "l10", "l11")]
    pods = []
    for k, claims in enumerate(mix):
        pod = MakePod(f"m{k}").req({"cpu": "1"}).created(float(k))
        for c in claims:
            pod = pod.volume(c)
        pods.append(pod.obj())
    return {
        "eight_tight": joint((8, 8, 8, 1, 1, 1, 1, 1), (10, 10, 2, 2, 2, 2, 2, 2)),
        "eight_dominance": joint((1, 8, 8, 8, 1, 1, 1, 1), (10, 10, 10, 2, 2, 2, 2, 2)),
        "chain": joint((1, 5, 8), (10, 6, 2)),
        "two_slots_provisioner": joint((5, 5), (10,), prov=True),
        "zones_mixed": (nodes, pods, dict(pvcs=pvcs, pvs=pvs, storage_classes=classes)),
    }


def volume_edge_checks(torch, dev) -> int:
    """K10 (both variants), K11 and K12 against their plain versions on
    `volume_edge_fixtures`, three seeded claim bitmaps, nodes and claimant
    sets each. Returns the number of comparisons."""
    from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext
    from k8s_scheduler_tpu_torch.models import SnapshotEncoder
    from k8s_scheduler_tpu_torch.ops import pv_choice as k11
    from k8s_scheduler_tpu_torch.ops import pv_fold as k12
    from k8s_scheduler_tpu_torch.ops import volume_mask as k10
    from k8s_scheduler_tpu_torch.ops import volumes as vol

    n = 0
    gen = torch.Generator(device=dev).manual_seed(5)
    for name, (nodes, pods, kw) in volume_edge_fixtures().items():
        snap = SnapshotEncoder(device=dev).encode(nodes, pods, **kw)
        tables = CycleContext(snap).volume_tables
        P, V = snap.P, snap.pv_avail.shape[0]
        for draw in range(3):
            claimed = torch.rand(V, generator=gen, device=dev) < 0.3 * draw
            node_of = torch.randint(0, len(nodes), (P,), generator=gen, device=dev,
                                    dtype=torch.int32)
            if draw == 2:  # every claimant on one node: contention
                node_of = torch.zeros_like(node_of)
            active = snap.pod_valid & (torch.rand(P, generator=gen, device=dev) < 0.9)
            rank = snap.pod_order.to(torch.int32)
            pairs = {
                "volume_mask static": (k10.volume_mask_cuda, vol.volume_mask_plain,
                                       (snap, tables, None, False)),
                "volume_mask unbound": (k10.volume_mask_cuda, vol.volume_mask_plain,
                                        (snap, tables, claimed, True)),
                "pv_choice": (k11.pv_choice_cuda, vol.pv_choice_plain,
                              (snap, tables, claimed, node_of, active)),
                "pv_fold": (k12.pv_fold_cuda, vol.pv_fold_plain,
                            (snap, tables, claimed, active, node_of, rank)),
            }
            for what, (kernel, plain, args) in pairs.items():
                check(torch.equal(kernel(*args), plain(*args)),
                      f"{what} differs from its plain version on {name} (draw {draw})")
                n += 1
    return n


def volume_kinds(torch, snap) -> dict:
    mode, rid = snap.pod_vol_mode, snap.pod_vol_req
    n1 = (mode == 1).sum(dim=1)
    return {"local x1": int(((n1 == 1) & (rid == -2).any(dim=1)).sum()),
            "local x2": int((n1 == 2).sum()),
            "zonal bound": int((mode == 0).any(dim=1).sum()),
            "zonal dynamic": int(((n1 == 1) & ((mode == 1) & (rid >= -1)).any(dim=1)).sum())}


def compare_static_base(torch, sb, x, tag=""):
    """K1 against its plain version on the inputs x: the masks and every
    value bit-equal. Returns (True, max |kernel - plain|)."""
    k_out = sb.static_base_cuda(x)
    p_out = sb.static_base_plain(x)
    mask_equal = torch.equal(k_out > sb.NEG_INF / 2, p_out > sb.NEG_INF / 2)
    k1_err = float((k_out - p_out).abs().max())
    check(mask_equal, f"static_base mask differs from its plain version {tag}")
    check(bits_equal(torch, k_out, p_out),
          f"static_base differs from its plain version {tag} (max |err| {k1_err})")
    return mask_equal, k1_err


def volumes_phase(torch, kb, fw, dev, nodes, existing, pending, smi, plain_kernels,
                  prev_libs):
    """Phase 6 (module docstring). Returns {"kernels": entries, "ms": [...],
    "pre_ms": [...]}."""
    from k8s_scheduler_tpu_torch.core.cycle import (_preemption_gate_rows, build_cycle_fn,
                                                    build_preemption_fn, sampling_window)
    from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext, VolumeKernels
    from k8s_scheduler_tpu_torch.kernel_variants import (contended_fold_args, device_ms,
                                                         pv_fold_with)
    from k8s_scheduler_tpu_torch.models import SnapshotEncoder
    from k8s_scheduler_tpu_torch.ops import affinity_update as au
    from k8s_scheduler_tpu_torch.ops import capacity as cap
    from k8s_scheduler_tpu_torch.ops import claim_pass as cp
    from k8s_scheduler_tpu_torch.ops import dyn_round as dr
    from k8s_scheduler_tpu_torch.ops import guard_sweep as gs
    from k8s_scheduler_tpu_torch.ops import interpod_terms as ipt
    from k8s_scheduler_tpu_torch.ops import preempt_claim as k9
    from k8s_scheduler_tpu_torch.ops import preemption as pre
    from k8s_scheduler_tpu_torch.ops import pv_choice as k11
    from k8s_scheduler_tpu_torch.ops import pv_fold as k12
    from k8s_scheduler_tpu_torch.ops import static_base as sb
    from k8s_scheduler_tpu_torch.ops import volume_mask as k10
    from k8s_scheduler_tpu_torch.ops import volumes as vol
    from k8s_scheduler_tpu_torch.utils import synth

    n_edge = volume_edge_checks(torch, dev)
    log(f"phase volumes edge fixtures: {n_edge} comparisons, K10-K12 == plain (up to 8 "
        "slots, PVs without affinity, zone-wide PVs, modes 0/1/2, dynamic provisioning)")

    # ---- data: config #4's workload with local and zonal volumes ----
    enc = SnapshotEncoder(device=dev)
    snaps, encode_ms = {}, {}
    t0 = time.time()
    drawn = {s: synth.config4_volumes(nodes, existing, pending[s], seed=s)
             for s in (AFF_WARM_SEED,) + AFF_TIMED_SEEDS}
    gen_s = time.time() - t0
    for s, (ex, pods, pvcs, pvs, classes) in drawn.items():
        t0 = time.time()
        snaps[s] = enc.encode(nodes, pods, ex, pvcs=pvcs, pvs=pvs, storage_classes=classes)
        torch.cuda.synchronize()
        encode_ms[str(s)] = round((time.time() - t0) * 1e3, 1)
    cut_draw = drawn[AFF_TIMED_SEEDS[0]]  # the scan leg's 2048-pod cut
    del drawn
    snap0 = snaps[AFF_WARM_SEED]
    P, N = snap0.P, snap0.N
    V, MVol = snap0.pv_avail.shape[0], snap0.pod_vol_mode.shape[1]
    check(snap0.has_volumes and snap0.has_multi_volume and MVol == 2,
          "the volume workload carries no multi-volume pods")
    log(f"phase volumes data: {N_NODES} nodes, {N_EXISTING} running, {N_PENDING} pending "
        f"(config #4 mix + config4_volumes) -> padded P={P} N={N}, V={V} PVs "
        f"({int(snap0.pv_avail.sum())} available), MVol={MVol}, Rq={snap0.rq_exprs.shape[0]}, "
        f"Ex={snap0.ex_key.shape[0]}; pods with volumes {json.dumps(volume_kinds(torch, snap0))}; "
        f"generate {gen_s:.1f}s; encode ms " + json.dumps(encode_ms))

    # ---- the kernels' cycle against the plain-versions cycle ----
    rec = {"volume_mask": Recorder(vol.volume_mask_plain, keep=(0, 1)),  # static, round 0
           "pv_choice": Recorder(vol.pv_choice_plain, keep=None),  # every round
           "pv_fold": Recorder(vol.pv_fold_plain, keep=None),  # every round
           "interpod_terms": Recorder(ipt.interpod_terms_plain)}
    cap_rec = Recorder(cap.capacity_plain, keep=None)  # every pass and fold
    rec_dyn = dyn_recorders(dr)  # every K14 / K15 call
    cycle_vp = build_cycle_fn(
        commit_mode="rounds", outputs="latency", device=dev,
        static_base_fn=sb.static_base_plain,
        claim_pass_fn=cp.claim_pass_plain,
        interpod_terms_fn=rec["interpod_terms"], interpod_norm_fn=ipt.interpod_norm_plain,
        affinity_update_fn=au.affinity_update_plain, capacity_fn=cap_rec,
        guard_sweep_fn=gs.guard_sweep_plain, volume_mask_fn=rec["volume_mask"],
        pv_choice_fn=rec["pv_choice"], pv_fold_fn=rec["pv_fold"],
        dyn_mask_fn=rec_dyn[0], dyn_score_fn=rec_dyn[1])
    fold_k = Recorder(k12.pv_fold, keep=())  # the last fold: the final claims
    cycle_k = build_cycle_fn(commit_mode="rounds", outputs="latency", device=dev,
                             pv_fold_fn=fold_k)
    t0 = time.time()
    dk = cycle_k(snap0)
    torch.cuda.synchronize()
    warm_ms = (time.time() - t0) * 1e3
    t0 = time.time()
    dp = cycle_vp(snap0)
    torch.cuda.synchronize()
    plain_cycle_ms = (time.time() - t0) * 1e3
    same = same_decisions(torch, dk, dp)
    log(f"phase volumes e2e-parity: kernels cycle {warm_ms:.1f} ms (warm-up), plain "
        f"cycle {plain_cycle_ms:.1f} ms, placed {int((dk.assignment >= 0).sum())}, rounds "
        f"{int(dk.placed_round.max()) + 1}; kernels == plain: {json.dumps(same)}")
    check(all(same.values()), "volume kernel cycle differs from the plain-versions cycle")
    del dp
    n_dyn = dyn_calls_equal(torch, dr, rec_dyn, "volume cycle")
    log(f"phase volumes kernels dyn_mask + dyn_score: equal to their plain versions bit for "
        f"bit on every call of the cycle ({n_dyn[0]} mask calls, {n_dyn[1]} score calls, "
        f"{n_dyn[2]} of them score anchors)")
    del rec_dyn
    n_pass, n_fold = capacity_calls_equal(torch, cap, cap_rec.args, "volume cycle")
    log(f"phase volumes kernel capacity: equal bit for bit on all {n_pass} passes and "
        f"{n_fold} revocation folds of the cycle")
    del cap_rec

    # ---- K1 with VolumeBinding's static mask operand (F_MASK) ----
    x = sb.static_base_inputs(fw, CycleContext(snap0), fit=True,
                              sampling=sampling_window(snap0, 0))
    check(bool(x.flags & sb.F_MASK), "static_base inputs carry no volume mask operand")
    _, k1_err = compare_static_base(torch, sb, x)
    log(f"phase volumes kernel static_base with the volume mask operand: [{P}, {N}] "
        f"mask equal True, max|err| {k1_err}; {int((~x.mask).sum())} (pod, node) pairs "
        "masked by VolumeBinding")
    del x

    # ---- K3, K10-K12 against their plain versions on round 0's inputs ----
    for k, r in rec.items():
        check(r.recorded(), f"{k}: inputs were not recorded ({sorted(r.args)})")
    t_args = rec["interpod_terms"].args[0]
    tk, tp = ipt.interpod_terms_cuda(*t_args), ipt.interpod_terms_plain(*t_args)
    check(all((x is None) == (y is None) and (x is None or torch.equal(x, y))
              for x, y in ((getattr(tk, f), getattr(tp, f)) for f in
                           ("aff_mask", "aff_raw", "spread_mask", "spread_raw"))),
          "interpod_terms differs from its plain version on the volume workload")
    log(f"phase volumes kernel interpod_terms: [{t_args[0].P}, {N}] round 0, equal True")
    del t_args, tk, tp
    s_args, u_args = rec["volume_mask"].args[0], rec["volume_mask"].args[1]
    check(s_args[3] is False and u_args[3] is True, "volume_mask calls out of order")
    tables = s_args[1]
    for tag, args in (("static", s_args), ("unbound", u_args)):
        check(torch.equal(k10.volume_mask_cuda(*args), vol.volume_mask_plain(*args)),
              f"volume_mask ({tag}) differs from its plain version")
    k10_ms = time_ms(torch, lambda: k10.volume_mask_cuda(*s_args), 20)
    k10u_ms = time_ms(torch, lambda: k10.volume_mask_cuda(*u_args), 20)
    k10_dev = device_ms(lambda: k10.volume_mask_cuda(*s_args), 10)
    k10u_dev = device_ms(lambda: k10.volume_mask_cuda(*u_args), 10)
    k10_plain = time_ms(torch, lambda: vol.volume_mask_plain(*s_args), 2)
    k10u_plain = time_ms(torch, lambda: vol.volume_mask_plain(*u_args), 2)
    cand_f = vol.pod_pv_cand(snap0, 0).float()
    pv_ok_f = vol.pv_node_table(snap0, tables.req).float()
    k10_lib = time_ms(torch, lambda: cand_f @ pv_ok_f, 3)
    del cand_f, pv_ok_f
    L, G = tables.node_pv.shape[0], tables.global_pv.shape[0]
    n_sub = MVol + len(vol._hall_subsets(MVol))
    walkers = int((snap0.pod_vol_mode == 1).any(dim=1).sum())
    rids = snap0.pod_vol_req[snap0.pod_vol_mode >= 0]
    k10_bytes = (P * N + P * MVol * 16 + (N + 1) * 4 + (L + G) * 4
                 + int(torch.unique(torch.cat([tables.node_pv, tables.global_pv])).numel()) * 8
                 + int(torch.unique(rids[rids >= 0]).numel()) * N)
    k10_ops = walkers * (L + N * G) * (3 * MVol + n_sub) + P * N
    log(f"phase kernel volume_mask: [{P}, {N}] equal True (static and unbound); kernel "
        f"{k10_ms:.3f} ms static, {k10u_ms:.3f} ms unbound ({k10_dev:.4f} / {k10u_dev:.4f} "
        f"ms device); plain {k10_plain:.3f} / "
        f"{k10u_plain:.3f} ms; dense count product [{P}, {V}] x [{V}, {N}] f32 "
        f"{k10_lib:.3f} ms; bound {bound(k10_bytes, k10_ops)[0]:.4f} ms; {walkers} pods "
        f"walk {L} node-list entries (mean {L / N_NODES:.2f} a node) + G = {G} global "
        f"PVs; {int((snap0.pod_vol_mode >= 0).any(dim=1).sum())} of "
        f"{int(snap0.pod_valid.sum())} pods with a volume slot")

    c_calls = rec["pv_choice"].args
    c_args = c_calls[0]
    csnap, _, cclaimed, cnode, clive = c_args
    for i, a_ in sorted(c_calls.items()):
        check(torch.equal(k11.pv_choice_cuda(*a_), vol.pv_choice_plain(*a_)),
              f"pv_choice differs from its plain version (call {i})")
    k11_ms = time_ms(torch, lambda: k11.pv_choice_cuda(*c_args), 20)
    k11_dev = device_ms(lambda: k11.pv_choice_cuda(*c_args), 20)
    k11_mean = sum(device_ms(lambda: k11.pv_choice_cuda(*a), 10)
                   for a in c_calls.values()) / len(c_calls)
    k11_prev = prev_ms(torch, kb, prev_libs, "pv_choice",
                       lambda: k11.pv_choice_cuda(*c_args), 20, device_ms)
    k11_prev_mean = None if k11_prev is None else sum(
        prev_ms(torch, kb, prev_libs, "pv_choice", lambda: k11.pv_choice_cuda(*a), 10,
                device_ms) for a in c_calls.values()) / len(c_calls)
    k11_plain = time_ms(torch, lambda: vol.pv_choice_plain(*c_args), 2)

    def list_bytes(snap_v, nodes_v, rows):
        """Bytes of the claimants' rows and of their nodes' lists (each
        node's list and each listed PV's class and capacity read once)."""
        un = torch.unique(nodes_v[rows].long())
        lens = (tables.node_off[un + 1] - tables.node_off[un]).sum()
        return int(rows.sum()) * MVol * 16 + int(lens) * 12 + G * 12 + un.numel() * 8

    c_rows = clive & (csnap.pod_vol_mode == 1).any(dim=1)
    B11 = cnode.shape[0]
    k11_bytes = B11 * (MVol * 4 + 5) + list_bytes(csnap, cnode, c_rows) + V
    k11_ops = int(c_rows.sum()) * MVol * 3 * (2 + G) * (3 * MVol + 4)
    # K12 on every round of the cycle and on a contended batch, 16 and 8 CTAs
    f_calls = rec["pv_fold"].args
    f_args = f_calls[0]
    fsnap, _, fclaimed, facc, fnode, frank = f_args
    cont = contended_fold_args(f_args)
    fold0, passes0 = vol.fold_pv_claims_passes(fsnap, tables.req, *f_args[2:])
    fold_c, passes_c = vol.fold_pv_claims_passes(fsnap, tables.req, *cont[2:])
    check(passes_c > 1, "the contended batch folded in one pass")
    for i, a_ in sorted(f_calls.items()) + [("contended", cont)]:
        want = fold0 if i == 0 else (fold_c if i == "contended" else vol.pv_fold_plain(*a_))
        for cl in (k12.CLUSTER, k12.CLUSTER_PORTABLE):
            check(torch.equal(k12.pv_fold_cuda(*a_, cluster=cl), want),
                  f"pv_fold differs from its plain version (call {i}, {cl} CTAs)")
    k12_shape = k12.fold_shape(fsnap.P, V)
    k12_ms = time_ms(torch, lambda: k12.pv_fold_cuda(*f_args), 20)
    k12_dev = device_ms(lambda: k12.pv_fold_cuda(*f_args), 20)
    k12_mean = sum(device_ms(lambda: k12.pv_fold_cuda(*a), 5)
                   for a in f_calls.values()) / len(f_calls)
    k12_cont = device_ms(lambda: k12.pv_fold_cuda(*cont), 10)
    k12_prev = k12_prev_mean = k12_prev_cont = None
    if "pv_fold" in prev_libs:  # the earlier design on the same calls
        prev_k12 = pv_fold_with(prev_libs["pv_fold"])
        check(torch.equal(prev_k12(*f_args), fold0) and torch.equal(prev_k12(*cont), fold_c),
              "the earlier pv_fold differs from the plain version")
        k12_prev = device_ms(lambda: prev_k12(*f_args), 20)
        k12_prev_mean = sum(device_ms(lambda: prev_k12(*a), 5)
                            for a in f_calls.values()) / len(f_calls)
        k12_prev_cont = device_ms(lambda: prev_k12(*cont), 10)
    k12_plain = time_ms(torch, lambda: vol.pv_fold_plain(*f_args), 2)
    f_rows = facc & (fsnap.pod_vol_mode == 1).any(dim=1)
    k12_bytes = fnode.shape[0] * 9 + list_bytes(fsnap, fnode, f_rows) + 2 * V
    k12_ops = int(f_rows.sum()) * MVol * passes0 * 3 * (2 + G) * (3 * MVol + 4)
    k11_prev_txt = ("not built" if k11_prev is None else
                    f"{k11_prev:.4f} ms device, mean {k11_prev_mean:.4f}")
    log(f"phase kernel pv_choice: {int(c_rows.sum())} claimants with unbound slots of "
        f"B={B11}; equal True on all {len(c_calls)} rounds of the cycle; kernel {k11_ms:.3f} "
        f"ms ({k11_dev:.4f} ms device, mean {k11_mean:.4f} over the rounds; earlier design: "
        f"{k11_prev_txt}), plain {k11_plain:.3f} ms, bound "
        f"{bound(k11_bytes, k11_ops)[0]:.4f} ms")
    k12_prev_txt = ("not built" if k12_prev is None else
                    f"{k12_prev:.4f} ms device, mean {k12_prev_mean:.4f}, contended "
                    f"{k12_prev_cont:.4f}")
    log(f"phase kernel pv_fold: {int(f_rows.sum())} claimants, {passes0} pass(es) in one "
        f"launch; equal True on all {len(f_calls)} rounds of the cycle and on a contended "
        f"batch ({int(cont[3].sum())} claimants at seeded nodes, {passes_c} passes), on 16 "
        f"and 8 CTAs (launch {json.dumps(k12_shape)}); kernel {k12_ms:.3f} ms "
        f"({k12_dev:.4f} ms device, mean {k12_mean:.4f} over the rounds, contended "
        f"{k12_cont:.4f}; earlier design: {k12_prev_txt}), plain {k12_plain:.3f} ms, bound "
        f"{bound(k12_bytes, k12_ops)[0]:.4f} ms")
    del rec, s_args, u_args, c_args, c_calls, f_args, f_calls, cont

    # ---- the volume main path: counts set to 0 just before, read just after ----
    results, finals = [], {}
    kb.reset_launch_counts()
    for s in AFF_TIMED_SEEDS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        start.record()
        d = cycle_k(snaps[s])
        end.record()
        torch.cuda.synchronize()
        finals[s] = fold_k.last
        results.append((s, d, start.elapsed_time(end), (time.time() - t0) * 1e3))
    launches = dict(kb.launch_counts)
    log(f"phase volumes launches over {len(AFF_TIMED_SEEDS)} cycles: {json.dumps(launches)}")
    rounds = launches["guard_sweep"]
    check(launches["volume_mask"] == rounds + len(AFF_TIMED_SEEDS),
          "volume_mask: not once per cycle plus once per round")
    check(launches["pv_choice"] == rounds and launches["pv_fold"] == rounds,
          "pv_choice / pv_fold: not once per round")
    check(launches["dyn_mask"] == rounds and launches["dyn_score"] > rounds,
          "dyn_mask / dyn_score: not once per round (and per score anchor)")
    ms, decisions = [], {}
    for s, d, dev_ms, host_ms in results:
        snap = snaps[s]
        claimed = finals[s]
        vk = VolumeKernels(vol.volume_mask_plain, vol.pv_choice_plain,
                           lambda *a, c=claimed: c)
        ctx, extra = check_placements(torch, snap, d, fw, plain_kernels, vk)
        n_anti, n_aff, n_spread = check_affinity(torch, snap, d, ctx, extra)
        n_b, n_u, n_c, n_dyn = check_volumes(torch, snap, d, ctx.volume_tables, claimed)
        ms.append(round(dev_ms, 1))
        decisions[s] = d
        log(f"phase volumes cycle seed {s}: device {dev_ms:.1f} ms, host {host_ms:.1f} ms, "
            f"placed {int((d.assignment >= 0).sum())}, unschedulable "
            f"{int(d.unschedulable.sum())}, rounds {int(d.placed_round.max()) + 1}; valid: "
            f"capacity, static masks, unplaced infeasible, {n_anti} anti, {n_aff} affinity, "
            f"{n_spread} spread; {n_b} bound claims on their PVs' nodes, {n_u} unbound slots "
            f"placed, {n_c} static PVs claimed once each, {n_dyn} slots riding dynamic")
    del results

    # ---- preemption after each cycle, with the volume gate ----
    claims = Recorder(k9.preempt_claim, keep=None)
    pre_k = build_preemption_fn(fw, device=dev, claim_fn=claims)
    pre_p = build_preemption_fn(fw, device=dev, prefilter_fn=pre.prefilter_plain,
                                whatif_fn=pre.nonresource_ok_plain,
                                claim_fn=pre.claim_loop_plain,
                                volume_mask_fn=vol.volume_mask_plain)
    pre_k(snap0, dk)
    torch.cuda.synchronize()
    timed = []
    kb.reset_launch_counts()
    for s in AFF_TIMED_SEEDS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r = pre_k(snaps[s], decisions[s])
        end.record()
        torch.cuda.synchronize()
        timed.append((s, r, start.elapsed_time(end)))
    p_launches = dict(kb.launch_counts)
    log(f"phase volumes preemption launches over {len(AFF_TIMED_SEEDS)} passes: "
        f"{json.dumps(p_launches)}")
    check(p_launches["volume_mask"] == len(AFF_TIMED_SEEDS),
          "volume_mask: not once per preemption pass")
    n_claims = claims_equal(torch, claims, "volumes preemption")
    log(f"phase volumes preemption: K9 equal to claim_loop_plain bit for bit on all "
        f"{n_claims} passes")
    pre_ms = []
    for s, r, dev_ms in timed:
        snap, d = snaps[s], decisions[s]
        rp = pre_p(snap, d)
        eq = {f: torch.equal(getattr(r, f), getattr(rp, f))
              for f in ("nominated", "victims", "num_preemptors")}
        check(all(eq.values()), f"seed {s}: kernels' preemption differs from the plain one: {eq}")
        gate_fn = _preemption_gate_rows(fw, CycleContext(snap))
        n_nom, n_vict, n_viol = check_preemption(torch, snap, d, r, gate_fn,
                                                 pre.DEFAULT_SCAN_BUDGET)
        nom = r.nominated
        ids = torch.nonzero(nom >= 0, as_tuple=True)[0]
        vol_gate = k10.volume_mask_cuda(snap, CycleContext(snap).volume_tables, None, False)
        check(bool(vol_gate[ids, nom[ids].long()].all()),
              "a nominated node fails the volume gate")
        n_vp = int((snap.pod_vol_mode[ids] >= 0).any(dim=1).sum())
        pre_ms.append(round(dev_ms, 2))
        log(f"phase volumes preemption seed {s}: device {dev_ms:.2f} ms; {n_nom} "
            f"nominations ({n_vp} of pods with volumes), {n_vict} victims, {n_viol} with "
            f"a PDB violation; kernels == plain, nominations valid incl. the volume gate "
            f"| {smi}")

    src = "k8s_scheduler_tpu_torch/csrc/"
    ref = "k8s_scheduler_tpu/ops/volumes.py:"
    entries = {
        "volume_mask": kernel_entry(
            "volume_mask", "cuda", src + "volume_mask.cu", ref + "159",
            launches["volume_mask"], 0.0, k10_ms, k10_dev, k10_plain, k10_bytes, k10_ops,
            k10_lib, unbound_device_ms=k10u_dev),
        "pv_choice": kernel_entry(
            "pv_choice", "cuda", src + "pv_choice.cu", ref + "535",
            launches["pv_choice"], 0.0, k11_ms, k11_dev, k11_plain, k11_bytes, k11_ops,
            mean_device_ms=k11_mean, prev_device_ms=k11_prev, prev_mean_device_ms=k11_prev_mean),
        "pv_fold": kernel_entry(
            "pv_fold", "cuda", src + "pv_fold.cu", ref + "419",
            launches["pv_fold"], 0.0, k12_ms, k12_dev, k12_plain, k12_bytes, k12_ops,
            mean_device_ms=k12_mean, contended_device_ms=k12_cont, prev_device_ms=k12_prev,
            prev_mean_device_ms=k12_prev_mean, prev_contended_device_ms=k12_prev_cont,
            cluster=k12_shape["cluster"]),
    }
    scan_stats = volumes_scan_leg(torch, kb, fw, dev, nodes, snaps, cut_draw, smi,
                                  plain_kernels)
    entries.update(scan_stats.pop("kernels"))
    return {"kernels": entries, "ms": ms, "pre_ms": pre_ms,
            "dyn_launches": {k: launches[k] for k in ("dyn_mask", "dyn_score")},
            "scan": scan_stats}


def scan_volume_bytes(torch, x) -> tuple[int, int]:
    """(bytes, operations) K13's volume path adds on this run's data: the
    valid pods' volume slots, the node lists and the global list, the
    listed PVs' class and capacity, the requirement rows the unbound slots
    name, the bitmap read and written; per step of a pod with an unbound
    slot, each node's list entries tested against each slot and subset."""
    V, MVol, n_sub = x.vol
    t = x.vol_tables
    valid = x.pod_valid
    nv = int(valid.sum())
    L, G = t.node_pv.shape[0], t.global_pv.shape[0]
    unb = valid & (x.vol_mode == 1).any(1)
    rids = x.vol_req[unb][x.vol_mode[unb] == 1]
    n_rows = int(torch.unique(rids[rids >= 0]).numel())
    b = (nv * MVol * 20 + (x.shape[1] + 1) * 4 + (L + G) * 4 + V * 8
         + n_rows * x.shape[1] + 2 * V)
    ops = int(unb.sum()) * (L + x.shape[1] * G) * (3 * MVol + n_sub)
    return b, ops


def volumes_scan_leg(torch, kb, fw, dev, nodes, snaps, cut_draw, smi, plain_kernels) -> dict:
    """The volumes phase's scan leg (phase 7): config #4's volume snapshots
    through `build_cycle_fn(commit_mode="scan")`, K13's volume instance
    against `scan_commit_plain` (the first timed seed in the latency mode,
    its 2048-pod cut with full N and V in the full mode), K13's us a step
    at full size with
    VolumeBinding on and off on one snapshot, three timed cycles whose
    placements and claims are checked, DefaultPreemption after each.
    Returns {"kernels": {...}, "ms": [...], "pre_ms": [...]}."""
    from k8s_scheduler_tpu_torch.config import (PluginSet, Plugins, Profile,
                                                SchedulerConfiguration)
    from k8s_scheduler_tpu_torch.core.cycle import (_preemption_gate_rows, build_cycle_fn,
                                                    build_preemption_fn, sampling_window)
    from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext, VolumeKernels
    from k8s_scheduler_tpu_torch.framework.runtime import Framework
    from k8s_scheduler_tpu_torch.kernel_variants import kernel_ms, states_equal
    from k8s_scheduler_tpu_torch import models as port_models
    from k8s_scheduler_tpu_torch.models import SnapshotEncoder
    from k8s_scheduler_tpu_torch.ops import preempt_claim as k9
    from k8s_scheduler_tpu_torch.ops import preemption as pre
    from k8s_scheduler_tpu_torch.ops import scan_commit as sc
    from k8s_scheduler_tpu_torch.ops import static_base as sb
    from k8s_scheduler_tpu_torch.ops import volume_mask as k10
    from k8s_scheduler_tpu_torch.ops import volumes as vol
    from k8s_scheduler_tpu_torch.utils import kernel_cases as kc

    def packed(snap, fw_=fw, full=False):
        ctx = CycleContext(snap)
        sbase = sb.static_base_cuda(sb.static_base_inputs(
            fw_, ctx, fit=not full, sampling=sampling_window(snap, 0)))
        return sc.scan_commit_inputs(fw_, ctx, sbase, fw_.extra_init(ctx), rejects=full)

    def kernel_vs_plain(xc, tag):
        check(bool(xc.flags & sc.F_VOLUMES), f"{tag}: the scan inputs carry no volumes")
        rk = sc.scan_commit_cuda(xc)
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        rp = sc.scan_commit_plain(xc)
        end.record()
        torch.cuda.synchronize()
        eq = {"assignment": torch.equal(rk.assignment, rp.assignment),
              "node_requested": torch.equal(rk.node_requested, rp.node_requested),
              "ports": torch.equal(rk.ports, rp.ports),
              "affinity tables": states_equal(rk.state, rp.state),
              "pv_claimed": torch.equal(rk.pv_claimed, rp.pv_claimed)}
        if xc.full:
            eq["rejects"] = torch.equal(rk.rejects, rp.rejects)
        log(f"phase volumes scan, kernel scan_commit, {tag}: kernel == plain: "
            f"{json.dumps(eq)}; placed {int((rk.assignment >= 0).sum())}, "
            f"{int(rk.pv_claimed.sum())} PVs claimed | {smi}")
        check(all(eq.values()), f"scan_commit with volumes differs from its plain version "
                                f"({tag})")
        return rk, start.elapsed_time(end)

    seed = AFF_TIMED_SEEDS[0]
    # the gang edge case's full scan cycle: the unwound members' claims
    # released by the refold (K12) over the survivors
    tag = "a gang that unwinds after claiming"
    g_nodes, g_pods, g_ex, g_opts = kc.scan_volume_objects(port_models, (tag,))[tag]
    gsnap = kc.encode_case(SnapshotEncoder(device=dev), g_nodes, g_pods, g_ex, g_opts)
    kb.reset_launch_counts()
    gk = build_cycle_fn(fw, commit_mode="scan", device=dev)(gsnap)
    torch.cuda.synchronize()
    g_launch = dict(kb.launch_counts)
    gp = build_cycle_fn(fw, commit_mode="scan", device=dev, **plain_kwargs())(gsnap)
    eq = results_equal(torch, gk, gp)
    check(all(eq.values()) and g_launch["scan_commit"] == 1 and g_launch["pv_fold"] == 1,
          f"the gang edge case's full scan cycle differs from the plain versions' ({eq}) or "
          f"took other launches ({g_launch})")
    check(torch.nonzero(gk.pv_claimed).flatten().tolist() == [2] and bool(gk.gang_dropped.any()),
          "the gang edge case did not unwind its claims")
    log(f"phase volumes scan, gang edge case: full scan cycle equal to the plain versions' "
        f"(every field), the unwound members' claims released by one K12 refold")
    cycle_s = build_cycle_fn(fw, commit_mode="scan", outputs="latency", device=dev)
    t0 = time.time()
    dw = cycle_s(snaps[AFF_WARM_SEED])
    torch.cuda.synchronize()
    log(f"phase volumes scan warm-up cycle: {(time.time() - t0) * 1e3:.1f} ms, placed "
        f"{int((dw.assignment >= 0).sum())}")
    del dw

    # ---- K13's volume instance against scan_commit_plain: the full mode
    # on the cut, then the latency mode at full size ----
    ex, pods, pvcs, pvs, classes = cut_draw
    snap_cut = SnapshotEncoder(device=dev).encode(nodes, pods[:SCAN_CUT], ex, pvcs=pvcs,
                                                  pvs=pvs, storage_classes=classes)
    check(snap_cut.pv_avail.shape == snaps[seed].pv_avail.shape,
          "the cut's PV table is not the full one")
    xf = packed(snap_cut, full=True)
    rf, _ = kernel_vs_plain(xf, f"full mode, the first {SCAN_CUT} pending pods of seed "
                                f"{seed} (full N and V)")
    col = fw.filter_names.index("VolumeBinding")
    log(f"phase volumes scan, kernel scan_commit full mode: VolumeBinding's column "
        f"{col} counts {int(rf.rejects[:, col].sum())} first rejections over "
        f"{int((rf.rejects[:, col] > 0).sum())} pods, equal to the plain version's")
    # the latency mode against its plain version on the same cut (phase 6
    # holds the scan's instance without volumes at full size; the full-size
    # plain run with volumes took 150 s and pays for phase 14)
    _rl, cut_plain = kernel_vs_plain(packed(snap_cut), f"latency mode, the first {SCAN_CUT} "
                                     f"pending pods of seed {seed} (full N and V)")
    del xf, rf, snap_cut, _rl
    # full size: the kernel alone on the first timed seed's snapshot, then
    # on the same snapshot with VolumeBinding off
    x = packed(snaps[seed])
    nv = int(x.pod_valid.sum())
    R = x.pod_requested.shape[1]
    rk = sc.scan_commit_cuda(x)
    # K13's us a step on the same snapshot with VolumeBinding on and off
    no_vb = Framework.from_config(SchedulerConfiguration(profiles=[Profile(
        plugins=Plugins(filter=PluginSet(disabled=["VolumeBinding"])))]))
    x_off = packed(snaps[seed], no_vb)
    check(not x_off.flags & sc.F_VOLUMES, "the profile without VolumeBinding packs volumes")
    shape = sc.scan_shape(x)
    shape_off = sc.scan_shape(x_off)
    on_ms = time_ms(torch, lambda: sc.scan_commit_cuda(x), 3)
    on_dev = profiled_device_ms(torch, lambda: sc.scan_commit_cuda(x), 2)
    on_kernel = kernel_ms(lambda: sc.scan_commit_cuda(x), 2, "scan_kernel")
    off_kernel = kernel_ms(lambda: sc.scan_commit_cuda(x_off), 2, "scan_kernel")
    on_kernel2 = kernel_ms(lambda: sc.scan_commit_cuda(x), 2, "scan_kernel")
    V, MVol, n_sub = x.vol
    walkers = int((x.pod_valid & (x.vol_mode == 1).any(1)).sum())
    vb_bytes, vb_ops = scan_volume_bytes(torch, x)
    full_bytes = scan_bytes(torch, x, rk) + vb_bytes
    full_ops = nv * x.shape[1] * (10 * R + 8) + vb_ops
    k13_bound, k13_by = bound(full_bytes, full_ops)
    log(f"phase volumes scan, kernel scan_commit us a step: VolumeBinding on "
        f"{1e3 * on_kernel / nv:.3f} (again {1e3 * on_kernel2 / nv:.3f}), off "
        f"{1e3 * off_kernel / nv:.3f} on the same snapshot ({nv} steps, {walkers} of them "
        f"pods with an unbound slot; V={V}, MVol={MVol}, {n_sub} slot subsets, L="
        f"{x.vol_tables.node_pv.shape[0]} list entries, G={x.vol_tables.global_pv.shape[0]}); "
        f"kernel alone {on_kernel:.3f} / {off_kernel:.3f} ms, wrapper {on_ms:.3f} ms "
        f"({on_dev:.3f} device, torch.profiler), plain {cut_plain:.1f} ms on the "
        f"{SCAN_CUT}-pod cut ({cut_plain / SCAN_CUT:.3f} ms a step), bound {k13_bound:.4f} "
        f"ms ({k13_by}); "
        f"cluster {shape['cluster']} ({shape['smem']} bytes of "
        f"shared memory a CTA, {shape['smem'] - shape_off['smem']} more than without "
        f"volumes) | {smi}")
    del x, x_off, rk

    # ---- the scan main path with volumes: counts set to 0 just before,
    # read just after ----
    seen, finals = [], {}

    def scan_fn(xs):
        seen.append(bool(xs.flags & sc.F_VOLUMES))
        r = sc.scan_commit(xs)
        finals[len(seen)] = r.pv_claimed
        return r

    cycle_t = build_cycle_fn(fw, commit_mode="scan", outputs="latency", device=dev,
                             scan_commit_fn=scan_fn)
    results, launches = timed_cycles(torch, kb, cycle_t, snaps, AFF_TIMED_SEEDS)
    log(f"phase volumes scan launches over {len(AFF_TIMED_SEEDS)} cycles: "
        f"{json.dumps(launches)}")
    n = len(AFF_TIMED_SEEDS)
    check(launches["scan_commit"] == n and seen == [True] * n,
          "the volume scan took other than one K13 launch of its volume instance a cycle")
    check(launches["static_base"] == n and launches["volume_mask"] == n,
          "K1 / K10 (static) not once per volume scan cycle")
    check(all(launches[k] == 0 for k in ("claim_pass", "capacity", "pv_choice", "dyn_mask")),
          "a scan cycle launched the rounds engine's kernels")
    claims = Recorder(k9.preempt_claim, keep=None)
    pre_k = build_preemption_fn(fw, device=dev, claim_fn=claims)
    pre_p = build_preemption_fn(fw, device=dev, prefilter_fn=pre.prefilter_plain,
                                whatif_fn=pre.nonresource_ok_plain,
                                claim_fn=pre.claim_loop_plain,
                                volume_mask_fn=vol.volume_mask_plain)
    ms, pre_ms = [], []
    kb.reset_launch_counts()
    for i, (s, d, dev_ms, host_ms) in enumerate(results):
        snap = snaps[s]
        claimed = finals[i + 1]
        vk = VolumeKernels(vol.volume_mask_plain, vol.pv_choice_plain,
                           lambda *a, c=claimed: c)
        ctx, _ = check_placements(torch, snap, d, fw, plain_kernels, vk,
                                  unplaced_infeasible=False)
        n_anti, n_aff, n_spread = check_scan_affinity(torch, snap, d, ctx)
        n_b, n_u, n_c, n_dyn = check_volumes(torch, snap, d, ctx.volume_tables, claimed)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rk = pre_k(snap, d)
        end.record()
        torch.cuda.synchronize()
        p_ms = start.elapsed_time(end)
        rp = pre_p(snap, d)
        same = {f: torch.equal(getattr(rk, f), getattr(rp, f))
                for f in ("nominated", "victims", "num_preemptors")}
        check(all(same.values()), f"seed {s}: preemption after the volume scan differs from "
              f"the plain versions' pass: {same}")
        n_nom, n_vict, _ = check_preemption(torch, snap, d, rk, _preemption_gate_rows(
            fw, CycleContext(snap)), pre.DEFAULT_SCAN_BUDGET)
        nom = rk.nominated
        ids = torch.nonzero(nom >= 0, as_tuple=True)[0]
        gate = k10.volume_mask_cuda(snap, CycleContext(snap).volume_tables, None, False)
        check(bool(gate[ids, nom[ids].long()].all()), "a nominated node fails the volume gate")
        ms.append(round(dev_ms, 1))
        pre_ms.append(round(p_ms, 2))
        log(f"phase volumes scan cycle seed {s}: device {dev_ms:.1f} ms, host {host_ms:.1f} "
            f"ms, placed {int((d.assignment >= 0).sum())}, unschedulable "
            f"{int(d.unschedulable.sum())}; valid: capacity, static masks, at each pod's "
            f"step {n_anti} anti terms, {n_aff} affinity terms, {n_spread} DoNotSchedule "
            f"constraints; {n_b} bound claims on their PVs' nodes, {n_u} unbound slots "
            f"placed, {n_c} static PVs claimed once each, {n_dyn} slots riding dynamic; "
            f"preemption after it {p_ms:.2f} ms device, {n_nom} nominations, {n_vict} "
            f"victims, kernels == plain, nominations valid incl. the volume gate | {smi}")
    pre_launch = dict(kb.launch_counts)
    check(pre_launch["preempt_claim"] >= n and pre_launch["scan_commit"] == 0,
          "preemption after the volume scan did not run its kernels")
    n_claims = claims_equal(torch, claims, "preemption after the volume scan")
    log(f"phase volumes scan preemption: K9 equal to claim_loop_plain bit for bit on all "
        f"{n_claims} passes")
    del results

    # ms, device_ms and the bound at full size; plain_ms on the SCAN_CUT-pod
    # cut of the same seed (full N and V), where the plain version is held
    entry = kernel_entry(
        "scan_commit_volumes", "cuda", "k8s_scheduler_tpu_torch/csrc/scan_commit.cu",
        "k8s_scheduler_tpu/framework/plugins.py:250", launches["scan_commit"], 0.0,
        on_ms, on_dev, cut_plain, full_bytes, full_ops, device_ms_by="torch.profiler",
        inputs=f"the pending pods of seed {seed}, full size", plain_pods=SCAN_CUT,
        kernel_alone_ms=on_kernel,
        us_per_step=1e3 * on_kernel / nv,
        us_per_step_without_volumebinding=1e3 * off_kernel / nv,
        extra_replaces=["k8s_scheduler_tpu/framework/plugins.py:267",
                        "k8s_scheduler_tpu/ops/volumes.py:242",
                        "k8s_scheduler_tpu/ops/volumes.py:400",
                        "k8s_scheduler_tpu/ops/volumes.py:567"],
        cluster=shape["cluster"])
    return {"kernels": {"scan_commit_volumes": entry}, "ms": ms, "pre_ms": pre_ms}


def check_scan_affinity(torch, snap, d, ctx):
    """Inter-pod constraints of every scan placement, each checked at the
    pod's own step: a host replay in rank order over the placed pods that
    keeps the (selector, domain) counts, totals and anti-affinity owners'
    domains in numpy, seeded with the running pods:
      - required anti-affinity: no matching pod in the pod's domain;
      - symmetric: no running or earlier-placed pod's anti term whose
        selector matches the pod covers its node;
      - required affinity: a matching pod in the domain, or nothing matching
        anywhere and the pod matching its own term (bootstrap);
      - DoNotSchedule: the key present, count + 1 - min over the key's
        domains <= maxSkew.
    Returns counts of the checked terms."""
    import numpy as np

    from k8s_scheduler_tpu_torch.models import encoding as enc
    from k8s_scheduler_tpu_torch.ops import interpod as ip

    check(not bool(d.gang_dropped.any()), "the replay needs every committed pod's node")
    S, D = snap.sel_exprs.shape[0], snap.domain_key.shape[0]
    mp = ctx.matched_pending.cpu().numpy()  # [S, P]
    state0 = ctx.initial_affinity_state()
    counts = state0.counts.double().cpu().numpy().copy()
    total = state0.total.double().cpu().numpy().copy()
    anti_flat = ip._flat_table(snap.exist_anti_terms, None, ip._exist_domains(snap),
                               S, D).cpu().numpy().copy()  # [S, D] owners' domains
    nd = snap.node_domains.cpu().numpy()
    dkey = snap.domain_key.cpu().numpy()
    elig = [np.flatnonzero((dkey == k) & (snap.domain_node_count.cpu().numpy() > 0))
            for k in range(nd.shape[1])]
    aff, anti = snap.pod_aff_terms.cpu().numpy(), snap.pod_anti_terms.cpu().numpy()
    tsc, skew = snap.pod_tsc.cpu().numpy(), snap.pod_tsc_skew.cpu().numpy()
    a = d.assignment.cpu().numpy()
    order = np.argsort(snap.pod_order.cpu().numpy(), kind="stable")
    n_anti = n_aff = n_spread = 0
    for p in order[a[order] >= 0]:
        n = a[p]
        dom = nd[n]
        sels = np.flatnonzero(mp[:, p])
        for sel, k in anti[p]:
            if sel >= 0 and dom[k] >= 0:
                check(counts[sel, dom[k]] == 0, f"pod {p}: required anti-affinity violated")
                n_anti += 1
        hit = anti_flat[sels][:, dom[dom >= 0]] if len(sels) else np.zeros((0, 0), bool)
        check(not hit.any(), f"pod {p}: an anti term of a placed or running pod covers it")
        for sel, k in aff[p]:
            if sel >= 0:
                boot = total[sel] == 0 and mp[sel, p]
                check(boot or (dom[k] >= 0 and counts[sel, dom[k]] > 0),
                      f"pod {p}: required affinity unsatisfied")
                n_aff += 1
        for (k, sel, when), sk in zip(tsc[p], skew[p]):
            if k >= 0 and when == enc.WHEN_DO_NOT_SCHEDULE:
                check(dom[k] >= 0, f"pod {p}: spread key absent at its node")
                minc = counts[sel, elig[k]].min() if len(elig[k]) else 0.0
                check(counts[sel, dom[k]] + 1 - minc <= sk,
                      f"pod {p}: DoNotSchedule skew exceeded at its step")
                n_spread += 1
        for k in range(nd.shape[1]):
            if dom[k] >= 0:
                counts[sels, dom[k]] += 1
        total[sels] += 1
        for sel, k in anti[p]:
            if sel >= 0 and dom[k] >= 0:
                anti_flat[sel, dom[k]] = True
    return n_anti, n_aff, n_spread


def scan_phase(torch, kb, fw, dev, nodes, existing, pending, snaps, smi, slice1_case,
               plain_kernels, prev_libs):
    """Phase 6 (module docstring). Returns {"kernels": entries, "ms": [...],
    "pre_ms": [...]}."""
    import numpy as np

    from k8s_scheduler_tpu_torch.core.cycle import (_preemption_gate_rows, build_cycle_fn,
                                                    build_preemption_fn, sampling_window)
    from k8s_scheduler_tpu_torch.config import (PluginSet, Plugins, Profile,
                                                SchedulerConfiguration)
    from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext
    from k8s_scheduler_tpu_torch.framework.runtime import Framework
    from k8s_scheduler_tpu_torch.kernel_variants import kernel_ms, scan_with, scans_equal
    from k8s_scheduler_tpu_torch.models import SnapshotEncoder
    from k8s_scheduler_tpu_torch.models import encoding as enc_mod
    from k8s_scheduler_tpu_torch.ops import preempt_claim as k9
    from k8s_scheduler_tpu_torch.ops import preemption as pre
    from k8s_scheduler_tpu_torch.ops import scan_commit as sc
    from k8s_scheduler_tpu_torch.ops import static_base as sb

    cycle_s = build_cycle_fn(fw, commit_mode="scan", outputs="latency", device=dev)
    t0 = time.time()
    dw = cycle_s(snaps[AFF_WARM_SEED])
    torch.cuda.synchronize()
    log(f"phase scan warm-up cycle: {(time.time() - t0) * 1e3:.1f} ms, placed "
        f"{int((dw.assignment >= 0).sum())}")

    def packed(snap, fw_=fw):
        ctx = CycleContext(snap)
        sbase = sb.static_base_cuda(sb.static_base_inputs(
            fw_, ctx, fit=True, sampling=sampling_window(snap, 0)))
        return sc.scan_commit_inputs(fw_, ctx, sbase, fw_.extra_init(ctx))

    # K13 against its plain version at full size on one seed (the plain
    # scan takes 7-10 ms per step on the card, 70-105 s at 10000 pods)
    def kernel_vs_plain(xc, tag):
        rk = sc.scan_commit_cuda(xc)
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        rp = sc.scan_commit_plain(xc)
        end.record()
        torch.cuda.synchronize()
        eq = {"assignment": torch.equal(rk.assignment, rp.assignment),
              "node_requested": torch.equal(rk.node_requested, rp.node_requested),
              "ports": torch.equal(rk.ports, rp.ports),
              **{f: torch.equal(getattr(rk.state, f), getattr(rp.state, f))
                 for f in ("counts", "total", "anti_presence", "pref_sym")}}
        log(f"phase kernel scan_commit, {tag}: kernel == plain: {json.dumps(eq)}")
        check(all(eq.values()), f"scan_commit differs from its plain version ({tag})")
        return rk, start.elapsed_time(end)

    seed = AFF_TIMED_SEEDS[0]
    x = packed(snaps[seed])
    nv = int(x.pod_valid.sum())
    rk, k13_plain = kernel_vs_plain(x, f"full size, seed {seed}")
    k13_shape = sc.scan_shape(x)
    k13_ms = time_ms(torch, lambda: sc.scan_commit_cuda(x), 3)
    k13_dev = profiled_device_ms(torch, lambda: sc.scan_commit_cuda(x), 2)
    k13_kernel = kernel_ms(lambda: sc.scan_commit_cuda(x), 2, "scan_kernel")
    k13_prev = None
    if "scan_commit" in prev_libs:  # the earlier design on the same inputs
        prev_k13 = scan_with(prev_libs["scan_commit"])  # its own C interface
        check(scans_equal(prev_k13(x), rk),
              "the earlier scan_commit differs from the kernel")
        k13_prev = kernel_ms(lambda: prev_k13(x), 2, "scan_kernel")
    k13_bytes = scan_bytes(torch, x, rk)
    n_sel = int(x.sel_ptr[-1])
    n_terms = int(((x.aff_terms[..., 0] >= 0).sum() + (x.anti_terms[..., 0] >= 0).sum()
                   + (x.pref_terms[..., 0] >= 0).sum() + (x.tsc[..., 0] >= 0).sum()))
    # per step and node: static test, fit (2R), two resource scores (~8R),
    # the sum and the argmax; per term and matched selector one lookup
    R = x.pod_requested.shape[1]
    k13_ops = nv * x.shape[1] * (10 * R + 8) + (n_terms + n_sel) * x.shape[1]
    k13_bound, k13_by = bound(k13_bytes, k13_ops)
    log(f"phase kernel scan_commit: full size, {nv} steps over [{x.shape[1]}] nodes on a "
        f"cluster of {k13_shape['cluster']} CTAs ({k13_shape['slice']} nodes each, "
        f"{k13_shape['smem']} bytes of shared memory): kernel {k13_ms:.3f} ms ({k13_dev:.3f} "
        f"ms device, torch.profiler; the kernel alone {k13_kernel:.3f} ms, "
        f"{1e3 * k13_kernel / nv:.3f} us per step; earlier design "
        f"{'not built' if k13_prev is None else f'{k13_prev:.3f} ms, {1e3 * k13_prev / nv:.3f} us per step'}"
        f"), plain "
        f"{k13_plain:.1f} ms ({k13_plain / nv:.3f} ms per step), bound {k13_bound:.4f} ms "
        f"({k13_by}, bytes {k13_bytes}); placed {int((rk.assignment >= 0).sum())}; "
        f"{n_terms} pod terms, {n_sel} matched selectors | {smi}")
    del rk, x
    # config #4's workload has no preferred term, no ScheduleAnyway
    # constraint, no nominated pod and no host port: hold K13 also on a
    # seeded variant that has all four, on the same cluster with the
    # pending set cut to its first SCAN_CUT pods
    snap_cut = SnapshotEncoder(device=dev).encode(nodes, pending[seed][:SCAN_CUT], existing)
    vsnap = scan_variant(torch, snap_cut, torch.Generator(device=dev).manual_seed(11))
    xv = packed(vsnap)
    rv, _ = kernel_vs_plain(xv, f"the first {SCAN_CUT} pending pods of seed {seed}, "
                                "preferred / ScheduleAnyway / nominated / host-port variant")
    noms = vsnap.pod_nominated
    honoured = int(((noms >= 0) & (rv.assignment == noms)).sum())
    log(f"phase kernel scan_commit variant: {int((vsnap.pod_pref_aff[..., 0] >= 0).sum())} "
        f"preferred terms, {int(((vsnap.pod_tsc[..., 0] >= 0) & (vsnap.pod_tsc[..., 2] == enc_mod.WHEN_SCHEDULE_ANYWAY)).sum())} "
        f"soft constraints, {int((noms[vsnap.pod_valid] >= 0).sum())} nominations "
        f"({honoured} honoured), {int(rv.ports.sum())} host ports claimed, max |pref_sym| "
        f"{float(rv.state.pref_sym.abs().max())}")
    check(honoured > 0 and bool(rv.ports.any()), "the scan variant left a path cold")
    # a profile whose one dynamic score is BalancedAllocation: the score sum
    # is one bare product, fused into the static score's add
    bal = SchedulerConfiguration(profiles=[Profile(plugins=Plugins(score=PluginSet(
        disabled=["NodeResourcesFit", "InterPodAffinity", "PodTopologySpread"])))])
    xb = packed(vsnap, Framework.from_config(bal))
    check(xb.terms == ((sc.T_BALANCED, 1.0),), "the lone-product profile packs other terms")
    kernel_vs_plain(xb, "variant, BalancedAllocation the one dynamic score")
    # resource scores averaged over three resources (the reciprocal of the
    # weight sum and of the resource count) and, on the first 512 of those
    # pods, over all four (the sum of rounded products, the fused variance)
    vsnap512 = scan_variant(torch, SnapshotEncoder(device=dev).encode(
        nodes, pending[seed][:512], existing), torch.Generator(device=dev).manual_seed(11))
    for res, vs in ((RESOURCES_3, vsnap), (RESOURCES_3 + ("pods",), vsnap512)):
        xr = packed(vs, Framework.from_config(resource_profile(res)))
        check(xr.fit_rwsum == xr.bal_rn == float(np.float32(1) / np.float32(len(res))),
              "the resource-mean profile packs other constants")
        kernel_vs_plain(xr, f"variant ({int(vs.pod_valid.sum())} pods), resource scores "
                            f"over {', '.join(res)}")
    del xv, xb, xr, rv, vsnap, vsnap512, snap_cut

    # the scan main path: counts set to 0 just before, read just after
    results, launches = timed_cycles(torch, kb, cycle_s, snaps, AFF_TIMED_SEEDS)
    log(f"phase scan launches over {len(AFF_TIMED_SEEDS)} cycles: {json.dumps(launches)}")
    check(launches["scan_commit"] == len(AFF_TIMED_SEEDS),
          "the scan commit took other than one launch per cycle")
    check(launches["static_base"] == len(AFF_TIMED_SEEDS), "K1 not once per scan cycle")
    check(launches["claim_pass"] == 0 and launches["capacity"] == 0,
          "a scan cycle launched the rounds engine's kernels")
    claims = Recorder(k9.preempt_claim, keep=None)
    pre_k = build_preemption_fn(fw, device=dev, claim_fn=claims)
    pre_p = build_preemption_fn(fw, device=dev, prefilter_fn=pre.prefilter_plain,
                                whatif_fn=pre.nonresource_ok_plain,
                                claim_fn=pre.claim_loop_plain)
    ms, pre_ms = [], []
    kb.reset_launch_counts()
    for s, d, dev_ms, host_ms in results:
        snap = snaps[s]
        ctx, _ = check_placements(torch, snap, d, fw, plain_kernels,
                                  unplaced_infeasible=False)
        n_anti, n_aff, n_spread = check_scan_affinity(torch, snap, d, ctx)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rk = pre_k(snap, d)
        end.record()
        torch.cuda.synchronize()
        p_ms = start.elapsed_time(end)
        rp = pre_p(snap, d)
        same = {f: torch.equal(getattr(rk, f), getattr(rp, f))
                for f in ("nominated", "victims", "num_preemptors")}
        check(all(same.values()), f"seed {s}: preemption after the scan differs from the "
              f"plain versions' pass: {same}")
        n_nom, n_vict, _ = check_preemption(torch, snap, d, rk,
                                            _preemption_gate_rows(fw, CycleContext(snap)),
                                            pre.DEFAULT_SCAN_BUDGET)
        ms.append(round(dev_ms, 1))
        pre_ms.append(round(p_ms, 2))
        log(f"phase scan cycle seed {s}: device {dev_ms:.1f} ms, host {host_ms:.1f} ms, "
            f"placed {int((d.assignment >= 0).sum())}, unschedulable "
            f"{int(d.unschedulable.sum())}; valid: capacity, static masks, at each pod's "
            f"step {n_anti} anti terms, {n_aff} affinity terms, {n_spread} DoNotSchedule "
            f"constraints; preemption after it {p_ms:.2f} ms device, {n_nom} nominations, "
            f"{n_vict} victims, kernels == plain, nominations valid")
    pre_launch = dict(kb.launch_counts)
    check(pre_launch["preempt_claim"] >= len(AFF_TIMED_SEEDS) and pre_launch["scan_commit"] == 0,
          "preemption after the scan did not run its kernels")
    n_claims = claims_equal(torch, claims, "preemption after the scan")
    log(f"phase scan preemption: K9 equal to claim_loop_plain bit for bit on all "
        f"{n_claims} passes")
    # the scan decides each pod once, at its rank; a second scan cycle over
    # the pods the first left unplaced, with its placements running, places
    # those that later placements made feasible (the rounds engine retries
    # a rejected pod in its later rounds)
    s, d = results[0][0], results[0][1]
    a = d.assignment[:len(pending[s])].tolist()
    ex2 = existing + [(p, nodes[n].metadata.name) for p, n in zip(pending[s], a) if n >= 0]
    left = [p for p, n in zip(pending[s], a) if n < 0]
    d2 = cycle_s(SnapshotEncoder(device=dev).encode(nodes, left, ex2))
    log(f"phase scan second pass, seed {s}: of the {len(left)} pods the scan left "
        f"unplaced, a second scan cycle with its placements running places "
        f"{int((d2.assignment >= 0).sum())}")

    # slice 1's workload: resource-only dynamic filters, so an unplaced pod
    # stays infeasible against the final state
    snap1 = slice1_case[0]
    kernel_vs_plain(packed(snap1), "slice 1's workload (resource-only dynamic filters)")
    kb.reset_launch_counts()
    d1 = cycle_s(snap1)
    torch.cuda.synchronize()
    check(kb.launch_counts["scan_commit"] == 1, "slice-1 scan cycle: K13 not launched once")
    check_placements(torch, snap1, d1, fw, plain_kernels)
    log(f"phase scan on slice 1's workload: placed {int((d1.assignment >= 0).sum())}, "
        f"unschedulable {int(d1.unschedulable.sum())}; valid: capacity, static masks, "
        f"unplaced infeasible against the final state")

    entry = kernel_entry(
        "scan_commit", "cuda", "k8s_scheduler_tpu_torch/csrc/scan_commit.cu",
        "k8s_scheduler_tpu/ops/commit.py:63", launches["scan_commit"], 0.0,
        k13_ms, k13_dev, k13_plain, k13_bytes, k13_ops, device_ms_by="torch.profiler",
        kernel_ms=k13_kernel, us_per_step=1e3 * k13_kernel / nv, prev_device_ms=k13_prev,
        cluster=k13_shape["cluster"])
    return {"kernels": {"scan_commit": entry}, "ms": ms, "pre_ms": pre_ms}


def static_reject_cost(torch, x, rows=None, survivors=False) -> tuple[int, int]:
    """(bytes, operations) of K16's function on these inputs, whatever
    implements it: the rows it needs (every row with the survivors plane,
    else the counted ones); every operand its tests read, once (the per-pod
    ids and port slots, the node vectors and port lists, the toleration
    table, the requirement table, the needed rows of the mask operand,
    `rows`), the i32 [P, F] output and the survivors plane written once; a
    test a 32-node word and needed row for each filter the flags name (a
    word of bits is one operation)."""
    from k8s_scheduler_tpu_torch.ops import static_base as sb

    P, N = x.shape
    need = P if survivors or rows is None else int(rows.sum())
    b = nbytes(x.pod_node_name, x.pod_tolset, x.pod_req_id, x.pod_sel_req_id, x.pod_ports,
               x.node_valid, x.node_unsched, x.node_taintset, x.node_used_ports, x.sched,
               x.req, rows) + P * x.n_filters * 4 + (P * N if survivors else 0)
    if x.flags & sb.F_MASK:
        b += need * N
    tests = sum(bool(x.flags & bit) for _, bit in sb.REJECT_TESTS)
    return b, need * (-(-N // 32)) * tests


def dyn_reject_cost(torch, start, parts, F, rows) -> tuple[int, int]:
    """(bytes, operations) of K17's function on these inputs: the counted
    rows' bytes of the start mask and of each plane, a FitMask's requests
    and node tables, a PortMask's ids and claimed bitmap and `rows` read
    once, the i32 [B, F] output written once; a test a (counted row, node)
    pair for each part (R compares for the fit), and its count."""
    from k8s_scheduler_tpu_torch.ops import dyn_round as dr

    B, N = start.shape
    need = B if rows is None else int(rows.sum())
    b, per = need * N + nbytes(rows) + B * F * 4, 1
    for _, p in parts:
        if isinstance(p, dr.FitMask):
            b += nbytes(*p)
            per += p.pod_requested.shape[1]
        elif isinstance(p, dr.PortMask):
            b += nbytes(*p)
            per += p.pod_port_ids.shape[1]
        else:
            b += need * N
            per += 1
    return b, need * N * per


def reject_kernel_entries(torch, full_stats, carry_stats, prev_libs) -> dict:
    """K16's and K17's lines of the kernel table. Each kernel is held
    against its plain version on every call that the full rounds cycles
    (with and without volumes) and the diagnosis programs' windows (both
    carry variants) recorded, K16's window calls with the survivors plane;
    timed on the full rounds cycle's call (no volumes: K16 over every pod
    row, K17 on the final window) and on the first diagnosis window of the
    carry phase's last frame (no volumes), `device_ms` by CUDA-graph
    replays; with --prev-csrc, the earlier design (K16 and K17 in
    csrc/static_base.cu and csrc/dyn_round.cu) on the same calls, K16's
    window without the plane (that design had none); launches over the
    full cycles and the diagnosis frames."""
    from k8s_scheduler_tpu_torch.kernel_variants import (device_ms, prev_static_rejects,
                                                         rejects_equal, with_library)
    from k8s_scheduler_tpu_torch.ops import dyn_round as dr
    from k8s_scheduler_tpu_torch.ops import static_base as sb

    recorded = {"static_rejects": [], "dyn_rejects": []}
    for tag, (c16, c17) in full_stats["calls"].items():
        recorded["static_rejects"] += [(f"full {tag}", a) for a in c16.values()]
        recorded["dyn_rejects"] += [(f"full {tag}", a) for a in c17.values()]
    for v, c in carry_stats.items():
        c16, c17 = c["diagnosis"]["calls"]
        tag = "diagnosis, volumes" if v else "diagnosis"
        recorded["static_rejects"] += [(tag, a) for a in c16.values()]
        recorded["dyn_rejects"] += [(tag, a) for a in c17.values()]
    full16, full17 = full_stats["calls"]["rounds"]
    diag16, diag17 = carry_stats[False]["diagnosis"]["calls"]
    launches = {k: full_stats["launches"][k] + sum(c["diagnosis"]["launches"][k]
                                                    for c in carry_stats.values())
                for k in ("static_rejects", "dyn_rejects")}

    def prev16(a):  # the earlier K16: no survivors plane
        return prev_static_rejects(prev_libs["static_base"], a[0], *a[1:2])

    def prev17(a):
        return with_library("dyn_rejects", prev_libs["dyn_round"],
                            lambda: dr.dyn_rejects_cuda(*a))

    out = {}
    for name, fn, plain, cost, full_call, diag_call, replaces, prev in (
            ("static_rejects", sb.static_rejects_cuda, sb.static_rejects_plain,
             static_reject_cost, full16[0], diag16.get(0),
             "k8s_scheduler_tpu/framework/runtime.py:79",
             prev16 if "static_base" in prev_libs else None),
            ("dyn_rejects", dr.dyn_rejects_cuda, dr.dyn_rejects_plain, dyn_reject_cost,
             full17[0], diag17.get(0), "k8s_scheduler_tpu/framework/runtime.py:223",
             prev17 if "dyn_round" in prev_libs else None)):
        for tag, a in recorded[name]:
            got = fn(*a)
            check(rejects_equal(got, plain(*a)),
                  f"{name} differs from its plain version on a recorded call ({tag})")
            if prev is not None:
                check(torch.equal(got[0] if isinstance(got, tuple) else got, prev(a)),
                      f"{name}: the earlier design counts otherwise on a recorded call ({tag})")
        a = full_call
        ms = time_ms(torch, lambda: fn(*a), 10)
        dms = device_ms(lambda: fn(*a), 10)
        pms = time_ms(torch, lambda: plain(*a), 2)
        nb, ops = cost(torch, *a)
        extra = {"rows": a[0].shape[0], "nodes": a[0].shape[1],
                 "calls_held": len(recorded[name])}
        if prev is not None:
            extra["prev_device_ms"] = device_ms(lambda: prev(a), 10)
        if diag_call is not None:
            d = diag_call
            nb_d, ops_d = cost(torch, *d)
            extra.update(window_device_ms=device_ms(lambda: fn(*d), 10),
                         window_plain_ms=time_ms(torch, lambda: plain(*d), 2),
                         window_bound_ms=bound(nb_d, ops_d)[0], window_rows=d[0].shape[0])
            if name == "static_rejects":
                extra["window_survivors"] = len(d) > 2 and bool(d[2])
            if prev is not None:
                extra["window_prev_device_ms"] = device_ms(lambda: prev(d), 10)
        out[name] = kernel_entry(
            name, "cuda", f"k8s_scheduler_tpu_torch/csrc/{name}.cu",
            replaces, launches[name], 0.0, ms, dms, pms, nb, ops,
            launches_by_path={"full cycles": full_stats["launches"][name],
                              "diagnosis": launches[name] - full_stats["launches"][name]},
            **extra)
        held = "; the earlier design counts alike" if prev else ""
        was = f" (the earlier design {extra['prev_device_ms']:.4f})" if prev else ""
        log(f"phase kernel {name}: equal to its plain version on {len(recorded[name])} "
            f"recorded calls (full cycles and diagnosis windows{held}); "
            f"{extra['rows']} rows x {extra['nodes']} nodes (the full "
            f"rounds cycle's call): kernel {ms:.4f} ms events, {dms:.4f} ms device{was}"
            f", plain {pms:.3f} ms, bound {bound(nb, ops)[0]:.4f} ms ({bound(nb, ops)[1]}); the "
            f"diagnosis window: {json.dumps({k: v for k, v in extra.items() if 'window' in k})}"
            f"; launches {launches[name]}")
    return out


def plain_kwargs():
    """`build_cycle_fn`'s kernel functions, every one its plain version."""
    from k8s_scheduler_tpu_torch.ops import affinity_update as au
    from k8s_scheduler_tpu_torch.ops import capacity as cap
    from k8s_scheduler_tpu_torch.ops import claim_pass as cp
    from k8s_scheduler_tpu_torch.ops import dyn_round as dr
    from k8s_scheduler_tpu_torch.ops import guard_sweep as gs
    from k8s_scheduler_tpu_torch.ops import interpod_terms as ipt
    from k8s_scheduler_tpu_torch.ops import scan_commit as sc
    from k8s_scheduler_tpu_torch.ops import static_base as sb
    from k8s_scheduler_tpu_torch.ops import volumes

    return dict(
        static_base_fn=sb.static_base_plain, static_rejects_fn=sb.static_rejects_plain,
        claim_pass_fn=cp.claim_pass_plain, interpod_terms_fn=ipt.interpod_terms_plain,
        interpod_norm_fn=ipt.interpod_norm_plain, affinity_update_fn=au.affinity_update_plain,
        capacity_fn=cap.capacity_plain, guard_sweep_fn=gs.guard_sweep_plain,
        volume_mask_fn=volumes.volume_mask_plain, pv_choice_fn=volumes.pv_choice_plain,
        pv_fold_fn=volumes.pv_fold_plain, scan_commit_fn=sc.scan_commit_plain,
        dyn_mask_fn=dr.dyn_mask_plain, dyn_score_fn=dr.dyn_score_plain,
        dyn_rejects_fn=dr.dyn_rejects_plain)


def results_equal(torch, a, b) -> dict:
    """Every field of two CycleResults, floats by their bits."""
    return {f.name: bits_equal(torch, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)}


def full_phase(torch, kb, fw, dev, nodes, existing, pending, snaps, smi) -> dict:
    """Phase 9 (module docstring): the full outputs at config #4 (seed
    AFF_TIMED_SEEDS[0]) in the rounds engine, with and without
    `config4_volumes`, and in the scan engine. Returns {"calls": the
    recorded K16 / K17 calls by tag, "launches": counts over the full
    cycles, "ms": {...}}."""
    from k8s_scheduler_tpu_torch.core.cycle import build_cycle_fn, sampling_window
    from k8s_scheduler_tpu_torch.framework.interfaces import CycleContext
    from k8s_scheduler_tpu_torch.kernel_variants import kernel_ms, scans_equal
    from k8s_scheduler_tpu_torch.models import SnapshotEncoder
    from k8s_scheduler_tpu_torch.ops import dyn_round as dr
    from k8s_scheduler_tpu_torch.ops import scan_commit as sc
    from k8s_scheduler_tpu_torch.ops import static_base as sb
    from k8s_scheduler_tpu_torch.utils import synth

    seed = AFF_TIMED_SEEDS[0]
    running, pods, pvcs, pvs, classes = synth.config4_volumes(nodes, existing,
                                                              list(pending[seed]), seed=seed)
    cases = {"rounds": snaps[seed], "rounds, volumes": SnapshotEncoder(device=dev).encode(
        nodes, pods, running, pvcs=pvcs, pvs=pvs, storage_classes=classes)}
    rec16 = Recorder(sb.static_rejects_cuda, keep=None)
    rec17 = Recorder(dr.dyn_rejects_cuda, keep=None)
    full_k = build_cycle_fn(fw, commit_mode="rounds", device=dev)
    full_r = build_cycle_fn(fw, commit_mode="rounds", device=dev, static_rejects_fn=rec16,
                            dyn_rejects_fn=rec17)
    lean = build_cycle_fn(fw, commit_mode="rounds", outputs="latency", device=dev)
    full_p = build_cycle_fn(fw, commit_mode="rounds", device=dev, **plain_kwargs())
    calls, ms, launches = {}, {}, dict.fromkeys(kb.launch_counts, 0)

    def timed(fn, snap):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        kb.reset_launch_counts()
        start.record()
        out = fn(snap)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end), dict(kb.launch_counts)

    for tag, snap in cases.items():
        full_r(snap)  # the K16 / K17 calls, recorded
        calls[tag] = (dict(rec16.args), dict(rec17.args))
        rec16.args.clear()
        rec17.args.clear()
        # the main path: counts set to 0 just before, read just after
        rk, full_ms, counted = timed(full_k, snap)
        for k, v in counted.items():
            launches[k] += v
        check(counted["static_rejects"] == 1 and counted["dyn_rejects"] == 1,
              f"full {tag} cycle: K16 / K17 launches {counted['static_rejects']} / "
              f"{counted['dyn_rejects']}, one each expected")
        d, lean_ms, lean_counted = timed(lean, snap)
        extra = {k: counted[k] - lean_counted[k] for k in counted if counted[k] != lean_counted[k]}
        full_dev = profiled_device_ms(torch, lambda: full_k(snap), 1)
        lean_dev = profiled_device_ms(torch, lambda: lean(snap), 1)
        t0 = time.time()
        rp = full_p(snap)
        torch.cuda.synchronize()
        plain_s = time.time() - t0
        eq = results_equal(torch, rk, rp)
        check(all(eq.values()), f"full {tag} cycle: kernels differ from the plain versions: {eq}")
        same = same_decisions(torch, rk, d)
        check(all(same.values()), f"full {tag} cycle decides otherwise than the latency "
              f"cycle: {same}")
        placed = int((rk.assignment >= 0).sum() + rk.gang_dropped.sum())
        check(int(rk.accepted_per_round.sum()) == placed,
              f"full {tag} cycle: sum(accepted_per_round) != placements before the unwind")
        unplaced = snap.pod_valid & (rk.assignment < 0)
        n_r = int(rk.rounds_used)
        ms[tag] = {"full_events_ms": round(full_ms, 2), "latency_events_ms": round(lean_ms, 2),
                   "full_device_ms": round(full_dev, 3), "latency_device_ms": round(lean_dev, 3)}
        log(f"phase full {tag} cycle, seed {seed}: events {full_ms:.2f} ms (latency cycle "
            f"{lean_ms:.2f}), device {full_dev:.3f} ms (latency {lean_dev:.3f}) by "
            f"torch.profiler; launches beyond the latency cycle's {json.dumps(extra)}; "
            f"kernels == plain on every CycleResult field (the plain full cycle "
            f"{plain_s:.1f} s); decisions == latency cycle; rounds {n_r}, accepted per round "
            f"{rk.accepted_per_round[:n_r].tolist()} (sum {placed} = placements before the "
            f"unwind), diag per round {rk.diag_per_round[:n_r].tolist()}; unplaced "
            f"{int(unplaced.sum())}, reject counts summed by filter "
            f"{dict(zip(fw.filter_names, rk.reject_counts.sum(0).tolist()))} | {smi}")
        del rk, rp, d

    # the scan engine: K13's full mode at full size, held on decisions
    # against the latency instance (its plain version on the edge cases and
    # the cut variant below)
    snap = snaps[seed]
    scan_full = build_cycle_fn(fw, commit_mode="scan", device=dev)
    scan_lean = build_cycle_fn(fw, commit_mode="scan", outputs="latency", device=dev)
    rk, sfull_ms, counted = timed(scan_full, snap)
    for k, v in counted.items():
        launches[k] += v
    check(counted["scan_commit"] == 1 and counted["static_rejects"] == 1,
          "full scan cycle: K13 and K16 not once each")
    d, slean_ms, _ = timed(scan_lean, snap)
    same = same_decisions(torch, rk, d)
    check(all(same.values()), f"the full scan cycle decides otherwise than the latency "
          f"one: {same}")

    def packed(snap_, full):
        ctx = CycleContext(snap_)
        sbase = sb.static_base_cuda(sb.static_base_inputs(
            fw, ctx, fit=not full, sampling=sampling_window(snap_, 0)))
        return sc.scan_commit_inputs(fw, ctx, sbase, fw.extra_init(ctx), rejects=full)

    xf, xl = packed(snap, True), packed(snap, False)
    first = sc.scan_commit_cuda(xf)
    k_full = kernel_ms(lambda: sc.scan_commit_cuda(xf), 2, "scan_kernel")
    k_lean = kernel_ms(lambda: sc.scan_commit_cuda(xl), 2, "scan_kernel")
    # events around the wrappers too (their host work included): a check on
    # the profiler's kernel times
    e_full = time_ms(torch, lambda: sc.scan_commit_cuda(xf), 2)
    e_lean = time_ms(torch, lambda: sc.scan_commit_cuda(xl), 2)
    again = sc.scan_commit_cuda(xf)
    check(scans_equal(first, again) and torch.equal(first.rejects, again.rejects),
          "K13's full mode gave another result on a later launch of the same inputs")
    nv, P = int(xl.pod_valid.sum()), xf.shape[0]
    ms["scan"] = {"full_events_ms": round(sfull_ms, 2), "latency_events_ms": round(slean_ms, 2),
                  "k13_full_kernel_ms": round(k_full, 3), "k13_latency_kernel_ms": round(k_lean, 3),
                  "k13_full_us_per_step": round(1e3 * k_full / P, 3),
                  "k13_latency_us_per_step": round(1e3 * k_lean / nv, 3),
                  "k13_full_wrapper_events_ms": round(e_full, 3),
                  "k13_latency_wrapper_events_ms": round(e_lean, 3)}
    log(f"phase full scan cycle, seed {seed}: events {sfull_ms:.2f} ms (latency cycle "
        f"{slean_ms:.2f}); decisions == latency cycle; K13 full mode {k_full:.3f} ms over "
        f"{P} steps ({nv} valid: {1e3 * k_full / P:.3f} us a step, "
        f"{1e3 * (k_full - k_lean) / max(P - nv, 1):.3f} us more an invalid step if the "
        f"valid ones cost as before), latency instance {k_lean:.3f} ms over {nv} steps "
        f"({1e3 * k_lean / nv:.3f} us a step), torch.profiler, in the same call (events "
        f"around the wrappers {e_full:.3f} and {e_lean:.3f} ms; a later launch equal to the "
        f"first); reject "
        f"counts summed by filter {dict(zip(fw.filter_names, rk.reject_counts.sum(0).tolist()))}"
        f" | {smi}")
    del xf, xl, rk, d, first, again
    # K13's full mode against its plain version on the cut variant (the
    # plain scan at full size would take a minute)
    snap_cut = SnapshotEncoder(device=dev).encode(nodes, pending[seed][:SCAN_CUT], existing)
    vsnap = scan_variant(torch, snap_cut, torch.Generator(device=dev).manual_seed(11))
    xv = packed(vsnap, True)
    rk, rp = sc.scan_commit_cuda(xv), sc.scan_commit_plain(xv)
    check(scans_equal(rk, rp) and torch.equal(rk.rejects, rp.rejects),
          "scan_commit's full mode differs from its plain version on the cut variant")
    log(f"phase kernel scan_commit full mode, the first {SCAN_CUT} pending pods of seed "
        f"{seed} (preferred / ScheduleAnyway / nominated / host-port variant): the seven "
        f"outputs and the rejects ({int(rk.rejects.sum())} counted) equal to "
        f"scan_commit_plain's")
    del xv, rk, rp, vsnap, snap_cut
    return {"calls": calls, "launches": launches, "ms": ms}


def diagnosis_frame(torch, kb, fw, dev, spec, w, b, stable, r, snap, tag, smi) -> dict:
    """The diagnosis program on one carry frame, fed the carry cycle's
    outputs: kernels against the plain versions, rows nonzero only for valid
    unplaced pods, the first three pods' FailedScheduling lines; {"launches",
    "ms", "windows", "calls": the recorded K16 / K17 calls}."""
    from k8s_scheduler_tpu_torch.core.cycle import build_diagnosis_fn
    from k8s_scheduler_tpu_torch.core.events import failed_scheduling_message

    from k8s_scheduler_tpu_torch.ops import dyn_round as dr
    from k8s_scheduler_tpu_torch.ops import static_base as sb

    pk = plain_kwargs()
    rec16 = Recorder(sb.static_rejects_cuda, keep=None)
    rec17 = Recorder(dr.dyn_rejects_cuda, keep=None)
    diag_r = build_diagnosis_fn(spec, fw, device=dev, static_rejects_fn=rec16,
                                dyn_rejects_fn=rec17)
    diag_k = build_diagnosis_fn(spec, fw, device=dev)
    diag_p = build_diagnosis_fn(spec, fw, device=dev, **{
        k: pk[k] for k in ("static_rejects_fn", "dyn_rejects_fn", "interpod_terms_fn",
                           "affinity_update_fn", "volume_mask_fn", "pv_fold_fn")})
    args = (w, b, stable, r.assignment, r.node_requested, r.pv_claimed)
    diag_r(*args)  # warm; every window's K16 / K17 calls recorded
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    kb.reset_launch_counts()  # the program's path: counts read just after
    t0 = time.time()
    start.record()
    rk = diag_k(*args)
    end.record()
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    ev_ms = start.elapsed_time(end)
    launched = dict(kb.launch_counts)
    rp = diag_p(*args)
    check(torch.equal(rk, rp), f"{tag}: the diagnosis program differs from its plain versions")
    unplaced = snap.pod_valid & (r.assignment < 0)
    n_un = int(unplaced.sum())
    check(not bool(rk[~unplaced].any()), f"{tag}: diagnosis rows beyond the unplaced pods")
    windows = -(-n_un // min(2048, snap.P))
    check(launched["static_rejects"] == windows and launched["dyn_rejects"] == windows,
          f"{tag}: K16 / K17 launched {launched['static_rejects']} / "
          f"{launched['dyn_rejects']} times over {windows} windows")
    check(launched["static_base"] == 0, f"{tag}: the diagnosis program launched K1 "
          f"{launched['static_base']} times (K16's survivors are its start mask)")
    order = torch.argsort(torch.where(unplaced, snap.pod_order.to(torch.int32),
                                      torch.iinfo(torch.int32).max), stable=True)
    n = int(snap.num_nodes)
    for p in order[:min(3, n_un)].tolist():
        log(f"  FailedScheduling {tag} pod slot {p}: " + failed_scheduling_message(
            n, zip(fw.filter_names, rk[p].tolist())))
    dev_ms = profiled_device_ms(torch, lambda: diag_k(*args), 1)
    log(f"phase diagnosis {tag}: {n_un} unplaced pods in {windows} windows of 2048; events "
        f"{ev_ms:.2f} ms a frame ({ev_ms / max(windows, 1):.2f} a window; wall {wall:.1f} "
        f"ms), device {dev_ms:.3f} ms by torch.profiler; kernels == plain versions; rows "
        f"nonzero: {int((rk.sum(1) > 0).sum())} of the {n_un} unplaced, none elsewhere; "
        f"launches {json.dumps({k: v for k, v in launched.items() if v})} | {smi}")
    return {"launches": launched, "ms": round(ev_ms, 2), "device_ms": round(dev_ms, 3),
            "windows": windows, "unplaced": n_un,
            "calls": (dict(rec16.args), dict(rec17.args))}


def carry_phase(torch, kb, fw, dev, nodes, existing, pending, smi, volumes: bool) -> dict:
    """Phase 8 (module docstring) on one variant: config #4's workload,
    with `config4_volumes` when `volumes`. Returns {"launches": counts
    over the carry path's frames, "ms": [carry cycle device ms],
    "diagnosis": the last frame's `diagnosis_frame`}."""
    import numpy as np

    from k8s_scheduler_tpu_torch.core.cycle import (CarryKeeper, build_carry_fns,
                                                    build_cycle_fn,
                                                    build_packed_cycle_carry_fn,
                                                    build_packed_preemption_fn,
                                                    build_preemption_fn,
                                                    build_stable_state_fn)
    from k8s_scheduler_tpu_torch.models import SnapshotEncoder
    from k8s_scheduler_tpu_torch.utils import synth

    tag = "carry, volumes" if volumes else "carry"
    seed = AFF_TIMED_SEEDS[0]
    rng = np.random.default_rng(CARRY_SEED + int(volumes))
    pods, running, vol = list(pending[seed]), list(existing), {}
    if volumes:
        running, pods, pvcs, pvs, classes = synth.config4_volumes(nodes, existing, pods,
                                                                  seed=seed)
        vol = dict(pvcs=pvcs, pvs=pvs, storage_classes=classes)
    names = [nd.name for nd in nodes]
    # the serving knobs, sized for the phase: every frame's bound pods fold
    # into E, and the hot nodes' depth into MPN, without a regime change
    knobs = dict(pad_existing=len(running) + CARRY_FRAMES * CARRY_BOUND,
                 pad_pods_per_node=CARRY_MPN)
    enc = SnapshotEncoder(device=dev, **knobs)
    full_enc = SnapshotEncoder(device=dev, incremental=False, **knobs)
    paths = []
    cycle_f = build_cycle_fn(fw, commit_mode="rounds", outputs="latency", device=dev)
    pre_f = build_preemption_fn(fw, device=dev)
    keeper, assignment, updates, prev_spec = None, None, 0, None
    counts = dict.fromkeys(kb.launch_counts, 0)
    ms = []

    def events(n):
        return [torch.cuda.Event(enable_timing=True) for _ in range(n)]

    for f in range(CARRY_FRAMES + 1):
        if f:  # churn: bind the first placements, refill their slots, replace others
            bound = np.nonzero(assignment[:len(pods)] >= 0)[0][:CARRY_BOUND]
            running += [(pods[i], names[assignment[i]]) for i in bound]
            others = rng.choice(np.setdiff1d(np.arange(len(pods)), bound), CARRY_REPLACED,
                                replace=False)
            slots = np.concatenate([bound, others])
            fresh = synth.make_pods(len(slots), seed=CARRY_SEED + 100 * f + int(volumes),
                                    name_prefix=f"carry{f}-", **synth.CONFIG4_PENDING)
            for i, p in zip(slots, fresh):
                pods[i] = p
        torch.cuda.synchronize()
        n_delta, n_fold = enc.delta_hits, enc.fold_hits
        t0 = time.time()
        frame = enc.encode_packed(nodes, pods, running, **vol)
        encode_ms = (time.time() - t0) * 1e3
        upload_ms = enc.last_upload_ms()
        w, b, spec = frame.wbuf, frame.bbuf, frame.spec
        path = ("full" if enc.delta_hits == n_delta
                else "delta + fold" if enc.fold_hits > n_fold else "delta")
        t0 = time.time()
        full = full_enc.encode_packed(nodes, pods, running, **vol)
        full_ms = (time.time() - t0) * 1e3
        full_enc.last_upload_ms()
        check(full.spec.key() == spec.key()
              and all(np.array_equal(a, c) for a, c in zip(enc.host_buffers(),
                                                           full_enc.host_buffers())),
              f"{tag} frame {f}: the {path} frame's host buffers differ from a full encode's")
        if frame.dirty is not None:
            check(full.dirty is not None and set(full.dirty.tolist()) <= set(frame.dirty.tolist()),
                  f"{tag} frame {f}: dirty misses rows a full encode finds changed")
        del full
        why = enc.full_reason if path == "full" else ""
        if f:
            check(path == "delta + fold" or (path == "full" and any(
                  w_ in why for w_ in ("pad", "interning", "capability", "inter-pod", "256"))),
                  f"{tag} frame {f}: {path} path ({why or 'no fold'}): the running list grew "
                  f"by a pure append")
        paths.append({"path": path, "encode_ms": round(encode_ms, 1),
                      "full_encode_ms": round(full_ms, 1)})
        prof = {k: round(v, 2) for k, v in enc.delta_profile.items()}
        log(f"phase {tag} frame {f}: encode path {path}{f' ({why})' if why else ''}, "
            f"{encode_ms:.1f} ms host against {full_ms:.1f} ms for a full encode of the "
            f"same objects (host buffers bit-equal; delta_profile ms {json.dumps(prof)}) "
            f"| {smi}")

        # the carry path: counts set to 0 just before, read just after
        ev = events(5)
        kb.reset_launch_counts()
        t0 = time.time()
        ev[0].record()
        stable = build_stable_state_fn(spec, device=dev)(w, b)
        if keeper is None or keeper.spec.layout_key() != spec.layout_key():
            keeper = CarryKeeper(spec, fw, device=dev)
        ev[1].record()
        carry = keeper.state(w, b, stable, frame.dirty, enc._carry_key)
        ev[2].record()
        t1 = time.time()
        r = build_packed_cycle_carry_fn(spec, fw, device=dev)(w, b, stable, carry)
        ev[3].record()
        torch.cuda.synchronize()
        t2 = time.time()
        rp = build_packed_preemption_fn(spec, fw, device=dev)(w, b, r, stable)
        ev[4].record()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
        cycle_wall = (t2 - t1) * 1e3
        launched = dict(kb.launch_counts)
        for k, v in launched.items():
            counts[k] += v
        t_stable, t_carry, t_cycle, t_pre = (ev[i].elapsed_time(ev[i + 1]) for i in range(4))

        # held against a fresh carry_init and the fresh rounds cycle
        ci = build_carry_fns(spec, fw, device=dev)[0]
        e = events(2)
        e[0].record()
        fresh = ci(w, b, stable)
        e[1].record()
        torch.cuda.synchronize()
        init_ms = e[0].elapsed_time(e[1])
        check(bits_equal(torch, carry["sbase"], fresh["sbase"])
              and torch.equal(carry["mp"], fresh["mp"]),
              f"{tag} frame {f}: the carried sbase / mp differ from a fresh carry_init")
        del fresh
        e = events(2)
        t0 = time.time()
        e[0].record()
        d = cycle_f(frame.snap)
        e[1].record()
        torch.cuda.synchronize()
        fresh_wall = (time.time() - t0) * 1e3
        fresh_ms = e[0].elapsed_time(e[1])
        same = same_decisions(torch, r, d)
        check(all(same.values()), f"{tag} frame {f}: the carry cycle differs from the fresh "
              f"rounds cycle: {same}")
        pd = pre_f(frame.snap, d)
        check(all(torch.equal(getattr(rp, k), getattr(pd, k))
                  for k in ("nominated", "victims", "num_preemptors")),
              f"{tag} frame {f}: packed preemption differs from build_preemption_fn's")
        if volumes:
            check(bool(frame.snap.has_volumes), f"{tag}: the frame carries no volumes")
        n_dirty = "none (full)" if frame.dirty is None else len(frame.dirty)
        if frame.dirty is None and prev_spec is not None:  # what moved the carry key
            moved = [n for (n, *a), (m, *b) in zip(spec.words + spec.bools,
                                                   prev_spec.words + prev_spec.bools)
                     if n != m or a[-2] != b[-2]]
            moved += [k for (k, v), (j, w) in zip(spec.aux, prev_spec.aux)
                      if k != "pref_raw_bound" and v != w]
            n_dirty += f" (the layout moved: {moved or 'no field; the encoder key'})"
        prev_spec = spec
        k1_rows = spec.shape_of("pod_priority")[0] if keeper.last == "init" else keeper.bucket
        ms.append(round(t_cycle, 2))
        log(f"phase {tag} frame {f}: dirty {n_dirty} (rows changed "
            f"{'-' if enc.last_changed_slots is None else len(enc.last_changed_slots)}), "
            f"carry {keeper.last}: K1 launches {launched['static_base']} at {k1_rows} rows; "
            f"encode {encode_ms:.1f} ms host, upload {upload_ms:.3f} ms device "
            f"({(spec.n_words * 4 + spec.n_bytes) / 2**20:.1f} MiB); events ms: stable "
            f"{t_stable:.2f}, carry {t_carry:.2f} (a fresh carry_init {init_ms:.2f}), cycle "
            f"{t_cycle:.2f} (wall {cycle_wall:.1f}), preemption {t_pre:.2f}, all {wall_ms:.1f} "
            f"wall; fresh rounds cycle {fresh_ms:.2f} (wall {fresh_wall:.1f}); placed "
            f"{int((r.assignment >= 0).sum())}, nominated {int(rp.num_preemptors)}; carry == "
            f"carry_init, decisions == fresh cycle, preemption == build_preemption_fn")
        if keeper.last == "update" and not updates:
            # device times of the carry programs and the cycles, by torch.profiler
            idx = np.full(keeper.bucket, frame.dirty[0], np.int32)
            idx[:len(frame.dirty)] = frame.dirty
            update = keeper._cu(keeper.bucket)
            init_dev = profiled_device_ms(torch, lambda: ci(w, b, stable), 3)
            upd_dev = profiled_device_ms(
                torch, lambda: update(w, b, stable, keeper.carry, idx), 3)
            cyc = build_packed_cycle_carry_fn(spec, fw, device=dev)
            carry_dev = profiled_device_ms(torch, lambda: cyc(w, b, stable, keeper.carry), 1)
            fresh_dev = profiled_device_ms(torch, lambda: cycle_f(frame.snap), 1)
            log(f"phase {tag} device time (torch.profiler, kernels summed): carry_init "
                f"{init_dev:.3f} ms, carry update of {keeper.bucket} rows {upd_dev:.3f} ms; "
                f"carry cycle {carry_dev:.3f} ms (busy share {carry_dev / cycle_wall:.4f} of "
                f"its {cycle_wall:.1f} ms wall), fresh rounds cycle {fresh_dev:.3f} ms (busy "
                f"share {fresh_dev / fresh_wall:.4f} of {fresh_wall:.1f} ms) | {smi}")
        updates += keeper.last == "update"
        if f == CARRY_FRAMES:  # phase 9: the diagnosis program on the last frame
            diag = diagnosis_frame(torch, kb, fw, dev, spec, w, b, stable, r, frame.snap,
                                   tag, smi)
        assignment = r.assignment.cpu().numpy()
        del frame, w, b, stable, carry, r, rp, d, pd
    log(f"phase {tag} launches over the carry path of {CARRY_FRAMES + 1} frames: "
        f"{json.dumps(counts)}")
    want = ["static_base", "claim_pass", "capacity", "guard_sweep", "interpod_terms",
            "interpod_norm", "affinity_update", "dyn_mask", "dyn_score", "preempt_prefilter",
            "preempt_whatif", "preempt_claim", "extender_merge"]
    if volumes:
        want += ["volume_mask", "pv_choice", "pv_fold"]
    for k in want:
        check(counts[k] > 0, f"kernel {k} was not launched on the {tag} path")
    check(updates > 0, f"{tag}: no frame updated the carry (every one rebuilt it)")
    check(counts["static_base"] == CARRY_FRAMES + 1,
          f"{tag}: K1 ran {counts['static_base']} times over {CARRY_FRAMES + 1} frames")
    log(f"phase {tag} encode paths: {json.dumps(paths)}")
    return {"launches": counts, "ms": ms, "diagnosis": diag, "encode": paths}


SERVE_CYCLES, SERVE_ARRIVALS, SERVE_DELETES = 5, 500, 200  # phase 10's churn
SERVE_SCAN_CYCLES = 2
SERVE_SEED = 202


def hand_kernel_names(source: str) -> set[str]:
    """The device function names a kernel source defines: `__global__`
    functions of a CUDA source, `@triton.jit` functions of a Python one."""
    import re

    text = (Path(__file__).resolve().parent / source).read_text()
    if source.endswith(".py"):
        return set(re.findall(r"@triton\.jit\s+def\s+(\w+)", text))
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                          text))


class ServeCluster:
    """Stands in for the API server in phase 10: records binds (each one
    confirmed at once, as an informer echo would) and evictions (each one
    echoed back as the pod's delete)."""

    def __init__(self):
        self.binds: list[tuple[str, str]] = []
        self.evictions: list[tuple[str, str]] = []
        self.sched = None

    def bind(self, pod, node):
        self.binds.append((pod.name, node))
        self.sched.cache.confirm(pod.uid)

    def evict(self, pod, node):
        self.evictions.append((pod.name, node))
        self.sched.on_pod_delete(pod.uid)


def last_frame(sch):
    """A serving Scheduler's last cycle: its frame (unpacked from the
    pipeline handle's upload) and its result."""
    from k8s_scheduler_tpu_torch.models import packing

    entry = max((e for e in sch._packed.values() if e["fns"][6]._last is not None),
                key=lambda e: e["fns"][6].stats["t_dispatch_start"])
    h = entry["fns"][6]._last
    return packing.unpack(h._wbuf, h._bbuf, entry["spec"]), h.result


def http_probe(sch, cl, tag: str) -> None:
    """The port's HTTP server over a serving Scheduler on port 0: /healthz,
    /metrics and /debug/flightrecorder answer 200, and /metrics' bind
    counter (scheduler_schedule_attempts_total{result="scheduled"}) equals
    the binds the stand-in API server recorded."""
    import urllib.request

    from k8s_scheduler_tpu_torch.cmd.httpserver import (staleness_healthz,
                                                        start_http_server, stop_http_server)

    server = start_http_server(
        sch.metrics, port=0, recorder=sch.flight, pod_timeline=sch.pod_timeline,
        observer=sch.observer,
        healthz=staleness_healthz(None, sch.flight, 0.0, sch.observer, sch.ladder))
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        bodies = {}
        for route in ("/healthz", "/metrics", "/debug/flightrecorder?last=4"):
            with urllib.request.urlopen(base + route, timeout=30) as r:
                check(r.status == 200, f"serving {tag}: {route} answered {r.status}")
                bodies[route] = r.read().decode()
        scheduled = sum(float(ln.rsplit(" ", 1)[1]) for ln in bodies["/metrics"].splitlines()
                        if ln.startswith("scheduler_schedule_attempts_total{")
                        and 'result="scheduled"' in ln)
        check(scheduled == len(cl.binds), f"serving {tag}: /metrics counts {scheduled} "
              f"scheduled attempts, the API server saw {len(cl.binds)} binds")
        n_rec = len(json.loads(bodies["/debug/flightrecorder?last=4"])["cycles"])
        log(f"phase serving {tag}: the HTTP server on port 0 answered /healthz "
            f"{json.loads(bodies['/healthz'])['ok']}, /metrics "
            f"({len(bodies['/metrics'])} bytes; scheduled attempts {scheduled:.0f} == "
            f"{len(cl.binds)} binds) and /debug/flightrecorder ({n_rec} records) with 200")
    finally:
        check(stop_http_server(server), f"serving {tag}: the HTTP server did not stop")


def serving_phase(torch, kb, dev, nodes, existing, pending, smi, kernels) -> dict:
    """Phase 10: the port's `Scheduler` serving config #4's workload through
    its informer handlers and `schedule_cycle()`: SERVE_CYCLES carry-path
    cycles with churn between them (SERVE_ARRIVALS new pods, SERVE_DELETES
    running pods deleted), then SERVE_SCAN_CYCLES cycles of a second
    Scheduler with `commitMode: scan` (the packed path), each beside a
    `forced_sync=True` twin driven by the same events. Launch counts are
    set to 0 just before each serving cycle and summed just after (the
    twins' cycles are the comparison and are not counted). Returns the
    counts and the per-cycle numbers."""
    import copy
    import warnings

    import numpy as np

    from k8s_scheduler_tpu_torch.config import SchedulerConfiguration
    from k8s_scheduler_tpu_torch.core import Scheduler
    from k8s_scheduler_tpu_torch.framework.interfaces import AffinityKernels
    from k8s_scheduler_tpu_torch.utils import synth
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.time()
    rng = np.random.default_rng(SERVE_SEED)
    running_uids = [p.uid for p, _ in existing]
    arrivals = [synth.make_pods(SERVE_ARRIVALS, seed=SERVE_SEED + 1000 + c,
                                name_prefix=f"serve{c}-", **synth.CONFIG4_PENDING)
                for c in range(SERVE_CYCLES)]
    deletes = [[running_uids[i] for i in rng.choice(len(running_uids), SERVE_DELETES,
                                                    replace=False)]
               for _ in range(SERVE_CYCLES)]
    counts = dict.fromkeys(kb.launch_counts, 0)
    lines = []

    def make(mode, forced):
        # pads sized for the phase: the binds folding in keep one regime
        cfg = SchedulerConfiguration(
            commit_mode=mode, forced_sync=forced,
            pad_existing=len(existing) + len(pending[SERVE_SEED])
            + SERVE_CYCLES * SERVE_ARRIVALS,
            pad_pods_per_node=2 * CARRY_MPN)
        cl = ServeCluster()
        sch = Scheduler(cfg, binder=cl.bind, evictor=cl.evict, now=clock, device=dev)
        cl.sched = sch
        t0 = time.time()
        for nd in nodes:
            sch.on_node_add(nd)
        for pod, node in existing:
            sch.on_pod_add(pod, node)
        # each scheduler its own pending objects: a nomination mutates its pod
        for pod in copy.deepcopy(pending[SERVE_SEED]):
            sch.on_pod_add(pod)
        return sch, cl, (time.time() - t0) * 1e3

    clock_t = [0.0]

    def clock():
        return clock_t[0]

    def outcome(sch, cl, nb, ne):
        return (cl.binds[nb:], cl.evictions[ne:],
                [(p.name, n) for p, n in sch.last_nominations],
                [(p.name, n) for p, n in sch.last_evictions])

    def sync_sites(sch):
        """One cycle with the sync debug mode on from its start to the end
        of its decision fetch (the decision path): (file:line, count) of
        every synchronizing call."""
        orig = sch._apply_phase

        def apply(*a, **k):
            torch.cuda.set_sync_debug_mode(0)
            return orig(*a, **k)

        sch._apply_phase = apply
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                st = sch.schedule_cycle()
            finally:
                torch.cuda.set_sync_debug_mode(0)
                sch._apply_phase = orig
        sites: dict[str, int] = {}
        for w in caught:
            if "synchroniz" in str(w.message):
                key = f"{Path(w.filename).name}:{w.lineno}"
                sites[key] = sites.get(key, 0) + 1
        return st, sites

    out = {"cycles": []}
    for mode, n_cycles in (("rounds", SERVE_CYCLES), ("scan", SERVE_SCAN_CYCLES)):
        sch, cl, feed_ms = make(mode, False)
        twin, tcl, _ = make(mode, True)
        log(f"phase serving {mode}: {len(nodes)} on_node_add, {len(existing)} on_pod_add "
            f"bound, {len(pending[SERVE_SEED])} pending on_pod_add: {feed_ms:.0f} ms of "
            f"handlers a scheduler (a forced_sync twin gets the same events)")
        for c in range(n_cycles):
            if c:  # churn, the same events to both
                for sch_ in (sch, twin):
                    for pod in copy.deepcopy(arrivals[c]):  # each its own objects
                        sch_.on_pod_add(pod)
                    for uid in deletes[c]:
                        sch_.on_pod_delete(uid)
            clock_t[0] += 1.0
            nb, ne, tnb, tne = len(cl.binds), len(cl.evictions), len(tcl.binds), len(tcl.evictions)
            enc = sch._encoder
            paths0 = (enc.full_encodes, enc.delta_hits, enc.fold_hits)
            kb.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            if mode == "rounds" and c == 2:
                st, sites = sync_sites(sch)
            elif c == 1:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    st = sch.schedule_cycle()
                    torch.cuda.synchronize()
                names = {e.name for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA}
                sites = None
            else:
                st, sites = sch.schedule_cycle(), None
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
            launched = dict(kb.launch_counts)
            for k, v in launched.items():
                counts[k] += v
            got = outcome(sch, cl, nb, ne)
            snap, res = last_frame(sch)
            tst = twin.schedule_cycle()
            want = outcome(twin, tcl, tnb, tne)
            check(got == want and vars(st) | {"cycle_seconds": 0}
                  == vars(tst) | {"cycle_seconds": 0},
                  f"serving {mode} cycle {c}: bindings / nominations / evictions differ "
                  f"from the forced_sync twin's")
            n_pods = st.attempted
            check(len(got[0]) == int((res.assignment[:n_pods] >= 0).sum()),
                  f"serving {mode} cycle {c}: binds != placements")
            check_placements(torch, snap, res, sch.framework, AffinityKernels.plain(),
                             unplaced_infeasible=(mode == "rounds"))
            rec = sch.flight.last_record()
            ph, mk = rec.phases, rec.marks
            apply_ms = (mk["postfilter_end"] - mk["apply_start"]) * 1e3
            path = ("full (the packed path)" if mode == "scan" else
                    "full" if enc.full_encodes > paths0[0] else
                    "delta + fold" if enc.fold_hits > paths0[2] else "delta")
            row = {"mode": mode, "cycle": c, "wall_ms": round(wall_ms, 1),
                   # the schedulers run on a logical clock (the twins must see
                   # the same backoff expiries): the host phases from the
                   # flight record's perf_counter marks
                   "encode_ms": round((mk["dispatch_start"] - mk["encode_start"]) * 1e3, 1),
                   "dispatch_ms": round(ph.get("dispatch_ms", 0.0), 1),
                   "decision_fetch_ms": round(ph.get("decision_wait_ms", 0.0), 2),
                   "carry_events_ms": round(ph.get("carry_events_ms", 0.0), 2),
                   "cycle_events_ms": round(ph.get("cycle_events_ms", 0.0), 2),
                   "apply_bind_ms": round(apply_ms, 1),
                   "diag_lag_ms": round(ph.get("diag_lag_ms", 0.0), 1),
                   "fetch_bytes": rec.counts["fetch_bytes"],
                   "placed": st.scheduled, "unschedulable": st.unschedulable,
                   "nominated": st.preemptors, "victims": st.victims,
                   "encode_path": path}
            out["cycles"].append(row)
            log(f"phase serving {mode} cycle {c}: schedule_cycle {wall_ms:.1f} ms wall "
                f"(encode {row['encode_ms']}, dispatch {row['dispatch_ms']}, decision fetch "
                f"{row['decision_fetch_ms']}, apply and bind {row['apply_bind_ms']}, "
                f"diagnosis lag {row['diag_lag_ms']} ms; events: carry "
                f"{row['carry_events_ms']}, cycle {row['cycle_events_ms']} ms"
                f"{', under torch.profiler' if c == 1 else ''}), fetch {row['fetch_bytes']} bytes, "
                f"{n_pods} pods: placed {st.scheduled}, unschedulable {st.unschedulable}, "
                f"nominated {st.preemptors}, victims {st.victims}; encode path {path}; "
                f"launches {json.dumps({k: v for k, v in launched.items() if v})}; equal to "
                f"the forced_sync twin, every binding valid | {smi}")
            if sites is not None:
                # the rounds engine's per-round stop test, and the known syncs
                # of the programs (ROADMAP A10b): the gang unwind's nonzero and
                # the label / match tables of a changed stable side or of the
                # carry's dirty rows (labels.py, interpod.py and the torch
                # functions they call)
                known = {"rounds.py", "commit.py", "labels.py", "interpod.py",
                         "functional.py", "__init__.py"}
                other = {k: v for k, v in sites.items() if k.split(":")[0] not in known}
                log(f"phase serving {mode} cycle {c}: host syncs on the decision path "
                    f"(set_sync_debug_mode('warn') from the cycle's start to its decision "
                    f"fetch, the fetch an event wait): {json.dumps(sites)}")
                check(not other, f"host syncs on the decision path beyond the known "
                      f"sites: {other}")
                out["sync_sites"] = sites
            if c == 1:
                hand = set()
                missing = []
                for k, v in launched.items():
                    if not v or k not in kernels:
                        continue
                    ns = hand_kernel_names(kernels[k]["source"])
                    hand |= ns
                    if not any(any(n in e for n in ns) for e in names):
                        missing.append(k)
                seen = sorted({e for e in names if any(n in e for n in hand)})
                log(f"phase serving {mode} cycle {c}: torch.profiler kernel names of the "
                    f"hand kernels: {json.dumps(seen)}")
                check(not missing, f"serving {mode}: launched kernels {missing} not in the "
                      f"profile")
        http_probe(sch, cl, mode)
        del sch, twin, cl, tcl
        torch.cuda.empty_cache()
    want = ["static_base", "claim_pass", "capacity", "guard_sweep", "interpod_terms",
            "interpod_norm", "affinity_update", "dyn_mask", "dyn_score", "preempt_prefilter",
            "preempt_whatif", "preempt_claim", "static_rejects", "dyn_rejects", "scan_commit",
            "extender_merge"]
    for k in want:
        check(counts.get(k, 0) > 0, f"kernel {k} was not launched in the serving cycles")
    log(f"phase serving launches over {SERVE_CYCLES} carry and {SERVE_SCAN_CYCLES} scan "
        f"cycles: {json.dumps(counts)}; the phase took {time.time() - t_phase:.1f} s")
    out["launches"] = counts
    return out


# ---- phase 11: HTTP extenders and their verdicts ---------------------------

EXT_SEED = 211
EXT_WEIGHT = 3.0  # the webhook extender's weight
EXT_CLIP_WEIGHT = 200000.0  # a weight whose scores cross K1's 1e6 clip
EXT_WINDOW = 2048  # the diagnosis window of K16's per-pod base
# the serving leg's cut of the pending set (see PERF.md §4): a
# filter-and-prioritize round at 5000 nodes costs tens of ms of host time a
# pod, so the leg schedules EXT_PENDING pods (+ EXT_HUGE that fit nowhere,
# for the diagnosis), then EXT_ARRIVALS arrivals a churn cycle: replicas of
# pods of the cut under new names (a Deployment scaling out), so the frame
# takes the delta encode, and its changed slots alone consult the webhooks
EXT_PENDING, EXT_HUGE, EXT_ARRIVALS, EXT_CHURN = 400, 8, 50, 3


def _ext_hash(uid: str, node: str) -> int:
    import zlib

    return zlib.crc32(f"{uid}|{node}".encode())


def _serve_webhook(port_queue) -> None:
    """The phase's scheduler extender, in a child process: its filter drops
    the nodes where a hash of (pod uid, node name) is 0 mod 8, its
    prioritize scores each node with that hash mod 11."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            uid = body["Pod"]["metadata"]["uid"]
            if self.path.endswith("/filter"):
                out = {"NodeNames": [n for n in body["NodeNames"]
                                     if _ext_hash(uid, n) % 8 != 0]}
            else:
                out = {"Items": [{"Host": n, "Score": _ext_hash(uid, n) % 11}
                                 for n in body["NodeNames"]]}
            data = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    class Server(ThreadingHTTPServer):
        request_queue_size = 128  # the prepass's 16 workers connect at once
        daemon_threads = True

    srv = Server(("127.0.0.1", 0), Handler)
    port_queue.put(srv.server_address[1])
    srv.serve_forever()


def extender_planes(torch, snap, gen, weight: float):
    """Seeded verdict planes on the device as the packed path carries them:
    bool [P, N] (7 in 8 pairs pass) and f32 [P, N] (0-10 times `weight`),
    mask True and score 0 on the pad rows and columns."""
    P, N = snap.P, snap.N
    dev = snap.device
    real = snap.pod_valid[:, None] & snap.node_valid[None, :]
    em = torch.rand((P, N), generator=gen, device=dev) < 0.875
    es = torch.randint(0, 11, (P, N), generator=gen, device=dev).to(torch.float32) * weight
    return em | ~real, torch.where(real, es, torch.zeros((), device=dev))


def extender_phase(torch, kb, dev, nodes, existing, pending, smi) -> dict:
    """Phase 11 (module docstring). Returns {"kernels": K1's extender
    instance, K16's per-pod base and K18 as kernel-table entries, "serving":
    the serving leg's numbers}."""
    import copy
    import dataclasses
    import multiprocessing

    from k8s_scheduler_tpu_torch.config import Extender, SchedulerConfiguration
    from k8s_scheduler_tpu_torch.core import Scheduler
    from k8s_scheduler_tpu_torch.core.cycle import (build_cycle_fn, sampling_params,
                                                    sampling_window)
    from k8s_scheduler_tpu_torch.framework.interfaces import AffinityKernels, CycleContext
    from k8s_scheduler_tpu_torch.framework.runtime import Framework
    from k8s_scheduler_tpu_torch.kernel_variants import device_ms
    from k8s_scheduler_tpu_torch.models import MakePod, SnapshotEncoder, packing
    from k8s_scheduler_tpu_torch.ops import extender_merge as em_ops
    from k8s_scheduler_tpu_torch.ops import rounds as rounds_ops
    from k8s_scheduler_tpu_torch.ops import static_base as sb
    from k8s_scheduler_tpu_torch.utils import synth

    t_phase = time.time()
    fw = Framework.from_config()
    plain = AffinityKernels.plain()
    gen = torch.Generator(device=dev).manual_seed(EXT_SEED)
    snap = SnapshotEncoder(device=dev).encode(nodes, pending[SERVE_SEED], existing)
    P, N = snap.P, snap.N
    em, es = extender_planes(torch, snap, gen, EXT_WEIGHT)
    esnap = dataclasses.replace(snap, has_extender=True, pod_extender_mask=em,
                                pod_extender_score=es)
    _, es_big = extender_planes(torch, snap, gen, EXT_CLIP_WEIGHT)
    bsnap = dataclasses.replace(esnap, pod_extender_score=es_big)
    log(f"phase extenders data: config #4 (seed {SERVE_SEED}) at P={P} N={N}, seeded "
        f"verdicts: {float(em.float().mean()):.4f} of the pairs pass, scores 0-10 x "
        f"{EXT_WEIGHT} (and x {EXT_CLIP_WEIGHT}: max {float(es_big.max()):.0f})")

    # the packed path uploads the planes every cycle: 5 B a pair
    host = torch.empty((P * N * 5,), dtype=torch.uint8, pin_memory=True)
    up_ms = time_ms(torch, lambda: host.to(dev, non_blocking=True), 5)
    log(f"phase extenders verdict planes' upload: {P * N * 5} bytes (bool + f32 [{P}, "
        f"{N}]) host to device {up_ms:.3f} ms (pinned, warm)")
    del host

    # ---- K1's extender instances against the plain version at full pads ----
    xs = {
        "rounds": sb.static_base_inputs(fw, CycleContext(esnap), fit=True,
                                        sampling=sampling_window(snap, 0)),
        "scan": sb.static_base_inputs(fw, CycleContext(esnap), fit=True, clip=False,
                                      sampling=sampling_window(snap, 0)),
        "rounds, scores past the clip": sb.static_base_inputs(
            fw, CycleContext(bsnap), fit=True, sampling=sampling_window(snap, 0)),
        "scan, scores past the clip": sb.static_base_inputs(
            fw, CycleContext(bsnap), fit=True, clip=False, sampling=sampling_window(snap, 0)),
    }
    for tag, x in xs.items():
        compare_static_base(torch, sb, x, f"(extender operands, {tag})")
    x = xs["rounds"]
    k1e_ms = time_ms(torch, lambda: sb.static_base_cuda(x), 20)
    k1e_dev = device_ms(lambda: sb.static_base_cuda(x), 10)
    k1e_plain = time_ms(torch, lambda: sb.static_base_plain(x), 2)
    k1e_bytes = P * N * 4 + nbytes(*[v for v in vars(x).values()
                                     if isinstance(v, torch.Tensor)])
    k1e_ops = P * N * (2 * len(x.terms) + 4)
    log(f"phase kernel static_base (extender operands): [{P}, {N}] equal to "
        f"static_base_plain bit for bit on {len(xs)} instances ({', '.join(xs)}); kernel "
        f"{k1e_ms:.3f} ms ({k1e_dev:.4f} ms device), plain {k1e_plain:.3f} ms, bound "
        f"{bound(k1e_bytes, k1e_ops)[0]:.3f} ms (bytes {k1e_bytes})")
    del xs

    # ---- K18 against its plain version: the merge and the window ----
    sbase = sb.static_base_cuda(sb.static_base_inputs(fw, CycleContext(snap)))  # the carry
    samp = sampling_params(snap, 0)
    for tag, args in (("verdicts and window", (em, es, samp)), ("verdicts", (em, es, None)),
                      ("window alone (the main path's carry cycle)", (None, None, samp))):
        check(bits_equal(torch, em_ops.extender_merge_triton(sbase, *args),
                         em_ops.extender_merge_plain(sbase, *args)),
              f"extender_merge differs from its plain version ({tag})")
    for n in (13, 2049):  # a ragged tile, one node past a tile
        a = (sbase[:64, :n].contiguous(), em[:64, :n].contiguous(), es[:64, :n].contiguous(),
             (samp[0][:64], samp[1], samp[2]))
        check(bits_equal(torch, em_ops.extender_merge_triton(*a),
                         em_ops.extender_merge_plain(*a)),
              f"extender_merge differs from its plain version at N={n}")
    k18 = lambda: em_ops.extender_merge_triton(sbase, em, es, samp)  # noqa: E731
    k18_ms = time_ms(torch, k18, 20)
    k18_dev = device_ms(k18, 20)
    k18_plain = time_ms(torch, lambda: em_ops.extender_merge_plain(sbase, em, es, samp), 3)
    k18_bytes = P * N * (4 + 1 + 4 + 4) + nbytes(samp[0]) + 16
    k18_ops = P * N * 4
    # the window alone, the main path's carry cycle: against the torch
    # composition it replaced (`sampling_mask` and a `torch.where`)
    k18w_dev = device_ms(lambda: em_ops.extender_merge_triton(sbase, None, None, samp), 20)
    k18w_plain = time_ms(torch, lambda: em_ops.extender_merge_plain(sbase, None, None, samp), 5)
    k18w_bound = bound(P * N * 8 + nbytes(samp[0]) + 16, P * N * 3)[0]
    log(f"phase kernel extender_merge: [{P}, {N}] equal to extender_merge_plain bit for bit "
        f"(verdicts and window, verdicts alone, window alone; ragged tiles N=13, 2049); "
        f"kernel {k18_ms:.3f} ms ({k18_dev:.4f} ms device), plain {k18_plain:.3f} ms, "
        f"bound {bound(k18_bytes, k18_ops)[0]:.3f} ms (bytes {k18_bytes}); the window "
        f"alone (the main path's carry cycle) {k18w_dev:.4f} ms device against the torch "
        f"composition it replaced {k18w_plain:.3f} ms, bound {k18w_bound:.3f} ms")

    # ---- K16's per-pod base against its plain version on a 2048-row window ----
    order = torch.argsort(torch.where(snap.pod_valid, snap.pod_order.to(torch.int32),
                                      torch.iinfo(torch.int32).max), stable=True)
    ids = order[:EXT_WINDOW]
    act = snap.pod_valid[ids]
    ids32 = ids.to(torch.int32)
    vsnap = rounds_ops._pod_view(snap, ids)
    xr = sb.reject_inputs(sb.static_base_inputs(fw, CycleContext(vsnap)))
    k16 = lambda: sb.static_rejects_cuda(xr, act, True, base=(em, ids32))  # noqa: E731
    got, want = k16(), sb.static_rejects_plain(xr, act, True, base=(em, ids32))
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "static_rejects with the per-pod base differs from its plain version")
    check(not torch.equal(got[1], sb.static_rejects_plain(xr, act, True)[1]),
          "the per-pod base changed no survivor")
    for n in (13, 8192 - 16):  # the scalar path, a row of 511 whole words
        xn = dataclasses.replace(xr, node_valid=xr.node_valid[:n].contiguous(),
                                 node_unsched=xr.node_unsched[:n].contiguous(),
                                 node_taintset=xr.node_taintset[:n].contiguous(),
                                 node_used_ports=xr.node_used_ports[:n].contiguous(),
                                 req=xr.req[:, :n].contiguous())
        bn = (em[:, :n].contiguous(), ids32)
        a, b = sb.static_rejects_cuda(xn, act, True, base=bn), \
            sb.static_rejects_plain(xn, act, True, base=bn)
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"static_rejects with the per-pod base differs at N={n}")
    k16_ms = time_ms(torch, k16, 20)
    k16_dev = device_ms(k16, 20)
    k16_plain = time_ms(torch, lambda: sb.static_rejects_plain(xr, act, True,
                                                                base=(em, ids32)), 3)
    B = EXT_WINDOW
    k16_bytes = B * N * 2 + B * xr.n_filters * 4 + nbytes(
        ids32, act, xr.node_valid, xr.node_unsched, xr.node_taintset, xr.sched, xr.req)
    k16_ops = B * (N // 32) * 8
    log(f"phase kernel static_rejects (per-pod base): [{B}, {N}] window equal to "
        f"static_rejects_plain bit for bit (counts and survivors; also N=13 and "
        f"N={8192 - 16}); kernel {k16_ms:.4f} ms ({k16_dev:.4f} ms device), plain "
        f"{k16_plain:.3f} ms, bound {bound(k16_bytes, k16_ops)[0]:.4f} ms (bytes {k16_bytes})")
    del sbase, vsnap, xr, got, want

    # ---- build_cycle_fn with the verdicts, both engines, at full size ----
    cycle_ms = {}
    launches = dict.fromkeys(kb.launch_counts, 0)
    for engine in ("rounds", "scan"):
        for s_tag, s_ in (("", esnap), (", scores past the clip", bsnap)):
            cyc = build_cycle_fn(commit_mode=engine, outputs="latency", device=dev)
            twin = build_cycle_fn(commit_mode=engine, outputs="latency", device=dev,
                                  static_base_fn=sb.static_base_plain)
            kb.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            dk = cyc(s_)
            torch.cuda.synchronize()
            cycle_ms[engine + s_tag] = round((time.time() - t0) * 1e3, 1)
            for k, v in kb.launch_counts.items():
                launches[k] += v
            dp = twin(s_)
            same = same_decisions(torch, dk, dp)
            check(all(same.values()), f"{engine}{s_tag} cycle with verdicts differs from "
                  f"its plain-K1 twin: {same}")
            a = dk.assignment
            placed = torch.nonzero(s_.pod_valid & (a >= 0), as_tuple=True)[0]
            check(bool(s_.pod_extender_mask[placed, a[placed].long()].all()),
                  f"{engine}{s_tag}: a pod placed on a node its extender filtered out")
            check_placements(torch, s_, dk, fw, plain, unplaced_infeasible=engine == "rounds")
            log(f"phase extenders {engine} cycle{s_tag}: {cycle_ms[engine + s_tag]} ms "
                f"(events of the first call), placed {len(placed)}, equal to the plain-K1 "
                f"twin, every placement on a node the filter passed; valid")
    check(launches["static_base_ext"] >= 4 and launches["static_base"] == 0,
          "K1's extender instance did not run in the cycles with verdicts")
    del esnap, bsnap, em, es, es_big, snap, dk, dp

    # ---- the serving leg: the Scheduler with the webhook in a child process ----
    ctx = multiprocessing.get_context("spawn")
    port_q = ctx.Queue()
    proc = ctx.Process(target=_serve_webhook, args=(port_q,), daemon=True)
    proc.start()
    serve = {"cycles": []}
    counts = dict.fromkeys(kb.launch_counts, 0)
    try:
        url = f"http://127.0.0.1:{port_q.get(timeout=120)}/ext"
        cut = pending[SERVE_SEED][:EXT_PENDING] + [
            MakePod(f"huge{i}").req({"cpu": "4000"}).priority(50).created(1e6 + i).obj()
            for i in range(EXT_HUGE)]
        def replica(pod, name):
            p = copy.deepcopy(pod)
            p.metadata.name, p.metadata.uid = name, f"{p.metadata.namespace}/{name}"
            return p

        arrivals = [[replica(p, f"ext{c}-{i}") for i, p in enumerate(cut[:EXT_ARRIVALS])]
                    for c in range(EXT_CHURN + 1)]
        clock_t = [0.0]

        def make(carry, forced):
            cfg = SchedulerConfiguration(
                forced_sync=forced,
                extenders=[Extender(url, filter_verb="filter", prioritize_verb="prioritize",
                                    weight=int(EXT_WEIGHT), carry_verdicts=carry)],
                pad_existing=len(existing) + len(cut) + EXT_CHURN * EXT_ARRIVALS,
                pad_pods_per_node=2 * CARRY_MPN)
            cl = ServeCluster()
            sch = Scheduler(cfg, binder=cl.bind, evictor=cl.evict, now=lambda: clock_t[0],
                            device=dev)
            cl.sched = sch
            for nd in nodes:
                sch.on_node_add(nd)
            for pod, node in existing:
                sch.on_pod_add(pod, node)
            for pod in copy.deepcopy(cut):
                sch.on_pod_add(pod)
            return sch, cl

        for carry, n_cycles in ((True, 1 + EXT_CHURN), (False, 2)):
            tag = "carry path" if carry else "packed path"
            sch, cl = make(carry, False)
            twin, tcl = make(carry, True)
            check(sch._use_carry == carry, f"{tag}: the Scheduler took the other chain")
            for c in range(n_cycles):
                if c:
                    for sch_ in (sch, twin):
                        for pod in copy.deepcopy(arrivals[c]):
                            sch_.on_pod_add(pod)
                clock_t[0] += 1.0
                nb, tnb = len(cl.binds), len(tcl.binds)
                kb.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.time()
                st = sch.schedule_cycle()
                torch.cuda.synchronize()
                wall_ms = (time.time() - t0) * 1e3
                for k, v in kb.launch_counts.items():
                    counts[k] += v
                tst = twin.schedule_cycle()
                check(cl.binds[nb:] == tcl.binds[tnb:]
                      and [(p.name, n) for p, n in sch.last_nominations]
                      == [(p.name, n) for p, n in twin.last_nominations]
                      and vars(st) | {"cycle_seconds": 0} == vars(tst) | {"cycle_seconds": 0},
                      f"serving with extenders, {tag} cycle {c}: differs from the "
                      f"forced_sync twin")
                entry = max((e for e in sch._packed.values() if e["fns"][6]._last is not None),
                            key=lambda e: e["fns"][6].stats["t_dispatch_start"])
                h = entry["fns"][6]._last
                fsnap = packing.unpack(h._wbuf, h._bbuf, entry["spec"])
                keeper = entry["fns"][5]
                if keeper is not None:  # the carried planes
                    fsnap = dataclasses.replace(fsnap, has_extender=True,
                                                pod_extender_mask=keeper.emask,
                                                pod_extender_score=keeper.escore)
                check(fsnap.has_extender, f"{tag}: the frame carries no verdicts")
                res = h.result
                a = res.assignment
                placed = torch.nonzero(fsnap.pod_valid & (a >= 0), as_tuple=True)[0]
                check(bool(fsnap.pod_extender_mask[placed, a[placed].long()].all()),
                      f"{tag} cycle {c}: a pod placed on a node its extender filtered out")
                check(len(cl.binds) - nb == int((a[:st.attempted] >= 0).sum()),
                      f"{tag} cycle {c}: binds != placements")
                check_placements(torch, fsnap, res, sch.framework, plain)
                rec = sch.flight.last_record()
                mk = rec.marks
                row = {"path": tag, "cycle": c, "pods": st.attempted,
                       "wall_ms": round(wall_ms, 1),
                       "encode_ms": round((mk["dispatch_start"] - mk["encode_start"]) * 1e3, 1),
                       "placed": st.scheduled, "unschedulable": st.unschedulable,
                       "bind_errors": st.bind_errors,
                       "carry_events_ms": round(rec.phases.get("carry_events_ms", 0.0), 2),
                       "cycle_events_ms": round(rec.phases.get("cycle_events_ms", 0.0), 2),
                       "frame_bytes": entry["spec"].n_words * 4 + entry["spec"].n_bytes}
                if keeper is not None:
                    row.update(keeper=keeper.last, consulted=keeper.consulted,
                               keeper_ms=round(keeper.last_ms, 1),
                               encode_path=sch._encoder.full_reason
                               if sch._encoder.delta_profile == {} else "delta")
                serve["cycles"].append(row)
                log(f"phase extenders serving, {tag} cycle {c}: {json.dumps(row)}; equal to "
                    f"the forced_sync twin, every binding valid and on a node the filter "
                    f"passed | {smi}")
            if carry:
                check(any(r.get("keeper") == "update" for r in serve["cycles"]),
                      "the verdict keeper never updated the changed slots alone")
            del sch, twin, cl, tcl
            torch.cuda.empty_cache()
    finally:
        proc.terminate()
        proc.join(10)
    for k in ("static_base", "static_base_ext", "extender_merge", "static_rejects_base",
              "dyn_rejects", "claim_pass", "capacity", "dyn_mask", "dyn_score"):
        check(counts[k] > 0, f"kernel {k} was not launched in the serving leg with extenders")
    log(f"phase extenders serving launches: {json.dumps(counts)}; cycles with verdicts' "
        f"launches: {json.dumps({k: v for k, v in launches.items() if v})}; the phase took "
        f"{time.time() - t_phase:.1f} s")
    serve["launches"] = counts
    kern = {
        "static_base (extender operands)": kernel_entry(
            "static_base (extender operands)", "cuda",
            "k8s_scheduler_tpu_torch/csrc/static_base.cu",
            "k8s_scheduler_tpu/core/cycle.py:574", launches["static_base_ext"]
            + counts["static_base_ext"], 0.0, k1e_ms, k1e_dev, k1e_plain, k1e_bytes, k1e_ops,
            launches_by_path={"cycles with verdicts": launches["static_base_ext"],
                              "serving": counts["static_base_ext"]}),
        "extender_merge": kernel_entry(
            "extender_merge", "triton", "k8s_scheduler_tpu_torch/ops/extender_merge.py",
            "k8s_scheduler_tpu/core/cycle.py:1349", counts["extender_merge"], 0.0, k18_ms,
            k18_dev, k18_plain, k18_bytes, k18_ops, window_device_ms=k18w_dev,
            window_plain_ms=k18w_plain, window_bound_ms=k18w_bound),
        "static_rejects (per-pod base)": kernel_entry(
            "static_rejects (per-pod base)", "cuda",
            "k8s_scheduler_tpu_torch/csrc/static_rejects.cu",
            "k8s_scheduler_tpu/core/cycle.py:1482", counts["static_rejects_base"], 0.0, k16_ms,
            k16_dev, k16_plain, k16_bytes, k16_ops),
    }
    return {"kernels": kern, "serving": serve, "cycle_ms": cycle_ms, "upload_ms": up_ms}


# ---- phase 12: durable state, the front door, spans, the black box, faults --

DURABLE_PLAN = "seed=7;device_error@cycle=2:kind=transport:n=1;fetch_delay@cycle=3:ms=20"
DURABLE_BATCHES = 4  # the pending set's submissions, one before each cycle
DURABLE_KILL_AFTER = 2  # the child is SIGKILLed after this cycle's flush
DURABLE_SPAN_RING = 65536
DURABLE_CHILD_WAIT_S = 240.0


def durable_batches(pods) -> list:
    """Config #4's pending set cut into DURABLE_BATCHES submissions."""
    n = -(-len(pods) // DURABLE_BATCHES)
    return [pods[i:i + n] for i in range(0, len(pods), n)]


def pct(values, q: float) -> float:
    """The q-quantile (nearest rank) of `values`."""
    v = sorted(values)
    return v[min(len(v) - 1, max(0, int(round(q * len(v) + 0.5)) - 1))] if v else 0.0


class DurableCluster:
    """Stands in for the API server in phase 12: records binds (each bind's
    host time and count by pod) and evictions (each one echoed back as the
    pod's delete). The front door's informer play confirms the binds after
    each cycle (`self_confirming_front_door`)."""

    def __init__(self):
        self.binds: list[tuple[str, str]] = []
        self.bind_t: dict[str, float] = {}
        self.bind_count: dict[str, int] = {}
        self.evictions: list[tuple[str, str]] = []
        self.evicted: list[str] = []  # uids, a bound submitted pod among them
        self.sched = None

    def bind(self, pod, node):
        self.binds.append((pod.name, node))
        self.bind_t.setdefault(pod.uid, time.perf_counter())
        self.bind_count[pod.uid] = self.bind_count.get(pod.uid, 0) + 1

    def evict(self, pod, node):
        self.evictions.append((pod.name, node))
        self.evicted.append(pod.uid)
        self.sched.on_pod_delete(pod.uid)


class JournalTimer:
    """Host time the serving thread spends journaling on one Scheduler: the
    codec's dicts, `DurableState._emit` and its record appends (a batch
    scope's flush included), outermost calls only."""

    def __init__(self, sched):
        import k8s_scheduler_tpu_torch.internal.cache as cache_mod
        from k8s_scheduler_tpu_torch.state import codec

        self.s = 0.0
        self._depth = 0
        self._main = threading.get_ident()
        self._cache_mod = cache_mod
        st = sched.state
        cache_mod._codec()
        cache_mod._pod_to_state = self._timed(codec.pod_to_state)
        cache_mod._node_to_state = self._timed(codec.node_to_state)
        emit = self._timed(st._emit)
        sched.queue._journal = sched.cache._journal = emit
        st._append_record = self._timed(st._append_record)

    def _timed(self, fn):
        def wrapped(*a, **k):
            if threading.get_ident() != self._main or self._depth:
                return fn(*a, **k)
            self._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.s += time.perf_counter() - t0
                self._depth -= 1
        return wrapped

    def close(self) -> None:
        from k8s_scheduler_tpu_torch.state import codec

        self._cache_mod._pod_to_state = codec.pod_to_state
        self._cache_mod._node_to_state = codec.node_to_state


class DurableServer:
    """One Scheduler of phase 12 on the carry path with its front door
    (`AdmissionController`, `self_confirming_front_door`): with `state_dir`
    a `DurableState` there (snapshotIntervalSeconds 0); `armed` adds the
    fault plan DURABLE_PLAN (the config's faultSpec), spans at rate 1.0 and
    a `BlackBox` under <stateDir>/blackbox; `box` the black box alone."""

    def __init__(self, dev, n_existing, clock, state_dir=None, armed=False, box=False):
        from k8s_scheduler_tpu_torch.config import SchedulerConfiguration
        from k8s_scheduler_tpu_torch.core import Scheduler
        from k8s_scheduler_tpu_torch.core import blackbox, spans
        from k8s_scheduler_tpu_torch.service.admission import (AdmissionController,
                                                               self_confirming_front_door)
        from k8s_scheduler_tpu_torch.state import DurableState

        # no kernel cache (a state dir would derive one, and its child and
        # standby would build every kernel cold): phase 13 measures it
        cfg = SchedulerConfiguration(pad_existing=n_existing + N_PENDING,
                                     pad_pods_per_node=2 * CARRY_MPN,
                                     fault_spec=DURABLE_PLAN if armed else "",
                                     compile_cache_dir="off")
        self.cl = DurableCluster()
        self.span_counts: dict[str, int] = {}
        if armed:
            spans.arm(spans.SpanRecorder(capacity=DURABLE_SPAN_RING), rate=1.0,
                      counter=lambda n: self.span_counts.__setitem__(
                          n, self.span_counts.get(n, 0) + 1))
        state = (DurableState(state_dir, snapshot_interval_seconds=0)
                 if state_dir is not None else None)
        t0 = time.perf_counter()
        self.sched = Scheduler(cfg, binder=self.cl.bind, evictor=self.cl.evict, now=clock,
                               state=state, device=dev)
        self.ctor_ms = (time.perf_counter() - t0) * 1e3
        self.cl.sched = self.sched
        self.box = None
        if armed or box:
            self.box = blackbox.arm(blackbox.BlackBox(
                os.path.join(state_dir, "blackbox"), retention=cfg.blackbox_retention,
                config={"faultSpec": cfg.fault_spec}, recorder=self.sched.flight,
                observer=self.sched.observer,
                spans_recorder=spans.RECORDER if armed else None, ladder=self.sched.ladder,
                fault_plan=self.sched._fault_plan, events=self.sched.events))
        self.adm = AdmissionController(self.sched)
        self.door = self_confirming_front_door(self.sched, self.adm)
        self.timer = JournalTimer(self.sched) if state is not None else None
        self.submit_t: dict[str, float] = {}
        self.acked: list[str] = []
        self.ack_ms: list[float] = []

    def feed(self, nodes, existing) -> float:
        """Config #4's cluster through the informer handlers; ms."""
        t0 = time.perf_counter()
        for nd in nodes:
            self.sched.on_node_add(nd)
        for pod, node in existing:
            self.sched.on_pod_add(pod, node)
        if self.sched.state is not None:
            self.sched.state.journal.flush()
        return (time.perf_counter() - t0) * 1e3

    def submit(self, pods) -> None:
        t0 = time.perf_counter()
        res = self.adm.submit(pods)
        ms = (time.perf_counter() - t0) * 1e3
        check(res.ok and res.accepted == len(pods), f"durable: a submission of {len(pods)} "
              f"pods was not accepted: {res.reason}")
        check(res.durable == (self.sched.state is not None),
              f"durable: the ack's durability is {res.durable}")
        for p in pods:
            self.submit_t[p.uid] = t0
        self.acked += [p.uid for p in pods]
        self.ack_ms.append(ms)

    def cycle(self, torch):
        """One serve-loop step (the cycle, then the binds' confirmation):
        (stats, wall ms, journal ms on the serving thread, outcome)."""
        s = self.sched
        nb, ne = len(self.cl.binds), len(self.cl.evictions)
        if self.timer is not None:
            self.timer.s = 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = self.door.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        jms = self.timer.s * 1e3 if self.timer is not None else 0.0
        outcome = (self.cl.binds[nb:], self.cl.evictions[ne:],
                   [(p.name, n) for p, n in s.last_nominations],
                   [(p.name, n) for p, n in s.last_evictions],
                   {k: v for k, v in vars(st).items() if k != "cycle_seconds"})
        return st, wall, jms, outcome

    def check_cycle(self, torch, st, tag) -> None:
        """The cycle's bindings against its frame (`check_placements`)."""
        from k8s_scheduler_tpu_torch.framework.interfaces import AffinityKernels

        snap, res = last_frame(self.sched)
        check(st.scheduled == int((res.assignment[:st.attempted] >= 0).sum()),
              f"durable {tag}: binds != placements")
        check_placements(torch, snap, res, self.sched.framework, AffinityKernels.plain())

    def digest(self) -> str:
        from k8s_scheduler_tpu_torch.state import state_digest

        return state_digest(self.sched.queue, self.sched.cache)

    def lost(self, evicted=()) -> list[str]:
        """Acked uids the Scheduler no longer knows: neither pending in the
        queue nor assumed or bound in the cache, nor preempted after
        their bind (an eviction deletes the pod)."""
        gone = set(self.cl.evicted) | set(evicted)
        known = {p.uid for p in self.sched.queue.all_pending()}
        return [u for u in self.acked
                if u not in known and u not in gone and not self.sched.cache.has_pod(u)]

    def close(self) -> None:
        from k8s_scheduler_tpu_torch.core import blackbox, faults, spans

        if self.timer is not None:
            self.timer.close()
        st = self.sched.state
        if st is not None and not st.status()["sealed"]:
            st.journal.flush()
            st.journal.close()
        spans.disarm()
        blackbox.disarm()
        faults.disarm()


def durable_child(state_dir: str) -> int:
    """`chip_smoke.py --durable-child DIR`: phase 12's active on the card in
    a process of its own, over config #4 as the parent drives it; after each
    cycle's journal flush a line {cycle, digest, binds, acked} in
    DIR/child.jsonl, and after the DURABLE_KILL_AFTER-th a `done` line,
    then it waits for its SIGKILL."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from k8s_scheduler_tpu_torch.utils import synth

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    nodes, existing, pending = synth.config4_workload((SERVE_SEED,), N_NODES, N_EXISTING,
                                                      N_PENDING)
    batches = durable_batches(pending[SERVE_SEED])
    clock_t = [0.0]
    srv = DurableServer(dev, len(existing), lambda: clock_t[0], state_dir, armed=True)
    srv.feed(nodes, existing)
    with open(os.path.join(state_dir, "child.jsonl"), "a") as out:
        for c in range(DURABLE_KILL_AFTER):
            srv.submit(batches[c])
            clock_t[0] += 1.0
            srv.cycle(torch)
            srv.sched.state.journal.flush()
            out.write(json.dumps({"cycle": c, "digest": srv.digest(), "binds": srv.cl.binds,
                                  "acked": srv.acked, "evicted": srv.cl.evicted}) + "\n")
            out.flush()
        out.write("done\n")
        out.flush()
    while True:  # the kill lands on a fully durable boundary
        time.sleep(1.0)


def durable_phase(torch, kb, dev, nodes, existing, pending, smi) -> dict:
    """Phase 12: the port's Scheduler with durable state, the front door,
    spans, the black box and a fault plan over config #4 (the carry path):
    decisions equal to a twin's without any of them; a SIGKILLed child
    process's last digest restored by a standby on the card, which then
    recovers the in-flight pods and runs the rest of the backlog; the
    stateless rung's bundle. Launch counts of the active's cycles alone."""
    import shutil
    import signal
    import tempfile

    from k8s_scheduler_tpu_torch.core import faults
    from k8s_scheduler_tpu_torch.core.blackbox import load_bundle
    from k8s_scheduler_tpu_torch.core.cycle import RESILIENT_STRIKES
    from k8s_scheduler_tpu_torch.core.degrade import RUNG_STATELESS
    from k8s_scheduler_tpu_torch.internal.cache import SchedulerCache
    from k8s_scheduler_tpu_torch.internal.queue import SchedulingQueue
    from k8s_scheduler_tpu_torch.state import DurableState, state_digest

    import copy

    t_phase = time.time()
    n_cycles = DURABLE_BATCHES
    pods = pending[SERVE_SEED]
    root = tempfile.mkdtemp(prefix="chip-smoke-durable-")
    out: dict = {}
    try:
        # ---- the twin: no state, spans, black box or faults ----
        clock_t = [0.0]
        twin = DurableServer(dev, len(existing), lambda: clock_t[0])
        twin_feed = twin.feed(nodes, existing)
        batches = durable_batches(copy.deepcopy(pods))
        want, twin_wall = [], []
        for c in range(n_cycles):
            twin.submit(batches[c])
            clock_t[0] += 1.0
            _st, wall, _j, outcome = twin.cycle(torch)
            want.append(outcome)
            twin_wall.append(round(wall, 1))
        twin.close()
        del twin
        torch.cuda.empty_cache()

        # ---- the active: durable state, spans at 1.0, the black box, the plan ----
        clock_t = [0.0]
        strikes0 = sum(RESILIENT_STRIKES.values())
        act_dir = os.path.join(root, "active")
        act = DurableServer(dev, len(existing), lambda: clock_t[0], act_dir, armed=True)
        act_feed = act.feed(nodes, existing)
        batches = durable_batches(copy.deepcopy(pods))
        counts = dict.fromkeys(kb.launch_counts, 0)
        walls, jms, digests = [], [], []
        for c in range(n_cycles):
            act.submit(batches[c])
            clock_t[0] += 1.0
            kb.reset_launch_counts()
            st, wall, j, outcome = act.cycle(torch)
            for k, v in kb.launch_counts.items():
                counts[k] += v
            walls.append(round(wall, 1))
            jms.append(round(j, 2))
            check(outcome == want[c], f"durable cycle {c}: bindings / nominations / "
                  f"evictions / stats differ from the twin's")
            act.check_cycle(torch, st, f"cycle {c}")
            act.sched.state.journal.flush()
            digests.append(act.digest())
            log(f"phase durable cycle {c}: {st.attempted} pods, placed {st.scheduled}, "
                f"unschedulable {st.unschedulable}, nominated {st.preemptors}, victims "
                f"{st.victims}; schedule_cycle wall {wall:.1f} ms (the twin's "
                f"{twin_wall[c]}), journaling on the serving thread {j:.2f} ms; equal to the "
                f"twin, every binding valid | {smi}")
        fired = sorted({(e["point"], e["cycle"]) for e in faults.plan().log})
        check(fired == [("device_error", 2), ("fetch_delay", 3)],
              f"durable: the plan fired {fired}")
        check(act.sched.ladder.rung == 0 and act.sched.ladder.degradations == 0,
              "durable: the transport fault was not absorbed by the retry")
        check(sum(RESILIENT_STRIKES.values()) == strikes0 + 1,
              "durable: the transport fault's retry was not counted")
        check(all(v == 1 for v in act.cl.bind_count.values()), "durable: a pod bound twice")
        lost = act.lost()
        check(not lost, f"durable: {len(lost)} acked pods lost: {lost[:4]}")
        js = act.sched.state.journal.status()
        t0 = time.perf_counter()
        act.sched.state.snapshot()
        snap_ms = (time.perf_counter() - t0) * 1e3
        snap_bytes = act.sched.state.last_snapshot["bytes"]
        bind_ms = [(t - act.submit_t[u]) * 1e3 for u, t in act.cl.bind_t.items()]
        ack_ms = [ms for ms, b in zip(act.ack_ms, batches) for _ in b]
        out.update(
            journal_records=js["appended"], journal_bytes=js["bytes_written"],
            journal_fsyncs=js["fsync_count"], journal_ms_a_cycle=jms, snapshot_ms=round(snap_ms, 1),
            snapshot_bytes=snap_bytes, submit_ack_ms=[round(x, 1) for x in act.ack_ms],
            submit_ack_p50_ms=round(pct(ack_ms, 0.5), 1),
            submit_ack_p99_ms=round(pct(ack_ms, 0.99), 1),
            submit_bind_p50_ms=round(pct(bind_ms, 0.5), 1),
            submit_bind_p99_ms=round(pct(bind_ms, 0.99), 1),
            wall_ms=walls, twin_wall_ms=twin_wall, feed_ms=round(act_feed, 1),
            twin_feed_ms=round(twin_feed, 1), spans=dict(act.span_counts), launches=counts)
        log(f"phase durable journal: {js['appended']} records, {js['bytes_written']} bytes, "
            f"{js['fsync_count']} fsyncs (the writer thread's group commits); journaling on "
            f"the serving thread ms a cycle {jms}; snapshot write {snap_ms:.1f} ms "
            f"({snap_bytes} bytes); handlers {act_feed:.0f} ms (the twin's {twin_feed:.0f}) | "
            f"{smi}")
        log(f"phase durable front door: 4 submissions of {len(batches[0])} pods, "
            f"submit-to-ack ms {out['submit_ack_ms']} (p50 {out['submit_ack_p50_ms']}, p99 "
            f"{out['submit_ack_p99_ms']} over the pods), submit-to-bind p50 "
            f"{out['submit_bind_p50_ms']} ms, p99 {out['submit_bind_p99_ms']} ms over "
            f"{len(bind_ms)} bound pods; spans {json.dumps(act.span_counts)} | {smi}")
        log(f"phase durable serving-cycle wall ms with state, spans and faults {walls} "
            f"against the twin's {twin_wall} (same call); the plan fired {fired}, absorbed "
            f"(rung 0); launches {json.dumps({k: v for k, v in counts.items() if v})}")
        act.close()
        del act
        torch.cuda.empty_cache()

        # ---- failover: the active in a child process, SIGKILLed ----
        child_dir = os.path.join(root, "child")
        os.makedirs(child_dir)
        here = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        with open(os.path.join(child_dir, "child.log"), "w") as clog:
            child = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                      "--durable-child", child_dir], cwd=here,
                                     stdout=clog, stderr=subprocess.STDOUT)
        lines_path = os.path.join(child_dir, "child.jsonl")
        try:
            deadline = time.monotonic() + DURABLE_CHILD_WAIT_S
            done = False
            while time.monotonic() < deadline:
                if os.path.exists(lines_path):
                    with open(lines_path) as f:
                        done = "done" in f.read().split("\n")
                if done:
                    break
                if child.poll() is not None:
                    break
                time.sleep(0.05)
            if not done:
                with open(os.path.join(child_dir, "child.log")) as f:
                    tail = f.read()[-4000:]
                check(False, f"durable: the child never reached its flush (exit "
                      f"{child.poll()}):\n{tail}")
        finally:
            if child.poll() is None:
                child.send_signal(signal.SIGKILL)
            child.wait()
        child_s = time.perf_counter() - t0
        with open(lines_path) as f:
            rows = [json.loads(x) for x in f.read().split("\n") if x.startswith("{")]
        check([r["cycle"] for r in rows] == list(range(DURABLE_KILL_AFTER)),
              "durable: the child's flush lines")
        check([r["digest"] for r in rows] == digests[:DURABLE_KILL_AFTER],
              "durable: the child's digests differ from the in-process active's")
        last = rows[-1]
        q, c = SchedulingQueue(), SchedulerCache()
        bare = DurableState(child_dir, snapshot_interval_seconds=0)
        bare.restore_into(q, c)
        bare.journal.close()
        check(state_digest(q, c) == last["digest"],
              "durable: the restored digest differs from the killed child's last one")
        n_flight = sum(1 for u in q._in_flight if u not in q._deleted_in_flight)
        clock_t = [float(DURABLE_KILL_AFTER)]
        q._now = lambda: clock_t[0]
        recovered = q.recover_in_flight()
        standby = DurableServer(dev, len(existing), lambda: clock_t[0], child_dir, box=True)
        restore = standby.sched.state.last_restore
        check(standby.digest() == state_digest(q, c),
              "durable: the standby's state differs from the restore with its in-flight "
              "pods recovered")
        log(f"phase durable failover: the child (the active in its own process on the card) "
            f"SIGKILLed after cycle {DURABLE_KILL_AFTER}'s flush, {child_s:.1f} s from its "
            f"start; its digests equal the in-process active's; the standby restored "
            f"{restore['records_replayed']} records in {restore['seconds'] * 1e3:.1f} ms "
            f"(snapshot {restore['snapshot']}; its constructor {standby.ctor_ms:.0f} ms) to "
            f"the child's last digest {last['digest'][:12]}, then requeued {recovered} "
            f"in-flight pods ({n_flight} untombstoned at the kill) | {smi}")
        standby.acked = list(last["acked"])
        child_binds = {name for name, _n in last["binds"]}
        for c in range(DURABLE_KILL_AFTER, n_cycles):
            standby.submit(batches[c])
            clock_t[0] += 1.0
            st, wall, _j, outcome = standby.cycle(torch)
            standby.check_cycle(torch, st, f"standby cycle {c}")
            # the sampling window rotates with the encoder's cycle index,
            # which a standby restarts (it is not durable state, in the
            # reference either): its nodes may differ from the twin's
            moved = len(set(outcome[0]) - set(want[c][0]))
            log(f"phase durable standby cycle {c}: placed {st.scheduled} of {st.attempted} "
                f"(the twin {want[c][4]['scheduled']} of {want[c][4]['attempted']}; "
                f"{moved} bindings not the twin's: the sampling window restarts with the "
                f"standby's cycle index), wall {wall:.1f} ms; every binding valid")
        names = [name for name, _n in standby.cl.binds]
        check(len(set(names)) == len(names) and not (set(names) & child_binds),
              "durable: a pod bound twice across the failover")
        lost = standby.lost(last["evicted"])
        check(not lost, f"durable: {len(lost)} acked pods lost across the failover: "
              f"{lost[:4]}")
        # ---- the stateless rung: seal, detach, the black box ----
        sealed = standby.digest()
        while standby.sched.ladder.rung < RUNG_STATELESS:
            standby.sched.ladder.degrade("forced by the smoke run")
        bundles = standby.box.status()["bundles"]
        check(len(bundles) == 1 and bundles[0].endswith("-stateless.json"),
              f"durable: the stateless rung left bundles {bundles}")
        path = os.path.join(child_dir, "blackbox", bundles[0])
        bundle = load_bundle(path)
        check(bundle["trigger"] == "stateless" and bundle["flight"]["records"],
              "durable: the bundle does not read back")
        q2, c2 = SchedulingQueue(), SchedulerCache()
        st2 = DurableState(child_dir, snapshot_interval_seconds=0)
        stats2 = st2.restore_into(q2, c2)
        st2.journal.close()
        check(stats2["clean_shutdown"] and stats2["records_replayed"] == 0
              and state_digest(q2, c2) == sealed, "durable: the sealed snapshot")
        out.update(restore_ms=round(restore["seconds"] * 1e3, 1),
                   restore_records=restore["records_replayed"], recovered=recovered,
                   bundle_bytes=os.path.getsize(path), child_s=round(child_s, 1))
        log(f"phase durable black box: the stateless rung sealed a clean snapshot (a "
            f"takeover replays 0 records) and dumped {bundles[0]}, "
            f"{out['bundle_bytes']} bytes, read back by load_bundle; the phase took "
            f"{time.time() - t_phase:.1f} s | {smi}")
        standby.close()
        del standby
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want_k = ["static_base", "claim_pass", "capacity", "guard_sweep", "interpod_terms",
              "interpod_norm", "affinity_update", "dyn_mask", "dyn_score",
              "preempt_prefilter", "preempt_whatif", "preempt_claim", "static_rejects",
              "dyn_rejects", "extender_merge"]
    for k in want_k:
        check(counts.get(k, 0) > 0, f"kernel {k} was not launched in the durable cycles")
    return out


COMPILE_CYCLES = 2  # phase 13's serving cycles a child
COMPILE_CHILD_WAIT_S = 300.0
FUZZ_SECONDS = 45.0  # phase 13's seeded run_case traces: as many as this allows
FUZZ_CORPUS = ("attribution_static_dyn_split", "tiebreak_argmax_last")


def grpc_fact() -> str:
    """Whether grpc and google.protobuf import here, with their versions or
    the error (the gRPC shim's prerequisite, ROADMAP A10b)."""
    out = []
    for mod in ("grpc", "google.protobuf"):
        try:
            m = __import__(mod, fromlist=["__version__"])
            out.append(f"{mod} {getattr(m, '__version__', '?')}")
        except Exception as e:  # any import failure is the fact to record
            out.append(f"{mod} missing ({type(e).__name__}: {e})")
    return "; ".join(out)


def triton_builds(root: str) -> int:
    """Kernels Triton compiled into its cache directory (one cubin each)."""
    n = 0
    for _, _, files in os.walk(root):
        n += sum(f.endswith(".cubin") for f in files)
    return n


def compile_child(cache_dir: str, role: str) -> int:
    """`chip_smoke.py --compile-child DIR --compile-role cold|warm`: phase
    13's process with the persistent kernel cache at DIR. It opens the
    cache through a `Scheduler` with `compileCacheDir` DIR (the cold one
    with `faultSpec` cache_torn@n=1), loads every CUDA library (one thread
    each) and compiles the Triton kernels, feeds config #4 (seed 202)
    through the handlers and runs COMPILE_CYCLES carry serving cycles; the
    warm one then runs `profile_cycle(repeats=3)`, `trace_cycle` on a
    further carry cycle, the watchtower (armed before the cycles, the
    built-in rules scaled by 0.01) and its three endpoints, and dumps a
    black-box bundle. Its last stdout line is one JSON object."""
    import hashlib
    import tempfile
    import urllib.request

    import torch

    t_proc = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from k8s_scheduler_tpu_torch.cmd.httpserver import start_http_server, stop_http_server
    from k8s_scheduler_tpu_torch.cmd.watchtower import arm_watchtower, disarm_watchtower
    from k8s_scheduler_tpu_torch.config import SchedulerConfiguration
    from k8s_scheduler_tpu_torch.core import Scheduler, blackbox, faults
    from k8s_scheduler_tpu_torch.core.profiling import TRACE_FILE, trace_cycle
    from k8s_scheduler_tpu_torch.metrics.rules import builtin_rules, scale_rules
    from k8s_scheduler_tpu_torch.ops import claim_pass as cp
    from k8s_scheduler_tpu_torch.ops import extender_merge as em
    from k8s_scheduler_tpu_torch.ops import kernel_build as kb
    from k8s_scheduler_tpu_torch.utils import synth

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    warm = role == "warm"
    nodes, existing, pending = synth.config4_workload((SERVE_SEED,), N_NODES, N_EXISTING,
                                                      N_PENDING)
    clock_t = [0.0]
    cfg = SchedulerConfiguration(
        compile_cache_dir=cache_dir, fault_spec="" if warm else "cache_torn@n=1",
        pad_existing=len(existing) + len(pending[SERVE_SEED]),
        pad_pods_per_node=2 * CARRY_MPN, metrics_ticker_seconds=0.2)
    cl = ServeCluster()
    t_ready0 = time.perf_counter()
    sch = Scheduler(cfg, binder=cl.bind, evictor=cl.evict, now=lambda: clock_t[0],
                    device=dev)
    cl.sched = sch
    cc = sch._compile_cache
    triton_dir = os.environ["TRITON_CACHE_DIR"]
    tri0 = triton_builds(triton_dir)
    errs: list[BaseException] = []

    def load(name):
        try:
            kb.load_cuda_library(name)
        except BaseException as e:  # re-raised on the main thread below
            errs.append(e)

    threads = [threading.Thread(target=load, args=(n,)) for n in kb.CUDA_KERNELS]
    for th in threads:
        th.start()
    z = torch.zeros((2, 8), device=dev)
    zb = torch.zeros((2, 8), dtype=torch.bool, device=dev)
    cp.claim_pass_triton(z, ~zb, zb, zb[:, 0], None,
                         torch.zeros(2, dtype=torch.int32, device=dev),
                         torch.full((2,), -1, dtype=torch.int32, device=dev))
    em.extender_merge_triton(z, sampling=(torch.zeros(2, dtype=torch.int32, device=dev),
                                          torch.tensor(8, device=dev),
                                          torch.tensor(8, device=dev)))
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    if errs:
        raise errs[0]
    ready_s = time.perf_counter() - t_ready0
    stats = {"role": role, "nvcc": int(kb.build_stats["nvcc"]),
             "hits": int(kb.build_stats["hits"]), "misses": int(kb.build_stats["misses"]),
             "load_s": round(kb.build_stats["load_s"], 4), "ready_s": round(ready_s, 2),
             "process_to_ready_s": round(time.perf_counter() - t_proc, 2),
             "triton_builds": triton_builds(triton_dir) - tri0,
             "triton_in_cache": os.path.abspath(triton_dir).startswith(
                 os.path.abspath(cache_dir)),
             "entries": cc.status()["entries"], "entry_bytes": cc.entry_bytes(),
             "fired": sorted(faults.plan().fired_points()) if faults.plan() else [],
             "metric_hits": sch.metrics.compile_cache_hits.get(),
             "metric_misses": sch.metrics.compile_cache_misses.get()}
    store = engine = None
    if warm:
        store, engine = arm_watchtower(cfg, sch, rules=scale_rules(builtin_rules(), 0.01))
    t0 = time.perf_counter()
    for nd in nodes:
        sch.on_node_add(nd)
    for pod, node in existing:
        sch.on_pod_add(pod, node)
    for pod in pending[SERVE_SEED]:
        sch.on_pod_add(pod)
    stats["feed_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    digests, walls = [], []
    for c in range(COMPILE_CYCLES):
        nb = len(cl.binds)
        clock_t[0] += 1.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sch.schedule_cycle()
        torch.cuda.synchronize()
        walls.append(round((time.perf_counter() - t0) * 1e3, 1))
        digests.append(hashlib.sha256(json.dumps(sorted(cl.binds[nb:])).encode())
                       .hexdigest()[:16])
        check(st.scheduled == len(cl.binds) - nb, f"compile child: cycle {c} binds")
    stats.update(digests=digests, cycle_wall_ms=walls, bound=len(cl.binds),
                 triton_builds_after_cycles=triton_builds(triton_dir) - tri0)
    if warm:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_watch_")
        # the profiling pass over the pods the cycles left pending
        t0 = time.perf_counter()
        report = sch.profile_cycle(repeats=3)
        stats["profile_s"] = round(time.perf_counter() - t0, 2)
        stats["profile_ms"] = {k: round(v["seconds"] * 1e3, 4) for k, v in report.items()}
        stats["profile_pending"] = len(list(sch.queue.all_pending()))
        n_plugin = sum(c.count for c in sch.metrics.plugin_duration._children.values())
        n_point = sum(c.count for c in sch.metrics.extension_point_duration._children.values())
        check(report and n_plugin > 0 and n_point > 0,
              f"compile child: profile_cycle filled {n_plugin} / {n_point} histogram samples")
        stats["histogram_samples"] = {"plugin": n_plugin, "extension_point": n_point}
        # one more carry cycle under torch.profiler, 500 arrivals of
        # config #4's mix
        for pod in synth.make_pods(SERVE_ARRIVALS, seed=SERVE_SEED + 1000,
                                   name_prefix="trace-", **synth.CONFIG4_PENDING):
            sch.on_pod_add(pod)
        clock_t[0] += 1.0
        trace_cycle(lambda _: sch.schedule_cycle(), None, tmp)
        path = os.path.join(tmp, TRACE_FILE)
        with open(path) as f:
            ev = json.load(f).get("traceEvents", [])
        stats["trace_bytes"] = os.path.getsize(path)
        stats["trace_kernels"] = sum(1 for e in ev if e.get("cat") == "kernel")
        check(stats["trace_kernels"] > 0, "compile child: the cycle's trace has no kernel")
        # the watchtower's endpoints and the black box
        time.sleep(0.5)  # a few ticks of the registry sampler
        srv = start_http_server(sch.metrics, port=0, recorder=sch.flight,
                                observer=sch.observer, tsdb=store, alerts=engine,
                                dashboard=cfg.debug_dashboard)
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        scraped = {}
        try:
            for route in ("/debug/metrics/history", "/debug/alerts", "/debug/dashboard"):
                with urllib.request.urlopen(base + route, timeout=30) as r:
                    check(r.status == 200, f"compile child: {route} answered {r.status}")
                    scraped[route] = len(r.read())
        finally:
            stop_http_server(srv)
        inv = store.families()
        stats.update(scraped_bytes=scraped, history_families=len(inv),
                     history_series=store.status()["series"], ticks=store.ticks,
                     alert_evaluations=engine.status()["evaluations"],
                     alerts_fired=engine.status()["fired_total"])
        box = blackbox.BlackBox(os.path.join(tmp, "blackbox"), recorder=sch.flight,
                                observer=sch.observer, tsdb=store, engine=engine,
                                ladder=sch.ladder, events=sch.events)
        bpath = box.dump("smoke", "phase 13")
        bundle = blackbox.load_bundle(bpath)
        check("alerts" in bundle and "metrics_history" in bundle,
              f"compile child: the bundle lacks alerts / metrics_history: {sorted(bundle)}")
        stats["bundle_bytes"] = os.path.getsize(bpath)
        stats["bundle_series"] = len(bundle["metrics_history"]["series"])
        disarm_watchtower(sch, store)
    faults.disarm()
    print(json.dumps({"compile_child": stats}))
    return 0


def run_compile_child(cache_dir: str, role: str) -> dict:
    """One phase-13 child on the card; its stats line."""
    t0 = time.time()
    # without this process's TRITON_CACHE_DIR (phase 2 compiled into it):
    # the child's Triton kernels compile under the kernel cache's tree
    env = {k: v for k, v in os.environ.items() if k != "TRITON_CACHE_DIR"}
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--compile-child", cache_dir,
         "--compile-role", role],
        capture_output=True, text=True, timeout=COMPILE_CHILD_WAIT_S, env=env)
    if proc.returncode != 0:
        log(f"phase compile {role} child stderr tail:\n{proc.stderr[-4000:]}")
    check(proc.returncode == 0, f"the {role} compile child exited {proc.returncode}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"compile_child"')]
    check(bool(lines), f"the {role} compile child printed no stats")
    refused = [ln for ln in proc.stderr.splitlines() if "REFUSING" in ln]
    out = json.loads(lines[-1])["compile_child"]
    out["refused"] = refused
    out["wall_s"] = round(time.time() - t0, 1)
    return out


def compile_phase(torch, kb, dev, smi) -> dict:
    """Phase 13: (a) the persistent kernel cache across two processes, cold
    then warm, on one empty directory; (b) in the warm one the profiling
    pass, a traced cycle and the watchtower; (c) here, the fuzz differential
    on the card: the corpus, the tiebreak bug through K13's last-max
    instance, seeded `run_case` traces (plain, durable, incremental) for
    FUZZ_SECONDS. Returns the phase's numbers."""
    import tempfile

    from k8s_scheduler_tpu_torch.fuzz import (engine_bug, generate_trace, replay_artifact,
                                              run_case)

    t_phase = time.time()
    out: dict = {}
    # ---- (a) + (b) ----
    cache_dir = tempfile.mkdtemp(prefix="chip_smoke_kscc_")
    cold = run_compile_child(cache_dir, "cold")
    log(f"phase compile cold child: {json.dumps(cold)} | {smi}")
    warm = run_compile_child(cache_dir, "warm")
    log(f"phase compile warm child: {json.dumps(warm)} | {smi}")
    n_cuda = len(kb.CUDA_KERNELS)
    check(cold["nvcc"] == n_cuda and cold["misses"] == n_cuda and cold["hits"] == 0,
          f"cold child: {cold['nvcc']} nvcc runs, {cold['hits']} hits, {cold['misses']} misses")
    check(cold["fired"] == ["cache_torn"], f"cold child: faults fired {cold['fired']}")
    check(warm["nvcc"] == 1 and warm["misses"] == 1 and warm["hits"] == n_cuda - 1,
          f"warm child: {warm['nvcc']} nvcc runs, {warm['hits']} hits, "
          f"{warm['misses']} misses (want 1, {n_cuda - 1}, 1)")
    check(len(warm["refused"]) == 1, f"warm child refused {len(warm['refused'])} entries")
    check(warm["metric_hits"] == n_cuda - 1 and warm["metric_misses"] == 1,
          "warm child: the compile-cache metric families disagree with the counts")
    check(cold["triton_in_cache"] and warm["triton_in_cache"],
          "a child's Triton kernels compiled outside the kernel cache's tree")
    check(cold["triton_builds_after_cycles"] > 0 and warm["triton_builds_after_cycles"] == 0,
          f"Triton builds: cold {cold['triton_builds_after_cycles']}, warm "
          f"{warm['triton_builds_after_cycles']}")
    check(cold["digests"] == warm["digests"],
          f"binding digests differ: cold {cold['digests']}, warm {warm['digests']}")
    log(f"phase compile: the warm child ran nvcc once (the torn entry, refused: "
        f"{warm['refused'][0].strip()[-120:]}), took {warm['hits']} libraries from the "
        f"cache in {warm['load_s']:.3f} s; kernels ready cold {cold['ready_s']} s, warm "
        f"{warm['ready_s']} s; Triton builds cold {cold['triton_builds_after_cycles']}, warm "
        f"{warm['triton_builds_after_cycles']}; entries {warm['entries']}, "
        f"{warm['entry_bytes']} bytes; "
        f"digests equal {cold['digests']}")
    out.update(cold=cold, warm=warm)
    # ---- (c) the fuzzer on the card ----
    # the harness's last-max instances of K13 and K9, built now (one nvcc
    # each, together), held against their plain versions under the same
    # mutation on the seeded edge cases
    with engine_bug("tiebreak"):
        t0 = time.time()
        errs: list[BaseException] = []

        def build(name):
            try:
                kb.load_cuda_library(name)
            except BaseException as e:  # re-raised on the main thread below
                errs.append(e)

        ths = [threading.Thread(target=build, args=(n,)) for n in kb.HARNESS_KERNELS]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        if errs:
            raise errs[0]
        build_s = time.time() - t0
        kb.reset_launch_counts()
        n_scan = len(scan_edge_checks(torch, dev))
        n_claim = len(claim_edge_checks(torch, dev))
        h = dict(kb.harness_launch_counts)
        check(h["scan_commit_tie_last"] == n_scan and h["preempt_claim_tie_last"] == n_claim
              and kb.launch_counts["scan_commit"] == 0 and kb.launch_counts["preempt_claim"] == 0,
              f"the tie-break mutation launched {json.dumps(h)}")
    log(f"phase fuzz harness instances: scan_commit_tie_last and preempt_claim_tie_last "
        f"built in {build_s:.1f} s, equal to the mutated plain versions on {n_scan} K13 "
        f"and {n_claim} K9 edge cases")
    out["harness_build_s"] = round(build_s, 1)
    corpus = Path(__file__).resolve().parent / "tests" / "corpus"
    for name in FUZZ_CORPUS:
        t0 = time.time()
        fails = replay_artifact(str(corpus / f"{name}.json"), device=dev)
        check(fails == [], f"corpus {name} did not replay clean: {fails}")
        log(f"phase fuzz corpus {name}: clean ({(time.time() - t0) * 1e3:.0f} ms)")
    kb.reset_launch_counts()
    t0 = time.time()
    fails = replay_artifact(str(corpus / "tiebreak_argmax_last.json"), with_bug=True,
                            device=dev)
    tie = {**kb.launch_counts, **kb.harness_launch_counts}
    check([f.cls for f in fails] == ["divergence/binds"],
          f"tiebreak bug: {[str(f) for f in fails]}")
    check(tie["scan_commit_tie_last"] > 0 and tie["scan_commit"] == 0,
          f"tiebreak bug: K13 launches {tie['scan_commit']}, its last-max instance "
          f"{tie['scan_commit_tie_last']}")
    log(f"phase fuzz tiebreak bug: {fails[0]} through K13's last-max instance "
        f"({tie['scan_commit_tie_last']} launches, {(time.time() - t0) * 1e3:.0f} ms; K9's "
        f"instance {tie['preempt_claim_tie_last']})")
    out["tie_last_launches"] = tie["scan_commit_tie_last"]
    try:
        replay_artifact(str(corpus / "tenant_row_skew_cross_leak.json"), device=dev)
        check(False, "the tenant corpus file was not refused")
    except NotImplementedError as e:
        check("A12" in str(e), f"tenant refusal names no ROADMAP item: {e}")
        log(f"phase fuzz tenant_row_skew_cross_leak: refused ({e})")
    kb.reset_launch_counts()
    counts = {"plain": 0, "durable": 0, "incremental": 0}
    failures: list[str] = []
    t0 = time.time()
    seed = 0
    while time.time() - t0 < FUZZ_SECONDS:
        kind = ("plain", "durable", "incremental")[seed % 3]
        tr = generate_trace(seed, multi_cycle=False)
        if kind == "incremental":
            tr.config["incremental_encode"] = True
        state = tempfile.mkdtemp(prefix="chip_smoke_fuzz_") + "/state" if kind == "durable" else ""
        f = run_case(tr, state_dir=state, device=dev)
        failures += [f"seed {seed} {kind}: {x}" for x in f]
        counts[kind] += 1
        seed += 1
    fuzz_s = time.time() - t0
    launches = {k: v for k, v in {**kb.launch_counts, **kb.harness_launch_counts}.items()
                if v}
    log(f"phase fuzz seeded run_case: {sum(counts.values())} traces in {fuzz_s:.1f} s "
        f"({json.dumps(counts)}), {len(failures)} failures; launches {json.dumps(launches)}")
    check(not failures, f"seeded fuzz failures: {failures[:5]}")
    check(launches.get("scan_commit", 0) > 0, "the seeded traces launched no K13")
    out.update(fuzz_traces=counts, fuzz_s=round(fuzz_s, 1), fuzz_launches=launches,
               seconds=round(time.time() - t_phase, 1))
    log(f"phase compile + fuzz took {out['seconds']} s")
    return out


# ---- phase 14: the CLI and the gRPC shim, multi-cycle and speculative ------

# arrival groups of phase 14 (slice 1's pending mix), and a gang of
# make_gang_pods(1) whose 8 members split 5 | 3 over groups 1 and 2: its
# minMember is cut to 4, so the first part binds and the stragglers join it
# through the batch loop's placed-count carry
CLI_GROUPS = (2500, 250, 1200, 600, 1800, 400, 900, 2000)
CLI_GANG_MIN, CLI_GANG_SPLIT = 4, 5
CLI_SEED = 1414
CLI_VARIANTS = (("k1", 1, 0), ("k4", 4, 0), ("k4_spec", 4, 1))
CLI_SERVE_WAIT_S = 300.0


def cli_child(report: str, cli_args: list) -> int:
    """`chip_smoke.py --cli-child REPORT -- ARGS`: `python -m
    k8s_scheduler_tpu_torch ARGS` in this process (runpy, as `-m` does),
    with launch counting around the multi-cycle batches: every
    `dispatch_multi` call's kernel launches, CUDA-event device ms, inner
    cycles run and host-sync sites (`set_sync_debug_mode("warn")` for the
    call), and each batch's deferred preemption / diagnosis launches. At
    exit REPORT holds them and the process's launch counts."""
    import atexit
    import inspect
    import runpy
    import warnings

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from k8s_scheduler_tpu_torch.core import cycle as cy
    from k8s_scheduler_tpu_torch.core import pipeline as pl
    from k8s_scheduler_tpu_torch.ops import kernel_build as kb

    src, lo = inspect.getsourcelines(cy.build_packed_multicycle_fn)
    rep = {"batches": [], "deferred": {}, "loop_lines": [lo, lo + len(src)]}

    def delta(before):
        return {k: v - before.get(k, 0) for k, v in kb.launch_counts.items()
                if v - before.get(k, 0)}

    orig_multi = pl.ServingPipeline.dispatch_multi

    def dispatch_multi(self, *a, **k):
        before = dict(kb.launch_counts)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ev[0].record()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                h = orig_multi(self, *a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            ev[1].record()
        torch.cuda.synchronize()
        sites: dict = {}
        for w in caught:
            if "synchroniz" in str(w.message):
                key = f"{Path(w.filename).name}:{w.lineno}"
                sites[key] = sites.get(key, 0) + 1
        rep["batches"].append({
            "n": int(a[3]), "cycles_run": int(h.result.cycles_run),
            "speculative": bool(k.get("speculative")), "continuation": k.get("carry0") is not None,
            "device_ms": ev[0].elapsed_time(ev[1]), "launches": delta(before),
            "sync_sites": sites})
        return h

    def deferred(name):
        orig = getattr(pl.MultiCycleHandle, name)

        def fn(self, *a, **k):
            before = dict(kb.launch_counts)
            out = orig(self, *a, **k)
            for kk, v in delta(before).items():
                rep["deferred"][kk] = rep["deferred"].get(kk, 0) + v
            return out

        setattr(pl.MultiCycleHandle, name, fn)

    pl.ServingPipeline.dispatch_multi = dispatch_multi
    for name in ("dispatch_preemption", "dispatch_diagnosis"):
        deferred(name)

    def dump():
        rep["total"] = {k: v for k, v in kb.launch_counts.items() if v}
        with open(report, "w") as f:
            json.dump(rep, f)

    atexit.register(dump)
    sys.argv = ["k8s_scheduler_tpu_torch", *cli_args]
    runpy.run_module("k8s_scheduler_tpu_torch", run_name="__main__", alter_sys=True)
    return 0


def cli_objects():
    """Phase 14's workload: slice 1's cluster (5000 nodes, 12000 running
    pods) and CLI_GROUPS arrival groups of its pending mix, the gang's
    members spliced into groups 1 and 2. Returns (nodes, existing, groups,
    pod_group)."""
    from k8s_scheduler_tpu_torch.models.api import PodGroup
    from k8s_scheduler_tpu_torch.utils import synth

    nodes, existing, pend = synth.config4_cluster_config2_pending(
        (CLI_SEED,), N_NODES, N_EXISTING, sum(CLI_GROUPS))
    pods = pend[CLI_SEED]
    groups, i = [], 0
    for n in CLI_GROUPS:
        groups.append(pods[i:i + n])
        i += n
    gang, pgs = synth.make_gang_pods(1, replicas=8, seed=CLI_SEED)
    groups[1] = gang[:CLI_GANG_SPLIT] + groups[1]
    groups[2] = gang[CLI_GANG_SPLIT:] + groups[2]
    return nodes, existing, groups, PodGroup(pgs[0].name, CLI_GANG_MIN)


def cli_bindings_valid(nodes, existing, binds, pods_by_uid, group) -> list:
    """Every binding in stream order against the oracle's per-node state:
    capacity (every resource and the pod count), node selectors and
    affinity, taints, unschedulable nodes; and the gang whole or dropped.
    Returns the violations."""
    from k8s_scheduler_tpu_torch import oracle

    st = oracle.OracleState.build(nodes, existing)
    index = {nd.name: i for i, nd in enumerate(nodes)}
    bad = []
    for uid, node in binds:
        pod, i = pods_by_uid[uid], index[node]
        for f in (oracle.filter_node_resources_fit, oracle.filter_node_unschedulable,
                  oracle.filter_node_affinity, oracle.filter_taint_toleration,
                  oracle.filter_node_name):
            if not f(pod, st, i):
                bad.append(f"{uid} -> {node}: {f.__name__}")
        st.add(i, pod)
    members = [u for u, _n in binds if pods_by_uid[u].spec.pod_group == group.name]
    if members and len(members) < group.min_member:
        bad.append(f"gang {group.name}: {len(members)} members bound < {group.min_member}")
    return bad


def cli_twin(torch, dev, nodes, existing, groups, group):
    """The in-process forced_sync twin: a K = 1 `Scheduler` fed the events
    the CLI children get (bound pods, the gang's group, one arrival group a
    cycle, each bind confirmed as the agent confirms it, two idle cycles).
    Returns the bind stream."""
    import copy

    from k8s_scheduler_tpu_torch.config import SchedulerConfiguration
    from k8s_scheduler_tpu_torch.core import Scheduler

    binds: list = []
    sch = Scheduler(SchedulerConfiguration(forced_sync=True, multi_cycle_max_wait_ms=1e9),
                    binder=lambda p, n: binds.append((p, n)), device=dev)
    for nd in nodes:
        sch.on_node_add(nd)
    for pod, node in existing:
        sch.on_pod_add(pod, node)
    sch.add_pod_group(group)
    out = []
    for g in groups + [[], []]:
        for p in copy.deepcopy(g):
            sch.on_pod_add(p)
        sch.schedule_cycle()
        for p, n in binds:
            sch.on_pod_update(p, n)
        out += [(p.uid, n) for p, n in binds]
        binds.clear()
    del sch
    torch.cuda.empty_cache()
    return out


def cli_run(variant: str, k: int, spec: int, nodes, existing, groups, group, tmp: str) -> dict:
    """One CLI child: started, fed over gRPC by the port's `SchedulerAgent`,
    probed over HTTP, SIGTERMed. Returns its binds, RPC times, report and
    the checks' readings."""
    import signal
    import subprocess
    import urllib.request

    from k8s_scheduler_tpu_torch.service.client import SchedulerAgent, SchedulerClient

    sd = os.path.join(tmp, variant)
    os.makedirs(sd, exist_ok=True)
    report = os.path.join(sd, "report.json")
    logf = os.path.join(sd, "child.log")
    args = ["--address", "127.0.0.1:0", "--http-port", "0", "--state-dir",
            os.path.join(sd, "state"), "--compile-cache-dir", "off",
            "--snapshot-interval", "0", "--multi-cycle-k", str(k),
            "--multi-cycle-max-wait-ms", "1e9", "--speculative-dispatch", str(spec)]
    t0 = time.time()
    with open(logf, "w") as lf:
        child = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--cli-child",
                                  report, "--", *args], stdout=lf, stderr=subprocess.STDOUT)
    ports: dict = {}
    try:
        while time.time() - t0 < CLI_SERVE_WAIT_S and child.poll() is None:
            text = open(logf).read()
            for key, pat in (("grpc", r"listening on port (\d+)"),
                             ("http", r"serving /healthz /metrics on port (\d+)")):
                hit = re.search(pat, text)
                if hit:
                    ports[key] = int(hit.group(1))
            if "http" in ports:
                break
            time.sleep(0.05)
        ready_s = time.time() - t0
        check("http" in ports, f"cli {variant}: the child did not serve in "
              f"{CLI_SERVE_WAIT_S:.0f} s:\n{open(logf).read()[-3000:]}")
        client = SchedulerClient(f"127.0.0.1:{ports['grpc']}")
        rpc = {"update": [], "cycle": []}
        for name in ("update", "cycle"):
            fn = getattr(client, name)

            def timed(*a, _fn=fn, _name=name, **kw):
                t = time.perf_counter()
                out = _fn(*a, **kw)
                rpc[_name].append((time.perf_counter() - t) * 1e3)
                return out

            setattr(client, name, timed)
        binds: list = []
        agent = SchedulerAgent(client, lambda uid, name, ns, node: binds.append((uid, node)))
        t_feed = time.time()
        for i in range(0, len(nodes), 1000):
            with agent.batched():
                for nd in nodes[i:i + 1000]:
                    agent.upsert_node(nd)
        for i in range(0, len(existing), 2000):
            with agent.batched():
                for pod, node in existing[i:i + 2000]:
                    agent.upsert_pod(pod, node)
        agent.add_pod_group(group)
        feed_s = time.time() - t_feed
        n_feed = len(rpc["update"])
        per_cycle = []
        for g in list(groups) + [[], []]:
            if g:
                with agent.batched():
                    for p in g:
                        agent.upsert_pod(p)
            nb = len(binds)
            agent.run_cycle()
            per_cycle.append(len(binds) - nb)
        bodies = {}
        for route in ("/healthz", "/metrics"):
            with urllib.request.urlopen(f"http://127.0.0.1:{ports['http']}{route}",
                                        timeout=30) as r:
                check(r.status == 200, f"cli {variant}: {route} answered {r.status}")
                bodies[route] = r.read().decode()
        client.close()
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    text = open(logf).read()
    check(rc == 0, f"cli {variant}: the child exited {rc} on SIGTERM:\n{text[-3000:]}")
    bb = os.path.join(sd, "state", "blackbox")
    bundles = sorted(n for n in os.listdir(bb) if "sigterm" in n) if os.path.isdir(bb) else []
    check(bundles and "black box dumped" in text,
          f"cli {variant}: no black-box bundle at SIGTERM:\n{text[-3000:]}")
    with open(report) as f:
        rep = json.load(f)
    metrics = bodies["/metrics"]
    fams = {ln.split("{")[0].split(" ")[0] for ln in metrics.splitlines()
            if ln and not ln.startswith("#")}
    spec_led = {o: sum(float(ln.rsplit(" ", 1)[1]) for ln in metrics.splitlines()
                       if ln.startswith("scheduler_speculation_total{")
                       and f'outcome="{o}"' in ln)
                for o in ("adopted", "abandoned", "redispatched")}
    return {"binds": binds, "per_cycle": per_cycle, "ready_s": ready_s, "feed_s": feed_s,
            "rpc": rpc, "n_feed_updates": n_feed, "report": rep, "fams": fams,
            "speculation": spec_led, "healthz": json.loads(bodies["/healthz"]),
            "bundles": bundles}


def cli_phase(torch, kb, dev, smi) -> dict:
    """Phase 14 (module docstring). Returns the launches of the children's
    multi-cycle batches and their deferred programs, and the readings."""
    import tempfile

    t_phase = time.time()
    nodes, existing, groups, group = cli_objects()
    pods_by_uid = {p.uid: p for g in groups for p in g}
    t0 = time.time()
    twin = cli_twin(torch, dev, nodes, existing, groups, group)
    log(f"phase cli: the in-process forced_sync twin (K = 1) served {len(CLI_GROUPS)} groups "
        f"({sum(CLI_GROUPS)} pods + the gang's 8) in {time.time() - t0:.1f} s: "
        f"{len(twin)} binds")
    bad = cli_bindings_valid(nodes, existing, twin, pods_by_uid, group)
    check(not bad, f"cli: invalid bindings in the twin's stream: {bad[:5]}")
    runs = {}
    with tempfile.TemporaryDirectory(prefix="cli-", dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        for variant, k, spec in CLI_VARIANTS:
            r = cli_run(variant, k, spec, nodes, existing, groups, group, tmp)
            runs[variant] = r
            rep = r["report"]
            batches = rep["batches"]
            cyc = [b["cycles_run"] for b in batches]
            inner = [round(b["device_ms"] / max(b["cycles_run"], 1), 2) for b in batches]
            loop_launch: dict = {}
            for b in batches:
                for kk, v in b["launches"].items():
                    loop_launch[kk] = loop_launch.get(kk, 0) + v
            r["loop_launches"] = loop_launch
            upd, cy_ms = r["rpc"]["update"], r["rpc"]["cycle"]
            log(f"phase cli {variant}: python -m k8s_scheduler_tpu_torch --multi-cycle-k {k} "
                f"--speculative-dispatch {spec}: serving {r['ready_s']:.1f} s after start; "
                f"feed {r['feed_s']:.1f} s ({r['n_feed_updates']} Update RPCs); gRPC Update "
                f"ms p50 / p99 {pct(upd, 0.5):.1f} / {pct(upd, 0.99):.1f} over {len(upd)}, "
                f"Cycle ms p50 / p99 {pct(cy_ms, 0.5):.1f} / {pct(cy_ms, 0.99):.1f} over "
                f"{len(cy_ms)} (each Cycle RPC one schedule_cycle: ms "
                f"{[round(x, 1) for x in cy_ms]}); binds per Cycle {r['per_cycle']}; "
                f"batches (inner cycles run) {cyc}, device ms an inner cycle {inner}, "
                f"speculative {[b['speculative'] for b in batches]}; speculation ledger "
                f"{json.dumps(r['speculation'])}; the batches' launches "
                f"{json.dumps(loop_launch)}, their deferred programs' "
                f"{json.dumps(rep['deferred'])}; /healthz ok {r['healthz'].get('ok')}; "
                f"bundle {r['bundles'][-1]} | {smi}")
            check(r["binds"] == twin, f"cli {variant}: the bind stream differs from the "
                  f"forced_sync twin's ({len(r['binds'])} / {len(twin)} binds)")
            check(r["healthz"].get("ok") is True, f"cli {variant}: /healthz not ok")
            for fam in ("scheduler_multicycle_batch_cycles_count",
                        "scheduler_multicycle_inner_cycles_total",
                        "scheduler_schedule_attempts_total"):
                check(fam in r["fams"], f"cli {variant}: /metrics lacks {fam}")
            # the loop's own code adds no host sync (the cycle body's known
            # sites are phase 10's), nor the serving layer
            loop = rep["loop_lines"]
            for b in batches:
                own = {s: n for s, n in b["sync_sites"].items()
                       if s.split(":")[0] in ("pipeline.py", "scheduler.py")
                       or (s.split(":")[0] == "cycle.py"
                           and loop[0] <= int(s.split(":")[1]) < loop[1])}
                check(not own, f"cli {variant}: host syncs in the batch loop or the serving "
                      f"layer: {own}")
            if k > 1:
                check(any(c > 1 for c in cyc), f"cli {variant}: no batch ran more than one "
                      f"inner cycle ({cyc})")
                for kk in ("static_base", "claim_pass", "capacity", "guard_sweep",
                           "dyn_mask", "dyn_score"):
                    check(loop_launch.get(kk, 0) > 0, f"cli {variant}: the batch loop "
                          f"launched no {kk}")
            if spec:
                check(r["speculation"]["adopted"] > 0,
                      f"cli {variant}: no speculative batch adopted ({r['speculation']})")
        sites = sorted({s for r in runs.values() for b in r["report"]["batches"]
                        for s in b["sync_sites"]})
        log(f"phase cli: host-sync sites inside the batches' dispatch (set_sync_debug_mode"
            f"('warn')): {json.dumps(sites)}; none in the loop's lines "
            f"(core/cycle.py:{runs['k4']['report']['loop_lines']}) or the serving layer")
    totals: dict = {}
    for r in runs.values():
        for kk, v in list(r["loop_launches"].items()) + list(r["report"]["deferred"].items()):
            totals[kk] = totals.get(kk, 0) + v
    log(f"phase cli: the three children's bind streams equal each other and the twin's "
        f"({len(twin)} binds, every binding valid, the gang whole); multi-cycle launches "
        f"(batches and their deferred programs) {json.dumps(totals)}; the phase took "
        f"{time.time() - t_phase:.1f} s | {smi}")
    return {"launches": totals, "binds": len(twin)}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    ap.add_argument("--prev-csrc", default=None,
                    help="a directory holding an earlier design's sources of "
                         "PREV_KERNELS: timed beside the kernels on the same inputs, "
                         "as prev_device_ms")
    ap.add_argument("--durable-child", default=None, metavar="DIR",
                    help="internal: phase 12's active in a process of its own, journaling "
                         "into DIR until the parent SIGKILLs it")
    ap.add_argument("--compile-child", default=None, metavar="DIR",
                    help="internal: phase 13's process with the persistent kernel cache "
                         "at DIR")
    ap.add_argument("--compile-role", default="cold", choices=("cold", "warm"),
                    help="internal: which of phase 13's two processes")
    argv = sys.argv[1:] if argv is None else list(argv)
    cli_args = None
    if "--cli-child" in argv and "--" in argv:
        # phase 14's CLI child: everything after "--" is the CLI's own
        cut = argv.index("--")
        argv, cli_args = argv[:cut], argv[cut + 1:]
    ap.add_argument("--cli-child", default=None, metavar="REPORT",
                    help="internal: phase 14's `python -m k8s_scheduler_tpu_torch` child, "
                         "its batch launch counts written to REPORT at exit (CLI arguments "
                         "after --)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.cli_child:
        return cli_child(args.cli_child, cli_args or [])
    if args.durable_child:
        return durable_child(args.durable_child)
    if args.compile_child:
        return compile_child(args.compile_child, args.compile_role)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import k8s_scheduler_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}", file=sys.stderr)
        return 3
    from k8s_scheduler_tpu_torch.core.cycle import build_cycle_fn, sampling_window
    from k8s_scheduler_tpu_torch.framework.interfaces import AffinityKernels, CycleContext
    from k8s_scheduler_tpu_torch.kernel_variants import (affinity_update_with, device_ms,
                                                         guard_sweep_with)
    from k8s_scheduler_tpu_torch.framework.runtime import Framework
    from k8s_scheduler_tpu_torch.models import SnapshotEncoder
    from k8s_scheduler_tpu_torch.models import encoding as enc_mod
    from k8s_scheduler_tpu_torch.ops import affinity_update as au
    from k8s_scheduler_tpu_torch.ops import capacity as cap
    from k8s_scheduler_tpu_torch.ops import claim_pass as cp
    from k8s_scheduler_tpu_torch.ops import dyn_round as dr
    from k8s_scheduler_tpu_torch.ops import guard_sweep as gs
    from k8s_scheduler_tpu_torch.ops import interpod as ip
    from k8s_scheduler_tpu_torch.ops import interpod_terms as ipt
    from k8s_scheduler_tpu_torch.ops import kernel_build as kb
    from k8s_scheduler_tpu_torch.ops import static_base as sb
    from k8s_scheduler_tpu_torch.utils import synth

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    dev = torch.device("cuda")
    plain_kernels = AffinityKernels.plain()

    # ---- 1. device ----
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"phase device: {name} x{torch.cuda.device_count()} | nvidia-smi: {smi} "
        f"| torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"phase device, the gRPC shim's packages: {grpc_fact()}")

    # ---- 2. build: one nvcc per CUDA source, all at once, while Triton
    # compiles K2 ----
    build_err: list[BaseException] = []
    build_s: dict[str, float] = {}

    def build(src):
        t0 = time.time()
        try:
            kb.load_cuda_library(src)
        except BaseException as e:  # re-raised on the main thread below
            build_err.append(e)
        build_s[src] = round(time.time() - t0, 2)

    prev_libs: dict = {}

    def build_prev(src):
        t0 = time.time()
        try:
            path = kb.build_cuda_library(src, Path(args.prev_csrc).resolve() / f"{src}.cu")
            prev_libs[src] = ctypes.CDLL(str(path))
        except BaseException as e:  # re-raised on the main thread below
            build_err.append(e)
        build_s[f"{src} (earlier design)"] = round(time.time() - t0, 2)

    threads = [threading.Thread(target=build, args=(s,)) for s in kb.CUDA_KERNELS]
    if args.prev_csrc:
        threads += [threading.Thread(target=build_prev, args=(s,)) for s in PREV_KERNELS]
    for th in threads:
        th.start()
    t0 = time.time()
    z = torch.zeros((2, 8), device=dev)
    zb = torch.zeros((2, 8), dtype=torch.bool, device=dev)
    cp.claim_pass_triton(z, ~zb, zb, zb[:, 0], None,
                         torch.zeros(2, dtype=torch.int32, device=dev),
                         torch.full((2,), -1, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    build_s["claim_pass (triton)"] = round(time.time() - t0, 2)
    for th in threads:
        th.join()
    if build_err:
        raise build_err[0]
    log(f"phase build (s): {json.dumps(build_s)}")
    for src, text in kb.build_logs.items():
        usage = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"  ptxas {src}: " + " | ".join(usage))
    edge = capacity_edge_checks(torch, cap, dev)
    log(f"phase kernel capacity, seeded edge cases: equal to capacity_plain bit for bit "
        f"on {len(edge)} cases: {json.dumps(edge)}")
    edge = static_base_edge_checks(torch, sb, dev)
    log(f"phase kernel static_base, seeded edge cases: mask equal, max|err| 0.0 on "
        f"{len(edge)} cases: {json.dumps(edge)}")
    shapes = claim_edge_checks(torch, dev)
    log(f"phase kernel preempt_claim, seeded edge cases: equal to claim_loop_plain bit "
        f"for bit on {len(shapes)} cases; launch shapes {json.dumps(shapes)}")
    edge = affinity_update_edge_checks(torch, dev)
    log(f"phase kernel affinity_update, seeded edge cases: equal to affinity_update_plain "
        f"on {len(edge)} cases (each twice): {json.dumps(edge)}")
    shapes = scan_edge_checks(torch, dev)
    log(f"phase kernel scan_commit, seeded edge cases: equal to scan_commit_plain on "
        f"{len(shapes)} cases; [cluster, slice] {json.dumps(shapes)}")
    edge = guard_edge_checks(torch, dev)
    log(f"phase kernel guard_sweep, seeded edge cases: equal to guard_sweep_plain on "
        f"{len(edge)} cases (each twice): {json.dumps(edge)}")
    shapes = fold_edge_checks(torch, dev)
    log(f"phase kernel pv_fold, seeded edge cases: equal to pv_fold_plain on "
        f"{len(shapes)} cases, on 16 and 8 CTAs (clusters launched): {json.dumps(shapes)}")
    edge = pv_choice_edge_checks(torch, dev)
    log(f"phase kernel pv_choice, seeded edge cases: equal to pv_choice_plain on {len(edge)} "
        f"cases: {json.dumps(edge)}")
    shapes = whatif_edge_checks(torch, dev)
    log(f"phase kernel preempt_whatif, seeded edge cases: equal to nonresource_ok_plain on "
        f"{len(shapes)} cases; [C2, N, MPN+1] {json.dumps(shapes)}")
    shapes = prefilter_edge_checks(torch, dev)
    log(f"phase kernel preempt_prefilter, seeded edge cases: equal to prefilter_plain on "
        f"{len(shapes)} cases; [C, N, MPN, R], grid, node tables, feasible "
        f"{json.dumps(shapes)}")
    shapes = dyn_edge_checks(torch, dev)
    log(f"phase kernel dyn_mask + dyn_score, seeded edge cases: equal to dyn_mask_plain and "
        f"dyn_score_plain bit for bit (and the score anchor) on {len(shapes)} cases; [B, N] "
        f"{json.dumps(shapes)}")
    shapes = reject_edge_checks(torch, dev)
    log(f"phase kernel static_rejects + dyn_rejects, seeded edge cases: equal to "
        f"static_rejects_plain and dyn_rejects_plain bit for bit on {len(shapes)} cases; "
        f"[rows, F, counted] {json.dumps(shapes)}")
    shapes = scan_full_edge_checks(torch, dev)
    log(f"phase kernel scan_commit full mode, seeded edge cases: the seven outputs and the "
        f"per-step rejects equal to scan_commit_plain's on {len(shapes)} cases; rejects "
        f"counted {json.dumps(shapes)}")

    fw = Framework.from_config()
    cycle_k = build_cycle_fn(commit_mode="rounds", outputs="latency", device=dev)
    kernels: dict[str, dict] = {}

    # ================= slice 1: config #2's pending mix =================
    t0 = time.time()
    nodes, existing, pending = synth.config4_cluster_config2_pending(
        (WARM_SEED,) + TIMED_SEEDS, N_NODES, N_EXISTING, N_PENDING)
    gen_s = time.time() - t0
    enc = SnapshotEncoder(device=dev)
    snaps, encode_ms = encode_all(torch, enc, nodes, existing, pending)
    snap0 = snaps[WARM_SEED]
    P, N = snap0.P, snap0.N
    log(f"phase slice1 data: {N_NODES} nodes, {N_EXISTING} running, {N_PENDING} "
        f"pending -> padded P={P} N={N}; generate {gen_s:.1f}s; encode ms "
        + json.dumps(encode_ms))

    rec_cp = Recorder(cp.claim_pass_plain, keep=(0, 3))  # round 0, passes 0, 3
    rec_dyn = dyn_recorders(dr)  # every K14 / K15 call
    cycle_p = build_cycle_fn(commit_mode="rounds", outputs="latency", device=dev,
                             static_base_fn=sb.static_base_plain,
                             claim_pass_fn=rec_cp, dyn_mask_fn=rec_dyn[0],
                             dyn_score_fn=rec_dyn[1])
    t0 = time.time()
    dk = cycle_k(snap0)
    torch.cuda.synchronize()
    warm_ms = (time.time() - t0) * 1e3
    t0 = time.time()
    dp = cycle_p(snap0)
    torch.cuda.synchronize()
    plain_cycle_ms = (time.time() - t0) * 1e3
    same = same_decisions(torch, dk, dp)
    log(f"phase slice1 e2e-parity: kernels cycle {warm_ms:.1f} ms (warm-up), plain "
        f"cycle {plain_cycle_ms:.1f} ms, placed {int((dk.assignment >= 0).sum())}"
        f"; kernels == plain: {json.dumps(same)}")
    check(all(same.values()), "slice-1 kernel cycle differs from the plain-versions cycle")
    n_dyn = dyn_calls_equal(torch, dr, rec_dyn, "slice-1 cycle")
    log(f"phase slice1 kernels dyn_mask + dyn_score: equal to their plain versions bit for "
        f"bit on every call of the cycle ({n_dyn[0]} mask calls, {n_dyn[1]} score calls, "
        f"{n_dyn[2]} of them score anchors)")
    del rec_dyn

    ctx = CycleContext(snap0)
    x = sb.static_base_inputs(fw, ctx, fit=True, sampling=sampling_window(snap0, 0))
    mask_equal, k1_err = compare_static_base(torch, sb, x)
    k1_ms = time_ms(torch, lambda: sb.static_base_cuda(x), 20)
    k1_dev = device_ms(lambda: sb.static_base_cuda(x), 10)
    k1_prev = prev_ms(torch, kb, prev_libs, "static_base", lambda: sb.static_base_cuda(x), 10,
                      timer=device_ms)
    k1_fill_ms = time_ms(torch, lambda: torch.empty((P, N), device=dev).fill_(sb.NEG_INF),
                         20)
    k1_plain_ms = time_ms(torch, lambda: sb.static_base_plain(x), 3)
    k1_bytes = P * N * 4 + nbytes(*[v for v in vars(x).values()
                                    if isinstance(v, torch.Tensor)])
    k1_ops = P * N * (2 * len(x.terms) + 2)
    log(f"phase kernel static_base: [{P}, {N}] mask equal {mask_equal}, "
        f"max|err| {k1_err}; kernel {k1_ms:.3f} ms ({k1_dev:.4f} ms device; the "
        f"earlier source {k1_prev}), "
        f"torch.empty(P, N).fill_(-1e9) {k1_fill_ms:.3f} ms, plain {k1_plain_ms:.3f} ms, "
        f"bound {bound(k1_bytes, k1_ops)[0]:.3f} ms (bytes {k1_bytes})")

    check(set(rec_cp.args) == {0, 3}, "claim-pass states were not recorded")
    k2_err = 0.0
    for i in (0, 3):
        args = rec_cp.args[i]
        bk, hk = cp.claim_pass_triton(*args)
        bp, hp = cp.claim_pass_plain(*args)
        equal = torch.equal(bk, bp) and torch.equal(hk, hp)
        k2_err = max(k2_err, float((bk - bp).abs().max()))
        log(f"phase kernel claim_pass pass {i}: best/has equal {equal} "
            f"(acc {int(args[3].sum())}, dead {int(args[2].sum())})")
        check(equal, f"claim_pass differs from its plain version at pass {i}")
    args0 = rec_cp.args[0]
    base, mask, dead, acc, delta, gid, nominated = args0
    B = base.shape[0]
    k2_ms = time_ms(torch, lambda: cp.claim_pass_triton(*args0), 20)
    k2_dev = device_ms(lambda: cp.claim_pass_triton(*args0), 20)
    k2_plain_ms = time_ms(torch, lambda: cp.claim_pass_plain(*args0), 5)
    avail = mask & ~dead & ~acc[:, None]
    eff = torch.where(avail, torch.round(base) + cp.tie_break(gid, N), cp.NEG_INF)
    k2_lib_ms = time_ms(torch, lambda: torch.argmax(eff, dim=1), 20)
    del avail, eff
    k2_bytes = nbytes(base, mask, dead, acc, gid, nominated) + B * (4 + 1)
    k2_ops = B * N * 8
    log(f"phase kernel claim_pass: [{B}, {N}] kernel {k2_ms:.3f} ms ({k2_dev:.4f} ms "
        f"device), plain "
        f"{k2_plain_ms:.3f} ms, torch.argmax yardstick {k2_lib_ms:.3f} ms, "
        f"bound {bound(k2_bytes, k2_ops)[0]:.3f} ms (bytes {k2_bytes})")
    del rec_cp, args0, args, base, mask, dead, x, dk, dp

    # the slice-1 main path: counts set to 0 just before, read just after
    results, launches1 = timed_cycles(torch, kb, cycle_k, snaps, TIMED_SEEDS)
    log(f"phase slice1 launches over {len(TIMED_SEEDS)} cycles: {json.dumps(launches1)}")
    for k in ("static_base", "claim_pass", "capacity", "dyn_mask", "dyn_score"):
        check(launches1[k] > 0, f"kernel {k} was not launched on the slice-1 path")
    timed1 = []
    for s, d, dev_ms, host_ms in results:
        check_placements(torch, snaps[s], d, fw, plain_kernels)
        timed1.append(round(dev_ms, 1))
        log(f"phase slice1 cycle seed {s}: device {dev_ms:.1f} ms, host {host_ms:.1f} ms, "
            f"placed {int((d.assignment >= 0).sum())}, unschedulable "
            f"{int(d.unschedulable.sum())}, valid: capacity, static masks, "
            f"unplaced infeasible")
    kernels["static_base"] = kernel_entry(
        "static_base", "cuda", "k8s_scheduler_tpu_torch/csrc/static_base.cu",
        "k8s_scheduler_tpu/ops/rounds.py:338", launches1["static_base"], k1_err,
        k1_ms, k1_dev, k1_plain_ms, k1_bytes, k1_ops, fill_ms=k1_fill_ms,
        prev_device_ms=k1_prev)
    kernels["claim_pass"] = kernel_entry(
        "claim_pass", "triton", "k8s_scheduler_tpu_torch/ops/claim_pass.py",
        "k8s_scheduler_tpu/ops/rounds.py:805", launches1["claim_pass"], k2_err,
        k2_ms, k2_dev, k2_plain_ms, k2_bytes, k2_ops, k2_lib_ms)
    slice1_case = (snaps[results[0][0]], results[0][1])  # for the preemption phase
    del results, snaps, snap0, ctx

    # ============ affinity: config #4's workload (minus preemption) ============
    t0 = time.time()
    nodes, existing, pending = synth.config4_workload(
        (AFF_WARM_SEED,) + AFF_TIMED_SEEDS, N_NODES, N_EXISTING, N_PENDING)
    gen_s = time.time() - t0
    snaps, encode_ms = encode_all(torch, SnapshotEncoder(device=dev), nodes,
                                  existing, pending)
    snap0 = snaps[AFF_WARM_SEED]
    P, N = snap0.P, snap0.N
    check(snap0.has_inter_pod_affinity and snap0.has_topology_spread,
          "config #4's workload carries no affinity/spread")
    S, D = snap0.sel_exprs.shape[0], snap0.domain_key.shape[0]
    log(f"phase affinity data: {N_NODES} nodes, {N_EXISTING} running, {N_PENDING} "
        f"pending (config #4 mix) -> padded P={P} N={N}, S={S} selectors, D={D} "
        f"domains, K={snap0.node_domains.shape[1]}, MA={snap0.pod_aff_terms.shape[1]}, "
        f"MC={snap0.pod_tsc.shape[1]}; generate {gen_s:.1f}s; encode ms "
        + json.dumps(encode_ms))

    rec = {
        "interpod_terms": Recorder(ipt.interpod_terms_plain),
        "interpod_norm": Recorder(ipt.interpod_norm_plain, keep=(0, 1)),
        "affinity_update": Recorder(au.affinity_update_plain, keep=None),  # every round
        "capacity": Recorder(cap.capacity_plain, keep=None),  # every pass and fold
        "guard_sweep": Recorder(gs.guard_sweep_plain, keep=None),  # every round
    }
    rec_dyn = dyn_recorders(dr)  # every K14 / K15 call
    cycle_ap = build_cycle_fn(
        commit_mode="rounds", outputs="latency", device=dev,
        static_base_fn=sb.static_base_plain,
        claim_pass_fn=cp.claim_pass_plain,
        interpod_terms_fn=rec["interpod_terms"], interpod_norm_fn=rec["interpod_norm"],
        affinity_update_fn=rec["affinity_update"], capacity_fn=rec["capacity"],
        guard_sweep_fn=rec["guard_sweep"], dyn_mask_fn=rec_dyn[0], dyn_score_fn=rec_dyn[1])
    t0 = time.time()
    dk = cycle_k(snap0)
    torch.cuda.synchronize()
    warm_ms = (time.time() - t0) * 1e3
    t0 = time.time()
    dp = cycle_ap(snap0)
    torch.cuda.synchronize()
    plain_cycle_ms = (time.time() - t0) * 1e3
    same = same_decisions(torch, dk, dp)
    log(f"phase affinity e2e-parity: kernels cycle {warm_ms:.1f} ms (warm-up), plain "
        f"cycle {plain_cycle_ms:.1f} ms, placed {int((dk.assignment >= 0).sum())}, "
        f"rounds {int(dk.placed_round.max()) + 1}; kernels == plain: {json.dumps(same)}")
    check(all(same.values()), "affinity kernel cycle differs from the plain-versions cycle")
    decisions = {AFF_WARM_SEED: dk}
    del dp

    # ---- K14 / K15: every call of the cycle, timed on round 0's ----
    gen_ports = torch.Generator(device=dev).manual_seed(11)
    n_dyn = dyn_calls_equal(torch, dr, rec_dyn, "affinity cycle")
    m_args = rec_dyn[0].args[0]
    s_calls = rec_dyn[1].args
    s_args = next(a for _, a in sorted(s_calls.items()) if a[0] is not None)
    anchors = [a for _, a in sorted(s_calls.items()) if a[0] is None]
    k14_ms = time_ms(torch, lambda: dr.dyn_mask_cuda(*m_args), 20)
    k14_dev = device_ms(lambda: dr.dyn_mask_cuda(*m_args), 10)
    k14_plain = time_ms(torch, lambda: dr.dyn_mask_plain(*m_args), 3)
    k15_ms = time_ms(torch, lambda: dr.dyn_score_cuda(*s_args), 20)
    k15_dev = device_ms(lambda: dr.dyn_score_cuda(*s_args), 10)
    k15_plain = time_ms(torch, lambda: dr.dyn_score_plain(*s_args), 3)
    k14_prev = prev_ms(torch, kb, prev_libs, "dyn_round", lambda: dr.dyn_mask_cuda(*m_args),
                       10, timer=device_ms)
    k15_prev = prev_ms(torch, kb, prev_libs, "dyn_round", lambda: dr.dyn_score_cuda(*s_args),
                       10, timer=device_ms)
    k15a_dev = device_ms(lambda: dr.dyn_score_cuda(*anchors[0]), 50)
    k15a_plain = time_ms(torch, lambda: dr.dyn_score_plain(*anchors[0]), 20)
    k14_bytes, k14_ops, k15_bytes, k15_ops = dyn_bytes(torch, dr, m_args, s_args)
    # the bounds beyond round 0: K14's mean over every mask call of the
    # cycle, K15's over the later rounds' score calls (the anchors apart)
    m_calls = [a for _, a in sorted(rec_dyn[0].args.items())]
    s_later = [a for _, a in sorted(s_calls.items()) if a[0] is not None][1:]
    k14_mean_bound = sum(bound(*dyn_bytes(torch, dr, m, s_args)[:2])[0]
                         for m in m_calls) / len(m_calls)
    k15_later_bound = sum(bound(*dyn_bytes(torch, dr, m_args, c)[2:])[0]
                          for c in s_later) / max(len(s_later), 1)
    peak_k = dyn_peak_mib(torch, dr.dyn_mask_cuda, dr.dyn_score_cuda, m_args, s_args)
    peak_p = dyn_peak_mib(torch, dr.dyn_mask_plain, dr.dyn_score_plain, m_args, s_args)
    B14, N14 = m_args[0].shape
    log(f"phase kernel dyn_mask + dyn_score: equal to their plain versions bit for bit on "
        f"every call of the cycle ({n_dyn[0]} mask calls, {n_dyn[1]} score calls, {n_dyn[2]} "
        f"of them score anchors); round 0 [{B14}, {N14}], {len(m_args[1])} mask parts, "
        f"{len(s_args[1])} score terms (the earlier source, device: {k14_prev}, {k15_prev}): "
        f"dyn_mask {k14_ms:.3f} ms ({k14_dev:.4f} ms device), "
        f"plain {k14_plain:.3f} ms, bound {bound(k14_bytes, k14_ops)[0]:.4f} ms (bytes "
        f"{k14_bytes}); dyn_score {k15_ms:.3f} ms ({k15_dev:.4f} ms device), plain "
        f"{k15_plain:.3f} ms, bound {bound(k15_bytes, k15_ops)[0]:.4f} ms (bytes {k15_bytes}); "
        f"bounds beyond round 0: dyn_mask's mean over the cycle's {len(m_calls)} calls "
        f"{k14_mean_bound:.4f} ms, dyn_score's over {len(s_later)} later rounds "
        f"{k15_later_bound:.4f} ms; "
        f"score anchor [1, {N14}] {k15a_dev:.4f} ms device, plain {k15a_plain:.3f} ms; "
        f"round-0 peak memory of the two stages: kernels {peak_k:.1f} MiB, plain versions "
        f"{peak_p:.1f} MiB")
    del rec_dyn, m_args, s_args, s_calls, anchors
    log(f"phase affinity round 0 without a host sync (set_sync_debug_mode('error'): "
        f"NodePorts' fold, one dyn_batched, then rounds_commit(max_rounds=1)), on a variant "
        f"whose pods name host ports: "
        f"{round_without_sync(torch, fw, ports_variant(torch, snap0, gen_ports))}")
    # resource scores averaged over three resources (a weight sum whose
    # reciprocal is inexact): the kernels' cycle against the plain versions'
    fw3 = Framework.from_config(resource_profile(RESOURCES_3))
    d3k = build_cycle_fn(fw3, commit_mode="rounds", outputs="latency", device=dev)(snap0)
    d3p = build_cycle_fn(
        fw3, commit_mode="rounds", outputs="latency", device=dev,
        static_base_fn=sb.static_base_plain,
        claim_pass_fn=cp.claim_pass_plain, interpod_terms_fn=ipt.interpod_terms_plain,
        interpod_norm_fn=ipt.interpod_norm_plain, affinity_update_fn=au.affinity_update_plain,
        capacity_fn=cap.capacity_plain, guard_sweep_fn=gs.guard_sweep_plain)(snap0)
    same3 = same_decisions(torch, d3k, d3p)
    log(f"phase affinity e2e-parity, resource scores over {', '.join(RESOURCES_3)}: placed "
        f"{int((d3k.assignment >= 0).sum())} (default profile "
        f"{int((dk.assignment >= 0).sum())}), {int((d3k.assignment != dk.assignment).sum())} "
        f"placements differ from the default profile's; kernels == plain: {json.dumps(same3)}")
    check(all(same3.values()), "the three-resource kernel cycle differs from the plain-versions "
          "cycle")
    # ... and the fit score over those three resources as the one dynamic
    # score: a bare product that the round's base add fuses (ROADMAP C3)
    fwf = Framework.from_config(fit_only_profile(RESOURCES_3))
    dfk = build_cycle_fn(fwf, commit_mode="rounds", outputs="latency", device=dev)(snap0)
    dfp = build_cycle_fn(
        fwf, commit_mode="rounds", outputs="latency", device=dev,
        static_base_fn=sb.static_base_plain,
        claim_pass_fn=cp.claim_pass_plain, interpod_terms_fn=ipt.interpod_terms_plain,
        interpod_norm_fn=ipt.interpod_norm_plain, affinity_update_fn=au.affinity_update_plain,
        capacity_fn=cap.capacity_plain, guard_sweep_fn=gs.guard_sweep_plain)(snap0)
    samef = same_decisions(torch, dfk, dfp)
    log(f"phase affinity e2e-parity, the fit score over {', '.join(RESOURCES_3)} as the one "
        f"dynamic score: placed {int((dfk.assignment >= 0).sum())}; kernels == plain: "
        f"{json.dumps(samef)}")
    check(all(samef.values()), "the fit-alone kernel cycle differs from the plain-versions "
          "cycle")
    del d3k, d3p, fw3, dfk, dfp, fwf
    # K1 on the affinity phase's snapshot
    xa = sb.static_base_inputs(fw, CycleContext(snap0), fit=True,
                               sampling=sampling_window(snap0, 0))
    _, k1a_err = compare_static_base(torch, sb, xa, "(affinity snapshot)")
    log(f"phase affinity kernel static_base: [{P}, {N}] mask equal True, max|err| {k1a_err}")
    del xa

    # ---- K3-K6 against their plain versions on round-0 inputs ----
    def equal_outputs(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        if isinstance(a, (tuple, list)):
            return all(equal_outputs(x, y) for x, y in zip(a, b))
        if a is None:
            return b is None
        fa, fb = vars(a), vars(b)
        return fa.keys() == fb.keys() and all(equal_outputs(fa[k], fb[k]) for k in fa)

    for k, r in rec.items():
        check(r.recorded(), f"{k}: inputs were not recorded ({sorted(r.args)})")

    # K3 terms (the wrapper: two symmetric matmuls + the kernel)
    t_args = rec["interpod_terms"].args[0]
    tsnap, tstate, tmp, tminc = t_args
    out_k, out_p = ipt.interpod_terms_cuda(*t_args), ipt.interpod_terms_plain(*t_args)
    k3_equal = equal_outputs(out_k, out_p)
    check(k3_equal, "interpod_terms differs from its plain version")
    k3_ms = time_ms(torch, lambda: ipt.interpod_terms_cuda(*t_args), 10)
    k3_dev = device_ms(lambda: ipt.interpod_terms_cuda(*t_args), 10)
    k3_plain_ms = time_ms(torch, lambda: ipt.interpod_terms_plain(*t_args), 2)
    k3_sym_ms = time_ms(torch, lambda: (ip.symmetric_anti(tstate, tmp),
                                        ip.symmetric_pref(tstate, tmp)), 10)
    B3 = tsnap.P
    n_match = int(tmp.sum())
    n_terms = int(((tsnap.pod_aff_terms[..., 0] >= 0).sum()
                   + (tsnap.pod_anti_terms[..., 0] >= 0).sum()
                   + (tsnap.pod_pref_aff[..., 0] >= 0).sum()
                   + (tsnap.pod_tsc[..., 0] >= 0).sum()))
    k3_bytes = (nbytes(tstate.counts, tstate.total, tstate.anti_presence,
                       tstate.pref_sym, tsnap.node_domains, tminc, tmp,
                       tsnap.pod_aff_terms, tsnap.pod_anti_terms, tsnap.pod_pref_aff,
                       tsnap.pod_pref_aff_w, tsnap.pod_tsc, tsnap.pod_tsc_skew)
                + nbytes(out_k.aff_mask, out_k.aff_raw, out_k.spread_mask, out_k.spread_raw))
    k3_ops = 2 * 2 * n_match * N + 3 * n_terms * N  # sparse symmetric sums + term tests
    log(f"phase kernel interpod_terms: [{B3}, {N}] equal {k3_equal}; wrapper "
        f"{k3_ms:.3f} ms ({k3_dev:.4f} ms device; before the fused symmetric sums: 7.680 ms, PERF.md kernel "
        f"table B5), the two symmetric matmuls it no longer runs {k3_sym_ms:.3f} ms, "
        f"plain {k3_plain_ms:.3f} ms, bound {bound(k3_bytes, k3_ops)[0]:.3f} ms "
        f"(bytes {k3_bytes}, ops {k3_ops}); {n_terms} pod terms, {n_match} matches "
        f"(at most {int(tmp.sum(dim=0).max())} a pod); raw-sum bound "
        f"{tsnap.pref_raw_bound:g} < 2^24")

    # config #4's workload has no preferred terms and no ScheduleAnyway
    # constraint: hold K3 (and K4 below) also on a seeded variant of the
    # same inputs that has both
    gen = torch.Generator(device=dev).manual_seed(7)
    vsnap = preferred_variant(torch, tsnap, gen)
    vstate = ip.AffinityState(
        tstate.counts, tstate.total,
        torch.rand(tstate.anti_presence.shape, generator=gen, device=dev) < 0.01,
        torch.randint(0, 4, tstate.pref_sym.shape, generator=gen, device=dev).float())
    # the random symmetric table is not the snapshot's: its largest column
    # sum joins the host-side bound
    vsnap = dataclasses.replace(vsnap, pref_raw_bound=vsnap.pref_raw_bound
                                + float(vstate.pref_sym.abs().sum(dim=0).max()))
    v_args = (vsnap, vstate, tmp, tminc)
    vk, vp = ipt.interpod_terms_cuda(*v_args), ipt.interpod_terms_plain(*v_args)
    check(equal_outputs(vk, vp), "interpod_terms differs from its plain version "
          "on the preferred/soft variant")
    vfeas = vk.aff_mask & vk.spread_mask
    for raw_v, spread in ((vk.aff_raw, False), (vk.spread_raw, True)):
        check(torch.equal(ipt.interpod_norm_cuda(raw_v, vfeas, spread),
                          ipt.interpod_norm_plain(raw_v, vfeas, spread)),
              f"interpod_norm (spread={spread}) differs on the preferred/soft variant")
    log(f"phase kernel interpod_terms + interpod_norm, preferred/soft variant: equal "
        f"True ({int((vsnap.pod_pref_aff[..., 0] >= 0).sum())} preferred terms, "
        f"{int(((vsnap.pod_tsc[..., 0] >= 0) & (vsnap.pod_tsc[..., 2] == enc_mod.WHEN_SCHEDULE_ANYWAY)).sum())} "
        f"soft constraints, "
        f"{int((vk.aff_raw != 0).sum())} nonzero raw scores)")
    del vstate, v_args, vk, vp, vfeas

    # K3 normalisation, both modes on their recorded inputs
    k3n = {}
    for i in (0, 1):
        raw, feas, spread = rec["interpod_norm"].args[i]
        ok_ = torch.equal(ipt.interpod_norm_cuda(raw, feas, spread),
                          ipt.interpod_norm_plain(raw, feas, spread))
        check(ok_, f"interpod_norm (spread={spread}) differs from its plain version")
        k3n[spread] = (raw, feas)
    raw, feas = k3n[False]
    k3n_ms = time_ms(torch, lambda: ipt.interpod_norm_cuda(raw, feas, False), 20)
    k3n_dev = device_ms(lambda: ipt.interpod_norm_cuda(raw, feas, False), 20)
    k3n_plain_ms = time_ms(torch, lambda: ipt.interpod_norm_plain(raw, feas, False), 5)
    # raw is read where feasible (the max) and in rows whose max is > 0
    # (the divide; other rows write 0 without reading it)
    live_rows = torch.where(feas, raw.abs(), 0.0).amax(dim=1) > 0
    n_raw = int(feas[~live_rows].sum()) + int(live_rows.sum()) * N
    k3n_bytes = nbytes(feas) + raw.numel() * 4 + n_raw * 4
    k3n_ops = int(feas.sum()) + int(live_rows.sum()) * N * 3
    log(f"phase kernel interpod_norm: [{raw.shape[0]}, {N}] equal True (both modes), "
        f"{int(live_rows.sum())} rows with a score; kernel {k3n_ms:.3f} ms ({k3n_dev:.4f} "
        f"ms device), plain {k3n_plain_ms:.3f} ms, bound "
        f"{bound(k3n_bytes, k3n_ops)[0]:.3f} ms")

    # K4 affinity update: every round of the cycle, timed on round 0's
    for i, a_ in sorted(rec["affinity_update"].args.items()):
        check(equal_outputs(au.affinity_update_cuda(*a_), au.affinity_update_plain(*a_)),
              f"affinity_update differs from its plain version (round {i})")
    n_k4 = len(rec["affinity_update"].args)
    u_args = rec["affinity_update"].args[0]
    usnap, ustate, ump, uacc, unode = u_args
    uk, up = au.affinity_update_cuda(*u_args), au.affinity_update_plain(*u_args)
    k4_equal = equal_outputs(uk, up)
    check(k4_equal, "affinity_update differs from its plain version")
    check(float(uk.pref_sym.abs().max()) < EXACT_F32, "pref_sym left the exact f32 range")
    vu_args = (preferred_variant(torch, usnap, gen), ustate, ump, uacc, unode)
    vuk = au.affinity_update_cuda(*vu_args)
    check(equal_outputs(vuk, au.affinity_update_plain(*vu_args)),
          "affinity_update differs from its plain version on the preferred variant")
    check(float(vuk.pref_sym.abs().max()) < EXACT_F32, "pref_sym left the exact f32 range")
    log(f"phase kernel affinity_update, preferred variant: equal True (max |pref_sym| "
        f"{float(vuk.pref_sym.abs().max())})")
    del vu_args, vuk
    k4_ms = time_ms(torch, lambda: au.affinity_update_cuda(*u_args), 20)
    k4_dev = device_ms(lambda: au.affinity_update_cuda(*u_args), 20)
    k4_prev = None if "affinity_update" not in prev_libs else device_ms(
        lambda: affinity_update_with(prev_libs["affinity_update"])(*u_args), 20)
    k4_plain_ms = time_ms(torch, lambda: au.affinity_update_plain(*u_args), 2)
    k4_bytes = (nbytes(ump, uacc, unode, usnap.node_domains, usnap.pod_anti_terms,
                       usnap.pod_pref_aff, usnap.pod_pref_aff_w)
                + 2 * nbytes(ustate.counts, ustate.total, ustate.anti_presence,
                             ustate.pref_sym))
    n_acc_match = int((ump & uacc[None, :]).sum())
    k4_ops = n_acc_match * (1 + usnap.node_domains.shape[1]) + int(uacc.sum()) * 2 * N
    log(f"phase kernel affinity_update: [{ump.shape[0]}, {ump.shape[1]}] equal "
        f"{k4_equal} on all {n_k4} rounds of the cycle ({int(uacc.sum())} accepted in round 0, max pref_sym "
        f"{float(uk.pref_sym.abs().max())}); kernel {k4_ms:.3f} ms, {k4_dev:.4f} ms device "
        f"(earlier design: {'not built' if k4_prev is None else f'{k4_prev:.4f} ms device'}), "
        f"plain {k4_plain_ms:.3f} ms, bound {bound(k4_bytes, k4_ops)[0]:.4f} ms")

    # K5 capacity: every pass and revocation fold of the cycle
    c_calls = rec["capacity"].args
    n_pass, n_fold = capacity_calls_equal(torch, cap, c_calls, "affinity cycle")
    c_args = c_calls[0]
    fold_args = c_calls[min(i for i, a in c_calls.items() if a[7] is False)]
    s_key, order, rank_bits, creq, cnode_req, calloc, cslack = c_args[:7]
    node_run = (s_key >> rank_bits)
    longest = int(torch.unique_consecutive(node_run[node_run < N],
                                           return_counts=True)[1].max())
    # device times from CUDA-graph replays: a K5 call's wrapper takes longer
    # on the host than the kernel on the card (kernel_variants.device_ms)
    k5_ms = device_ms(lambda: cap.capacity_cuda(*c_args), 50)
    k5_fold_ms = device_ms(lambda: cap.capacity_cuda(*fold_args), 50)
    k5_mean_ms = sum(device_ms(lambda: cap.capacity_cuda(*a), 10)
                     for a in c_calls.values()) / len(c_calls)
    k5_wall_ms = time_ms(torch, lambda: cap.capacity_cuda(*c_args), 50)
    k5_plain_ms = time_ms(torch, lambda: cap.capacity_plain(*c_args), 5)
    B5 = s_key.shape[0]
    k5_bytes = (nbytes(s_key, order, cnode_req, calloc, cslack) + B5 * creq.shape[1] * 4
                + B5 + cnode_req.numel() * 4)
    k5_ops = 4 * B5 * creq.shape[1]
    log(f"phase kernel capacity: B={B5} claims, longest node run {longest}; equal "
        f"bit for bit on all {n_pass} passes and {n_fold} revocation folds of the cycle; "
        f"kernel {k5_ms:.4f} ms round-0 pass, {k5_fold_ms:.4f} ms round-0 revocation "
        f"fold, {k5_mean_ms:.4f} ms mean over the cycle's calls, device time (the "
        f"wrapper back to back, host-bound: {k5_wall_ms:.4f} ms), plain "
        f"{k5_plain_ms:.3f} ms, bound {bound(k5_bytes, k5_ops)[0]:.4f} ms")

    # K6 guard sweep: every round of the cycle
    g_calls = rec["guard_sweep"].args
    for i, a_ in sorted(g_calls.items()):
        check(torch.equal(gs.guard_sweep_cuda(*a_), gs.guard_sweep_plain(*a_)),
              f"guard_sweep differs from its plain version (round {i})")
    g_args = g_calls[0]
    s_packed, gperm, grank_bits, gB, role_tab, gcaps, gk_invalid = g_args
    okk = gs.guard_sweep_cuda(*g_args)
    k6_ms = time_ms(torch, lambda: gs.guard_sweep_cuda(*g_args), 20)
    k6_dev = device_ms(lambda: gs.guard_sweep_cuda(*g_args), 20)
    k6_mean = sum(device_ms(lambda: gs.guard_sweep_cuda(*a), 10)
                  for a in g_calls.values()) / len(g_calls)
    k6_prev = k6_prev_mean = None
    if "guard_sweep" in prev_libs:  # the earlier design on the same calls
        prev_k6 = guard_sweep_with(prev_libs["guard_sweep"])
        check(torch.equal(prev_k6(*g_args), okk),
              "the earlier guard_sweep differs from the kernel")
        k6_prev = device_ms(lambda: prev_k6(*g_args), 20)
        k6_prev_mean = sum(device_ms(lambda: prev_k6(*a), 10)
                           for a in g_calls.values()) / len(g_calls)
    k6_plain_ms = time_ms(torch, lambda: gs.guard_sweep_plain(*g_args), 5)
    L = s_packed.shape[0]
    n_valid = int(((s_packed >> grank_bits) != gk_invalid).sum())
    k6_bytes_all = nbytes(s_packed, gperm, role_tab, gcaps) + gB
    check(gs._library().guard_sweep_tile() == gs.TILE, "guard_sweep: TILE is not kTile")
    k6_bytes = guard_prefix_bytes(torch, gs.TILE, g_args)
    k6_ops = 8 * n_valid
    k6_prev_txt = ("not built" if k6_prev is None else
                   f"{k6_prev:.4f} ms device, mean {k6_prev_mean:.4f}")
    log(f"phase kernel guard_sweep: L={L} entries ({n_valid} valid, "
        f"{role_tab.shape[0]} slots x {gB}); revoked {int((~okk).sum())}; equal True on all "
        f"{len(g_calls)} rounds of the cycle; kernel {k6_ms:.3f} ms ({k6_dev:.4f} ms device, "
        f"mean {k6_mean:.4f} over the rounds; earlier design: {k6_prev_txt}), plain "
        f"{k6_plain_ms:.3f} ms, bound {bound(k6_bytes, k6_ops)[0]:.4f} ms (the valid prefix, "
        f"{k6_bytes} bytes) / {bound(k6_bytes_all, k6_ops)[0]:.4f} ms (all of L, "
        f"{k6_bytes_all} bytes)")
    del rec, t_args, u_args, c_args, g_args, g_calls, out_k, out_p, uk, up, k3n, raw, feas

    # the affinity main path: counts set to 0 just before, read just after
    results, launches = timed_cycles(torch, kb, cycle_k, snaps, AFF_TIMED_SEEDS)
    log(f"phase affinity launches over {len(AFF_TIMED_SEEDS)} cycles: {json.dumps(launches)}")
    for k in ("static_base", "claim_pass", "interpod_terms", "interpod_norm",
              "affinity_update", "capacity", "guard_sweep", "dyn_mask", "dyn_score"):
        check(launches[k] > 0, f"kernel {k} was not launched on the affinity path")
    timed = []
    for s, d, dev_ms, host_ms in results:
        snap = snaps[s]
        ctx, extra = check_placements(torch, snap, d, fw, plain_kernels)
        n_anti, n_aff, n_spread = check_affinity(torch, snap, d, ctx, extra)
        timed.append(round(dev_ms, 1))
        log(f"phase affinity cycle seed {s}: device {dev_ms:.1f} ms, host "
            f"{host_ms:.1f} ms, placed {int((d.assignment >= 0).sum())}, unschedulable "
            f"{int(d.unschedulable.sum())}, rounds {int(d.placed_round.max()) + 1}; "
            f"valid: capacity, static masks, unplaced infeasible, {n_anti} anti terms, "
            f"{n_aff} affinity terms, {n_spread} DoNotSchedule constraints")
        decisions[s] = d
    cycle_ms = {s: dev_ms for s, _, dev_ms, _ in results}
    del results

    # ============ preemption: DefaultPreemption after config #4's cycles ============
    pre_stats = preemption_phase(torch, kb, fw, dev, nodes, existing, pending, snaps,
                                 decisions, cycle_ms, cycle_k, smi, slice1_case, prev_libs)
    kernels.update(pre_stats.pop("kernels"))
    del decisions

    # ============ scan: config #4's workload through the scan engine ============
    scan_stats = scan_phase(torch, kb, fw, dev, nodes, existing, pending, snaps, smi,
                            slice1_case, plain_kernels, prev_libs)
    kernels.update(scan_stats.pop("kernels"))

    # ============ full outputs: the reject attribution and round counters ============
    full_stats = full_phase(torch, kb, fw, dev, nodes, existing, pending, snaps, smi)
    kernels["scan_commit"].update(full_mode=full_stats["ms"]["scan"])
    del snaps

    # ============ volumes: config #4's workload with local and zonal PVs ============
    vol_stats = volumes_phase(torch, kb, fw, dev, nodes, existing, pending, smi,
                              plain_kernels, prev_libs)
    kernels.update(vol_stats.pop("kernels"))

    # ============ carry: the device-carry latency path over churn ============
    carry_stats = {v: carry_phase(torch, kb, fw, dev, nodes, existing, pending, smi, v)
                   for v in (False, True)}
    kernels["static_base"]["carry_launches"] = sum(
        c["launches"]["static_base"] for c in carry_stats.values())
    for k in ("preempt_prefilter", "preempt_whatif", "preempt_claim"):
        kernels[k]["carry_launches"] = sum(c["launches"][k] for c in carry_stats.values())
    kernels.update(reject_kernel_entries(torch, full_stats, carry_stats, prev_libs))

    # ============ serving: the Scheduler over config #4's workload ============
    serve_stats = serving_phase(torch, kb, dev, nodes, existing, pending, smi, kernels)

    # ============ extenders: the verdicts through every program ============
    ext_stats = extender_phase(torch, kb, dev, nodes, existing, pending, smi)
    kernels.update(ext_stats.pop("kernels"))
    kernels["extender_merge"]["carry_launches"] = sum(
        c["launches"]["extender_merge"] for c in carry_stats.values())

    # ============ durable: state, the front door, spans, black box, faults ============
    dur_stats = durable_phase(torch, kb, dev, nodes, existing, pending, smi)

    # ============ compile cache, profiling, watchtower, the fuzzer ============
    comp_stats = compile_phase(torch, kb, dev, smi)
    # ============ the CLI and the gRPC shim, multi-cycle and speculative ============
    cli_stats = cli_phase(torch, kb, dev, smi)
    kernels["scan_commit"]["tie_last_launches"] = comp_stats["tie_last_launches"]
    kernels["scan_commit"]["fuzz_launches"] = comp_stats["fuzz_launches"].get("scan_commit", 0)

    kernels["interpod_terms"] = kernel_entry(
        "interpod_terms", "cuda", "k8s_scheduler_tpu_torch/csrc/interpod_terms.cu",
        "k8s_scheduler_tpu/ops/interpod.py:374", launches["interpod_terms"], 0.0,
        k3_ms, k3_dev, k3_plain_ms, k3_bytes, k3_ops)
    kernels["interpod_norm"] = kernel_entry(
        "interpod_norm", "cuda", "k8s_scheduler_tpu_torch/csrc/interpod_terms.cu",
        "k8s_scheduler_tpu/ops/interpod.py:416", launches["interpod_norm"], 0.0,
        k3n_ms, k3n_dev, k3n_plain_ms, k3n_bytes, k3n_ops)
    kernels["affinity_update"] = kernel_entry(
        "affinity_update", "cuda", "k8s_scheduler_tpu_torch/csrc/affinity_update.cu",
        "k8s_scheduler_tpu/ops/interpod.py:489", launches["affinity_update"], 0.0,
        k4_ms, k4_dev, k4_plain_ms, k4_bytes, k4_ops, prev_device_ms=k4_prev)
    kernels["capacity"] = kernel_entry(
        "capacity", "cuda", "k8s_scheduler_tpu_torch/csrc/capacity.cu",
        "k8s_scheduler_tpu/ops/rounds.py:592", launches["capacity"], 0.0,
        k5_wall_ms, k5_ms, k5_plain_ms, k5_bytes, k5_ops, fold_device_ms=k5_fold_ms,
        mean_device_ms=k5_mean_ms)
    by_path = {k: {"slice1": launches1[k], "affinity": launches[k],
                   "volumes": vol_stats["dyn_launches"][k]} for k in ("dyn_mask", "dyn_score")}
    kernels["dyn_mask"] = kernel_entry(
        "dyn_mask", "cuda", "k8s_scheduler_tpu_torch/csrc/dyn_round.cu",
        "k8s_scheduler_tpu/framework/runtime.py:202", launches["dyn_mask"], 0.0,
        k14_ms, k14_dev, k14_plain, k14_bytes, k14_ops, launches_by_path=by_path["dyn_mask"],
        round0_peak_mib=peak_k, plain_round0_peak_mib=peak_p, prev_device_ms=k14_prev,
        mean_bound_ms=k14_mean_bound)
    kernels["dyn_score"] = kernel_entry(
        "dyn_score", "cuda", "k8s_scheduler_tpu_torch/csrc/dyn_round.cu",
        "k8s_scheduler_tpu/framework/runtime.py:202", launches["dyn_score"], 0.0,
        k15_ms, k15_dev, k15_plain, k15_bytes, k15_ops, launches_by_path=by_path["dyn_score"],
        anchor_device_ms=k15a_dev, anchor_plain_ms=k15a_plain,
        anchor_replaces="k8s_scheduler_tpu/framework/runtime.py:242", prev_device_ms=k15_prev,
        later_bound_ms=k15_later_bound)
    kernels["guard_sweep"] = kernel_entry(
        "guard_sweep", "cuda", "k8s_scheduler_tpu_torch/csrc/guard_sweep.cu",
        "k8s_scheduler_tpu/ops/rounds.py:342", launches["guard_sweep"], 0.0,
        k6_ms, k6_dev, k6_plain_ms, k6_bytes, k6_ops,
        bound_all_ms=bound(k6_bytes_all, k6_ops)[0], mean_device_ms=k6_mean,
        prev_device_ms=k6_prev, prev_mean_device_ms=k6_prev_mean)
    for k, v in serve_stats["launches"].items():
        if k in kernels:
            kernels[k]["serving_launches"] = v
    for k, v in dur_stats["launches"].items():
        if k in kernels:
            kernels[k]["durable_launches"] = v
    for k, v in cli_stats["launches"].items():
        if k in kernels:
            kernels[k]["multicycle_launches"] = v
    for k in kernels.values():
        log(f"  kernel {k['name']:17s} ms {k['ms']:9.3f}  device {k['device_ms']:9.4f}  "
            f"bound {k['bound_ms']:8.4f} ({k['bound_by']})  plain {k['plain_ms']:9.3f}  "
            f"launches {k['launches']}")
    log(f"phase summary: slice-1 cycle device ms {timed1}, affinity cycle device ms "
        f"{timed}, preemption device ms {pre_stats['ms']}, scan cycle device ms "
        f"{scan_stats['ms']}, scan preemption device ms {scan_stats['pre_ms']}, volumes "
        f"cycle device ms {vol_stats['ms']}, volumes preemption device ms "
        f"{vol_stats['pre_ms']}, volumes scan cycle device ms {vol_stats['scan']['ms']}, "
        f"volumes scan preemption device ms {vol_stats['scan']['pre_ms']}, carry cycle "
        f"device ms {carry_stats[False]['ms']}, with "
        f"volumes {carry_stats[True]['ms']}, full cycles "
        f"{json.dumps(full_stats['ms'])}, diagnosis ms a frame "
        f"{[c['diagnosis']['ms'] for c in carry_stats.values()]}, cycles with extender "
        f"verdicts ms {json.dumps(ext_stats['cycle_ms'])}, durable serving-cycle wall ms "
        f"{dur_stats['wall_ms']} (the twin's {dur_stats['twin_wall_ms']}), kernels ready "
        f"cold / warm {comp_stats['cold']['ready_s']} / {comp_stats['warm']['ready_s']} s, "
        f"fuzz traces {json.dumps(comp_stats['fuzz_traces'])}, CLI binds "
        f"{cli_stats['binds']}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, "
        f"total {time.time() - t_start:.0f}s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
