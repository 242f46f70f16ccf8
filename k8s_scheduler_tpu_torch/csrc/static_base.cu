// static_base: the combined static base of the rounds engine, one f32 [P, N]
// plane written once.
//
// Replaces (no Pallas kernel existed; this is the XLA-compiled device
// function): k8s_scheduler_tpu/ops/rounds.py:338
//   sbase = where(static_mask, clip(static_score, -1e6, 1e6), NEG_INF)
// with (static_mask, static_score) = Framework.static_lean
// (k8s_scheduler_tpu/framework/runtime.py:103), optionally ANDed with
// core/cycle.py sampling_mask and resources.fit_mask_single against the
// snapshot's node_requested.
//
// mask  = node_valid & NodeUnschedulable & NodeName & toleration-pair lookup
//         & requirement rows (pod_req_id, pod_sel_req_id) & no host-port
//         conflict & [fit] & [sampling window]
// score = fused multiply-add of the weighted static plugin scores in the
//         framework's order (ImageLocality, NodeAffinity preferred,
//         TaintToleration by default), the same single roundings XLA's
//         contraction gives the reference.
//
// Bound on an H100: bytes. The only [P, N]-sized traffic is the output
// (4 B per element); per-pod values are broadcast reads and the small
// deduplicated tables ([Tl, Ts], [Rq, N], [Pf, N], [Is, N]) stay in L2.
// Design: one block of 256 threads per (pod, 256-node tile); per-pod ids,
// port slots and requests are read once per thread from a broadcast
// address, each thread writes one coalesced output element. No per-plugin
// [P, N] temporaries.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a --fmad=false ...
// (--fmad=false keeps every multiply and add separately rounded except
// the explicit __fmaf_rn calls).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kThreads = 256;

// filter bits (ops/static_base.py mirrors these)
constexpr int kUnsched = 1, kNodeName = 2, kTaint = 4, kAffinity = 8,
              kPorts = 16, kFit = 32, kSample = 64;
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
  int flags;
  int term[3];
  float weight[3];
  int n_terms;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void static_base_kernel(Args a) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= a.N) return;
  const int flags = a.flags;
  // node-side values: one coalesced read per node
  const bool valid = a.node_valid[n] != 0;
  const bool unsched = a.node_unsched[n] != 0;
  const int ts = clampi(a.node_taintset[n], 0, a.Ts - 1);

  for (int p = blockIdx.y; p < a.P; p += gridDim.y) {
    bool ok = valid;
    if (flags & kUnsched) ok = ok && !unsched;
    if (flags & kNodeName) {
      const int pin = a.pod_node_name[p];
      if (pin >= 0) ok = ok && (n == pin);
      if (pin == -2) ok = false;
    }
    const int tl = clampi(a.pod_tolset[p], 0, a.Tl - 1);
    if (flags & kTaint) ok = ok && a.sched[(size_t)tl * a.Ts + ts] != 0;
    if (flags & kAffinity) {
      const int rid = a.pod_req_id[p];
      if (rid >= 0) ok = ok && a.req[(size_t)clampi(rid, 0, a.Rq - 1) * a.N + n] != 0;
      const int sid = a.pod_sel_req_id[p];
      if (sid >= 0) ok = ok && a.req[(size_t)clampi(sid, 0, a.Rq - 1) * a.N + n] != 0;
    }
    if (flags & kPorts) {
      for (int j = 0; j < a.MPp; ++j) {
        const int pp = a.pod_ports[(size_t)p * a.MPp + j];
        if (pp < 0) continue;
        for (int k = 0; k < a.MUP; ++k) {
          if (a.node_used_ports[(size_t)n * a.MUP + k] == pp) ok = false;
        }
      }
    }
    if (flags & kFit) {
      for (int r = 0; r < a.R; ++r) {
        if (!(a.pod_requested[(size_t)p * a.R + r] <= a.node_room[(size_t)n * a.R + r]))
          ok = false;
      }
    }
    if (flags & kSample) {
      // (n - off) mod samp_n, floor semantics; samp_n >= 1
      int win = (n - a.samp_off[p]) % a.samp_n;
      if (win < 0) win += a.samp_n;
      ok = ok && win < a.samp_k;
    }
    float out = kNegInf;
    if (ok) {
      float s = 0.0f;
      for (int t = 0; t < a.n_terms; ++t) {
        float v = 0.0f;
        if (a.term[t] == kTermImage) {
          const int iid = a.pod_imageset[p];
          if (iid >= 0) v = a.img[(size_t)clampi(iid, 0, a.Is - 1) * a.N + n];
        } else if (a.term[t] == kTermPref) {
          const int fid = a.pod_pref_id[p];
          if (fid >= 0) v = a.pref[(size_t)clampi(fid, 0, a.Pf - 1) * a.N + n];
        } else if (a.term[t] == kTermTaint) {
          v = a.tscore[(size_t)tl * a.Ts + ts];
        }
        s = __fmaf_rn(a.weight[t], v, s);
      }
      out = fminf(fmaxf(s, -1e6f), 1e6f);
    }
    a.out[(size_t)p * a.N + n] = out;
  }
}

}  // namespace

extern "C" int static_base_launch(
    float* out, int P, int N, int R,
    const int* pod_node_name, const int* pod_tolset, const int* pod_req_id,
    const int* pod_sel_req_id, const int* pod_pref_id, const int* pod_imageset,
    const int* pod_ports, int MPp, const float* pod_requested,
    const int* samp_off, int samp_k, int samp_n,
    const uint8_t* node_valid, const uint8_t* node_unsched,
    const int* node_taintset, const int* node_used_ports, int MUP,
    const float* node_room,
    const uint8_t* sched, const float* tscore, int Tl, int Ts,
    const uint8_t* req, int Rq, const float* pref, int Pf,
    const float* img, int Is,
    int flags, int term0, int term1, int term2,
    float w0, float w1, float w2, int n_terms,
    void* stream) {
  if (P <= 0 || N <= 0) return 0;
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
  a.flags = flags;
  a.term[0] = term0; a.term[1] = term1; a.term[2] = term2;
  a.weight[0] = w0; a.weight[1] = w1; a.weight[2] = w2;
  a.n_terms = n_terms;
  dim3 grid((N + kThreads - 1) / kThreads, P < 65535 ? P : 65535);
  static_base_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
