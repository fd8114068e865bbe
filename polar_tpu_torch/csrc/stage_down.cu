// The standalone l > 2 DOWN kernel (K6): the input-i LLR of an l x l
// kernel from its coset-adjusted output LLRs, over a flattened axis.
//
// Replaces polar_tpu/ops/pallas_stage.py `build_down_kernel` -> `_build` ->
// `fn` (the `pallas_call` at :161), the big-stage kernel of the hybrid
// decoder (ops/scl.py `big_stage_backend="pallas"`). Plain version:
// ops/kernel_proc.py StageProcessor.plain_llr; the two agree bit for bit.
//
//   lam_adj [P, l, n, B] f32 -> out [P, n, B] f32, 0 <= i < l-1.
//
// The marginal is independent per output element (p, r), r in [0, n*B).
// What the TPU version did for its tiling (a VMEM budget, 128-lane tiles,
// `pick_mt`) has no counterpart here. A group of `lanes` threads computes
// one element: for the syndrome trellis one lane per state (S lanes, the
// state relabelling is a warp shuffle), for the tail table G lanes that
// share the 2^(l-1-i) columns and reduce the two maxima by shuffles. The
// kernel's rows, syndrome columns and the input index come in the
// argument block.
//
// What bounds it on an H100: operations. It reads 4*l bytes and writes 4
// an element, but does l*S*2 min-plus steps (trellis) or 2^(l-i) tree
// correlations of l terms (table) for them, up to ~64k operations an
// element at i = 5 of the 16x16 kernel. The design spreads the work of
// one element over lanes when there are few elements (n = 1 at the second
// stage of bch_sc), keeps everything in registers and reads each input
// once per lane (broadcast within a group, coalesced across groups).
#include <cuda_runtime.h>
#include <stdint.h>

#include "big_stage.cuh"

using bigstage::BigKernel;

// ops/cuda_stage.py `StageDownArgs` mirrors this layout.
struct StageDownArgs {
  const float* lam;   // [P, l, nB]
  float* out;         // [P, nB]
  int P, nB, i, lanes;
  BigKernel k;
};

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) stage_down(StageDownArgs a) {
  const int l = a.k.l;
  const long long E = (long long)a.P * a.nB;
  const long long gt = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long e = gt / a.lanes;
  const int g = (int)(gt % a.lanes);
  const bool active = e < E;
  if (!active) e = E - 1;   // idle lanes still take part in the shuffles
  const long long p = e / a.nB, r = e % a.nB;
  float v[bigstage::kMaxL];
#pragma unroll
  for (int k = 0; k < bigstage::kMaxL; ++k)
    v[k] = (k < l) ? a.lam[(p * l + k) * a.nB + r] : 0.f;
  float res;
  if (a.k.states[a.i]) {
    res = bigstage::trellis_llr(a.k, a.i, v, g);
  } else {
    float m0, m1;
    bigstage::table_max(a.k, a.i, v, g, a.lanes, m0, m1);
    m0 = bigstage::group_max(m0, a.lanes);
    m1 = bigstage::group_max(m1, a.lanes);
    res = 0.5f * (m0 - m1);
  }
  if (active && g == 0) a.out[e] = res;
}

}  // namespace

extern "C" {

int stage_down_launch(const StageDownArgs* a, void* stream) {
  const int l = a->k.l;
  if (l < 4 || l > bigstage::kMaxL || a->i < 0 || a->i >= l - 1 || a->P < 1
      || a->nB < 1 || a->lanes < 1 || a->lanes > 32
      || (a->lanes & (a->lanes - 1)))
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)a->P * a->nB * a->lanes;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  stage_down<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int stage_down_args_bytes(void) { return (int)sizeof(StageDownArgs); }

}  // extern "C"
