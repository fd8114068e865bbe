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
// share its columns and reduce the two maxima by shuffles. The kernel's
// rows, columns, syndrome columns and the input index come in the
// argument block.
//
// What bounds it on an H100: operations. It reads 4*l bytes and writes 4
// an element, but does l*S*2 min-plus steps (trellis) or walks up to 512
// tail-table columns of two correlations each (i = 5 of the 16x16 kernel).
// The design (csrc/big_stage.cuh `table_max`): the columns walk in Gray
// order, so a column's parity is one XOR; complementary columns are
// walked once (|corr|); and from a walk of QUAD_MIN_COLS columns on, a
// group of 16 lanes holds the element's quad tables (the fixed tree's
// 4-input subtrees) in registers and a column is 8 shuffles and 6 adds
// for both hypotheses instead of a 16-term fold each. ops/cuda_stage.py
// decides both (`big_kernel`: the walk and the quad inputs; `lanes_for`:
// 16 lanes an element for those inputs, 32 where there are too few
// elements to fill the card); the others keep one group of lanes an
// element as before. Everything stays in registers and
// each input is read once per lane (broadcast within a group). Indices
// are 32-bit inside a launch (64-bit divisions cost more than a short
// walk): the launcher splits a problem of more than 2^31 threads into
// launches of at most that many.
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

// Elements [e0, e0 + count) of the flattened axis, e0 = p0 * nB + r0,
// a.out advanced to element e0. Indices are 32-bit (the launcher splits
// larger problems); lanes is a power of two.
__global__ void __launch_bounds__(kThreads)
    stage_down(StageDownArgs a, unsigned p0, unsigned r0, unsigned count) {
  const int l = a.k.l;
  const unsigned gt = blockIdx.x * kThreads + threadIdx.x;
  unsigned e = gt >> (__ffs(a.lanes) - 1);
  const int g = (int)(gt & (unsigned)(a.lanes - 1));
  const bool active = e < count;
  if (!active) e = count - 1;   // idle lanes still take part in the shuffles
  const unsigned q = r0 + e;    // < 2^32: r0 < nB < 2^31, count <= 2^31
  const unsigned p = p0 + q / (unsigned)a.nB, r = q % (unsigned)a.nB;
  const float* src = a.lam + (size_t)p * l * a.nB + r;
  float v[bigstage::kMaxL];
#pragma unroll
  for (int k = 0; k < bigstage::kMaxL; ++k)
    v[k] = (k < l) ? src[(size_t)k * a.nB] : 0.f;
  float res;
  if (a.k.states[a.i]) {
    res = bigstage::trellis_llr(a.k, a.i, v, g);
  } else {
    float m0, m1;
    bigstage::table_max(a.k, a.i, v, g, a.lanes,
                        bigstage::table_walk(a.k, a.i),
                        bigstage::table_quads(a.k, a.i, a.lanes), m0, m1);
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
  // a table group's lanes must not outnumber the columns it walks
  if (!a->k.states[a->i] && a->lanes > bigstage::table_walk(a->k, a->i))
    return (int)cudaErrorInvalidValue;
  // launches of at most 2^31 threads, so that a launch's indices are
  // 32-bit
  const long long E = (long long)a->P * a->nB;
  const long long chunk = (1LL << 31) / a->lanes;
  for (long long e0 = 0; e0 < E; e0 += chunk) {
    const long long count = E - e0 < chunk ? E - e0 : chunk;
    const long long blocks = (count * a->lanes + kThreads - 1) / kThreads;
    StageDownArgs c = *a;
    c.out += e0;
    stage_down<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        c, (unsigned)(e0 / a->nB), (unsigned)(e0 % a->nB), (unsigned)count);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

int stage_down_args_bytes(void) { return (int)sizeof(StageDownArgs); }

}  // extern "C"
