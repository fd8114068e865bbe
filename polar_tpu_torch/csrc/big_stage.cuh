// The l > 2 kernel-input LLR of one output element, shared by the
// standalone stage kernel (stage_down.cu, K6) and the decode body
// (scl_decode.cu, K1/K2/K4/K5).
//
// It mirrors polar_tpu/ops/pallas_scl.py `down_big` and
// polar_tpu/ops/pallas_stage.py `kernel_fn` op for op, and so
// ops/kernel_proc.py StageProcessor._llr_static, whose floats it must
// give bit for bit. The caller forms v[k] = lam_adj[k] (k < l), the
// coset-adjusted output LLRs of the element: the parent LLR with its sign
// flipped where the prior decisions' coset bit is 1 (an exact negation).
//
// - i = l-1: the fixed pairwise tree ((0+1)+(2+3))+... of v[k] * K[i,k]
//   with 0/1 weights (zero weights give -0.0 terms; kept).
// - Syndrome trellis (small i, S = 2^(i+1) <= 32 states for l <= 16): one
//   lane per state, alpha'[st] = min(alpha[st] + pen0, alpha[st ^ c_t] +
//   pen1) for both hypotheses, sections in order, INF = 3e38 / 4 padding,
//   unclamped. The relabelling alpha[st ^ c_t] is a warp shuffle, so the
//   states never index a register array at run time.
// - Tail table (the other inputs): max over the 2^(l-1-i) tail codewords
//   of the tree-folded correlation, the +-1 columns regenerated from the
//   message index bits and the generator-row parities in _tail_table's
//   column order; the max may be taken across lanes in any order (it is
//   exact). The result is 0.5 * (corr0 - corr1).
//
// Build with --fmad=false: no add may be contracted with a multiply.
#pragma once

#include <cuda_runtime.h>

namespace bigstage {

constexpr int kMaxL = 16;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kTrellisInf = 3e38f / 4.f;   // kernels/trellis.py INF

// An l x l kernel (l > 2) and its inputs' tables; ops/cuda_stage.py
// `BigKernel` mirrors this layout.
struct BigKernel {
  int l;
  unsigned short kcol[kMaxL];         // column k of K: bit j = K[j, k]
  unsigned char states[kMaxL];        // input i: trellis states S; 0 = table
  unsigned char cols[kMaxL][kMaxL];   // input i, section t: syndrome column
};

// The fixed pairwise tree over t[0..l) (l a power of two <= 16).
__device__ __forceinline__ float tree_fold(float (&t)[kMaxL], int l) {
#pragma unroll
  for (int w = 1; w < kMaxL; w <<= 1) {
#pragma unroll
    for (int k = 0; k + w < kMaxL; k += 2 * w)
      if (k + w < l) t[k] = t[k] + t[k + w];
  }
  return t[0];
}

// i = l-1: the correlation with row l-1.
__device__ __forceinline__ float last_llr(const BigKernel& K,
                                          const float (&v)[kMaxL]) {
  const int i = K.l - 1;
  float t[kMaxL];
#pragma unroll
  for (int k = 0; k < kMaxL; ++k)
    t[k] = (k < K.l) ? v[k] * (float)((K.kcol[k] >> i) & 1u) : 0.f;
  return tree_fold(t, K.l);
}

// Syndrome trellis of input i over a group of S = K.states[i] lanes, one
// state each (st = lane & (S-1)); every lane of the warp calls it with the
// same (K, i). The result is valid in the group's lane st = 0.
__device__ __forceinline__ float trellis_llr(const BigKernel& K, int i,
                                             const float (&v)[kMaxL], int st) {
  float a0 = (st == 0) ? 0.f : kTrellisInf;   // hypothesis u_i = 0
  float a1 = a0;                               // u_i = 1: row i sign flip
#pragma unroll
  for (int t = 0; t < kMaxL; ++t) {
    if (t < K.l) {
      const float x = v[t];
      const float y = ((K.kcol[t] >> i) & 1u) ? x * -1.f : x;
      const int c = K.cols[i][t];
      const float o0 = __shfl_xor_sync(kFullMask, a0, c);
      const float o1 = __shfl_xor_sync(kFullMask, a1, c);
      a0 = fminf(a0 + fmaxf(-x, 0.f), o0 + fmaxf(x, 0.f));
      a1 = fminf(a1 + fmaxf(-y, 0.f), o1 + fmaxf(y, 0.f));
    }
  }
  return a1 - a0;
}

// Tail table of input i: this lane's share (columns g, g + G, ...) of the
// two maxima; the caller reduces them over the G lanes of the element.
__device__ __forceinline__ void table_max(const BigKernel& K, int i,
                                          const float (&v)[kMaxL], int g,
                                          int G, float& m0, float& m1) {
  const int l = K.l;
  const int C = 1 << (l - 1 - i);
  unsigned row = 0u;
#pragma unroll
  for (int k = 0; k < kMaxL; ++k)
    if (k < l) row |= ((K.kcol[k] >> i) & 1u) << k;
  m0 = -__int_as_float(0x7f800000);
  m1 = m0;
  for (int c = g; c < C; c += G) {
    float t[kMaxL];
    unsigned par = 0u;   // bit k: column k of tail codeword c
#pragma unroll
    for (int k = 0; k < kMaxL; ++k) {
      if (k < l) {
        par |= (__popc((unsigned)c & ((unsigned)K.kcol[k] >> (i + 1))) & 1u) << k;
        t[k] = ((par >> k) & 1u) ? -v[k] : v[k];
      }
    }
    const float s0 = tree_fold(t, l);
    const unsigned par1 = par ^ row;
#pragma unroll
    for (int k = 0; k < kMaxL; ++k)
      if (k < l) t[k] = ((par1 >> k) & 1u) ? -v[k] : v[k];
    const float s1 = tree_fold(t, l);
    m0 = fmaxf(m0, s0);
    m1 = fmaxf(m1, s1);
  }
}

// Max over the G (<= 32, a power of two) lanes of an aligned lane group;
// every lane gets it.
__device__ __forceinline__ float group_max(float x, int G) {
  for (int off = 1; off < G && off < 32; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

}  // namespace bigstage
