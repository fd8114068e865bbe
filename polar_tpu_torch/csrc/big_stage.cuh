// The l > 2 kernel-input LLR of one output element, shared by the
// standalone stage kernel (stage_down.cu, K6) and the decode body
// (scl_decode.cu, K1/K2/K3/K4/K5).
//
// It gives the floats of polar_tpu/ops/pallas_scl.py `down_big` and
// polar_tpu/ops/pallas_stage.py `kernel_fn`, and so of
// ops/kernel_proc.py StageProcessor._llr_static, bit for bit. The caller
// forms v[k] = lam_adj[k] (k < l), the coset-adjusted output LLRs of the
// element: the parent LLR with its sign flipped where the prior decisions'
// coset bit is 1 (an exact negation).
//
// - i = l-1: the fixed pairwise tree ((0+1)+(2+3))+... of v[k] * K[i,k]
//   with 0/1 weights (zero weights give -0.0 terms; kept).
// - Syndrome trellis (small i, S = 2^(i+1) <= 32 states for l <= 16): one
//   lane per state, alpha'[st] = min(alpha[st] + pen0, alpha[st ^ c_t] +
//   pen1) for both hypotheses, sections in order, INF = 3e38 / 4 padding,
//   unclamped. The relabelling alpha[st ^ c_t] is a warp shuffle, so the
//   states never index a register array at run time.
// - Tail table (the other inputs): max over the C = 2^(l-1-i) tail
//   codewords of the tree-folded correlation, for both hypotheses; the
//   result is 0.5 * (corr0 - corr1). A column is its parity mask par (bit
//   k: the codeword's bit k), and its correlation is the tree over
//   t[k] = par_k ? -v[k] : v[k]. `table_max` below says how a column is
//   made cheap without changing a float.
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
// The tail-table rules (the walk, the quad cut-over) are decided once, on
// the host, by `big_kernel` there; the kernels only read them.
struct BigKernel {
  int l;
  unsigned short kcol[kMaxL];         // column k of K: bit j = K[j, k]
  unsigned short krow[kMaxL];         // row j of K: bit k = K[j, k]
  unsigned char states[kMaxL];        // input i: trellis states S; 0 = table
  unsigned char cols[kMaxL][kMaxL];   // input i, section t: syndrome column
  unsigned short walk[kMaxL];         // input i: table columns walked
  unsigned short quads;               // bit i: input i takes quad tables
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

// Columns of the tail table of input i that a lane group walks: with
// row l-1 all ones (the eBCH kernels), column c + C/2 is the complement of
// column c, whose correlation is the negation of c's (negation is exact;
// a sum that is exactly zero is +0.0 both ways), so the pair's maximum is
// |corr(c)| (up to the sign of a zero, which the max of the reference
// leaves to its order too) and only the first C/2 columns are walked.
__host__ __device__ __forceinline__ int table_walk(const BigKernel& K, int i) {
  return K.walk[i];
}

// Whether input i's table takes the quad-table path: a group of >= 16
// lanes and an input whose quad bit the host set (l = 8 or 16 and a walk
// long enough to pay for the tables).
__host__ __device__ __forceinline__ bool table_quads(const BigKernel& K, int i,
                                                     int G) {
  return G >= 16 && ((K.quads >> i) & 1u);
}

// The pairwise tree over the NQ = l/4 quad sums: for l = 16,
// (x0 + x1) + (x2 + x3), the top two levels of `tree_fold`.
template <int NQ>
__device__ __forceinline__ float quad_fold(const float (&x)[NQ]) {
  if constexpr (NQ == 4) return (x[0] + x[1]) + (x[2] + x[3]);
  else return x[0] + x[1];
}

// The quad-table walk of `table_max` for NQ = l/4 quads (2 or 4): lane
// h = g & 15 of each 16-lane subgroup holds entry h of every quad table.
template <int NQ>
__device__ __forceinline__ void quad_walk(const BigKernel& K, int i,
                                          const float (&v)[kMaxL], int g,
                                          unsigned base, int cnt,
                                          unsigned row, bool absmax,
                                          float& m0, float& m1) {
  const int h = g & 15;
  const unsigned r0 = K.krow[i + 1];
  float q[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const float t0 = (h & 1) ? -v[4 * j] : v[4 * j];
    const float t1 = (h & 2) ? -v[4 * j + 1] : v[4 * j + 1];
    const float t2 = (h & 4) ? -v[4 * j + 2] : v[4 * j + 2];
    const float t3 = (h & 8) ? -v[4 * j + 3] : v[4 * j + 3];
    q[j] = (t0 + t1) + (t2 + t3);
  }
  auto corr = [&](unsigned par) {
    float x[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      x[j] = __shfl_sync(kFullMask, q[j], (int)((par >> (4 * j)) & 15u), 16);
    return quad_fold<NQ>(x);
  };
  auto column = [&](unsigned par) {
    const float s0 = corr(par), s1 = corr(par ^ row);
    m0 = fmaxf(m0, absmax ? fabsf(s0) : s0);
    m1 = fmaxf(m1, absmax ? fabsf(s1) : s1);
  };
  if (cnt == 1) {
    column(base);
    return;
  }
  // pairs of columns {c, c ^ 1}, the pairs' bases in Gray order
  for (int j = 0; j < cnt; j += 2) {
    if (j) base ^= K.krow[i + 2 + __ffs(j >> 1) - 1];
    column(base);
    column(base ^ r0);
  }
}

// Tail table of input i: this lane's share of the two maxima (lane g of
// a group of G aligned lanes, G a power of two no larger than the walk);
// the caller reduces them over the group. Every lane of the warp calls it
// with the same (K, i, G). The caller reads walk = table_walk(K, i) and
// quads = table_quads(K, i, G) once and passes them in (re-read for every
// element group, they made bch_sc's capacity-8 K1 1.4% slower on an H100,
// PERF.md §6).
//
// The walk: lane g takes the cnt = walk / G columns c = g*cnt + j, j in
// [0, cnt), in Gray order: a column's parity is the previous column's
// XOR one generator row (bit b of c <-> row i+1+b). The parity of
// hypothesis 1 is par ^ row i. No column index is ever turned into a
// parity bit by bit.
//
// The fold, two ways:
// - Direct (a short walk, or fewer than 16 lanes): the l terms
//   par_k ? -v[k] : v[k] summed by `tree_fold`, both hypotheses.
// - Quad tables (`table_quads`: l = 8 or 16, G >= 16, a long walk): the
//   tree's subtrees over four inputs, Q_j[a] = (t0 + t1) + (t2 + t3) for
//   inputs 4j..4j+3 with signs from the 4 bits of a, are its lowest two
//   levels, so corr(par) = quad_fold(Q_j[nibble j of par]) is the same
//   expression tree and the same float. Lane h of each 16-lane subgroup
//   holds entry h of every quad table (l/4 registers, built from its own
//   v) and a column reads entry nibble_j(par) of table j from lane
//   nibble_j(par) by a width-16 shuffle: l/2 shuffles and 2 (l/4 - 1) adds
//   a column for both hypotheses, against 2 l selects and 2 (l - 1) adds
//   folded directly.
__device__ __forceinline__ void table_max(const BigKernel& K, int i,
                                          const float (&v)[kMaxL], int g,
                                          int G, int walk, bool quads,
                                          float& m0, float& m1) {
  const int l = K.l;
  const bool absmax = walk < (1 << (l - 1 - i));
  const unsigned row = K.krow[i];
  const int cnt = walk / G;
  // the parity of this lane's first column g * cnt
  unsigned base = 0u;
  const unsigned c0 = (unsigned)(g * cnt);
  for (int b = 0; (c0 >> b) != 0u; ++b)
    if ((c0 >> b) & 1u) base ^= K.krow[i + 1 + b];
  m0 = -__int_as_float(0x7f800000);
  m1 = m0;
  if (quads) {
    if (l == 16) quad_walk<4>(K, i, v, g, base, cnt, row, absmax, m0, m1);
    else quad_walk<2>(K, i, v, g, base, cnt, row, absmax, m0, m1);
    return;
  }
  for (int j = 0; j < cnt; ++j) {
    if (j) base ^= K.krow[i + __ffs(j)];     // row i+1+ctz(j)
    float t[kMaxL];
#pragma unroll
    for (int k = 0; k < kMaxL; ++k)
      t[k] = (k < l) ? (((base >> k) & 1u) ? -v[k] : v[k]) : 0.f;
    const float s0 = tree_fold(t, l);
    const unsigned par1 = base ^ row;
#pragma unroll
    for (int k = 0; k < kMaxL; ++k)
      if (k < l) t[k] = ((par1 >> k) & 1u) ? -v[k] : v[k];
    const float s1 = tree_fold(t, l);
    m0 = fmaxf(m0, absmax ? fabsf(s0) : s0);
    m1 = fmaxf(m1, absmax ? fabsf(s1) : s1);
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
