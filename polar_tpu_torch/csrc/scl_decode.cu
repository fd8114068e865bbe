// CA-SCL decode of Arikan polar codes, one thread block per codeword, and
// the fused Monte-Carlo step around it.
//
// One decode body (`scl_body`), templated on where the channel LLRs come
// from and on what it writes, gives four kernels. Each replaces one
// `pallas_call` of polar_tpu/ops/pallas_scl.py build_pallas_scl_kernel:
//
//   scl_decode       LLRs in -> best path's u, pm, crc_ok (K1, `core_sel`,
//                    select=True): the in-kernel epilogue (suffix
//                    composition of the per-span survival permutations,
//                    CRC, first-index argmin);
//   scl_decode_traj  LLRs in -> the genealogy: trajectory bits, per-span
//                    survival permutations and all path metrics (K2,
//                    `core`, select=False), finished by ops/scl.py
//                    `scl_epilogue`;
//   scl_mc_traj      Monte-Carlo prologue -> the genealogy and the
//                    transmitted u (K4, `core_mc`, mc=True);
//   scl_mc_counters  Monte-Carlo prologue -> per-codeword frame error and
//                    bit errors on the data rows (K5, `core_cnt`,
//                    mc=True, counters=True).
//
// The Monte-Carlo prologue (pallas_scl.py:457-543) draws the data bits and
// the uniforms from Philox4x32-10 (ops/philox.py pins the stream), appends
// the CRC, encodes x = u F^{(x)m}, and forms llr = (2 / sigma^2) *
// ((1 - 2x) + sigma * gauss) with a Box-Muller draw that uses both outputs
// of each pair, or with injected standard normals. The plain PyTorch
// versions are ops/scl.py (decode) and ops/mc.py (the step); the kernels
// and they agree bit for bit, path metrics included.
//
// The decode body covers the whole fast-SSCL op program (f/g DOWN, UP
// re-encode, R0/REP/R1/SPC/LEAF nodes, 2P -> P forks, lazy path maps).
//
// What bounds it on an H100: neither bytes nor arithmetic. A codeword
// moves 4N bytes in and N + 8 out (the trajectory kernels N*P + Q*P + 4P
// out, the counters kernel 8), and the program is a few hundred thousand
// element operations, but they form a chain of ~316 dependent ops (and
// ~245 forks) whose widths shrink from P*N/2 to P elements. The kernels
// are latency-bound: block-wide barriers between ops, shared memory round
// trips, and warp shuffles in the forks. The prologue adds ~70k
// independent operations a codeword (Philox dominates), spread over the
// whole block.
//
// What the design does about it:
// - All decode state lives in shared memory for the whole decode (for
//   N=1024, L=8 about 58 KB: LLR buffers P*(N-1) f32, decisions
//   2*P*(N-1) u8, trajectory bits N*P u8, span perms Q*P u8; the
//   Monte-Carlo kernels add the channel LLRs 4N and u_true N, ~64 KB), so
//   three blocks share an SM and hide each other's barriers. Device memory
//   is touched only for the channel LLRs (none in the Monte-Carlo
//   kernels), the op table and the outputs.
// - The op program is a device table (kind, level, t0, child index) read
//   at run time, so one compiled kernel serves every Arikan spec.
// - Tal-Vardy lazy copies: a fork permutes the 3*m*P bytes of path->slot
//   maps, never the buffers; a write resets its buffer's map.
// - A 2P -> P fork is a rank select in one warp: candidate c = bit*P + p
//   counts the candidates before it by (metric, c), survivors go out in
//   rank order (== lax.top_k on negated metrics, ties included).
// - Node metric sums use one fixed pairwise tree (x[:h] + x[h:]) in a
//   warp per path, the same tree as the plain version. Built with
//   --fmad=false so no multiply-add is contracted.
// - The counters kernel counts errors after the in-kernel backtrack and
//   best-path choice; it does not carry per-path CRC and error sums
//   through every fork as the TPU kernel does (that avoided the genealogy
//   there). The encode is log2 N XOR butterfly stages in shared memory,
//   not the TPU's generator matmul.
#include <cuda_runtime.h>
#include <stdint.h>

// Kernel arguments; ops/cuda_scl.py `SclArgs` mirrors this layout. Outside
// the anonymous namespace: the extern "C" entry points take it.
struct SclArgs {
  const float* llr;          // [B, N] channel LLRs (kLlrIn)
  const float* noise;        // [B, N] standard normals, or null (kMonteCarlo)
  const int4* ops;           // [n_ops] kind, level, t0, child
  const short* qrow;         // [N] trajectory span of each u row
  const short* pidx;         // [N] payload slot of each row, -1 frozen
  const unsigned* gmask;     // [K] CRC generator row masks
  int8_t* u;                 // [B, N] best path's u (kSelect)
  float* pm;                 // [B] best metric (kSelect); [B, P] (kTrajectory)
  uint8_t* ok;               // [B] best path's CRC pass (kSelect)
  uint8_t* traj_bit;         // [B, N, P] trajectory bits (kTrajectory)
  uint8_t* traj_perm;        // [B, Q, P] span survival perms (kTrajectory)
  int8_t* u_true;            // [B, N] transmitted u (kMonteCarlo, kTrajectory)
  int* counters;             // [2, B] frame error, bit errors (kCounters)
  unsigned offmask;          // CRC offset mask
  unsigned seed0, seed1;     // Philox key (kMonteCarlo)
  float sigma;               // channel noise deviation (kMonteCarlo)
  int n_ops, N, m, P, Q, K, W, B;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 8;
constexpr int kMaxRounds = kMaxP + 1;   // SPC extracts up to P + 1 minima
constexpr float kBig = 1e30f;
constexpr float kTwoPi = 6.28318530717958647692f;   // float32(2 pi)
constexpr float kTwoM24 = 5.9604644775390625e-08f;  // 2^-24
constexpr unsigned kFull = 0xffffffffu;

enum OpKind {
  DOWN_FRESH = 0, DOWN_DYN = 1, UP = 2, R0 = 3, REP = 4, R1 = 5, SPC = 6,
  LEAF = 7, LEAF_FROZEN = 8
};

// where the channel LLRs come from / what the kernel writes
enum Source { kLlrIn = 0, kMonteCarlo = 1 };
enum Output { kSelect = 0, kTrajectory = 1, kCounters = 2 };

struct Small {
  float pm[kMaxP];
  float vals[kMaxRounds][kMaxP];   // least-reliable |llr| per round, path
  float s0[kMaxP], s1[kMaxP];      // REP sums
  float ok[kMaxP];                 // CRC pass per path (0/1)
  short poss[kMaxRounds][kMaxP];   // their positions
  unsigned char nmap[kMaxP];       // node-local path map / fork perm
  unsigned char bit[kMaxP];        // fork bit / parity / eta
  unsigned char perms[kMaxP][kMaxP];
  unsigned char flips[kMaxP][kMaxP];
  unsigned char flipfin[kMaxP][kMaxP];
  unsigned red[kWarps];            // block reductions
  int best;
};

__device__ __forceinline__ float relu_val(float v, int positive) {
  return positive ? fmaxf(v, 0.f) : fmaxf(-v, 0.f);
}

// Sum of relu(+-v[j]) over j < n (n a power of two, n <= 512) as the fixed
// pairwise tree x[:h] + x[h:]; the result is valid in lane 0.
__device__ float warp_tree_sum(const float* v, int n, int positive, int lane) {
  float r[16];
  const int k = n >> 5;
  if (n >= 32) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      r[i] = (i < k) ? relu_val(v[lane + 32 * i], positive) : 0.f;
#pragma unroll
    for (int h = 8; h >= 1; h >>= 1) {
      if (2 * h <= k) {
#pragma unroll
        for (int i = 0; i < h; ++i) r[i] = r[i] + r[i + h];
      }
    }
  } else {
    r[0] = (lane < n) ? relu_val(v[lane], positive) : 0.f;
  }
  float s = r[0];
  const int top = (n >= 32) ? 16 : (n >> 1);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const float o = __shfl_xor_sync(kFull, s, off);
    if (off <= top) s = s + o;
  }
  return s;
}

// count smallest |v[j]| (j < n) with positions, ascending, ties to the
// lowest index; an already chosen position counts as kBig. Whole warp.
__device__ void warp_extract(const float* v, int n, int count, int lane,
                             Small& sm, int p) {
  int chosen[kMaxRounds];
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    if (r < count) {
      float bv = __int_as_float(0x7f800000);   // +inf
      int bi = 0x7fffffff;
      for (int j = lane; j < n; j += 32) {
        float val = fabsf(v[j]);
#pragma unroll
        for (int c = 0; c < kMaxRounds; ++c)
          if (c < r && chosen[c] == j) val = kBig;
        if (val < bv) { bv = val; bi = j; }
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (ov < bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
      chosen[r] = bi;
      if (lane == 0) { sm.vals[r][p] = bv; sm.poss[r][p] = (short)bi; }
    }
  }
}

// 2P -> P fork, warp 0, all 32 lanes. Lane p < P holds path p's metric and
// penalties. Lane r < P gets survivor r: metric, parent path, bit.
__device__ void fork2(int lane, int P, float pm_p, float pen0_p, float pen1_p,
                      float& npm, int& nperm, int& nbit) {
  const int c = lane;
  const int p = c % P;
  const int b = c / P;
  const float vpm = __shfl_sync(kFull, pm_p, p);
  const float v0 = __shfl_sync(kFull, pen0_p, p);
  const float v1 = __shfl_sync(kFull, pen1_p, p);
  const float cand = b ? (vpm + v1) : (vpm + v0);
  int rank = 0;
  for (int c2 = 0; c2 < 2 * P; ++c2) {
    const float o = __shfl_sync(kFull, cand, c2);
    rank += (o < cand) || (o == cand && c2 < c);
  }
  if (c >= 2 * P) rank = 64;
  npm = 0.f; nperm = 0; nbit = 0;
  for (int c2 = 0; c2 < 2 * P; ++c2) {
    const int rk = __shfl_sync(kFull, rank, c2);
    const float o = __shfl_sync(kFull, cand, c2);
    if (rk == lane) { npm = o; nperm = c2 % P; nbit = c2 / P; }
  }
}

// maps[i] = old maps[base(i) + perm[p]] for every map, except the map at
// reset_base, which becomes the identity. Every thread of the block.
__device__ void apply_perm(unsigned char* maps, int total, const unsigned char* perm,
                           int P, int reset_base, int tid) {
  unsigned char v[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = tid + k * kThreads;
    if (i < total) {
      const int p = i % P;
      const int base = i - p;
      v[k] = (base == reset_base) ? (unsigned char)p : maps[base + perm[p]];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = tid + k * kThreads;
    if (i < total) maps[i] = v[k];
  }
  __syncthreads();
}

// The suffix-composed flips of `rounds` forks, recorded in sm.perms /
// sm.flips, in final path indexing (lane p < P).
__device__ void defer_flips(Small& sm, int rounds, int p) {
  int s = p;
  for (int r = rounds - 1; r >= 0; --r) {
    sm.flipfin[r][p] = sm.flips[r][s];
    s = sm.perms[r][s];
  }
}

// Philox4x32-10 (Salmon et al., SC'11) of counter c under key (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// XOR / sum of one value per thread over the block; every thread gets it.
__device__ unsigned block_xor(unsigned v, Small& sm, int lane, int warp) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v ^= __shfl_xor_sync(kFull, v, off);
  if (lane == 0) sm.red[warp] = v;
  __syncthreads();
  unsigned r = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r ^= sm.red[w];
  __syncthreads();
  return r;
}

__device__ int block_sum(int v, Small& sm, int lane, int warp) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if (lane == 0) sm.red[warp] = (unsigned)v;
  __syncthreads();
  int r = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r += (int)sm.red[w];
  __syncthreads();
  return r;
}

// The Monte-Carlo prologue of codeword b = blockIdx.x: data bits, CRC,
// encode, BPSK-AWGN, LLRs into chan[N]; the transmitted u into ut[N]. xb
// (N bytes) is scratch. Every thread of the block.
__device__ void mc_prologue(const SclArgs& a, float* chan, unsigned char* ut,
                            unsigned char* xb, Small& sm, int tid, int lane,
                            int warp) {
  const int N = a.N, K = a.K, nh = a.N >> 1;
  const unsigned b = blockIdx.x;
  unsigned* words = reinterpret_cast<unsigned*>(chan);
  // word w = output w % 4 of counter (w / 4, b, 0, 0): words [0, N) give
  // the data bits (least significant bit), [N, 2N) the uniforms u1, u2
  for (int i = tid; i < nh; i += kThreads) {
    const uint4 r = philox4x32_10(make_uint4((unsigned)i, b, 0u, 0u),
                                  a.seed0, a.seed1);
    const unsigned o[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int w = 4 * i + k;
      if (w < N) {
        const int slot = a.pidx[w];
        ut[w] = (slot >= 0 && slot < K) ? (unsigned char)(o[k] & 1u) : 0;
      } else {
        words[w - N] = o[k];
      }
    }
  }
  __syncthreads();
  // CRC rows: XOR of the generator masks of the set data bits
  if (a.W > 0) {
    unsigned acc = 0u;
    for (int t = tid; t < N; t += kThreads) {
      const int slot = a.pidx[t];
      if (slot >= 0 && slot < K && ut[t]) acc ^= a.gmask[slot];
    }
    acc = block_xor(acc, sm, lane, warp) ^ a.offmask;
    for (int t = tid; t < N; t += kThreads) {
      const int slot = a.pidx[t];
      if (slot >= K) ut[t] = (unsigned char)((acc >> (slot - K)) & 1u);
    }
    __syncthreads();
  }
  // x = u F^{(x)m}: log2 N stages of butterfly XORs
  for (int t = tid; t < N; t += kThreads) xb[t] = ut[t];
  __syncthreads();
  for (int h = nh; h >= 1; h >>= 1) {
    for (int e = tid; e < nh; e += kThreads) {
      const int i = (e / h) * 2 * h + (e % h);
      xb[i] ^= xb[i + h];
    }
    __syncthreads();
  }
  // llr = (2 / sigma^2) * ((1 - 2x) + sigma * gauss); Box-Muller rows
  // [0, N/2) take r cos(th), rows [N/2, N) r sin(th) of the same pair
  const float sg = a.sigma;
  const float scale = 2.f / (sg * sg);
  if (a.noise == nullptr) {
    for (int j = tid; j < nh; j += kThreads) {
      const float u1 = ((float)(words[j] >> 8) + 1.f) * kTwoM24;   // (0, 1]
      const float u2 = (float)(words[nh + j] >> 8) * kTwoM24;      // [0, 1)
      const float r = sqrtf(-2.f * logf(u1));
      const float th = kTwoPi * u2;
      const float g0 = r * cosf(th);
      const float g1 = r * sinf(th);
      chan[j] = scale * ((1.f - 2.f * (float)xb[j]) + sg * g0);
      chan[nh + j] = scale * ((1.f - 2.f * (float)xb[nh + j]) + sg * g1);
    }
  } else {
    const float* g = a.noise + (size_t)b * N;
    for (int t = tid; t < N; t += kThreads)
      chan[t] = scale * ((1.f - 2.f * (float)xb[t]) + sg * g[t]);
  }
  __syncthreads();
}

template <int SRC, int OUT>
__device__ __forceinline__ void scl_body(const SclArgs& a) {
  static_assert(OUT != kCounters || SRC == kMonteCarlo,
                "counting errors needs the transmitted u");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Small sm;
  const int N = a.N, m = a.m, P = a.P, Q = a.Q, K = a.K, W = a.W;
  float* lam = reinterpret_cast<float*>(smem);
  float* chan = lam + P * (N - 1);                      // kMonteCarlo only
  unsigned char* dec =
      reinterpret_cast<unsigned char*>(chan + (SRC == kMonteCarlo ? N : 0));
  unsigned char* traj = dec + 2 * P * (N - 1);
  unsigned char* tperm = traj + N * P;
  unsigned char* sidx = tperm + Q * P;
  unsigned char* maps = sidx + Q * P;
  unsigned char* ut = maps + 3 * m * P;                 // kMonteCarlo only
  const int n_maps = 3 * m * P;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* x;
  if constexpr (SRC == kMonteCarlo) {
    mc_prologue(a, chan, ut, traj, sm, tid, lane, warp);   // traj: scratch
    x = chan;
  } else {
    x = a.llr + (size_t)blockIdx.x * N;
  }

  // stage s (1..m): block n_s = N >> s; buffers for stages < s come first
  auto lam_at = [&](int s) { return lam + P * (N - 2 * (N >> s)); };
  auto dec_at = [&](int s, int c) {
    return dec + 2 * P * (N - 2 * (N >> s)) + c * P * (N >> s);
  };
  auto rlam = [&](int s) { return maps + 3 * (s - 1) * P; };
  auto rdec_base = [&](int s, int c) { return (3 * (s - 1) + 1 + c) * P; };

  for (int i = tid; i < n_maps; i += kThreads) maps[i] = (unsigned char)(i % P);
  if (tid < P) sm.pm[tid] = (tid == 0) ? 0.f : kBig;
  __syncthreads();

  int q = 0;   // trajectory span of the next node op
  for (int o = 0; o < a.n_ops; ++o) {
    const int4 op = a.ops[o];
    const int kind = op.x, lvl = op.y, t0 = op.z, child = op.w;
    const int ln = m - lvl;
    const int n = 1 << ln;

    if (kind == DOWN_FRESH || kind == DOWN_DYN) {
      const int s = lvl;
      float* out = lam_at(s);
      const float* par = (s > 1) ? lam_at(s - 1) : nullptr;
      const unsigned char* rl = (s > 1) ? rlam(s - 1) : nullptr;
      const unsigned char* d0 = dec_at(s, 0);
      const unsigned char* rd0 = maps + rdec_base(s, 0);
      for (int e = tid; e < P * n; e += kThreads) {
        const int p = e >> ln, j = e & (n - 1);
        float a, b;
        if (s == 1) {
          a = x[j];
          b = x[j + n];
        } else {
          const float* row = par + rl[p] * 2 * n;
          a = row[j];
          b = row[j + n];
        }
        float v;
        if (kind == DOWN_FRESH) {
          const float sg = ((a < 0.f) != (b < 0.f)) ? -1.f : 1.f;
          v = sg * fminf(fabsf(a), fabsf(b));
        } else {
          const float d = (float)d0[rd0[p] * n + j];
          v = a * (1.f - 2.f * d) + b;
        }
        out[p * n + j] = v;
      }
      if (tid < P) rlam(s)[tid] = (unsigned char)tid;
      __syncthreads();
      continue;
    }

    if (kind == UP) {
      const int s = lvl;
      const unsigned char* d0 = dec_at(s, 0);
      const unsigned char* d1 = dec_at(s, 1);
      const unsigned char* rd0 = maps + rdec_base(s, 0);
      const unsigned char* rd1 = maps + rdec_base(s, 1);
      unsigned char* dst = dec_at(s - 1, child);
      for (int e = tid; e < P * n; e += kThreads) {
        const int p = e >> ln, j = e & (n - 1);
        const unsigned char b0 = d0[rd0[p] * n + j];
        const unsigned char b1 = d1[rd1[p] * n + j];
        dst[p * 2 * n + j] = b0 ^ b1;
        dst[p * 2 * n + n + j] = b1;
      }
      if (tid < P) maps[rdec_base(s - 1, child) + tid] = (unsigned char)tid;
      __syncthreads();
      continue;
    }

    // ---- node ops at depth d = lvl: input lam_at(d) at identity slots ----
    const int d = lvl;
    const float* L = lam_at(d);
    unsigned char* D = dec_at(d, child);
    const int reset = rdec_base(d, child);

    if (kind == R0) {
      if (warp < P) {
        const float sum = warp_tree_sum(L + warp * n, n, 0, lane);
        if (lane == 0) sm.pm[warp] = sm.pm[warp] + sum;
      }
      for (int e = tid; e < P * n; e += kThreads) {
        const int p = e >> ln, j = e & (n - 1);
        D[e] = 0;
        traj[(t0 + j) * P + p] = 0;
      }
      if (tid < P) {
        tperm[q * P + tid] = (unsigned char)tid;
        maps[reset + tid] = (unsigned char)tid;
      }
      ++q;
      __syncthreads();
      continue;
    }

    if (kind == REP || kind == LEAF || kind == LEAF_FROZEN) {
      if (kind == REP) {
        if (warp < P) {
          const float a = warp_tree_sum(L + warp * n, n, 0, lane);
          const float b = warp_tree_sum(L + warp * n, n, 1, lane);
          if (lane == 0) { sm.s0[warp] = a; sm.s1[warp] = b; }
        }
      } else if (tid < P) {
        sm.s0[tid] = fmaxf(-L[tid], 0.f);
        sm.s1[tid] = fmaxf(L[tid], 0.f);
      }
      __syncthreads();
      if (warp == 0) {
        if (kind == LEAF_FROZEN || P == 1) {
          if (lane < P) {
            const float a = sm.s0[lane], b = sm.s1[lane];
            int bit = 0;
            if (kind == REP) bit = b < a;
            else if (kind == LEAF) bit = L[lane] < 0.f;
            sm.pm[lane] = sm.pm[lane] + (bit ? b : a);
            sm.bit[lane] = (unsigned char)bit;
            sm.nmap[lane] = (unsigned char)lane;
          }
        } else {
          const float pmv = lane < P ? sm.pm[lane] : 0.f;
          const float a = lane < P ? sm.s0[lane] : 0.f;
          const float b = lane < P ? sm.s1[lane] : 0.f;
          float npm; int nperm, nbit;
          fork2(lane, P, pmv, a, b, npm, nperm, nbit);
          if (lane < P) {
            sm.pm[lane] = npm;
            sm.nmap[lane] = (unsigned char)nperm;
            sm.bit[lane] = (unsigned char)nbit;
          }
        }
      }
      __syncthreads();
      apply_perm(maps, n_maps, sm.nmap, P, reset, tid);
      for (int e = tid; e < P * n; e += kThreads) {
        const int p = e >> ln, j = e & (n - 1);
        const unsigned char bit = sm.bit[p];
        D[e] = bit;
        traj[(t0 + j) * P + p] = (j == n - 1) ? bit : 0;
      }
      if (tid < P) tperm[q * P + tid] = sm.nmap[tid];
      ++q;
      __syncthreads();
      continue;
    }

    // ---- R1 / SPC: least-reliable keep/flip forks (Fast-SSCL) ----
    const bool spc = (kind == SPC);
    const int rounds = spc ? (P == 1 ? 0 : min(P, n - 1)) : min(P - 1, n);
    const int n_min = spc ? rounds + 1 : rounds;
    if (warp < P) {
      const float* v = L + warp * n;
      warp_extract(v, n, n_min, lane, sm, warp);
      if (spc) {
        int par = 0;
        for (int j = lane; j < n; j += 32) par ^= (v[j] < 0.f);
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
          par ^= __shfl_xor_sync(kFull, par, off);
        if (lane == 0) sm.bit[warp] = (unsigned char)par;
      }
    }
    __syncthreads();
    if (warp == 0) {
      int nm = lane < P ? lane : 0;
      float pmv = lane < P ? sm.pm[lane] : 0.f;
      int eta = 0;
      if (spc && lane < P) {
        eta = sm.bit[lane];
        pmv = pmv + (float)eta * sm.vals[0][lane];     // mandatory parity fix
      }
      const int first = spc ? 1 : 0;
      for (int r = 0; r < rounds; ++r) {
        float pen = 0.f;
        if (lane < P) {
          pen = sm.vals[r + first][nm];
          if (spc) pen = pen + (1.f - 2.f * (float)eta) * sm.vals[0][nm];
        }
        float npm; int nperm, nbit;
        fork2(lane, P, pmv, 0.f, pen, npm, nperm, nbit);
        nm = __shfl_sync(kFull, nm, nperm);
        eta = __shfl_sync(kFull, eta, nperm) ^ nbit;
        pmv = npm;
        if (lane < P) {
          sm.perms[r][lane] = (unsigned char)nperm;
          sm.flips[r][lane] = (unsigned char)nbit;
        }
      }
      __syncwarp();
      if (lane < P) {
        defer_flips(sm, rounds, lane);
        sm.pm[lane] = pmv;
        sm.nmap[lane] = (unsigned char)nm;
        sm.bit[lane] = (unsigned char)eta;
        tperm[q * P + lane] = (unsigned char)nm;
      }
    }
    __syncthreads();
    for (int e = tid; e < P * n; e += kThreads) {
      const int p = e >> ln, j = e & (n - 1);
      const int src = sm.nmap[p];
      unsigned char xb = L[src * n + j] < 0.f;
      if (spc && sm.poss[0][src] == j) xb ^= sm.bit[p];
      const int first = spc ? 1 : 0;
      for (int r = 0; r < rounds; ++r)
        if (sm.poss[r + first][src] == j) xb ^= sm.flipfin[r][p];
      D[e] = xb;
      traj[(t0 + j) * P + p] = xb;
    }
    apply_perm(maps, n_maps, sm.nmap, P, reset, tid);
    // u = x F^{(x)k}: in-place butterflies over the span's trajectory rows
    for (int h = n >> 1; h >= 1; h >>= 1) {
      for (int e = tid; e < P * (n >> 1); e += kThreads) {
        const int p = e / (n >> 1), k = e % (n >> 1);
        const int i = (k / h) * 2 * h + (k % h);
        traj[(t0 + i) * P + p] ^= traj[(t0 + i + h) * P + p];
      }
      __syncthreads();
    }
    ++q;
  }

  const size_t b = blockIdx.x;
  if constexpr (OUT == kTrajectory) {
    // the genealogy, [B, ...]-major: one contiguous run per codeword
    uint8_t* tb = a.traj_bit + b * N * P;
    for (int i = tid; i < N * P; i += kThreads) tb[i] = traj[i];
    uint8_t* tp = a.traj_perm + b * Q * P;
    for (int i = tid; i < Q * P; i += kThreads) tp[i] = tperm[i];
    if (tid < P) a.pm[b * P + tid] = sm.pm[tid];
    if constexpr (SRC == kMonteCarlo) {
      int8_t* u = a.u_true + b * N;
      for (int t = tid; t < N; t += kThreads) u[t] = (int8_t)ut[t];
    }
    return;
  }

  // ---- epilogue: suffix maps, CRC per path, first-index argmin ----
  if (tid < P) {
    int s = tid;
    for (int qq = Q - 1; qq >= 0; --qq) {
      sidx[qq * P + tid] = (unsigned char)s;
      s = tperm[qq * P + s];
    }
  }
  __syncthreads();
  if (warp < P) {
    unsigned acc = 0u, rec = 0u;
    if (W > 0) {
      for (int t = lane; t < N; t += 32) {
        const int k = a.pidx[t];
        if (k < 0) continue;
        const unsigned bit = traj[t * P + sidx[a.qrow[t] * P + warp]];
        if (k < K) acc ^= bit ? a.gmask[k] : 0u;
        else rec |= bit << (k - K);
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        acc ^= __shfl_xor_sync(kFull, acc, off);
        rec |= __shfl_xor_sync(kFull, rec, off);
      }
    }
    if (lane == 0) sm.ok[warp] = (W == 0 || (acc ^ a.offmask) == rec) ? 1.f : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int best = 0;
    float bs = sm.pm[0] + kBig * (1.f - sm.ok[0]);
    for (int p = 1; p < P; ++p) {
      const float sc = sm.pm[p] + kBig * (1.f - sm.ok[p]);
      if (sc < bs) { bs = sc; best = p; }
    }
    sm.best = best;
    if constexpr (OUT == kSelect) {
      a.pm[b] = sm.pm[best];
      a.ok[b] = sm.ok[best] > 0.5f;
    }
  }
  __syncthreads();
  const int best = sm.best;
  if constexpr (OUT == kSelect) {
    int8_t* u = a.u + b * N;
    for (int t = tid; t < N; t += kThreads)
      u[t] = (int8_t)traj[t * P + sidx[a.qrow[t] * P + best]];
  } else {
    // errors of the best path on the data rows (CRC rows do not count)
    int err = 0;
    for (int t = tid; t < N; t += kThreads) {
      const int k = a.pidx[t];
      if (k < 0 || k >= K) continue;
      err += traj[t * P + sidx[a.qrow[t] * P + best]] != ut[t];
    }
    err = block_sum(err, sm, lane, warp);
    if (tid == 0) {
      a.counters[b] = err > 0;
      a.counters[a.B + b] = err;
    }
  }
}

// min 3 blocks an SM: ca_scl's ~64 KB of shared memory a block allows 3
__global__ void __launch_bounds__(kThreads, 3) scl_decode(SclArgs a) {
  scl_body<kLlrIn, kSelect>(a);
}
__global__ void __launch_bounds__(kThreads, 3) scl_decode_traj(SclArgs a) {
  scl_body<kLlrIn, kTrajectory>(a);
}
__global__ void __launch_bounds__(kThreads, 3) scl_mc_traj(SclArgs a) {
  scl_body<kMonteCarlo, kTrajectory>(a);
}
__global__ void __launch_bounds__(kThreads, 3) scl_mc_counters(SclArgs a) {
  scl_body<kMonteCarlo, kCounters>(a);
}

}  // namespace

extern "C" {

// kernel: 0 scl_decode, 1 scl_decode_traj, 2 scl_mc_traj, 3 scl_mc_counters
size_t scl_smem_bytes(int kernel, int N, int m, int P, int Q) {
  return (size_t)4 * P * (N - 1) + (size_t)2 * P * (N - 1) + (size_t)N * P
         + (size_t)2 * Q * P + (size_t)3 * m * P
         + (kernel >= 2 ? (size_t)5 * N : 0);
}

int scl_launch(int kernel, const SclArgs* a, void* stream) {
  static void (*const fns[4])(SclArgs) = {scl_decode, scl_decode_traj,
                                          scl_mc_traj, scl_mc_counters};
  if (kernel < 0 || kernel > 3 || a->P < 1 || a->P > kMaxP || a->W > 32
      || a->B < 1 || a->N < 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = scl_smem_bytes(kernel, a->N, a->m, a->P, a->Q);
  cudaError_t err = cudaFuncSetAttribute(
      fns[kernel], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fns[kernel]<<<a->B, kThreads, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int scl_args_bytes(void) { return (int)sizeof(SclArgs); }

int scl_decode_max_smem_bytes(void) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)
      != cudaSuccess) return -1;
  return v;
}

}  // extern "C"
