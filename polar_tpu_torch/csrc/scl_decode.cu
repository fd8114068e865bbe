// CA-SCL decode of polar codes (Arikan and eBCH kernels), one thread
// block per codeword, and
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
//                    mc=True, counters=True);
//   scl_subtree      one depth-1 child of a code decoded on its own (K3,
//                    `core_sub`, subtree=True), for codes whose state does
//                    not fit a block (mixed_scl32: ~330 KB a codeword):
//                    path-bound input block [P, N] and metrics in; span
//                    bits, span perms, the net survival map, the root
//                    re-encode and the metrics out (ops/scl.py
//                    build_plain_subtree states the contract).
//
// Two bodies. K1, K2, K4 and K5 of Arikan specs (2x2 kernels only) at
// P <= 8 run `fast_body`, the body redesigned for Hopper (128 threads a
// codeword, packed bits, rank forks, warp-0 ops; its note below); every
// other instance runs the general body `scl_body` (256 threads), whose
// design the rest of this note describes. `arikan8` is the rule.
//
// List capacity: every kernel has an instance for P <= 8 and one for
// P <= 32 (template CAP), chosen at launch. Capacity 8 ranks the 2P fork
// candidates one a lane and keeps the R1/SPC minima's positions in
// registers; capacity 32 ranks two candidates a lane (c = lane, lane + 32)
// and reads the positions back from shared memory, with a ~10 KB `Small`.
//
// The subtree kernel's stage-1 DOWNs read row netmap[p] of the input
// block: netmap, one more P-byte map after the stage maps, starts as the
// identity and every fork composes it like the others (the regression
// tests/test_subtree.py pins for the JAX kernel). One compiled instance
// serves every child: the op program is a device table. What bounds it:
// operations. A mixed_scl32 child (16x16 eBCH over four 2x2 stages,
// N = 256, L = 32) moves ~57 KB a codeword but needs ~71 M element
// operations, most of them in its 16 stage-1 DOWN ops (tail tables of up
// to 1,024 codewords for 512 path-positions); the body spreads each DOWN
// over the block as above, and the state (~24 KB) stays in shared memory.
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
// - Tal-Vardy lazy copies: a fork permutes the (1 + l_s)*P bytes a stage
//   of path->slot maps, never the buffers; a write resets its buffer's map.
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
//
// Kernels of size l > 2 (eBCH 4x4 .. 16x16, mixed specs such as bch_sc,
// N = 16 x 16): a second instance of each kernel (template flag BIG)
// adds the l > 2 branch of pallas_scl.py (`down_big` :847-935, the l > 2
// `up` :985-1005, the non-2 `apply_inverse` :1007-1040 and the stagewise
// Kronecker encode :505-523); Arikan specs keep the instances without it.
// The buffers follow a per-stage table (StageTab: n_s, offsets, path-map
// base, the kernel's columns and its inputs' trellis tables), with l_s
// decision children and 1 + l_s path maps a stage. An l > 2 DOWN op's
// work is not its P*n positions alone (n = 1 at bch_sc's second stage) but
// the trellis states or the up to 1,024 tail codewords of each: the body
// gives each position a group of lanes (csrc/big_stage.cuh), up to the
// whole block, and reduces the maxima across it. UP is x_k = XOR_j u_j
// K[j,k]; the R1/SPC inverse and the prologue's encode run stage by stage
// with the kernels' (inverse) columns as bit masks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "big_stage.cuh"

using bigstage::BigKernel;

// One stage s of the code (entry 0: the whole code, depth 0);
// ops/cuda_scl.py `StageTab` mirrors this layout.
struct StageTab {
  int n;                     // n_s: block size below the stage
  int loff;                  // its LLR buffer: float offset
  int doff;                  // its decision buffers (l_s children): byte offset
  int mbase;                 // its path maps (rlam, then l_s rdec): byte offset
  int arikan_below;          // every kernel of stages > s is 2x2
  unsigned short icol[16];   // column k of K_s^-1: bit j = Kinv[j, k]
  BigKernel k;               // K_s (l = 0 in entry 0)
};

// Kernel arguments; ops/cuda_scl.py `SclArgs` mirrors this layout. Outside
// the anonymous namespace: the extern "C" entry points take it.
struct SclArgs {
  const float* llr;          // [B, N] channel LLRs (kLlrIn); [B, P, N] (kPathBound)
  const float* noise;        // [B, N] standard normals, or null (kMonteCarlo)
  const int4* ops;           // [n_ops] kind, level, t0, child
  const short* qrow;         // [N] trajectory span of each u row
  const short* pidx;         // [N] payload slot of each row, -1 frozen
  const unsigned* gmask;     // [K] CRC generator row masks
  const StageTab* st;        // [m + 1] stage tables
  int8_t* u;                 // [B, N] best path's u (kSelect)
  float* pm;                 // [B] best metric (kSelect); [B, P] (kTrajectory)
  uint8_t* ok;               // [B] best path's CRC pass (kSelect)
  uint8_t* traj_bit;         // [B, N, P] trajectory bits (kTrajectory)
  uint8_t* traj_perm;        // [B, Q, P] span survival perms (kTrajectory)
  int8_t* u_true;            // [B, N] transmitted u (kMonteCarlo, kTrajectory)
  int* counters;             // [2, B] frame error, bit errors (kCounters)
  const float* pm_in;        // [B, P] path metrics at entry (kPathBound)
  uint8_t* netp;             // [B, P] net survival permutation (kSubtree)
  uint8_t* xblk;             // [B, P, N] root re-encode (kSubtree)
  unsigned offmask;          // CRC offset mask
  unsigned seed0, seed1;     // Philox key (kMonteCarlo)
  float sigma;               // channel noise deviation (kMonteCarlo)
  int n_ops, N, m, P, Q, K, W, B;
  int n_lam, n_dec, n_maps;  // LLR floats, decision bytes, path-map bytes
  int big;                   // 1: some kernel is l > 2 (the BIG instances)
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 17;          // m <= 16: N <= 65536 for 2x2 kernels
constexpr float kBig = 1e30f;
constexpr float kTwoPi = 6.28318530717958647692f;   // float32(2 pi)
constexpr float kTwoM24 = 5.9604644775390625e-08f;  // 2^-24
constexpr unsigned kFull = 0xffffffffu;

enum OpKind {
  DOWN_FRESH = 0, DOWN_DYN = 1, UP = 2, R0 = 3, REP = 4, R1 = 5, SPC = 6,
  LEAF = 7, LEAF_FROZEN = 8
};

// where the channel LLRs come from / what the kernel writes
enum Source { kLlrIn = 0, kMonteCarlo = 1, kPathBound = 2 };
enum Output { kSelect = 0, kTrajectory = 1, kCounters = 2, kSubtree = 3 };

// ---- op-kind clock: the SCL_CLOCK build only (ops/cuda_scl.py
// `clock_build`, sim/kernel_times.py --split) ----
// Thread 0 of each of the first kClockBlocks blocks adds the clock64()
// cycles since its last mark to the slot of the work that just ended; the
// marks sit after the barriers that end each part, so a slot holds thread
// 0's view of the block's time there (its own work and its wait for the
// others). ops/cuda_scl.py CLOCK_SLOTS names the slots in this order.
// kClkDown is the 2x2 f/g DOWN; an l > 2 DOWN (`big_down`) goes to the
// slot of its input's method: the last input's single correlation, the
// syndrome trellis or the tail table.
enum ClockSlot {
  kClkSetup = 0, kClkPrologue, kClkDown, kClkUp, kClkR0, kClkRepSums,
  kClkRepFork, kClkSelect, kClkChain, kClkDecide, kClkPerm, kClkInverse,
  kClkBigLast, kClkBigTrellis, kClkBigTable, kClkEpilogue, kClkSlots
};
#ifdef SCL_CLOCK
constexpr int kClockBlocks = 128;
__device__ unsigned long long g_clock[kClkSlots + 1];   // + blocks measured
__shared__ unsigned long long clk_acc[kClkSlots];
__shared__ long long clk_last;
__device__ __forceinline__ void clk_begin() {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kClkSlots; ++i) clk_acc[i] = 0ull;
    clk_last = clock64();
  }
}
__device__ __forceinline__ void clk_mark(int slot) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    clk_acc[slot] += (unsigned long long)(now - clk_last);
    clk_last = now;
  }
}
__device__ __forceinline__ void clk_end() {
  clk_mark(kClkEpilogue);
  if (threadIdx.x == 0 && blockIdx.x < kClockBlocks) {
    for (int i = 0; i < kClkSlots; ++i) atomicAdd(&g_clock[i], clk_acc[i]);
    atomicAdd(&g_clock[kClkSlots], 1ull);
  }
}
#else
__device__ __forceinline__ void clk_begin() {}
__device__ __forceinline__ void clk_mark(int) {}
__device__ __forceinline__ void clk_end() {}
#endif

// Path maps a thread of apply_perm holds: the maps of a list capacity CAP
// (the instances of capacity 8 and 32) are <= this many times kThreads
// bytes.
__host__ __device__ constexpr int maps_per_thread(int cap) {
  return cap <= 8 ? 2 : 8;
}

// The node-local state of a list capacity CAP (P <= CAP).
template <int CAP>
struct Small {
  static constexpr int kRounds = CAP + 1;   // SPC extracts up to P + 1 minima
  float pm[CAP];
  float vals[kRounds][CAP];        // least-reliable |llr| per round, path
  float s0[CAP], s1[CAP];          // REP sums
  float ok[CAP];                   // CRC pass per path (0/1)
  short poss[kRounds][CAP];        // their positions
  unsigned char nmap[CAP];         // node-local path map / fork perm
  unsigned char bit[CAP];          // fork bit / parity / eta
  unsigned char perms[CAP][CAP];
  unsigned char flips[CAP][CAP];
  unsigned char flipfin[CAP][CAP];
  unsigned red[kWarps];            // block reductions
  float redf[kWarps][2];           // l > 2 table maxima across warps
  int4 stage[kMaxStages];          // n, loff, doff, mbase of each stage
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
// Capacity 8 keeps the chosen positions in registers (the rounds
// unrolled), capacity 32 reads them back from sm.poss.
template <int CAP>
__device__ void warp_extract(const float* v, int n, int count, int lane,
                             Small<CAP>& sm, int p) {
  constexpr int kRounds = Small<CAP>::kRounds;
  auto pick = [&](float& bv, int& bi) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ov < bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
  };
  if constexpr (CAP <= 8) {
    int chosen[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (r < count) {
        float bv = __int_as_float(0x7f800000);   // +inf
        int bi = 0x7fffffff;
        for (int j = lane; j < n; j += 32) {
          float val = fabsf(v[j]);
#pragma unroll
          for (int c = 0; c < kRounds; ++c)
            if (c < r && chosen[c] == j) val = kBig;
          if (val < bv) { bv = val; bi = j; }
        }
        pick(bv, bi);
        chosen[r] = bi;
        if (lane == 0) { sm.vals[r][p] = bv; sm.poss[r][p] = (short)bi; }
      }
    }
  } else {
    for (int r = 0; r < count; ++r) {
      float bv = __int_as_float(0x7f800000);   // +inf
      int bi = 0x7fffffff;
      for (int j = lane; j < n; j += 32) {
        float val = fabsf(v[j]);
        for (int c = 0; c < r; ++c)
          if (sm.poss[c][p] == j) val = kBig;
        if (val < bv) { bv = val; bi = j; }
      }
      pick(bv, bi);
      if (lane == 0) { sm.vals[r][p] = bv; sm.poss[r][p] = (short)bi; }
      __syncwarp();
    }
  }
}

// 2P -> P fork, warp 0, all 32 lanes. Lane p < P holds path p's metric and
// penalties. Lane r < P gets survivor r: metric, parent path, bit.
// Candidate c = bit * P + p ranks by (metric, c); capacity 8 holds one
// candidate a lane (2P <= 16), capacity 32 two (c = lane, lane + 32).
template <int CAP>
__device__ void fork2(int lane, int P, float pm_p, float pen0_p, float pen1_p,
                      float& npm, int& nperm, int& nbit) {
  if constexpr (CAP <= 8) {
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
  } else {
    const float vpm = __shfl_sync(kFull, pm_p, lane % P);
    const float v0 = __shfl_sync(kFull, pen0_p, lane % P);
    const float v1 = __shfl_sync(kFull, pen1_p, lane % P);
    // the candidate c = lane + 32 is path (lane + 32) % P
    const int p_hi = (lane + 32) % P;
    const float wpm = __shfl_sync(kFull, pm_p, p_hi);
    const float w0 = __shfl_sync(kFull, pen0_p, p_hi);
    const float w1 = __shfl_sync(kFull, pen1_p, p_hi);
    const float cand_lo = (lane / P) ? (vpm + v1) : (vpm + v0);
    const float cand_hi = ((lane + 32) / P) ? (wpm + w1) : (wpm + w0);
    int rank_lo = 0, rank_hi = 0;
    for (int c2 = 0; c2 < 2 * P; ++c2) {
      // c2 < 32 lives in cand_lo, c2 >= 32 in cand_hi (warp-uniform)
      const float o = __shfl_sync(kFull, c2 < 32 ? cand_lo : cand_hi, c2 & 31);
      rank_lo += (o < cand_lo) || (o == cand_lo && c2 < lane);
      rank_hi += (o < cand_hi) || (o == cand_hi && c2 < lane + 32);
    }
    // not a candidate: a rank no lane has
    if (lane >= 2 * P) rank_lo = 1 << 20;
    if (lane + 32 >= 2 * P) rank_hi = 1 << 20;
    npm = 0.f; nperm = 0; nbit = 0;
    for (int c2 = 0; c2 < 2 * P; ++c2) {
      const int rk = __shfl_sync(kFull, c2 < 32 ? rank_lo : rank_hi, c2 & 31);
      const float o = __shfl_sync(kFull, c2 < 32 ? cand_lo : cand_hi, c2 & 31);
      if (rk == lane) { npm = o; nperm = c2 % P; nbit = c2 / P; }
    }
  }
}

// maps[i] = old maps[base(i) + perm[p]] for every map, except the map at
// reset_base, which becomes the identity. Every thread of the block.
template <int CAP>
__device__ void apply_perm(unsigned char* maps, int total, const unsigned char* perm,
                           int P, int reset_base, int tid) {
  constexpr int kPer = maps_per_thread(CAP);
  unsigned char v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kThreads;
    if (i < total) {
      const int p = i % P;
      const int base = i - p;
      v[k] = (base == reset_base) ? (unsigned char)p : maps[base + perm[p]];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kThreads;
    if (i < total) maps[i] = v[k];
  }
  __syncthreads();
}

// Bits b[0..l) at stride `stride` from `x`, as a mask.
__device__ __forceinline__ unsigned gather_bits(const unsigned char* x, int l,
                                                int stride) {
  unsigned mask = 0u;
  for (int j = 0; j < l; ++j) mask |= (unsigned)(x[j * stride] & 1u) << j;
  return mask;
}

// One stage of a Kronecker transform over GF(2) in place: x [pre, l, post]
// (element (a, j, c) at a*l*post + j*post + c, stride `stride` bytes) ->
// x'_k = XOR_j x_j T[j, k], column k of T given as bit masks over j, for
// each of `paths` interleaved vectors (path p at byte offset p). Each
// thread takes whole columns (p, a, c) of l values, so in place is safe.
__device__ void kron_stage(unsigned char* x, int stride, int pre, int l,
                           int post, int paths, const unsigned short* tcol,
                           int tid) {
  const int units = pre * post * paths;
  for (int w = tid; w < units; w += kThreads) {
    const int p = w % paths;
    const int ac = w / paths;
    const int a = ac / post, c = ac % post;
    unsigned char* base = x + ((a * l * post + c) * stride + p);
    const unsigned mask = gather_bits(base, l, post * stride);
    for (int k = 0; k < l; ++k)
      base[k * post * stride] = (unsigned char)(__popc(mask & tcol[k]) & 1u);
  }
  __syncthreads();
}

// The suffix-composed flips of `rounds` forks, recorded in sm.perms /
// sm.flips, in final path indexing (lane p < P).
template <class SM>
__device__ void defer_flips(SM& sm, int rounds, int p) {
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

// XOR / sum of one value per thread over a block of T threads; every
// thread gets it.
template <int T, class SM>
__device__ unsigned block_xor(unsigned v, SM& sm, int lane, int warp) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v ^= __shfl_xor_sync(kFull, v, off);
  if (lane == 0) sm.red[warp] = v;
  __syncthreads();
  unsigned r = 0u;
#pragma unroll
  for (int w = 0; w < T / 32; ++w) r ^= sm.red[w];
  __syncthreads();
  return r;
}

template <int T, class SM>
__device__ int block_sum(int v, SM& sm, int lane, int warp) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if (lane == 0) sm.red[warp] = (unsigned)v;
  __syncthreads();
  int r = 0;
#pragma unroll
  for (int w = 0; w < T / 32; ++w) r += (int)sm.red[w];
  __syncthreads();
  return r;
}

// The Monte-Carlo prologue of codeword b = blockIdx.x: data bits, CRC,
// encode, BPSK-AWGN, LLRs into chan[N]; the transmitted u into ut[N]. xb
// (N bytes) is scratch. Every thread of the block (T threads).
template <bool BIG, int T, class SM>
__device__ void mc_prologue(const SclArgs& a, float* chan, unsigned char* ut,
                            unsigned char* xb, SM& sm, int tid, int lane,
                            int warp) {
  static_assert(!BIG || T == kThreads, "kron_stage strides by kThreads");
  const int N = a.N, K = a.K, nh = a.N >> 1;
  const unsigned b = blockIdx.x;
  unsigned* words = reinterpret_cast<unsigned*>(chan);
  // word w = output w % 4 of counter (w / 4, b, 0, 0): words [0, N) give
  // the data bits (least significant bit), [N, 2N) the uniforms u1, u2
  for (int i = tid; i < nh; i += T) {
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
    for (int t = tid; t < N; t += T) {
      const int slot = a.pidx[t];
      if (slot >= 0 && slot < K && ut[t]) acc ^= a.gmask[slot];
    }
    acc = block_xor<T>(acc, sm, lane, warp) ^ a.offmask;
    for (int t = tid; t < N; t += T) {
      const int slot = a.pidx[t];
      if (slot >= K) ut[t] = (unsigned char)((acc >> (slot - K)) & 1u);
    }
    __syncthreads();
  }
  for (int t = tid; t < N; t += T) xb[t] = ut[t];
  __syncthreads();
  if (!BIG || a.st[0].arikan_below) {
    // x = u F^{(x)m}: log2 N stages of butterfly XORs
    for (int h = nh; h >= 1; h >>= 1) {
      for (int e = tid; e < nh; e += T) {
        const int i = (e / h) * 2 * h + (e % h);
        xb[i] ^= xb[i + h];
      }
      __syncthreads();
    }
  } else {
    // x = u (K_1 (x) ... (x) K_m): one Kronecker stage per kernel
    for (int s = 1; s <= a.m; ++s) {
      const StageTab& st = a.st[s];
      const int l = st.k.l;
      kron_stage(xb, 1, N / (l * st.n), l, st.n, 1, st.k.kcol, tid);
    }
  }
  // llr = (2 / sigma^2) * ((1 - 2x) + sigma * gauss); Box-Muller rows
  // [0, N/2) take r cos(th), rows [N/2, N) r sin(th) of the same pair
  const float sg = a.sigma;
  const float scale = 2.f / (sg * sg);
  if (a.noise == nullptr) {
    for (int j = tid; j < nh; j += T) {
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
    for (int t = tid; t < N; t += T)
      chan[t] = scale * ((1.f - 2.f * (float)xb[t]) + sg * g[t]);
  }
  __syncthreads();
}

// The coset-adjusted output LLRs v[k] (k < l) of position j of path p at an
// l > 2 stage: the parent row with its sign flipped where the prior
// children u_0..u_{i-1} (through their path maps) give coset bit 1.
__device__ __forceinline__ void big_view(const BigKernel& K, const float* row,
                                         int n, int j, int i,
                                         const unsigned char* dec0,
                                         const unsigned char* rd, int P, int p,
                                         float (&v)[bigstage::kMaxL]) {
  unsigned u = 0u;
  for (int c = 0; c < i; ++c)
    u |= (unsigned)dec0[c * P * n + rd[c * P + p] * n + j] << c;
#pragma unroll
  for (int k = 0; k < bigstage::kMaxL; ++k) {
    if (k < K.l) {
      const float x = row[k * n + j];
      v[k] = (__popc(u & K.kcol[k]) & 1u) ? -x : x;
    }
  }
}

// DOWN at an l > 2 stage: input i's LLR of every (path, position) into
// out[P, n]. The whole block; ends with a barrier.
__device__ void big_down(const BigKernel& K, int i, float* out,
                         const float* x, const float* par,
                         const unsigned char* rl, const unsigned char* dec0,
                         const unsigned char* rd, int P, int n,
                         float (*redf)[2], int tid, int lane, int warp) {
  const int l = K.l;
  const int E = P * n;
  auto row_of = [&](int p) { return par ? par + rl[p] * l * n : x; };
  float v[bigstage::kMaxL];
  if (i == l - 1) {
    for (int e = tid; e < E; e += kThreads) {
      const int p = e / n, j = e % n;
      big_view(K, row_of(p), n, j, i, dec0, rd, P, p, v);
      out[e] = bigstage::last_llr(K, v);
    }
    __syncthreads();
    return;
  }
  const int S = K.states[i];
  if (S) {
    // syndrome trellis: S lanes a position, warp-uniform rounds
    const int per = kThreads / S;
    for (int base = 0; base < E; base += per) {
      const int e0 = base + tid / S;
      const int e = e0 < E ? e0 : E - 1;
      const int p = e / n, j = e % n;
      big_view(K, row_of(p), n, j, i, dec0, rd, P, p, v);
      const float r = bigstage::trellis_llr(K, i, v, lane & (S - 1));
      if (e0 < E && (lane & (S - 1)) == 0) out[e] = r;
    }
    __syncthreads();
    return;
  }
  // tail table: G lanes a position share the columns it walks, up to the
  // whole block when there are few positions; at least a 16-lane group
  // where the quad tables pay (bigstage::table_max)
  const int walk = bigstage::table_walk(K, i);
  int G = bigstage::table_quads(K, i, 16) ? 16 : 1;
  while (G < kThreads && G < walk && E * G * 2 <= kThreads) G *= 2;
  const bool quads = bigstage::table_quads(K, i, G);
  const int per = kThreads / G;
  const int gw = G < 32 ? G : 32;            // lanes of the group in a warp
  for (int base = 0; base < E; base += per) {
    const int e0 = base + tid / G;
    const int e = e0 < E ? e0 : E - 1;
    const int p = e / n, j = e % n;
    const int g = tid % G;
    big_view(K, row_of(p), n, j, i, dec0, rd, P, p, v);
    float m0, m1;
    bigstage::table_max(K, i, v, g, G, walk, quads, m0, m1);
    m0 = bigstage::group_max(m0, gw);
    m1 = bigstage::group_max(m1, gw);
    if (G <= 32) {
      if (e0 < E && g == 0) out[e] = 0.5f * (m0 - m1);
    } else {
      if (lane == 0) { redf[warp][0] = m0; redf[warp][1] = m1; }
      __syncthreads();
      if (g == 0 && e0 < E) {
        for (int w = warp + 1; w < warp + G / 32; ++w) {
          m0 = fmaxf(m0, redf[w][0]);
          m1 = fmaxf(m1, redf[w][1]);
        }
        out[e] = 0.5f * (m0 - m1);
      }
      __syncthreads();
    }
  }
  __syncthreads();
}

template <int SRC, int OUT, bool BIG, int CAP>
__device__ __forceinline__ void scl_body(const SclArgs& a) {
  static_assert(OUT != kCounters || SRC == kMonteCarlo,
                "counting errors needs the transmitted u");
  static_assert((OUT == kSubtree) == (SRC == kPathBound),
                "a depth-1 child takes a path-bound input");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Small<CAP> sm;
  const int N = a.N, m = a.m, P = a.P, Q = a.Q, K = a.K, W = a.W;
  float* lam = reinterpret_cast<float*>(smem);
  float* chan = lam + a.n_lam;                           // kMonteCarlo only
  unsigned char* dec =
      reinterpret_cast<unsigned char*>(chan + (SRC == kMonteCarlo ? N : 0));
  unsigned char* traj = dec + a.n_dec;
  unsigned char* tperm = traj + N * P;
  unsigned char* sidx = tperm + Q * P;
  unsigned char* maps = sidx + Q * P;
  unsigned char* ut = maps + a.n_maps;                  // kMonteCarlo only
  // kPathBound: the net survival map (current path -> entry row of the
  // input block) follows the stage maps and is composed at every fork
  unsigned char* netmap = maps + a.n_maps;
  const int n_maps = a.n_maps + (SRC == kPathBound ? P : 0);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid <= m) {
    const StageTab& T = a.st[tid];
    sm.stage[tid] = make_int4(T.n, T.loff, T.doff, T.mbase);
  }
  const float* x;
  if constexpr (SRC == kMonteCarlo) {
    mc_prologue<BIG, kThreads>(a, chan, ut, traj, sm, tid, lane, warp);   // traj: scratch
    clk_mark(kClkPrologue);
    x = chan;
  } else if constexpr (SRC == kPathBound) {
    x = a.llr + (size_t)blockIdx.x * P * N;
  } else {
    x = a.llr + (size_t)blockIdx.x * N;
  }

  // stage s (1..m): block n_s, LLR buffer P*n_s, l_s decision children of
  // P*n_s, path maps rlam then rdec of each child (P bytes each)
  auto lam_at = [&](int s) { return lam + sm.stage[s].y; };
  auto dec_at = [&](int s, int c) {
    return dec + sm.stage[s].z + c * P * sm.stage[s].x;
  };
  auto rlam = [&](int s) { return maps + sm.stage[s].w; };
  auto rdec_base = [&](int s, int c) { return sm.stage[s].w + (1 + c) * P; };

  for (int i = tid; i < n_maps; i += kThreads) maps[i] = (unsigned char)(i % P);
  if (tid < P) {
    if constexpr (SRC == kPathBound) sm.pm[tid] = a.pm_in[blockIdx.x * P + tid];
    else sm.pm[tid] = (tid == 0) ? 0.f : kBig;
  }
  __syncthreads();
  clk_mark(kClkSetup);

  int q = 0;   // trajectory span of the next node op
  for (int o = 0; o < a.n_ops; ++o) {
    const int4 op = a.ops[o];
    const int kind = op.x, lvl = op.y, t0 = op.z, child = op.w;
    const int n = sm.stage[lvl].x;
    const int ln = __ffs(n) - 1;

    if (kind == DOWN_FRESH || kind == DOWN_DYN) {
      const int s = lvl;
      float* out = lam_at(s);
      // the parent block and its path map: the LLR buffer of stage s-1, or
      // at s = 1 the input block through the net map (kPathBound) or the
      // channel LLRs, the same on every path (par null)
      const float* par = (s > 1) ? lam_at(s - 1)
                                 : (SRC == kPathBound ? x : nullptr);
      const unsigned char* rl = (s > 1) ? rlam(s - 1)
                                        : (SRC == kPathBound ? netmap : nullptr);
      const unsigned char* d0 = dec_at(s, 0);
      const unsigned char* rd0 = maps + rdec_base(s, 0);
      if constexpr (BIG) {
        const BigKernel& bk = a.st[s].k;
        if (bk.l > 2) {
          const int bi = kind == DOWN_FRESH ? 0 : child;
          big_down(bk, bi, out, x, par, rl, d0, rd0, P, n, sm.redf, tid,
                   lane, warp);
          if (tid < P) rlam(s)[tid] = (unsigned char)tid;
          __syncthreads();
          clk_mark(bi == bk.l - 1 ? kClkBigLast
                   : bk.states[bi] ? kClkBigTrellis : kClkBigTable);
          continue;
        }
      }
      for (int e = tid; e < P * n; e += kThreads) {
        const int p = e >> ln, j = e & (n - 1);
        float a, b;
        if (par == nullptr) {
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
      clk_mark(kClkDown);
      continue;
    }

    if (kind == UP) {
      const int s = lvl;
      unsigned char* dst = dec_at(s - 1, child);
      if constexpr (BIG) {
        const BigKernel& bk = a.st[s].k;
        const int l = bk.l;
        if (l > 2) {
          // x_k = XOR_j u_j K[j, k] of every (path, position)
          const unsigned char* d0 = dec_at(s, 0);
          const unsigned char* rd0 = maps + rdec_base(s, 0);
          for (int e = tid; e < P * n; e += kThreads) {
            const int p = e >> ln, j = e & (n - 1);
            unsigned u = 0u;
            for (int c = 0; c < l; ++c)
              u |= (unsigned)d0[c * P * n + rd0[c * P + p] * n + j] << c;
            for (int k = 0; k < l; ++k)
              dst[p * l * n + k * n + j] =
                  (unsigned char)(__popc(u & bk.kcol[k]) & 1u);
          }
          if (tid < P) maps[rdec_base(s - 1, child) + tid] = (unsigned char)tid;
          __syncthreads();
          clk_mark(kClkUp);
          continue;
        }
      }
      const unsigned char* d0 = dec_at(s, 0);
      const unsigned char* d1 = dec_at(s, 1);
      const unsigned char* rd0 = maps + rdec_base(s, 0);
      const unsigned char* rd1 = maps + rdec_base(s, 1);
      for (int e = tid; e < P * n; e += kThreads) {
        const int p = e >> ln, j = e & (n - 1);
        const unsigned char b0 = d0[rd0[p] * n + j];
        const unsigned char b1 = d1[rd1[p] * n + j];
        dst[p * 2 * n + j] = b0 ^ b1;
        dst[p * 2 * n + n + j] = b1;
      }
      if (tid < P) maps[rdec_base(s - 1, child) + tid] = (unsigned char)tid;
      __syncthreads();
      clk_mark(kClkUp);
      continue;
    }

    // ---- node ops at depth d = lvl: input lam_at(d) at identity slots ----
    const int d = lvl;
    const float* L = lam_at(d);
    unsigned char* D = dec_at(d, child);
    const int reset = rdec_base(d, child);

    if (kind == R0) {
      for (int p = warp; p < P; p += kWarps) {
        const float sum = warp_tree_sum(L + p * n, n, 0, lane);
        if (lane == 0) sm.pm[p] = sm.pm[p] + sum;
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
      clk_mark(kClkR0);
      continue;
    }

    if (kind == REP || kind == LEAF || kind == LEAF_FROZEN) {
      if (kind == REP) {
        for (int p = warp; p < P; p += kWarps) {
          const float a = warp_tree_sum(L + p * n, n, 0, lane);
          const float b = warp_tree_sum(L + p * n, n, 1, lane);
          if (lane == 0) { sm.s0[p] = a; sm.s1[p] = b; }
        }
      } else if (tid < P) {
        sm.s0[tid] = fmaxf(-L[tid], 0.f);
        sm.s1[tid] = fmaxf(L[tid], 0.f);
      }
      __syncthreads();
      clk_mark(kClkRepSums);
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
          fork2<CAP>(lane, P, pmv, a, b, npm, nperm, nbit);
          if (lane < P) {
            sm.pm[lane] = npm;
            sm.nmap[lane] = (unsigned char)nperm;
            sm.bit[lane] = (unsigned char)nbit;
          }
        }
      }
      __syncthreads();
      clk_mark(kClkRepFork);
      apply_perm<CAP>(maps, n_maps, sm.nmap, P, reset, tid);
      clk_mark(kClkPerm);
      for (int e = tid; e < P * n; e += kThreads) {
        const int p = e >> ln, j = e & (n - 1);
        const unsigned char bit = sm.bit[p];
        D[e] = bit;
        traj[(t0 + j) * P + p] = (j == n - 1) ? bit : 0;
      }
      if (tid < P) tperm[q * P + tid] = sm.nmap[tid];
      ++q;
      __syncthreads();
      clk_mark(kClkRepFork);
      continue;
    }

    // ---- R1 / SPC: least-reliable keep/flip forks (Fast-SSCL) ----
    const bool spc = (kind == SPC);
    const int rounds = spc ? (P == 1 ? 0 : min(P, n - 1)) : min(P - 1, n);
    const int n_min = spc ? rounds + 1 : rounds;
    for (int p = warp; p < P; p += kWarps) {
      const float* v = L + p * n;
      warp_extract(v, n, n_min, lane, sm, p);
      if (spc) {
        int par = 0;
        for (int j = lane; j < n; j += 32) par ^= (v[j] < 0.f);
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
          par ^= __shfl_xor_sync(kFull, par, off);
        if (lane == 0) sm.bit[p] = (unsigned char)par;
      }
    }
    __syncthreads();
    clk_mark(kClkSelect);
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
        fork2<CAP>(lane, P, pmv, 0.f, pen, npm, nperm, nbit);
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
    clk_mark(kClkChain);
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
    clk_mark(kClkDecide);
    apply_perm<CAP>(maps, n_maps, sm.nmap, P, reset, tid);
    clk_mark(kClkPerm);
    if (!BIG || a.st[d].arikan_below) {
      // u = x F^{(x)k}: in-place butterflies over the span's trajectory rows
      for (int h = n >> 1; h >= 1; h >>= 1) {
        for (int e = tid; e < P * (n >> 1); e += kThreads) {
          const int p = e / (n >> 1), k = e % (n >> 1);
          const int i = (k / h) * 2 * h + (k % h);
          traj[(t0 + i) * P + p] ^= traj[(t0 + i + h) * P + p];
        }
        __syncthreads();
      }
    } else {
      // u = x (K_{d+1} (x) ... (x) K_m)^-1, one stage per kernel below
      for (int s = d + 1; s <= m; ++s) {
        const StageTab& T = a.st[s];
        const int l = T.k.l;
        kron_stage(traj + t0 * P, P, n / (l * T.n), l, T.n, P, T.icol, tid);
      }
    }
    clk_mark(kClkInverse);
    ++q;
  }

  const size_t b = blockIdx.x;
  if constexpr (OUT == kTrajectory || OUT == kSubtree) {
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
    if constexpr (OUT == kSubtree) {
      // the net survival map, and the root re-encode x_k = XOR_j u_j
      // K_1[j, k] of the stage-1 children (through their maps: final path
      // indexing), what the parent's UP would write
      if (tid < P) a.netp[b * P + tid] = netmap[tid];
      const BigKernel& bk = a.st[1].k;
      const int l = bk.l, n = sm.stage[1].x;
      const unsigned char* d0 = dec_at(1, 0);
      const unsigned char* rd0 = maps + rdec_base(1, 0);
      uint8_t* xo = a.xblk + b * P * N;
      for (int e = tid; e < P * n; e += kThreads) {
        const int p = e / n, j = e % n;
        unsigned u = 0u;
        for (int c = 0; c < l; ++c)
          u |= (unsigned)d0[c * P * n + rd0[c * P + p] * n + j] << c;
        for (int k = 0; k < l; ++k)
          xo[p * N + k * n + j] = (uint8_t)(__popc(u & bk.kcol[k]) & 1u);
      }
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
  for (int p = warp; p < P; p += kWarps) {
    unsigned acc = 0u, rec = 0u;
    if (W > 0) {
      for (int t = lane; t < N; t += 32) {
        const int k = a.pidx[t];
        if (k < 0) continue;
        const unsigned bit = traj[t * P + sidx[a.qrow[t] * P + p]];
        if (k < K) acc ^= bit ? a.gmask[k] : 0u;
        else rec |= bit << (k - K);
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        acc ^= __shfl_xor_sync(kFull, acc, off);
        rec |= __shfl_xor_sync(kFull, rec, off);
      }
    }
    if (lane == 0) sm.ok[p] = (W == 0 || (acc ^ a.offmask) == rec) ? 1.f : 0.f;
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
    err = block_sum<kThreads>(err, sm, lane, warp);
    if (tid == 0) {
      a.counters[b] = err > 0;
      a.counters[a.B + b] = err;
    }
  }
}

// ---- the Arikan capacity-8 body: K1, K2, K4, K5 of Arikan specs, P <= 8 ----
//
// The op-kind clock of the general body above on ca_scl (L=8, K5) put
// 60% of a block's time in the R1/SPC fork chains, 9% in the least-reliable
// selection and 7.5% in the REP forks: each fork ran two loops of 2P
// shuffles with divisions by a run-time P, each selection round a 5-step
// shuffle argmin, and 7 of the block's 8 warps waited at a barrier. This
// body keeps the decisions and metrics of the general one bit for bit and
// changes how it gets them:
// - A fork writes its 2P candidates to shared memory; each lane ranks its
//   candidate against all 2P in one unrolled loop of independent reads and
//   the survivors are scattered by rank (`fork_rank`).
// - Selection is one pass: each input's rank by (|v|, j) among its path's
//   n inputs; ranks < n_min give the positions in order. That equals the
//   rounds of extract_mins (ops/scl.py) wherever every |v| < 1e30 (kBig);
//   at or above it the rounds pick one position again, and the chain's
//   head repeats that rule (`rstar`), so the two agree there too.
// - Fewer threads and packed bits: T threads a codeword (a template
//   parameter), decisions and trajectory bits as 32-bit words written by
//   __ballot_sync, path maps of 8 bytes permuted by __byte_perm. ca_scl's
//   K5 state falls from ~64 KB to ~42 KB, so five blocks share an SM.
// - Fewer barriers: an op of P*n <= kSmallWork elements (and every LEAF)
//   runs in warp 0 alone with __syncwarp; the fork chains and the path-map
//   updates are warp 0's too, so a block barrier sits only where the work
//   moves between warp 0 and the block.
// - The R1/SPC inverse transform u = x F^(x)k works on the bit words:
//   shift-XOR steps inside a word, XORs of words for spans above 32.
// Both settings were timed on an H100 at ca_scl (PERF.md, PR 5): 64 or
// 256 threads a codeword and warp-0 thresholds of 64 or 128 were slower.
constexpr int kSmallWork = 32;
constexpr int kFastThreads = 128;

// Node-local state of the Arikan capacity-8 body (static shared memory);
// ops/cuda_scl.py FAST_STATIC_BYTES mirrors its size.
struct Fast {
  int4 stage[kMaxStages];          // n, LLR offset, decision word offset
  float4 cand[4];                  // fork candidates, c = bit * P + p
  float pm[8];
  float spm[8];                    // fork survivors' metrics, by rank
  float vals[9][8];                // least-reliable |llr| by rank, path
  float s0[8], s1[8];              // REP sums
  float ok[8];                     // CRC pass per path (0/1)
  short poss[9][8];                // their positions
  unsigned par[8];                 // SPC parity per path, 0 between nodes
  unsigned red[8];                 // block reductions
  unsigned char src[8];            // fork survivors' candidates, by rank
  unsigned char rstar[8];          // inputs below kBig per path (<= n_min)
  unsigned char nmap[8];           // node-local path map (identity beyond P)
  unsigned char bit[8];            // fork bit / eta
  unsigned char perms[8][8];
  unsigned char flips[8][8];
  unsigned char flipfin[8][8];
  int best;
};

// Byte offsets of the body's dynamic shared memory: LLR buffers P*(N-1)
// f32, the channel LLRs N f32 (Monte-Carlo), decision words (two children
// of ceil(P*n_s/32) words a stage), trajectory rows (P rows of ceil(N/32)
// words), path maps (3 a stage, 8 bytes each), span perms and suffix
// indices (Q*P bytes each), u_true N bytes (Monte-Carlo). ops/cuda_scl.py
// `fast_smem_bytes` mirrors it.
struct FastLayout {
  int chan, dec, traj, maps, tperm, ut, total;
};

__host__ __device__ inline FastLayout fast_layout(int N, int m, int P, int Q,
                                                 bool mc) {
  FastLayout l;
  int off = 4 * P * (N - 1);
  l.chan = off;
  if (mc) off += 4 * N;
  l.dec = off;
  for (int s = 1; s <= m; ++s) off += 8 * ((P * (N >> s) + 31) >> 5);
  l.traj = off;
  off += 4 * P * ((N + 31) >> 5);
  off = (off + 7) & ~7;
  l.maps = off;
  off += 24 * m;
  l.tperm = off;
  off += 2 * Q * P;
  l.ut = off;
  if (mc) off += N;
  l.total = off;
  return l;
}

__device__ __forceinline__ uint2 ident_map() {
  return make_uint2(0x03020100u, 0x07060504u);
}

// The nibble selector of __byte_perm for bytes b0..b3 (each < 8) of w.
__device__ __forceinline__ unsigned byte_selector(unsigned w) {
  return (w & 0x7u) | ((w >> 4) & 0x70u) | ((w >> 8) & 0x700u) |
         ((w >> 12) & 0x7000u);
}

// Every path map (8 bytes: slot of path p at byte p) permuted by the
// node's map, new[p] = old[nmap[p]], except map `reset`, which becomes the
// identity. Warp 0, all lanes: a lane a map.
__device__ __forceinline__ void fast_perm(uint2* maps, int n_maps,
                                          const unsigned char* nmap, int reset,
                                          int lane) {
  const unsigned lo = byte_selector(reinterpret_cast<const unsigned*>(nmap)[0]);
  const unsigned hi = byte_selector(reinterpret_cast<const unsigned*>(nmap)[1]);
  for (int i = lane; i < n_maps; i += 32) {
    const uint2 v = maps[i];
    maps[i] = (i == reset) ? ident_map()
                           : make_uint2(__byte_perm(v.x, v.y, lo),
                                        __byte_perm(v.x, v.y, hi));
  }
}

// 2P -> P fork, warp 0, all 32 lanes (P <= 8). Lane p < P holds path p's
// metric and penalties; lane r < P gets survivor r: metric, parent path,
// bit. Candidate c = bit * P + p ranks by (metric, c) against all 2P,
// read from shared memory (== lax.top_k on negated metrics, ties
// included, as `fork2`).
__device__ __forceinline__ void fork_rank(Fast& sm, int lane, int P, float pm_p,
                                          float pen0_p, float pen1_p,
                                          float& npm, int& nperm, int& nbit) {
  float* cand = reinterpret_cast<float*>(sm.cand);
  if (lane < P) {
    cand[lane] = pm_p + pen0_p;
    cand[P + lane] = pm_p + pen1_p;
  }
  __syncwarp();
  const float v = cand[lane & 15];
  int r4[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 o4 = sm.cand[i];
    const float o[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c2 = 4 * i + k;
      r4[i] += (c2 < 2 * P) && ((o[k] < v) || (o[k] == v && c2 < lane));
    }
  }
  const int rank = (r4[0] + r4[1]) + (r4[2] + r4[3]);
  if (lane < 2 * P && rank < P) {
    sm.spm[rank] = v;
    sm.src[rank] = (unsigned char)lane;
  }
  __syncwarp();
  npm = 0.f; nperm = 0; nbit = 0;
  if (lane < P) {
    const int c = sm.src[lane];
    npm = sm.spm[lane];
    nbit = c >= P;
    nperm = c - (nbit ? P : 0);
  }
}

// u = x F^(x)k over each aligned run of n bits of w (n a power of two,
// n <= 32): bit i (i & h == 0) ^= bit i + h, for h < n.
__device__ __forceinline__ unsigned arikan_word(unsigned w, int n) {
  if (n > 1) w ^= (w >> 1) & 0x55555555u;
  if (n > 2) w ^= (w >> 2) & 0x33333333u;
  if (n > 4) w ^= (w >> 4) & 0x0f0f0f0fu;
  if (n > 8) w ^= (w >> 8) & 0x00ff00ffu;
  if (n > 16) w ^= (w >> 16) & 0x0000ffffu;
  return w;
}

// Node metric sums: put(p, tree sum of relu(+-L[p*n + j]) over j) for
// every p < P, in the fixed pairwise tree of `warp_tree_sum`. P*n <= 32:
// all paths in one warp, n lanes a path; else a warp a path. By the
// group's warps (gwarp of gwarps).
template <class Put>
__device__ __forceinline__ void node_sums(const float* L, int n, int ln, int P,
                                          int positive, int gwarp, int gwarps,
                                          int lane, Put put) {
  if (P * n <= 32) {
    if (gwarp == 0) {
      float v = lane < P * n ? relu_val(L[lane], positive) : 0.f;
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        const float o = __shfl_xor_sync(kFull, v, off);
        if (off < n) v = v + o;
      }
      if (lane < P * n && (lane & (n - 1)) == 0) put(lane >> ln, v);
    }
  } else {
    for (int p = gwarp; p < P; p += gwarps) {
      const float v = warp_tree_sum(L + p * n, n, positive, lane);
      if (lane == 0) put(p, v);
    }
  }
}

template <int SRC, int OUT, int T>
__device__ __forceinline__ void fast_body(const SclArgs& a) {
  static_assert(OUT != kCounters || SRC == kMonteCarlo,
                "counting errors needs the transmitted u");
  static_assert(SRC != kPathBound && OUT != kSubtree,
                "the subtree kernel keeps the general body");
  constexpr int kW = T / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Fast sm;
  const int N = a.N, m = a.m, P = a.P, Q = a.Q, K = a.K, W = a.W;
  const FastLayout ly = fast_layout(N, m, P, Q, SRC == kMonteCarlo);
  float* lam = reinterpret_cast<float*>(smem);
  float* chan = reinterpret_cast<float*>(smem + ly.chan);
  unsigned* decw = reinterpret_cast<unsigned*>(smem + ly.dec);
  unsigned* trajw = reinterpret_cast<unsigned*>(smem + ly.traj);
  uint2* maps = reinterpret_cast<uint2*>(smem + ly.maps);
  unsigned char* tperm = smem + ly.tperm;
  unsigned char* sidx = tperm + Q * P;
  unsigned char* ut = smem + ly.ut;
  const int R = (N + 31) >> 5;     // words of a trajectory row
  const int n_maps = 3 * m;        // stage s: rlam, rdec child 0, child 1

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid <= m) {
    int dw = 0;
    for (int s = 1; s < tid; ++s) dw += 2 * ((P * (N >> s) + 31) >> 5);
    sm.stage[tid] = make_int4(N >> tid, P * (N - 2 * (N >> tid)), dw, 0);
  }
  if (tid < 8) {
    sm.nmap[tid] = (unsigned char)tid;
    sm.par[tid] = 0u;
  }
  const float* x;
  if constexpr (SRC == kMonteCarlo) {
    // the LLR buffers are scratch until the first DOWN
    mc_prologue<false, T>(a, chan, ut, reinterpret_cast<unsigned char*>(lam),
                          sm, tid, lane, warp);
    clk_mark(kClkPrologue);
    x = chan;
  } else {
    x = a.llr + (size_t)blockIdx.x * N;
  }
  for (int i = tid; i < P * R; i += T) trajw[i] = 0u;
  for (int i = tid; i < n_maps; i += T) maps[i] = ident_map();
  if (tid < P) sm.pm[tid] = (tid == 0) ? 0.f : kBig;
  __syncthreads();

  auto lam_at = [&](int s) { return lam + sm.stage[s].y; };
  auto dec_at = [&](int s, int c) {
    return decw + sm.stage[s].z + c * ((P * sm.stage[s].x + 31) >> 5);
  };
  auto map_at = [&](int k) {
    return reinterpret_cast<const unsigned char*>(maps + k);
  };
  auto bit_at = [](const unsigned* w, int i) { return (w[i >> 5] >> (i & 31)) & 1u; };

  int q = 0;                 // trajectory span of the next node op
  bool prev_small = false;
  int prev_slot = kClkSetup;
  int4 nxt = a.ops[0];
  for (int o = 0; o < a.n_ops; ++o) {
    const int4 op = nxt;
    if (o + 1 < a.n_ops) nxt = a.ops[o + 1];
    const int kind = op.x, lvl = op.y, t0 = op.z, child = op.w;
    const int n = sm.stage[lvl].x;
    const int ln = __ffs(n) - 1;
    // the group that runs this op: warp 0 alone, or the whole block
    const bool small = kind >= LEAF || P * n <= kSmallWork;
    if (small && prev_small) __syncwarp(); else __syncthreads();
    clk_mark(prev_slot);
    prev_small = small;
    const int qq = q;
    if (kind >= R0) ++q;
    if (small && warp != 0) continue;
    const int gsize = small ? 32 : T, grank = small ? lane : tid;
    const int gwarps = small ? 1 : kW, gwarp = small ? 0 : warp;
    auto gsync = [&]() { if (small) __syncwarp(); else __syncthreads(); };

    if (kind == DOWN_FRESH || kind == DOWN_DYN) {
      const int s = lvl;
      float* out = lam_at(s);
      const float* par = (s > 1) ? lam_at(s - 1) : nullptr;
      const unsigned char* rl = (s > 1) ? map_at(3 * (s - 2)) : nullptr;
      const unsigned* d0 = dec_at(s, 0);
      const unsigned char* rd0 = map_at(3 * (s - 1) + 1);
      for (int e = grank; e < P * n; e += gsize) {
        const int p = e >> ln, j = e & (n - 1);
        float va, vb;
        if (par == nullptr) {
          va = x[j];
          vb = x[j + n];
        } else {
          const float* row = par + rl[p] * 2 * n;
          va = row[j];
          vb = row[j + n];
        }
        float v;
        if (kind == DOWN_FRESH) {
          const float sg = ((va < 0.f) != (vb < 0.f)) ? -1.f : 1.f;
          v = sg * fminf(fabsf(va), fabsf(vb));
        } else {
          const float d = (float)bit_at(d0, rd0[p] * n + j);
          v = va * (1.f - 2.f * d) + vb;
        }
        out[e] = v;
      }
      if (grank == 0) maps[3 * (s - 1)] = ident_map();
      prev_slot = kClkDown;
      continue;
    }

    if (kind == UP) {
      // child `child` of stage s-1 (rows of 2n bits): x0 ^ x1, then x1
      const int s = lvl;
      unsigned* dst = dec_at(s - 1, child);
      const unsigned* d0 = dec_at(s, 0);
      const unsigned* d1 = dec_at(s, 1);
      const unsigned char* rd0 = map_at(3 * (s - 1) + 1);
      const unsigned char* rd1 = map_at(3 * (s - 1) + 2);
      if ((n & 31) == 0) {
        const int nw = n >> 5;
        for (int w = grank; w < 2 * P * nw; w += gsize) {
          const int p = w / (2 * nw), k = w - p * 2 * nw;
          const int kk = k < nw ? k : k - nw;
          const unsigned b1 = d1[rd1[p] * nw + kk];
          dst[w] = k < nw ? (d0[rd0[p] * nw + kk] ^ b1) : b1;
        }
      } else {
        for (int base = gwarp * 32; base < 2 * P * n; base += gsize) {
          const int e = base + lane;
          unsigned b = 0u;
          if (e < 2 * P * n) {
            const int p = e >> (ln + 1), k = e & (2 * n - 1);
            const int j = k & (n - 1);
            b = bit_at(d1, rd1[p] * n + j);
            if (k < n) b ^= bit_at(d0, rd0[p] * n + j);
          }
          const unsigned word = __ballot_sync(kFull, b);
          if (lane == 0) dst[base >> 5] = word;
        }
      }
      if (grank == 0) maps[3 * (s - 2) + 1 + child] = ident_map();
      prev_slot = kClkUp;
      continue;
    }

    // ---- node ops at depth d = lvl: input lam_at(d) at identity slots ----
    const int d = lvl;
    const float* L = lam_at(d);
    unsigned* D = dec_at(d, child);
    const int reset = 3 * (d - 1) + 1 + child;
    const int cw = (P * n + 31) >> 5;      // words of D

    if (kind == R0) {
      node_sums(L, n, ln, P, 0, gwarp, gwarps, lane,
                [&](int p, float v) { sm.pm[p] = sm.pm[p] + v; });
      for (int i = grank; i < cw; i += gsize) D[i] = 0u;
      if (grank < P) tperm[qq * P + grank] = (unsigned char)grank;
      if (grank == 0) maps[reset] = ident_map();
      prev_slot = kClkR0;
      continue;
    }

    if (kind == REP || kind == LEAF || kind == LEAF_FROZEN) {
      if (kind == REP) {
        node_sums(L, n, ln, P, 0, gwarp, gwarps, lane,
                  [&](int p, float v) { sm.s0[p] = v; });
        node_sums(L, n, ln, P, 1, gwarp, gwarps, lane,
                  [&](int p, float v) { sm.s1[p] = v; });
      } else if (grank < P) {
        sm.s0[grank] = fmaxf(-L[grank], 0.f);
        sm.s1[grank] = fmaxf(L[grank], 0.f);
      }
      gsync();
      clk_mark(kClkRepSums);
      if (gwarp == 0) {
        if (kind == LEAF_FROZEN || P == 1) {
          if (lane < P) {
            const float s0 = sm.s0[lane], s1 = sm.s1[lane];
            int bit = 0;
            if (kind == REP) bit = s1 < s0;
            else if (kind == LEAF) bit = L[lane] < 0.f;
            sm.pm[lane] = sm.pm[lane] + (bit ? s1 : s0);
            sm.bit[lane] = (unsigned char)bit;
            sm.nmap[lane] = (unsigned char)lane;
          }
        } else {
          const float pmv = lane < P ? sm.pm[lane] : 0.f;
          const float s0 = lane < P ? sm.s0[lane] : 0.f;
          const float s1 = lane < P ? sm.s1[lane] : 0.f;
          float npm; int nperm, nbit;
          fork_rank(sm, lane, P, pmv, s0, s1, npm, nperm, nbit);
          if (lane < P) {
            sm.pm[lane] = npm;
            sm.nmap[lane] = (unsigned char)nperm;
            sm.bit[lane] = (unsigned char)nbit;
          }
        }
        __syncwarp();
        fast_perm(maps, n_maps, sm.nmap, reset, lane);
        if (lane < P) {
          tperm[qq * P + lane] = sm.nmap[lane];
          // u = (0, ..., 0, bit): only the span's last row is set
          const int t = t0 + n - 1;
          if (sm.bit[lane]) trajw[lane * R + (t >> 5)] |= 1u << (t & 31);
        }
      }
      gsync();
      for (int base = gwarp * 32; base < cw * 32; base += gsize) {
        const int e = base + lane;
        const unsigned w = __ballot_sync(kFull, e < P * n && sm.bit[e >> ln]);
        if (lane == 0) D[base >> 5] = w;
      }
      prev_slot = kClkRepFork;
      continue;
    }

    // ---- R1 / SPC: least-reliable keep/flip forks (Fast-SSCL) ----
    const bool spc = (kind == SPC);
    const int rounds = spc ? (P == 1 ? 0 : min(P, n - 1)) : min(P - 1, n);
    const int n_min = spc ? rounds + 1 : rounds;
    const int first = spc ? 1 : 0;
    // 1. each input's rank by (|v|, j) in its path: ranks < n_min give the
    //    least-reliable positions in order; the signs' parity (SPC)
    for (int base = gwarp * 32; base < cw * 32; base += gsize) {
      const int e = base + lane;
      const bool in = e < P * n;
      const float v = in ? L[e] : 0.f;
      if (in && n_min > 0) {
        const int p = e >> ln, j = e & (n - 1);
        const float av = fabsf(v);
        const float* row = L + p * n;
        int rank = 0, below = 0;
        if (n >= 4) {
          // rows start at multiples of 4 floats: 16-byte reads
          const float4* row4 = reinterpret_cast<const float4*>(row);
          for (int k4 = 0; k4 < (n >> 2); ++k4) {
            const float4 w4 = row4[k4];
            const float ak[4] = {fabsf(w4.x), fabsf(w4.y), fabsf(w4.z), fabsf(w4.w)};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int k = 4 * k4 + i;
              rank += (ak[i] < av) || (ak[i] == av && k < j);
              below += ak[i] < kBig;
            }
          }
        } else {
          for (int k = 0; k < n; ++k) {
            const float ak = fabsf(row[k]);
            rank += (ak < av) || (ak == av && k < j);
            below += ak < kBig;
          }
        }
        if (rank < n_min) {
          sm.poss[rank][p] = (short)j;
          sm.vals[rank][p] = av;
          if (rank == 0) sm.rstar[p] = (unsigned char)min(below, n_min);
        }
      }
      if (spc) {
        const unsigned neg = __ballot_sync(kFull, in && v < 0.f);
        if (lane == 0) {
          if (n >= 32) {
            atomicXor(&sm.par[base >> ln], (unsigned)__popc(neg) & 1u);
          } else {
            for (int sg = 0; sg < 32 && base + sg < P * n; sg += n)
              atomicXor(&sm.par[(base + sg) >> ln],
                        (unsigned)__popc((neg >> sg) & ((1u << n) - 1u)) & 1u);
          }
        }
      }
    }
    gsync();
    clk_mark(kClkSelect);
    // 2. the fork chain, warp 0: metrics, node map and eta in registers
    if (gwarp == 0) {
      int nm = lane < P ? lane : 0;
      float pmv = lane < P ? sm.pm[lane] : 0.f;
      int eta = 0;
      if (lane < P) {
        // inputs at or above kBig: the rounds of extract_mins, which mark
        // a chosen position as kBig, choose one position again from the
        // first round whose least unchosen |v| is >= kBig
        const int rs = sm.rstar[lane];
        if (rs < n_min) {
          const int start = rs > 0 ? rs : 1;
          int e = 0x7fff;
          for (int r = 0; r < start; ++r) e = min(e, (int)sm.poss[r][lane]);
          if (rs > 0 && sm.vals[rs][lane] == kBig)
            e = min(e, (int)sm.poss[rs][lane]);
          for (int r = start; r < n_min; ++r) {
            sm.poss[r][lane] = (short)e;
            sm.vals[r][lane] = kBig;
          }
        }
        if (spc) {
          eta = (int)sm.par[lane];
          sm.par[lane] = 0u;
          pmv = pmv + (float)eta * sm.vals[0][lane];   // mandatory parity fix
        }
      }
      __syncwarp();
      for (int r = 0; r < rounds; ++r) {
        float pen = 0.f;
        if (lane < P) {
          pen = sm.vals[r + first][nm];
          if (spc) pen = pen + (1.f - 2.f * (float)eta) * sm.vals[0][nm];
        }
        float npm; int nperm, nbit;
        fork_rank(sm, lane, P, pmv, 0.f, pen, npm, nperm, nbit);
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
        tperm[qq * P + lane] = (unsigned char)nm;
      }
      __syncwarp();
      fast_perm(maps, n_maps, sm.nmap, reset, lane);
    }
    gsync();
    clk_mark(kClkChain);
    // 3. decisions x (D), and u = x F^(x)k into the trajectory rows
    for (int base = gwarp * 32; base < cw * 32; base += gsize) {
      const int e = base + lane;
      unsigned xb = 0u;
      if (e < P * n) {
        const int p = e >> ln, j = e & (n - 1);
        const int src = sm.nmap[p];
        xb = L[src * n + j] < 0.f;
        if (spc && sm.poss[0][src] == j) xb ^= sm.bit[p];
        for (int r = 0; r < rounds; ++r)
          if (sm.poss[r + first][src] == j) xb ^= sm.flipfin[r][p];
      }
      const unsigned w = __ballot_sync(kFull, xb);
      if (lane == 0) {
        D[base >> 5] = w;
        if (n < 32) {
          const unsigned u = arikan_word(w, n);
          for (int sg = 0; sg < 32 && base + sg < P * n; sg += n)
            trajw[((base + sg) >> ln) * R + (t0 >> 5)] |=
                ((u >> sg) & ((1u << n) - 1u)) << (t0 & 31);
        }
      }
    }
    prev_slot = kClkDecide;
    if (n >= 32) {
      // across words: u_k = T(XOR of x_k' over the supersets k' of k)
      gsync();
      clk_mark(kClkDecide);
      const int nw = n >> 5;
      for (int i = grank; i < P * nw; i += gsize) {
        const int p = i / nw, k = i - p * nw;
        unsigned acc = 0u;
        for (int k2 = k; k2 < nw; k2 = (k2 + 1) | k) acc ^= D[p * nw + k2];
        trajw[p * R + (t0 >> 5) + k] = arikan_word(acc, 32);
      }
      prev_slot = kClkInverse;
    }
  }
  __syncthreads();
  clk_mark(prev_slot);

  const size_t b = blockIdx.x;
  auto traj_at = [&](int t, int slot) {
    return (trajw[slot * R + (t >> 5)] >> (t & 31)) & 1u;
  };
  if constexpr (OUT == kTrajectory) {
    uint8_t* tb = a.traj_bit + b * N * P;
    for (int i = tid; i < N * P; i += T) tb[i] = (uint8_t)traj_at(i / P, i % P);
    uint8_t* tp = a.traj_perm + b * Q * P;
    for (int i = tid; i < Q * P; i += T) tp[i] = tperm[i];
    if (tid < P) a.pm[b * P + tid] = sm.pm[tid];
    if constexpr (SRC == kMonteCarlo) {
      int8_t* u = a.u_true + b * N;
      for (int t = tid; t < N; t += T) u[t] = (int8_t)ut[t];
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
  for (int p = warp; p < P; p += kW) {
    unsigned acc = 0u, rec = 0u;
    if (W > 0) {
      for (int t = lane; t < N; t += 32) {
        const int k = a.pidx[t];
        if (k < 0) continue;
        const unsigned bit = traj_at(t, sidx[a.qrow[t] * P + p]);
        if (k < K) acc ^= bit ? a.gmask[k] : 0u;
        else rec |= bit << (k - K);
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        acc ^= __shfl_xor_sync(kFull, acc, off);
        rec |= __shfl_xor_sync(kFull, rec, off);
      }
    }
    if (lane == 0) sm.ok[p] = (W == 0 || (acc ^ a.offmask) == rec) ? 1.f : 0.f;
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
    for (int t = tid; t < N; t += T)
      u[t] = (int8_t)traj_at(t, sidx[a.qrow[t] * P + best]);
  } else {
    // errors of the best path on the data rows (CRC rows do not count)
    int err = 0;
    for (int t = tid; t < N; t += T) {
      const int k = a.pidx[t];
      if (k < 0 || k >= K) continue;
      err += traj_at(t, sidx[a.qrow[t] * P + best]) != ut[t];
    }
    err = block_sum<T>(err, sm, lane, warp);
    if (tid == 0) {
      a.counters[b] = err > 0;
      a.counters[a.B + b] = err;
    }
  }
}

#define SCL_KERNEL(NAME, MIN_BLOCKS, ...)                                  \
  __global__ void __launch_bounds__(kThreads, MIN_BLOCKS) NAME(SclArgs a) { \
    clk_begin();                                                          \
    scl_body<__VA_ARGS__>(a);                                             \
    clk_end();                                                            \
  }

#define FAST_KERNEL(NAME, SRC, OUT)                                        \
  __global__ void __launch_bounds__(kFastThreads, 5) NAME(SclArgs a) {     \
    clk_begin();                                                          \
    fast_body<SRC, OUT, kFastThreads>(a);                                 \
    clk_end();                                                            \
  }

// Arikan, capacity 8: the redesigned body, min 5 blocks an SM (ca_scl's
// ~42 KB of shared memory a block allows 5)
FAST_KERNEL(scl_decode, kLlrIn, kSelect)
FAST_KERNEL(scl_decode_traj, kLlrIn, kTrajectory)
FAST_KERNEL(scl_mc_traj, kMonteCarlo, kTrajectory)
FAST_KERNEL(scl_mc_counters, kMonteCarlo, kCounters)
// with l > 2 kernels: bch_sc's decode state is a few KB, so registers set
// the blocks an SM; ask for 4 (<= 64 registers a thread)
SCL_KERNEL(scl_decode_big, 4, kLlrIn, kSelect, true, 8)
SCL_KERNEL(scl_decode_traj_big, 4, kLlrIn, kTrajectory, true, 8)
SCL_KERNEL(scl_mc_traj_big, 4, kMonteCarlo, kTrajectory, true, 8)
SCL_KERNEL(scl_mc_counters_big, 4, kMonteCarlo, kCounters, true, 8)
// capacity 32 (L <= 32): the wider fork and map loops, 2 blocks an SM
SCL_KERNEL(scl_decode_c32, 2, kLlrIn, kSelect, false, 32)
SCL_KERNEL(scl_decode_traj_c32, 2, kLlrIn, kTrajectory, false, 32)
SCL_KERNEL(scl_mc_traj_c32, 2, kMonteCarlo, kTrajectory, false, 32)
SCL_KERNEL(scl_mc_counters_c32, 2, kMonteCarlo, kCounters, false, 32)
SCL_KERNEL(scl_decode_big_c32, 2, kLlrIn, kSelect, true, 32)
SCL_KERNEL(scl_decode_traj_big_c32, 2, kLlrIn, kTrajectory, true, 32)
SCL_KERNEL(scl_mc_traj_big_c32, 2, kMonteCarlo, kTrajectory, true, 32)
SCL_KERNEL(scl_mc_counters_big_c32, 2, kMonteCarlo, kCounters, true, 32)
// the subtree kernel: one depth-1 child a block; the l > 2 instance (it
// also runs 2x2 stages) serves Arikan and mixed children
SCL_KERNEL(scl_subtree, 4, kPathBound, kSubtree, true, 8)
SCL_KERNEL(scl_subtree_c32, 2, kPathBound, kSubtree, true, 32)

}  // namespace

extern "C" {

// The instances of the Arikan capacity-8 body: every kernel but the
// subtree kernel, for specs of 2x2 kernels only at P <= 8.
static bool arikan8(int kernel, int P, int big) {
  return kernel < 4 && !big && P <= 8;
}

// threads a block of the instance that takes (kernel, P, big)
int scl_block_threads(int kernel, int P, int big) {
  return arikan8(kernel, P, big) ? kFastThreads : kThreads;
}

// kernel: 0 scl_decode, 1 scl_decode_traj, 2 scl_mc_traj, 3 scl_mc_counters,
// 4 scl_subtree
size_t scl_smem_bytes(int kernel, const SclArgs* a) {
  if (arikan8(kernel, a->P, a->big))
    return (size_t)fast_layout(a->N, a->m, a->P, a->Q, kernel == 2 || kernel == 3)
        .total;
  const size_t N = a->N, P = a->P, Q = a->Q;
  return (size_t)4 * a->n_lam + (size_t)a->n_dec + N * P + 2 * Q * P
         + (size_t)a->n_maps + (kernel == 2 || kernel == 3 ? 5 * N : 0)
         + (kernel == 4 ? P : 0);
}

// The instance that runs `kernel` for *a, after its shared-memory limit is
// set; null if *a is out of range.
static void (*instance(int kernel, const SclArgs* a, size_t smem))(SclArgs) {
  // [capacity 8, 32][kernel + 5 * big]
  static void (*const fns[2][10])(SclArgs) = {
      {scl_decode, scl_decode_traj, scl_mc_traj, scl_mc_counters, scl_subtree,
       scl_decode_big, scl_decode_traj_big, scl_mc_traj_big,
       scl_mc_counters_big, scl_subtree},
      {scl_decode_c32, scl_decode_traj_c32, scl_mc_traj_c32,
       scl_mc_counters_c32, scl_subtree_c32, scl_decode_big_c32,
       scl_decode_traj_big_c32, scl_mc_traj_big_c32, scl_mc_counters_big_c32,
       scl_subtree_c32}};
  const int cap = a->P <= 8 ? 0 : 1;
  const int maps = a->n_maps + (kernel == 4 ? a->P : 0);
  if (kernel < 0 || kernel > 4 || a->P < 1 || a->P > 32 || a->W > 32
      || a->B < 1 || a->N < 2 || a->m < 1 || a->m + 1 > kMaxStages
      || maps > maps_per_thread(cap ? 32 : 8) * kThreads)
    return nullptr;
  void (*const fn)(SclArgs) = fns[cap][kernel + (a->big ? 5 : 0)];
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return nullptr;
  return fn;
}

int scl_launch(int kernel, const SclArgs* a, void* stream) {
  const size_t smem = scl_smem_bytes(kernel, a);
  void (*const fn)(SclArgs) = instance(kernel, a, smem);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int threads = scl_block_threads(kernel, a->P, a->big);
  fn<<<a->B, threads, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// blocks an SM of the instance that runs `kernel` for *a (occupancy API);
// -1 on error
int scl_blocks_per_sm(int kernel, const SclArgs* a) {
  const size_t smem = scl_smem_bytes(kernel, a);
  void (*const fn)(SclArgs) = instance(kernel, a, smem);
  int blocks = 0;
  if (fn == nullptr
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, fn, scl_block_threads(kernel, a->P, a->big), smem)
             != cudaSuccess)
    return -1;
  return blocks;
}

int scl_args_bytes(void) { return (int)sizeof(SclArgs); }

int scl_stage_tab_bytes(void) { return (int)sizeof(StageTab); }

#ifdef SCL_CLOCK
// the op-kind clock: slots then the count of blocks measured
int scl_clock_slots(void) { return kClkSlots; }

int scl_clock_reset(void) {
  static const unsigned long long zero[kClkSlots + 1] = {};
  return (int)cudaMemcpyToSymbol(g_clock, zero, sizeof(zero));
}

int scl_clock_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clock,
                                   sizeof(unsigned long long) * (kClkSlots + 1));
}
#endif

// static shared memory of the instance that takes (kernel, P, big)
int scl_static_smem_bytes(int kernel, int P, int big) {
  if (arikan8(kernel, P, big)) return (int)sizeof(Fast);
  return P <= 8 ? (int)sizeof(Small<8>) : (int)sizeof(Small<32>);
}

int scl_decode_max_smem_bytes(void) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)
      != cudaSuccess) return -1;
  return v;
}

}  // extern "C"
