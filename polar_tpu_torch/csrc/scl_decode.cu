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
// P <= 8 run `fast_body`, the body redesigned for Hopper (64 or 128
// threads a codeword, stage 1 read through the channel row, packed bits,
// forks in registers, leader-warp ops; its note below); every
// other instance runs the general body `scl_body`, whose design the rest
// of this note describes. ops/cuda_scl.py `launch_plan` chooses the
// instance (`arikan8`: which body).
//
// List capacity: every kernel has an instance for P <= 8 and one for
// P <= 32 (template CAP), chosen at launch. Capacity 32 (K3
// `scl_subtree_c32`, replacing pallas_scl.py `core_sub`, and K1, K2, K4,
// K5 at 8 < L <= 32; 256 threads) was redesigned for Hopper; its note is
// above `fork_table`. Capacity 8 (the l > 2 instances at L <= 8, bch_sc's
// among them, and K3 `scl_subtree`) was redesigned after it; its note is
// above `kBig8Registers`.
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
  int n_ops, N, m, P, Q, K, W, B;  // B: the whole batch
  int n_lam, n_dec, n_maps;  // LLR floats, decision bytes, path-map bytes
  int big;                   // 1: some kernel is l > 2 (the BIG instances)
  int view1;                 // the Arikan capacity-8 body reads stage 1
                             // through the channel row (no node op reads it)
  int b0;                    // batch index of the launch's first codeword:
                             // K5 (kCounters) runs a batch in chunks; 0 else
                             // (last, so the other fields keep their offsets)
};

namespace {

constexpr int kThreads = 256;   // capacity 32: threads a codeword
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
// syndrome trellis or the tail table. kClkRounds is a count, not cycles:
// the R1/SPC fork rounds the block ran (kClkChain / kClkRounds: cycles a
// round). The general body keys each slot by the stage of the op that
// ran as well (`clk_stage`: its level, stages past kClkStages - 1 in the
// last key; key 0 holds the set-up, the prologue and the epilogue), so
// the split shows where the block's time goes stage by stage.
enum ClockSlot {
  kClkSetup = 0, kClkPrologue, kClkDown, kClkUp, kClkR0, kClkRepSums,
  kClkRepFork, kClkSelect, kClkChain, kClkDecide, kClkPerm, kClkInverse,
  kClkBigLast, kClkBigTrellis, kClkBigTable, kClkEpilogue, kClkRounds,
  kClkSlots
};
constexpr int kClkStages = 4;
#ifdef SCL_CLOCK
constexpr int kClockBlocks = 128;
constexpr int kClkCells = kClkStages * kClkSlots;   // [stage key][slot]
__device__ unsigned long long g_clock[kClkCells + 1];   // + blocks measured
__shared__ unsigned long long clk_acc[kClkCells];
__shared__ long long clk_last;
__shared__ int clk_key;
__device__ __forceinline__ void clk_begin() {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kClkCells; ++i) clk_acc[i] = 0ull;
    clk_key = 0;
    clk_last = clock64();
  }
}
// the stage the next marks are keyed by
__device__ __forceinline__ void clk_stage(int lvl) {
  if (threadIdx.x == 0) clk_key = (lvl < kClkStages ? lvl : kClkStages - 1) * kClkSlots;
}
__device__ __forceinline__ void clk_mark(int slot) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    clk_acc[clk_key + slot] += (unsigned long long)(now - clk_last);
    clk_last = now;
  }
}
__device__ __forceinline__ void clk_count(int slot, int n) {
  if (threadIdx.x == 0) clk_acc[clk_key + slot] += (unsigned long long)n;
}
// the same by the thread `me` (the Arikan body's leader warp, lane 0)
__device__ __forceinline__ void clk_mark_by(bool me, int slot) {
  if (me) {
    const long long now = clock64();
    clk_acc[slot] += (unsigned long long)(now - clk_last);
    clk_last = now;
  }
}
__device__ __forceinline__ void clk_count_by(bool me, int slot, int n) {
  if (me) clk_acc[slot] += (unsigned long long)n;
}
__device__ __forceinline__ void clk_end() {
  clk_stage(0);
  clk_mark(kClkEpilogue);
  if (threadIdx.x == 0 && blockIdx.x < kClockBlocks) {
    for (int i = 0; i < kClkCells; ++i) atomicAdd(&g_clock[i], clk_acc[i]);
    atomicAdd(&g_clock[kClkCells], 1ull);
  }
}
#else
__device__ __forceinline__ void clk_begin() {}
__device__ __forceinline__ void clk_stage(int) {}
__device__ __forceinline__ void clk_mark(int) {}
__device__ __forceinline__ void clk_count(int, int) {}
__device__ __forceinline__ void clk_mark_by(bool, int) {}
__device__ __forceinline__ void clk_count_by(bool, int, int) {}
__device__ __forceinline__ void clk_end() {}
#endif

// Path maps a thread of the capacity-32 apply_perm holds: the maps are <=
// this many times kThreads bytes. (Capacity 8 permutes a map a thread:
// no limit.)
constexpr int kMapsPerThread32 = 8;

// The fork table and one-pass selection state of a list capacity CAP.
template <int CAP>
struct ForkTable {
  float4 cand[CAP / 2];            // candidates: capacity 32 slot s = bit * 32
                                   // + p, NaN for p >= P; capacity 8
                                   // `fork_rank`'s c = bit * P + p
  float spm[CAP];                  // fork survivors' metrics, by rank
  unsigned par[CAP];               // SPC parity per path, 0 between nodes
  unsigned char src[CAP];          // fork survivors' slots, by rank
  unsigned char rstar[CAP];        // inputs below kBig per path (<= n_min)
};

// The node-local state of a list capacity CAP (P <= CAP).
template <int CAP>
struct Small : ForkTable<CAP> {
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

// `warp_tree_sum` on the 16 lanes of a half-warp (lane < 16, the
// codeword's; two codewords a warp, each in its own half): the same tree,
// x[lane + 16 i] folded by halves in registers, then across the half.
__device__ float half_tree_sum(const float* v, int n, int positive, int lane) {
  float r[32];
  const int k = n >> 4;
  if (n >= 16) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      r[i] = (i < k) ? relu_val(v[lane + 16 * i], positive) : 0.f;
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) {
      if (2 * h <= k) {
#pragma unroll
        for (int i = 0; i < h; ++i) r[i] = r[i] + r[i + h];
      }
    }
  } else {
    r[0] = (lane < n) ? relu_val(v[lane], positive) : 0.f;
  }
  float s = r[0];
  const int top = (n >= 16) ? 8 : (n >> 1);
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1) {
    const float o = __shfl_xor_sync(kFull, s, off);
    if (off <= top) s = s + o;
  }
  return s;
}

// A barrier over the block of T threads: a warp's at T <= 32 (T = 16: the
// half-warp of a codeword, both halves of the warp at the barrier).
template <int T>
__device__ __forceinline__ void block_sync() {
  if constexpr (T <= 32) __syncwarp();
  else __syncthreads();
}

// 2P -> P fork, one warp, all 32 lanes (P <= 8): the Arikan capacity-8
// body's and the general body's at capacity 8. Lane p < P holds path p's
// metric and penalties; lane r < P gets survivor r: metric, parent path,
// bit. Candidate c = bit * P + p ranks by (metric, c) against all 2P,
// read from shared memory (== lax.top_k on negated metrics, ties
// included, as ops/scl.py `fork2`).
template <class SM>
__device__ __forceinline__ void fork_rank(SM& sm, int lane, int P, float pm_p,
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

// Node metric sums: put(p, tree sum of relu(+-L[p*n + j]) over j) for
// every p < P, in the fixed pairwise tree of `warp_tree_sum`. P*n <= W:
// all paths in one group of W lanes (a warp, or at W = 16 a codeword's
// half-warp), n lanes a path; else a group a path. By the codeword's
// groups (gwarp of gwarps).
template <int W = 32, class Put>
__device__ __forceinline__ void node_sums(const float* L, int n, int ln, int P,
                                          int positive, int gwarp, int gwarps,
                                          int lane, Put put) {
  if (P * n <= W) {
    if (gwarp == 0) {
      float v = lane < P * n ? relu_val(L[lane], positive) : 0.f;
#pragma unroll
      for (int off = W / 2; off >= 1; off >>= 1) {
        const float o = __shfl_xor_sync(kFull, v, off);
        if (off < n) v = v + o;
      }
      if (lane < P * n && (lane & (n - 1)) == 0) put(lane >> ln, v);
    }
  } else {
    for (int p = gwarp; p < P; p += gwarps) {
      float v;
      if constexpr (W == 32) v = warp_tree_sum(L + p * n, n, positive, lane);
      else v = half_tree_sum(L + p * n, n, positive, lane);
      if (lane == 0) put(p, v);
    }
  }
}

// ---- list capacity 32 (P <= 32): the fork table and one-pass selection ----
//
// The op-kind clock (kernel_times --split, PERF.md) put 55.5% of K3's
// block time in the R1/SPC fork chains and 9.7% in the least-reliable
// selection, ~17k cycles a fork round: the old fork ranked two candidates
// a lane by 2P shuffles, scattered them by 4P more, divided by a run-time
// P in both loops, and warp 0 ran the rounds while 7 warps waited; each
// selection round re-read every earlier position (O(count^2) a path). A
// mixed_scl32 decode runs ~134 rounds a child, every R1/SPC node there
// has n <= 16.
// This design keeps every survivor, its order and every metric bit for bit
// (lax.top_k's order: ties to the lower candidate c = bit * P + p):
// - The candidates go to a table in shared memory at slot s = bit * 32 + p
//   (NaN where p >= P, set once: NaN is never before anything). s orders
//   as c does, so ties need no division; a survivor's parent and bit are
//   s & 31 and s >> 5. Each lane ranks its two slots against the table by
//   broadcast 16-byte reads and scatters the survivors by rank
//   (`fork_table`), as the Arikan capacity-8 body's `fork_rank` does.
// - Where pm is sorted (the TPU kernel's `fork2_sorted`, pallas_scl.py
//   :691-738), the keep half A = pm + 0 is in order already: rank_A = p +
//   #{B < A[p]} and rank_B = #{A <= B[p]} (a binary search in A) + B's
//   rank among itself, half the compares. `pm_sorted` follows the TPU
//   kernel's rules: true at the decode's start ([0, kBig, ...]) and after
//   every fork; false for K3's path-bound pm_in, after R0, a frozen leaf,
//   and for SPC's first round, which follows the parity fix.
// - Selection is one pass over the block (`select_rank`): each input's
//   rank by (|v|, j) in its path, ranks < n_min give the positions in
//   order, the rule at kBig (`rstar`) as in the Arikan capacity-8 body.
//   Small blocks share a warp between paths. It costs n compares an input
//   (n^2 a path), which suits the n <= 16 of the target codes.
// - Decisions keep the loop over the rounds for every input: the parent's
//   clock put them at 0.4% of K3 (PERF.md).
// - The rank loops read one 16-byte table entry a step (`unroll 1`):
//   unrolled fully, the 64 floats stay live together, and the l > 2
//   capacity-32 instances spilled 20-64 B at their 128 registers; 1, 2
//   and 4 entries a step timed alike on an H100 (PERF.md).
// - One warp runs the chain. A round measured ~2.6k cycles, of which the
//   compares are a few hundred; two warps ranking half the table each
//   would halve those behind two named barriers a round. Not taken.
// What bounds the capacity-32 instances stays latency: a round is a
// dependent chain (penalty gather, table, rank, scatter, survivors) in one
// warp, and 2 blocks an SM hide little of it.

// The fork from the table, warp 0, all lanes: lanes p < P have written
// their candidates (slot p: keep, 32 + p: the other bit) before the call.
// Lane r < P gets survivor r: metric, parent path, bit. `sorted`: the keep
// half is in order (value, then p).
__device__ __forceinline__ void fork_table(ForkTable<32>& ft, int lane, int P,
                                           bool sorted, float& npm, int& nperm,
                                           int& nbit) {
  __syncwarp();
  const float* cf = reinterpret_cast<const float*>(ft.cand);
  const float va = cf[lane], vb = cf[32 + lane];
  int ra = 0, rb = 0;
  if (sorted) {
    // rank_A = p + #{B[j] < A[p]}; rank_B = #{A[j] <= B[p]} + #{B before B[p]}
    ra = lane;
    int k = 0;
#pragma unroll
    for (int step = 32; step >= 1; step >>= 1)
      if (k + step <= P && cf[k + step - 1] <= vb) k += step;
    rb = k;
  } else {
#pragma unroll 1
    for (int i = 0; i < 8; ++i) {
      const float4 o4 = ft.cand[i];
      const float o[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = 4 * i + k;
        ra += (o[k] < va) || (o[k] == va && s < lane);
        rb += o[k] <= vb;
      }
    }
  }
#pragma unroll 1
  for (int i = 8; i < 16; ++i) {
    const float4 o4 = ft.cand[i];
    const float o[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = 4 * (i - 8) + k;
      ra += o[k] < va;
      rb += (o[k] < vb) || (o[k] == vb && s < lane);
    }
  }
  if (lane < P) {
    if (ra < P) { ft.spm[ra] = va; ft.src[ra] = (unsigned char)lane; }
    if (rb < P) { ft.spm[rb] = vb; ft.src[rb] = (unsigned char)(32 + lane); }
  }
  __syncwarp();
  npm = 0.f; nperm = 0; nbit = 0;
  if (lane < P) {
    const int s = ft.src[lane];
    npm = ft.spm[lane];
    nperm = s & 31;
    nbit = s >> 5;
  }
}

// The R1/SPC selection of the general body, by a group of warps (warp
// runs from `base0`, `stride` threads; at W = 16 a codeword's half-warp):
// each input's rank by (|v|, j) among its path's n inputs; ranks < n_min
// give the least reliable positions and |v| in order (== extract_mins'
// rounds wherever every |v| < kBig; the chain's head applies `rstar` for
// the rest); and the signs' parity a path (SPC) into ft.par.
template <int CAP, int W = 32>
__device__ void select_rank(const float* L, int P, int n, int ln, int n_min,
                            bool spc, Small<CAP>& sm, int base0, int stride,
                            int lane) {
  constexpr int kLog = W == 32 ? 5 : 4;
  const int E = P * n;
  const int cw = (E + W - 1) >> kLog;
  for (int base = base0; base < cw * W; base += stride) {
    const int e = base + lane;
    const bool in = e < E;
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
      unsigned neg = __ballot_sync(kFull, in && v < 0.f);
      if constexpr (W < 32) neg = (neg >> (threadIdx.x & 16)) & 0xffffu;   // the half's
      if (lane == 0) {
        if (n >= W) {
          atomicXor(&sm.par[base >> ln], (unsigned)__popc(neg) & 1u);
        } else {
          for (int sg = 0; sg < W && base + sg < E; sg += n)
            atomicXor(&sm.par[(base + sg) >> ln],
                      (unsigned)__popc((neg >> sg) & ((1u << n) - 1u)) & 1u);
        }
      }
    }
  }
}

// Capacity 32: maps[i] = old maps[base(i) + perm[p]] for every map,
// except the map at reset_base, which becomes the identity. Every thread
// of the block.
__device__ void apply_perm32(unsigned char* maps, int total,
                             const unsigned char* perm, int P, int reset_base,
                             int tid) {
  constexpr int kPer = kMapsPerThread32;
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

// Capacity 8: every path map (P bytes at a multiple of P) permuted by the
// node's map, new[p] = old[perm[p]], except the map at byte `reset`,
// which becomes the identity. A thread a map (rank of `size` threads), so
// it is in place without a barrier; the caller syncs after it.
__device__ __forceinline__ void permute_maps(unsigned char* maps, int total,
                                             const unsigned char* perm, int P,
                                             int reset, int rank, int size) {
  unsigned char pr[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) pr[p] = p < P ? perm[p] : 0;
  for (int base = rank * P; base < total; base += size * P) {
    unsigned char v[8];
#pragma unroll
    for (int p = 0; p < 8; ++p)
      if (p < P) v[p] = base == reset ? (unsigned char)p : maps[base + pr[p]];
#pragma unroll
    for (int p = 0; p < 8; ++p)
      if (p < P) maps[base + p] = v[p];
  }
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
// By `size` threads (this one `rank`); the caller syncs after it.
__device__ void kron_stage(unsigned char* x, int stride, int pre, int l,
                           int post, int paths, const unsigned short* tcol,
                           int rank, int size) {
  const int units = pre * post * paths;
  for (int w = rank; w < units; w += size) {
    const int p = w % paths;
    const int ac = w / paths;
    const int a = ac / post, c = ac % post;
    unsigned char* base = x + ((a * l * post + c) * stride + p);
    const unsigned mask = gather_bits(base, l, post * stride);
    for (int k = 0; k < l; ++k)
      base[k * post * stride] = (unsigned char)(__popc(mask & tcol[k]) & 1u);
  }
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
// T = 16: a codeword's half-warp, reduced by its shuffles alone.
template <int T, class SM>
__device__ unsigned block_xor(unsigned v, SM& sm, int lane, int warp) {
#pragma unroll
  for (int off = T < 32 ? T / 2 : 16; off >= 1; off >>= 1)
    v ^= __shfl_xor_sync(kFull, v, off);
  if constexpr (T < 32) {
    return v;
  } else {
    if (lane == 0) sm.red[warp] = v;
    block_sync<T>();
    unsigned r = 0u;
#pragma unroll
    for (int w = 0; w < T / 32; ++w) r ^= sm.red[w];
    block_sync<T>();
    return r;
  }
}

template <int T, class SM>
__device__ int block_sum(int v, SM& sm, int lane, int warp) {
#pragma unroll
  for (int off = T < 32 ? T / 2 : 16; off >= 1; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  if constexpr (T < 32) {
    return v;
  } else {
    if (lane == 0) sm.red[warp] = (unsigned)v;
    block_sync<T>();
    int r = 0;
#pragma unroll
    for (int w = 0; w < T / 32; ++w) r += (int)sm.red[w];
    block_sync<T>();
    return r;
  }
}

// The Monte-Carlo prologue of codeword b (its batch index: Philox
// counter and noise row): data bits, CRC, encode, BPSK-AWGN, LLRs into
// chan[N]; the transmitted u into ut[N]. xb (N bytes) is scratch; st the
// stage tables (read after the first barrier). Every thread of the
// codeword (T threads).
template <bool BIG, int T, class SM>
__device__ void mc_prologue(const SclArgs& a, unsigned b, const StageTab* st,
                            float* chan, unsigned char* ut, unsigned char* xb,
                            SM& sm, int tid, int lane, int warp) {
  const int N = a.N, K = a.K, nh = a.N >> 1;
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
  block_sync<T>();
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
    block_sync<T>();
  }
  for (int t = tid; t < N; t += T) xb[t] = ut[t];
  block_sync<T>();
  if (!BIG || st[0].arikan_below) {
    // x = u F^{(x)m}: log2 N stages of butterfly XORs
    for (int h = nh; h >= 1; h >>= 1) {
      for (int e = tid; e < nh; e += T) {
        const int i = (e / h) * 2 * h + (e % h);
        xb[i] ^= xb[i + h];
      }
      block_sync<T>();
    }
  } else {
    // x = u (K_1 (x) ... (x) K_m): one Kronecker stage per kernel
    for (int s = 1; s <= a.m; ++s) {
      const StageTab& ts = st[s];
      const int l = ts.k.l;
      kron_stage(xb, 1, N / (l * ts.n), l, ts.n, 1, ts.k.kcol, tid, T);
      block_sync<T>();
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
  block_sync<T>();
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

// States a lane of the decode body's syndrome trellis at most (`big_down`,
// bigstage::trellis_llr_any; ops/cuda_scl.py BODY_TRELLIS_MAX_R mirrors
// it). Measured on an H100 (PERF.md §6): up to R = 32 (~3k
// instructions a variant at R = 32) spilled 6-36 B at 128 registers in 13
// of the 15 l > 2 instances; at most R = 4 (every section unrolled) spilled
// too and ran bch_sc's K5 3% slower than before the redesign.
constexpr int kTrellisMaxR = 8;

// DOWN at an l > 2 stage: input i's LLR of every (path, position) into
// out[P, n] (n = 1 << ln). The whole block of T threads; capacity 32 ends
// with a barrier, capacity 8 leaves it to the caller's.
// PRE: the syndrome trellis loads a position's inputs first (`trellis_llr`
// at R = 8), which the capacity-32 subtree kernel (K3) holds in its 128
// registers; the other l > 2 instances spilled 4-64 B with it (PERF.md
// §6) and take the loads four sections ahead.
template <int CAP, int T, bool PRE>
__device__ void big_down(const BigKernel& K, int i, float* out,
                         const float* x, const float* par,
                         const unsigned char* rl, const unsigned char* dec0,
                         const unsigned char* rd, int P, int n, int ln,
                         float (*redf)[2], int tid, int lane, int warp) {
  const int l = K.l;
  const int E = P * n;
  auto row_of = [&](int p) { return par ? par + rl[p] * l * n : x; };
  // element e = (path p, position j): capacity 8 shifts by log2 n;
  // capacity 32 keeps the division its instances were timed with
  auto at = [&](int e, int& p, int& j) {
    if constexpr (CAP == 8) { p = e >> ln; j = e & (n - 1); }
    else { p = e / n; j = e % n; }
  };
  float v[bigstage::kMaxL];
  if (i == l - 1) {
    for (int e = tid; e < E; e += T) {
      int p, j;
      at(e, p, j);
      big_view(K, row_of(p), n, j, i, dec0, rd, P, p, v);
      out[e] = bigstage::last_llr(K, v);
    }
    if constexpr (CAP == 32) block_sync<T>();
    return;
  }
  const int S = K.states[i];
  if (S) {
    // syndrome trellis: `lanes` lanes a position, R = S / lanes states a
    // lane (bigstage::trellis_lanes: one lane a position unless the block
    // would idle), warp-uniform rounds; a warp with no position of its
    // own in a round skips it. A position's prior decisions are read once
    // (its coset mask u); `trellis_llr` reads its parent row's entries.
    const int lanes = bigstage::trellis_lanes(S, E, T, kTrellisMaxR);
    const int per = T / lanes;
    const int g = lane & (lanes - 1);
    for (int base = 0; base < E; base += per) {
      if (base + (tid & ~31) / lanes >= E) break;
      const int e0 = base + tid / lanes;
      const int e = e0 < E ? e0 : E - 1;
      int p, j;
      at(e, p, j);
      unsigned u = 0u;
      for (int c = 0; c < i; ++c)
        u |= (unsigned)dec0[c * P * n + rd[c * P + p] * n + j] << c;
      const float* row = row_of(p) + j;
      const float r = bigstage::trellis_llr_any<kTrellisMaxR, PRE>(
          K, i, g, lanes, [&](int t) {
            const float y = row[t * n];
            return (__popc(u & K.kcol[t]) & 1u) ? -y : y;
          });
      if (e0 < E && g == 0) out[e] = r;
    }
    if constexpr (CAP == 32) block_sync<T>();
    return;
  }
  // tail table: G lanes a position share the columns it walks, up to the
  // whole block when there are few positions; at least a 16-lane group
  // where the quad tables pay (bigstage::table_max)
  const int walk = bigstage::table_walk(K, i);
  int G = bigstage::table_quads(K, i, 16) ? 16 : 1;
  while (G < T && G < walk && E * G * 2 <= T) G *= 2;
  const bool quads = bigstage::table_quads(K, i, G);
  const int per = T / G;
  const int gw = G < 32 ? G : 32;            // lanes of the group in a warp
  for (int base = 0; base < E; base += per) {
    const int e0 = base + tid / G;
    const int e = e0 < E ? e0 : E - 1;
    int p, j;
    at(e, p, j);
    const int g = tid % G;
    big_view(K, row_of(p), n, j, i, dec0, rd, P, p, v);
    float m0, m1;
    bigstage::table_max(K, i, v, g, G, walk, quads, m0, m1);
    m0 = bigstage::group_max(m0, gw);
    m1 = bigstage::group_max(m1, gw);
    if (T == 32 || G <= 32) {
      if (e0 < E && g == 0) out[e] = 0.5f * (m0 - m1);
    } else {
      if (lane == 0) { redf[warp][0] = m0; redf[warp][1] = m1; }
      block_sync<T>();
      if (g == 0 && e0 < E) {
        for (int w = warp + 1; w < warp + G / 32; ++w) {
          m0 = fmaxf(m0, redf[w][0]);
          m1 = fmaxf(m1, redf[w][1]);
        }
        out[e] = 0.5f * (m0 - m1);
      }
      block_sync<T>();
    }
  }
  if constexpr (CAP == 32) block_sync<T>();
}

// ---- the general body at list capacity 8: the l > 2 instances at L <= 8
// (bch_sc's K1, K2, K4, K5) and K3 `scl_subtree` ----
//
// The op-kind clock (kernel_times --split --only bch_sc, PERF.md) put
// bch_sc's K5 (L=1) at 1.03M cycles a block of 256 threads, 68% of it in
// the l > 2 DOWNs, ~6.5k cycles each for a handful of positions (one at
// the second stage): the work was small, the block wide. Every op ended
// in barriers over 8 warps (a tail table of few positions in two more),
// `big_down` divided by a run-time n, the stage's kernel tables were read
// from device memory inside the trellis and table loops, and 64 registers
// spilled 152-180 B. At L=8 (K1, 2.10M cycles) the shuffle forks cost
// 6.7k cycles a fork round and the LEAF/REP forks 19% of the block. This
// design keeps every decision and metric bit for bit (the marginal's
// arithmetic is `big_stage.cuh`'s) and changes how the block is organised:
// - One warp a codeword as a rule (ops/cuda_scl.py `general_threads`): a
//   barrier is a __syncwarp. The block takes a second warp only where the
//   blocks an SM's shared memory holds would bring too few warps (the golden mixed
//   spec, N=512, from L=6 or 7); bch_sc takes one warp at every L. PERF.md
//   (§6) has the times at 32 and 64 threads and why no wider block is
//   kept.
// - At L = 1, K2, K4 and K5 decode two codewords a warp, a half-warp each
//   (ops/cuda_scl.py `general_codewords`, the `_cw2` instances), where an
//   SM then holds more codewords. The op-kind clock by stage (PERF.md §6) put 66% of
//   bch_sc's K5 block in stage 2, one position a step, whose trellis
//   inputs take 2-16 lanes, whose last tables 1-16 and whose leaves one:
//   the second codeword fills lanes the first leaves idle, for the same
//   warps and registers an SM.
// - 128 registers a thread (16 warps an SM): at 80 and 64 these
//   instances spilled and ran slower (PERF.md).
// - The stage tables (StageTab with its BigKernel) are copied once to
//   shared memory; the op table is read one op ahead.
// - In a block of more than one warp, an op of P * n <= 32 elements (and
//   every LEAF) runs in warp 0 alone with __syncwarp (as the Arikan
//   capacity-8 body does); an l > 2 DOWN always takes the whole block.
// - Forks rank from a candidate table (`fork_rank`, shared with the
//   Arikan capacity-8 body); the R1/SPC selection is the one-pass
//   `select_rank` with the `rstar` rule at kBig, as at capacity 32.
// - A thread permutes whole path maps (`permute_maps`): no barrier inside
//   and no bound on the maps a thread holds.
// - The l > 2 element loops shift by log2 n.
constexpr int kBig8Registers = 128;                        // a thread, capacity 8

// Bytes of the stage tables a capacity-8 block copies to the start of its
// dynamic shared memory (16-aligned).
__host__ __device__ inline int stage_copy_bytes(int m) {
  return ((m + 1) * (int)sizeof(StageTab) + 15) & ~15;
}

// Bytes of one codeword's decode state in the general body's dynamic
// shared memory (past the copied stage tables): LLR buffers, the channel
// LLRs (Monte-Carlo kernels), decision bytes, trajectory bits, span perms
// and suffix indices, the path maps, u_true (Monte-Carlo kernels) and the
// subtree kernel's net map.
__host__ __device__ inline int codeword_state_bytes(const SclArgs& a, bool mc,
                                                    bool subtree) {
  return 4 * a.n_lam + a.n_dec + a.N * a.P + 2 * a.Q * a.P + a.n_maps
         + (mc ? 5 * a.N : 0) + (subtree ? a.P : 0);
}

// CW codewords a block: CW = 2 is the list-size-1 instances of K2, K4 and
// K5 (`general_codewords`), a half-warp (TC = 16 threads) a codeword in
// lockstep, each with its own decode state (a 16-aligned region of the
// dynamic shared memory after the one copy of the stage tables) and its
// own `Small<8>`. SC has no forks, so both halves run the same op program
// and meet at the same barriers (__syncwarp); every group of lanes, shuffle
// and ballot stays within a half. Codeword b0 + 2 * blockIdx.x + half; in
// the last block of an odd batch the second half decodes the last codeword
// again and writes nothing. P is 1 at compile time there.
template <int SRC, int OUT, bool BIG, int CAP, int T, int CW = 1>
__device__ __forceinline__ void scl_body(const SclArgs& a) {
  static_assert(OUT != kCounters || SRC == kMonteCarlo,
                "counting errors needs the transmitted u");
  static_assert((OUT == kSubtree) == (SRC == kPathBound),
                "a depth-1 child takes a path-bound input");
  static_assert(CAP == 8 || T == kThreads, "capacity 32 runs kThreads");
  static_assert(CW == 1 || (CW == 2 && CAP == 8 && T == 32 && SRC != kPathBound
                            && OUT != kSelect),
                "two codewords a block: K2, K4, K5 on a warp at capacity 8");
  constexpr int TC = T / CW;                 // threads a codeword
  constexpr int kW = TC >= 32 ? TC / 32 : 1;   // its lane groups
  constexpr int kLanes = TC < 32 ? TC : 32;    // lanes of a group
  // capacity 8 on more than one warp: small ops run in warp 0 alone
  constexpr bool kGroups = CAP == 8 && T > 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Small<CAP> sms[CW];
  const int half = CW == 1 ? 0 : (int)threadIdx.x / TC;
  Small<CAP>& sm = sms[half];
  const int N = a.N, m = a.m, P = CW == 1 ? a.P : 1, Q = a.Q, K = a.K, W = a.W;
  const int tid = CW == 1 ? (int)threadIdx.x : (int)threadIdx.x % TC;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the codeword (its batch index; only K5 launches in chunks); `live`: in
  // the batch (it writes), else it decodes the last one again (`bx`, CW =
  // 2 only)
  const unsigned bq = (OUT == kCounters ? (unsigned)a.b0 : 0u) + blockIdx.x * CW + half;
  const bool live = CW == 1 || (int)bq < a.B;
  const unsigned bx = live ? bq : (unsigned)a.B - 1u;
  // capacity 8: the stage tables in shared memory for the whole decode
  const int st_bytes = CAP == 8 ? stage_copy_bytes(m) : 0;
  const StageTab* const st =
      CAP == 8 ? reinterpret_cast<const StageTab*>(smem) : a.st;
  if constexpr (CAP == 8) {
    const unsigned* from = reinterpret_cast<const unsigned*>(a.st);
    unsigned* to = reinterpret_cast<unsigned*>(smem);
    for (int i = threadIdx.x; i < (m + 1) * (int)sizeof(StageTab) / 4; i += T)
      to[i] = from[i];
  }
  const int cw_off = CW == 1 ? 0
      : half * ((codeword_state_bytes(a, SRC == kMonteCarlo, false) + 15) & ~15);
  float* lam = reinterpret_cast<float*>(smem + st_bytes + cw_off);
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

  if constexpr (TC >= 32) {
    if (tid <= m) {
      const StageTab& ts = a.st[tid];
      sm.stage[tid] = make_int4(ts.n, ts.loff, ts.doff, ts.mbase);
    }
  } else {
    for (int i = tid; i <= m; i += TC) {     // up to 17 stages, 16 lanes
      const StageTab& ts = a.st[i];
      sm.stage[i] = make_int4(ts.n, ts.loff, ts.doff, ts.mbase);
    }
  }
  const float* x;
  if constexpr (SRC == kMonteCarlo) {
    mc_prologue<BIG, TC>(a, bx, st, chan, ut, traj, sm, tid, lane, warp);   // traj: scratch
    clk_mark(kClkPrologue);
    x = chan;
  } else if constexpr (SRC == kPathBound) {
    x = a.llr + (size_t)bq * P * N;
  } else {
    x = a.llr + (size_t)bx * N;
  }

  // stage s (1..m): block n_s, LLR buffer P*n_s, l_s decision children of
  // P*n_s, path maps rlam then rdec of each child (P bytes each)
  auto lam_at = [&](int s) { return lam + sm.stage[s].y; };
  auto dec_at = [&](int s, int c) {
    return dec + sm.stage[s].z + c * P * sm.stage[s].x;
  };
  auto rlam = [&](int s) { return maps + sm.stage[s].w; };
  auto rdec_base = [&](int s, int c) { return sm.stage[s].w + (1 + c) * P; };

  for (int i = tid; i < n_maps; i += TC) maps[i] = (unsigned char)(i % P);
  if (tid < P) {
    if constexpr (SRC == kPathBound) sm.pm[tid] = a.pm_in[bq * P + tid];
    else sm.pm[tid] = (tid == 0) ? 0.f : kBig;
  }
  if constexpr (CAP == 32) {
    if (tid < 64)
      reinterpret_cast<float*>(sm.cand)[tid] =
          (tid & 31) < P ? 0.f : __int_as_float(0x7fffffff);   // NaN
  }
  if (tid < CAP) sm.par[tid] = 0u;
  block_sync<TC>();
  clk_mark(kClkSetup);

  int q = 0;   // trajectory span of the next node op
  // pm in order by (value, path): [0, kBig, ...] is; K3's pm_in is not
  bool pm_sorted = SRC != kPathBound;
  bool prev_small = false;
  int4 nxt = CAP == 8 ? a.ops[0] : make_int4(0, 0, 0, 0);
  for (int o = 0; o < a.n_ops; ++o) {
    int4 op;
    if constexpr (CAP == 8) {
      op = nxt;
      if (o + 1 < a.n_ops) nxt = a.ops[o + 1];
    } else {
      op = a.ops[o];
    }
    const int kind = op.x, lvl = op.y, t0 = op.z, child = op.w;
    const int n = sm.stage[lvl].x;
    const int ln = __ffs(n) - 1;
    const bool down = kind == DOWN_FRESH || kind == DOWN_DYN;
    clk_stage(lvl);
    // the group that runs this op: warp 0 alone for an op of P*n <= 32
    // elements and every LEAF (never an l > 2 DOWN), else the block
    const bool small =
        kGroups && (kind >= LEAF || (P * n <= 32 && !(BIG && down && st[lvl].k.l > 2)));
    if constexpr (kGroups) {
      if (!small && prev_small) __syncthreads();
      prev_small = small;
      if (small && warp != 0) {
        if (kind >= R0) ++q;
        continue;
      }
    }
    const int gsize = small ? 32 : TC, grank = small ? lane : tid;
    const int gwarps = small ? 1 : kW, gwarp = small ? 0 : warp;
    auto gsync = [&]() {
      if (small) __syncwarp();
      else block_sync<TC>();
    };

    if (down) {
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
        const BigKernel& bk = st[s].k;
        if (bk.l > 2) {
          const int bi = kind == DOWN_FRESH ? 0 : child;
          big_down<CAP, TC, CAP == 32 && OUT == kSubtree>(
              bk, bi, out, x, par, rl, d0, rd0, P, n, ln, sm.redf, tid, lane,
              warp);
          if (tid < P) rlam(s)[tid] = (unsigned char)tid;
          block_sync<TC>();
          clk_mark(bi == bk.l - 1 ? kClkBigLast
                   : bk.states[bi] ? kClkBigTrellis : kClkBigTable);
          continue;
        }
      }
      for (int e = grank; e < P * n; e += gsize) {
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
      if (grank < P) rlam(s)[grank] = (unsigned char)grank;
      gsync();
      clk_mark(kClkDown);
      continue;
    }

    if (kind == UP) {
      const int s = lvl;
      unsigned char* dst = dec_at(s - 1, child);
      if constexpr (BIG) {
        const BigKernel& bk = st[s].k;
        const int l = bk.l;
        if (l > 2) {
          // x_k = XOR_j u_j K[j, k] of every (path, position)
          const unsigned char* d0 = dec_at(s, 0);
          const unsigned char* rd0 = maps + rdec_base(s, 0);
          for (int e = grank; e < P * n; e += gsize) {
            const int p = e >> ln, j = e & (n - 1);
            unsigned u = 0u;
            for (int c = 0; c < l; ++c)
              u |= (unsigned)d0[c * P * n + rd0[c * P + p] * n + j] << c;
            for (int k = 0; k < l; ++k)
              dst[p * l * n + k * n + j] =
                  (unsigned char)(__popc(u & bk.kcol[k]) & 1u);
          }
          if (grank < P) maps[rdec_base(s - 1, child) + grank] = (unsigned char)grank;
          gsync();
          clk_mark(kClkUp);
          continue;
        }
      }
      const unsigned char* d0 = dec_at(s, 0);
      const unsigned char* d1 = dec_at(s, 1);
      const unsigned char* rd0 = maps + rdec_base(s, 0);
      const unsigned char* rd1 = maps + rdec_base(s, 1);
      for (int e = grank; e < P * n; e += gsize) {
        const int p = e >> ln, j = e & (n - 1);
        const unsigned char b0 = d0[rd0[p] * n + j];
        const unsigned char b1 = d1[rd1[p] * n + j];
        dst[p * 2 * n + j] = b0 ^ b1;
        dst[p * 2 * n + n + j] = b1;
      }
      if (grank < P) maps[rdec_base(s - 1, child) + grank] = (unsigned char)grank;
      gsync();
      clk_mark(kClkUp);
      continue;
    }

    // ---- node ops at depth d = lvl: input lam_at(d) at identity slots ----
    const int d = lvl;
    const float* L = lam_at(d);
    unsigned char* D = dec_at(d, child);
    const int reset = rdec_base(d, child);

    if (kind == R0) {
      if constexpr (CAP == 8) {
        node_sums<kLanes>(L, n, ln, P, 0, gwarp, gwarps, lane,
                  [&](int p, float v) { sm.pm[p] = sm.pm[p] + v; });
      } else {
        for (int p = warp; p < P; p += kWarps) {
          const float sum = warp_tree_sum(L + p * n, n, 0, lane);
          if (lane == 0) sm.pm[p] = sm.pm[p] + sum;
        }
      }
      for (int e = grank; e < P * n; e += gsize) {
        const int p = e >> ln, j = e & (n - 1);
        D[e] = 0;
        traj[(t0 + j) * P + p] = 0;
      }
      if (grank < P) {
        tperm[q * P + grank] = (unsigned char)grank;
        maps[reset + grank] = (unsigned char)grank;
      }
      ++q;
      pm_sorted = P == 1;
      gsync();
      clk_mark(kClkR0);
      continue;
    }

    if (kind == REP || kind == LEAF || kind == LEAF_FROZEN) {
      if (kind == REP) {
        if constexpr (CAP == 8) {
          node_sums<kLanes>(L, n, ln, P, 0, gwarp, gwarps, lane,
                    [&](int p, float v) { sm.s0[p] = v; });
          node_sums<kLanes>(L, n, ln, P, 1, gwarp, gwarps, lane,
                    [&](int p, float v) { sm.s1[p] = v; });
        } else {
          for (int p = warp; p < P; p += kWarps) {
            const float a = warp_tree_sum(L + p * n, n, 0, lane);
            const float b = warp_tree_sum(L + p * n, n, 1, lane);
            if (lane == 0) { sm.s0[p] = a; sm.s1[p] = b; }
          }
        }
      } else if (grank < P) {
        sm.s0[grank] = fmaxf(-L[grank], 0.f);
        sm.s1[grank] = fmaxf(L[grank], 0.f);
      }
      gsync();
      clk_mark(kClkRepSums);
      if (gwarp == 0) {
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
          if constexpr (CAP == 32) {
            if (lane < P) {
              reinterpret_cast<float*>(sm.cand)[lane] = pmv + a;
              reinterpret_cast<float*>(sm.cand)[32 + lane] = pmv + b;
            }
            fork_table(sm, lane, P, false, npm, nperm, nbit);
          } else {
            fork_rank(sm, lane, P, pmv, a, b, npm, nperm, nbit);
          }
          if (lane < P) {
            sm.pm[lane] = npm;
            sm.nmap[lane] = (unsigned char)nperm;
            sm.bit[lane] = (unsigned char)nbit;
          }
        }
      }
      gsync();
      clk_mark(kClkRepFork);
      if constexpr (CAP == 32) apply_perm32(maps, n_maps, sm.nmap, P, reset, tid);
      else permute_maps(maps, n_maps, sm.nmap, P, reset, grank, gsize);
      clk_mark(kClkPerm);
      for (int e = grank; e < P * n; e += gsize) {
        const int p = e >> ln, j = e & (n - 1);
        const unsigned char bit = sm.bit[p];
        D[e] = bit;
        traj[(t0 + j) * P + p] = (j == n - 1) ? bit : 0;
      }
      if (grank < P) tperm[q * P + grank] = sm.nmap[grank];
      ++q;
      pm_sorted = kind != LEAF_FROZEN || P == 1;
      gsync();
      clk_mark(kClkRepFork);
      continue;
    }

    // ---- R1 / SPC: least-reliable keep/flip forks (Fast-SSCL) ----
    const bool spc = (kind == SPC);
    const int rounds = spc ? (P == 1 ? 0 : min(P, n - 1)) : min(P - 1, n);
    const int n_min = spc ? rounds + 1 : rounds;
    const int first = spc ? 1 : 0;
    clk_count(kClkRounds, rounds);
    // 1. the least reliable positions and the parity, one pass
    select_rank<CAP, kLanes>(L, P, n, ln, n_min, spc, sm, gwarp * 32, gsize, lane);
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
        float npm; int nperm, nbit;
        if constexpr (CAP == 32) {
          float* cand = reinterpret_cast<float*>(sm.cand);
          if (lane < P) {
            float pen = sm.vals[r + first][nm];
            if (spc) pen = pen + (1.f - 2.f * (float)eta) * sm.vals[0][nm];
            cand[lane] = pmv + 0.f;
            cand[32 + lane] = pmv + pen;
          }
          fork_table(sm, lane, P, r > 0 || (pm_sorted && !spc), npm, nperm, nbit);
        } else {
          float pen = 0.f;
          if (lane < P) {
            pen = sm.vals[r + first][nm];
            if (spc) pen = pen + (1.f - 2.f * (float)eta) * sm.vals[0][nm];
          }
          fork_rank(sm, lane, P, pmv, 0.f, pen, npm, nperm, nbit);
        }
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
    pm_sorted = P == 1 || rounds > 0 || (pm_sorted && !spc);
    gsync();
    clk_mark(kClkChain);
    // 3. decisions x, the path maps, and u = x K^-1 below into the rows
    for (int e = grank; e < P * n; e += gsize) {
      const int p = e >> ln, j = e & (n - 1);
      const int src = sm.nmap[p];
      unsigned char xb = L[src * n + j] < 0.f;
      if (spc && sm.poss[0][src] == j) xb ^= sm.bit[p];
      for (int r = 0; r < rounds; ++r)
        if (sm.poss[r + first][src] == j) xb ^= sm.flipfin[r][p];
      D[e] = xb;
      traj[(t0 + j) * P + p] = xb;
    }
    clk_mark(kClkDecide);
    if constexpr (CAP == 32) {
      apply_perm32(maps, n_maps, sm.nmap, P, reset, tid);
    } else {
      permute_maps(maps, n_maps, sm.nmap, P, reset, grank, gsize);
      gsync();
    }
    clk_mark(kClkPerm);
    if (!BIG || st[d].arikan_below) {
      // u = x F^{(x)k}: in-place butterflies over the span's trajectory rows
      for (int h = n >> 1; h >= 1; h >>= 1) {
        for (int e = grank; e < P * (n >> 1); e += gsize) {
          const int p = e / (n >> 1), k = e % (n >> 1);
          const int i = (k / h) * 2 * h + (k % h);
          traj[(t0 + i) * P + p] ^= traj[(t0 + i + h) * P + p];
        }
        gsync();
      }
    } else {
      // u = x (K_{d+1} (x) ... (x) K_m)^-1, one stage per kernel below
      for (int s = d + 1; s <= m; ++s) {
        const StageTab& ts = st[s];
        const int l = ts.k.l;
        kron_stage(traj + t0 * P, P, n / (l * ts.n), l, ts.n, P, ts.icol,
                   grank, gsize);
        gsync();
      }
    }
    clk_mark(kClkInverse);
    ++q;
  }
  if constexpr (kGroups) {
    if (prev_small) __syncthreads();
  }

  const size_t b = bq;
  if constexpr (OUT == kTrajectory || OUT == kSubtree) {
    if (!live) return;                     // no barrier follows
    // the genealogy, [B, ...]-major: one contiguous run per codeword
    uint8_t* tb = a.traj_bit + b * N * P;
    for (int i = tid; i < N * P; i += TC) tb[i] = traj[i];
    uint8_t* tp = a.traj_perm + b * Q * P;
    for (int i = tid; i < Q * P; i += TC) tp[i] = tperm[i];
    if (tid < P) a.pm[b * P + tid] = sm.pm[tid];
    if constexpr (SRC == kMonteCarlo) {
      int8_t* u = a.u_true + b * N;
      for (int t = tid; t < N; t += TC) u[t] = (int8_t)ut[t];
    }
    if constexpr (OUT == kSubtree) {
      // the net survival map, and the root re-encode x_k = XOR_j u_j
      // K_1[j, k] of the stage-1 children (through their maps: final path
      // indexing), what the parent's UP would write
      if (tid < P) a.netp[b * P + tid] = netmap[tid];
      const BigKernel& bk = st[1].k;
      const int l = bk.l, n = sm.stage[1].x;
      const unsigned char* d0 = dec_at(1, 0);
      const unsigned char* rd0 = maps + rdec_base(1, 0);
      uint8_t* xo = a.xblk + b * P * N;
      for (int e = tid; e < P * n; e += TC) {
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
  block_sync<TC>();
  for (int p = warp; p < P; p += kW) {
    unsigned acc = 0u, rec = 0u;
    if (W > 0) {
      for (int t = lane; t < N; t += kLanes) {
        const int k = a.pidx[t];
        if (k < 0) continue;
        const unsigned bit = traj[t * P + sidx[a.qrow[t] * P + p]];
        if (k < K) acc ^= bit ? a.gmask[k] : 0u;
        else rec |= bit << (k - K);
      }
#pragma unroll
      for (int off = kLanes / 2; off >= 1; off >>= 1) {
        acc ^= __shfl_xor_sync(kFull, acc, off);
        rec |= __shfl_xor_sync(kFull, rec, off);
      }
    }
    if (lane == 0) sm.ok[p] = (W == 0 || (acc ^ a.offmask) == rec) ? 1.f : 0.f;
  }
  block_sync<TC>();
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
  block_sync<TC>();
  const int best = sm.best;
  if constexpr (OUT == kSelect) {
    int8_t* u = a.u + b * N;
    for (int t = tid; t < N; t += TC)
      u[t] = (int8_t)traj[t * P + sidx[a.qrow[t] * P + best]];
  } else {
    // errors of the best path on the data rows (CRC rows do not count)
    int err = 0;
    for (int t = tid; t < N; t += TC) {
      const int k = a.pidx[t];
      if (k < 0 || k >= K) continue;
      err += traj[t * P + sidx[a.qrow[t] * P + best]] != ut[t];
    }
    err = block_sum<TC>(err, sm, lane, warp);
    if (tid == 0 && live) {
      a.counters[b] = err > 0;
      a.counters[a.B + b] = err;
    }
  }
}

// ---- the Arikan capacity-8 body: K1, K2, K4, K5 of Arikan specs, P <= 8 ----
//
// First redesign (on the general body's op-kind clock at ca_scl, L=8, K5:
// 60% of a block in the R1/SPC fork chains, each fork two loops of 2P
// shuffles with divisions by a run-time P, 7 of 8 warps waiting): forks
// ranked from a candidate table, a one-pass selection, decisions and
// trajectory bits as 32-bit words written by __ballot_sync, path maps of 8
// bytes permuted by __byte_perm, and ops of P*n <= kSmallWork elements
// (and every LEAF) in warp 0 alone with __syncwarp, so a block barrier
// sits only where the work moves between warp 0 and the block. The R1/SPC
// inverse transform u = x F^(x)k works on the bit words.
//
// Second redesign. Its own clock (sim/kernel_times.py --split, ca_scl,
// K5, on an H100) put 31% of 0.93M cycles a block in the fork chains
// (~1.3k cycles a round), 18% in DOWN and 16% in the selection, whose
// rank costs n compares an input (8 x 128^2 at the n = 128 SPC node); and
// ~42 KB of shared memory a block held an SM to 5 codewords, 20 of its 64
// warps. The lever is codewords in flight and a shorter chain:
// - Stage 1 is not stored (`view1`, where no node op reads it): its rows
//   are f(x[j], x[j + n1]) for every path (DOWN_FRESH) or x[j] (1 - 2d) +
//   x[j + n1] (DOWN_DYN), d the bit of stage 1's child-0 decisions at the
//   row of path map 1. Map 0 (stage 1's rows) is reset at the stage-1
//   DOWN_DYN and from then on permuted with map 1, which nothing resets
//   later, so the row map0[p] was made from decision row map1_then[map0[p]]
//   = map1_now[p]: the stage-2 DOWNs recompute the row from the channel row
//   and map 1, the same arithmetic, so bit for bit. It saves P*N/2 floats
//   (16 KB at ca_scl). u_true is kept as bits. (Stage 2 the same way: 8 KB
//   more, 12-15 blocks an SM, and slower on an H100: not taken.)
// - Threads a codeword by a rule of the layout (ops/cuda_scl.py
//   `fast_threads`): 128 while
//   the registers (kFastRegisters a thread) cap the blocks an SM, 64 where
//   shared memory would hold more 128-thread blocks than the registers.
//   ca_scl K5 (~26 KB): 8 blocks of 128; K1 (~21 KB): 10 of 64.
// - The leader's part runs on the warp `leader_warp` picks from the warp
//   slots the block got, so the chains of an SM's blocks spread over its
//   four sub-partitions (at 64 threads a fixed warp 0 sat on two of them).
// - The fork in registers (`fork_reg`): lane p holds path p's metric, node
//   map, eta and least-reliable values; a round gathers its penalty through
//   the node map by a shuffle, ranks the 2P candidates by shuffles and takes
//   survivor r by a ballot on rank == r; no shared memory and no barrier in
//   a round. The flips on each survivor's line are carried forward as a
//   mask (no perms/flips record to walk back). Shuffles sit outside every
//   branch and the compares are bitwise: nvcc wraps a shuffle behind a
//   branch, and a short-circuit && / ||, in a reconvergence barrier.
// - DOWN takes four pairs a step (16-byte reads and writes, four decision
//   bits from one word) where n is a multiple of 4.
// - Nodes of n >= 64 select by extraction: a warp a path, n_min rounds of
//   a warp minimum by (|v|, j), each input a lane's (n / 32 a lane).
// Every decision and metric stays the first redesign's, bit for bit.
constexpr int kSmallWork = 32;
// registers a thread at the launch bounds: 65536 / 64 / T blocks an SM
constexpr int kFastRegisters = 64;
constexpr int kFastExtract = 64;    // from this n (to 1024) the selection extracts

// Node-local state of the Arikan capacity-8 body (static shared memory);
// ops/cuda_scl.py FAST_STATIC_BYTES mirrors its size.
struct Fast {
  int4 stage[kMaxStages];          // n, LLR offset, decision word offset
  float pm[8];
  float vals[9][8];                // least-reliable |llr| by rank, path
  float s0[8], s1[8];              // REP sums
  float ok[8];                     // CRC pass per path (0/1)
  short poss[9][8];                // their positions
  unsigned par[8];                 // SPC parity per path, 0 between nodes
  unsigned red[8];                 // block reductions
  unsigned char rstar[8];          // inputs below kBig per path (<= n_min)
  unsigned char nmap[8];           // node-local path map (identity beyond P)
  unsigned char bit[8];            // fork bit / eta
  unsigned char flipm[8];          // R1/SPC: bit r = the flip of round r
                                   // on path p's line (`fork chain`)
  int best;
};

// The warp of a block of kW warps that runs the leader's part (ops of
// P*n <= kSmallWork, the forks, the path maps), from the warp slots
// (%warpid) the block got, `slot[w]` (warp slot s issues from the SM's
// sub-partition s % 4): the one on sub-partition (s0 + ((s0 >> 2) & (kW -
// 1))) % 4, s0 the block's least slot, else warp 0. An H100 gives a 4-warp block the
// slots 4k .. 4k + 3 with warp 0 on sub-partition k % 4, which the rule
// keeps; a 2-warp block 2k, 2k + 1 with warp 0 on sub-partition 0 or 2,
// where the rule takes sub-partitions 0, 2, 1, 3 for k = 0, 1, 2, 3 (mod
// 4). So the leaders of an SM's blocks spread over its four
// sub-partitions.
__device__ __forceinline__ unsigned warp_slot() {
#ifdef __CUDA_ARCH__
  unsigned s;
  asm volatile("mov.u32 %0, %%warpid;" : "=r"(s));
  return s;
#else
  return 0u;
#endif
}

__device__ __forceinline__ int leader_warp(const unsigned* slot, int kW) {
  unsigned s0 = slot[0];
  for (int w = 1; w < kW; ++w) s0 = min(s0, slot[w]);
  const unsigned want = (s0 + ((s0 >> 2) & (unsigned)(kW - 1))) & 3u;
  for (int w = 0; w < kW; ++w)
    if ((slot[w] & 3u) == want) return w;
  return 0;
}

// Byte offsets of the body's dynamic shared memory: LLR buffers P*(N-1)
// f32, or P*(N/2 - 1) without stage 1 (`view`; at least 2N bytes in the
// Monte-Carlo kernels: the prologue's u and x bytes), the channel LLRs N
// f32 (Monte-Carlo), decision words (two children of ceil(P*n_s/32) words
// a stage), trajectory rows (P rows of ceil(N/32) words), path maps (3 a
// stage, 8 bytes each), span perms and suffix indices (Q*P bytes each),
// u_true as ceil(N/32) words (Monte-Carlo). ops/cuda_scl.py
// `fast_smem_bytes` mirrors it.
struct FastLayout {
  int chan, dec, traj, maps, tperm, ut, total;
};

__host__ __device__ inline FastLayout fast_layout(int N, int m, int P, int Q,
                                                 bool mc, bool view) {
  FastLayout l;
  int off = 4 * P * ((view ? N >> 1 : N) - 1);
  if (mc && off < 2 * N) off = 2 * N;
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
  off = (off + 3) & ~3;
  l.ut = off;
  if (mc) off += 4 * ((N + 31) >> 5);
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

// Four floats from p: one 16-byte read where p is 16-byte aligned.
__device__ __forceinline__ float4 load4(const float* p, bool aligned) {
  if (aligned) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

// The f (DOWN_FRESH) or g (DOWN_DYN, bit d) step of one pair.
__device__ __forceinline__ float fg_step(bool dyn, float va, float vb, unsigned d) {
  if (!dyn) {
    const float sg = ((va < 0.f) != (vb < 0.f)) ? -1.f : 1.f;
    return sg * fminf(fabsf(va), fabsf(vb));
  }
  return va * (1.f - 2.f * (float)d) + vb;
}

// The same for four pairs, bit k of dw the g step's bit of pair k.
__device__ __forceinline__ float4 fg_step4(bool dyn, float4 a, float4 b, unsigned dw) {
  return make_float4(fg_step(dyn, a.x, b.x, dw & 1u), fg_step(dyn, a.y, b.y, (dw >> 1) & 1u),
                     fg_step(dyn, a.z, b.z, (dw >> 2) & 1u), fg_step(dyn, a.w, b.w, (dw >> 3) & 1u));
}

// 2P -> P fork in registers, one warp, all 32 lanes (P <= 8): lane p < P
// holds path p's candidates a = pm + pen0 (c = p) and b = pm + pen1 (c =
// P + p). Lane l < 2P ranks candidate l by (metric, c) against all 2P by
// shuffles; lane r < P takes survivor r from the lane whose rank is r (a
// ballot a survivor): metric, parent path, bit. == `fork_rank`.
__device__ __forceinline__ void fork_reg(int lane, int P, float a, float b,
                                         float& npm, int& nperm, int& nbit) {
  const float bl = __shfl_sync(kFull, b, (lane - P) & 31);
  const float v = lane < P ? a : bl;
  // every shuffle and ballot unconditional, and the compares bitwise: a
  // branch on P, or a short-circuit && / ||, costs a reconvergence
  // barrier; four partial counts, not one chain of 16 increments
  int r4[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float oa = __shfl_sync(kFull, a, k);
    const float ob = __shfl_sync(kFull, b, k);
    r4[(2 * k) & 3] += (k < P) & ((oa < v) | ((oa == v) & (k < lane)));
    r4[(2 * k + 1) & 3] += (k < P) & ((ob < v) | ((ob == v) & (P + k < lane)));
  }
  const int rank = (r4[0] + r4[1]) + (r4[2] + r4[3]);
  int src = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const unsigned w = __ballot_sync(kFull, (lane < 2 * P) & (rank == r));
    src = lane == r ? __ffs(w) - 1 : src;
  }
  npm = __shfl_sync(kFull, v, src);
  nbit = src >= P;
  nperm = src - (nbit ? P : 0);
  if (lane >= P) { npm = 0.f; nperm = 0; nbit = 0; }
}

// The least-reliable selection of one path's n inputs (64 <= n <= 1024),
// by one warp: n_min rounds of a warp minimum by (|v|, j) over the inputs
// not yet taken (input j is lane j & 31's), positions and |v| in order ==
// the one-pass rank's; the inputs below kBig (the chain's `rstar` rule) and
// the signs' parity (SPC) a path.
template <class SM>
__device__ void extract_path(const float* row, int n, int n_min, bool spc,
                             int p, SM& sm, int lane) {
  const int k = n >> 5;
  int below = 0;
  unsigned neg = 0u;
  for (int i = 0; i < k; ++i) {
    const float v = row[lane + 32 * i];
    below += fabsf(v) < kBig;
    neg ^= (unsigned)(v < 0.f);
  }
  if (spc) {
    neg = __reduce_xor_sync(kFull, neg);
    if (lane == 0) sm.par[p] = neg;
  }
  if (n_min == 0) return;
  below = __reduce_add_sync(kFull, below);
  unsigned taken = 0u;
  for (int r = 0; r < n_min; ++r) {
    float bv = __int_as_float(0x7f800000);   // +inf at no position
    int bj = 0x7fffffff;
    for (int i = 0; i < k; ++i) {
      if ((taken >> i) & 1u) continue;
      const int j = lane + 32 * i;
      const float av = fabsf(row[j]);
      const bool lt = (av < bv) | ((av == bv) & (j < bj));
      bv = lt ? av : bv;
      bj = lt ? j : bj;
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oj = __shfl_xor_sync(kFull, bj, off);
      const bool lt = (ov < bv) | ((ov == bv) & (oj < bj));
      bv = lt ? ov : bv;
      bj = lt ? oj : bj;
    }
    if ((bj & 31) == lane) taken |= 1u << (bj >> 5);
    if (lane == 0) {
      sm.poss[r][p] = (short)bj;
      sm.vals[r][p] = bv;
    }
  }
  if (lane == 0) sm.rstar[p] = (unsigned char)min(below, n_min);
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
  const bool view1 = a.view1 != 0;
  const FastLayout ly = fast_layout(N, m, P, Q, SRC == kMonteCarlo, view1);
  float* lam = reinterpret_cast<float*>(smem);
  float* chan = reinterpret_cast<float*>(smem + ly.chan);
  unsigned* decw = reinterpret_cast<unsigned*>(smem + ly.dec);
  unsigned* trajw = reinterpret_cast<unsigned*>(smem + ly.traj);
  uint2* maps = reinterpret_cast<uint2*>(smem + ly.maps);
  unsigned char* tperm = smem + ly.tperm;
  unsigned char* sidx = tperm + Q * P;
  unsigned* utw = reinterpret_cast<unsigned*>(smem + ly.ut);
  const int R = (N + 31) >> 5;     // words of a trajectory row
  const int n_maps = 3 * m;        // stage s: rlam, rdec child 0, child 1
  const int n1 = N >> 1;           // stage 1's block

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the codeword (its batch index; only K5 launches in chunks)
  const unsigned bq = (OUT == kCounters ? (unsigned)a.b0 : 0u) + blockIdx.x;
  if (tid <= m) {
    int dw = 0;
    for (int s = 1; s < tid; ++s) dw += 2 * ((P * (N >> s) + 31) >> 5);
    const int lo = P * ((view1 ? n1 : N) - 2 * (N >> tid));
    sm.stage[tid] = make_int4(N >> tid, lo, dw, 0);
  }
  if (tid < 8) {
    sm.nmap[tid] = (unsigned char)tid;
    sm.par[tid] = 0u;
  }
  const float* x;
  if constexpr (SRC == kMonteCarlo) {
    // the LLR buffers are scratch until the first DOWN: u_true and x bytes
    unsigned char* ub = reinterpret_cast<unsigned char*>(lam);
    mc_prologue<false, T>(a, bq, a.st, chan, ub, ub + N, sm, tid, lane, warp);
    __syncthreads();
    for (int base = warp * 32; base < R * 32; base += T) {
      const int t = base + lane;
      const unsigned w = __ballot_sync(kFull, t < N && ub[t]);
      if (lane == 0) utw[base >> 5] = w;
    }
    clk_mark(kClkPrologue);
    x = chan;
  } else {
    x = a.llr + (size_t)bq * N;
  }
  for (int i = tid; i < P * R; i += T) trajw[i] = 0u;
  for (int i = tid; i < n_maps; i += T) maps[i] = ident_map();
  if (tid < P) sm.pm[tid] = (tid == 0) ? 0.f : kBig;
  if (lane == 0) sm.red[warp] = warp_slot();
  __syncthreads();
  // the op loop's warps, counted from the leader
  const int rwarp = (warp - leader_warp(sm.red, kW)) & (kW - 1);
  const int rtid = rwarp * 32 + lane;
  const bool clk0 = rtid == 0;     // the op-kind clock's thread

  auto lam_at = [&](int s) { return lam + sm.stage[s].y; };
  auto dec_at = [&](int s, int c) {
    return decw + sm.stage[s].z + c * ((P * sm.stage[s].x + 31) >> 5);
  };
  auto map_at = [&](int k) {
    return reinterpret_cast<const unsigned char*>(maps + k);
  };
  auto bit_at = [](const unsigned* w, int i) { return (w[i >> 5] >> (i & 31)) & 1u; };

  int q = 0;                 // trajectory span of the next node op
  bool dyn1 = false;         // stage 1 holds DOWN_DYN rows (view1)
  bool prev_small = false;
  int prev_slot = kClkSetup;
  int4 nxt = a.ops[0];
  for (int o = 0; o < a.n_ops; ++o) {
    const int4 op = nxt;
    if (o + 1 < a.n_ops) nxt = a.ops[o + 1];
    const int kind = op.x, lvl = op.y, t0 = op.z, child = op.w;
    const int n = sm.stage[lvl].x;
    const int ln = __ffs(n) - 1;
    // the group that runs this op: the leader warp alone, or the block
    const bool small = kind >= LEAF || P * n <= kSmallWork;
    if (small && prev_small) __syncwarp(); else __syncthreads();
    clk_mark_by(clk0, prev_slot);
    prev_small = small;
    const int qq = q;
    if (kind >= R0) ++q;
    if (kind <= DOWN_DYN && lvl == 1) dyn1 = kind == DOWN_DYN;
    if (small && rwarp != 0) continue;
    const int gsize = small ? 32 : T, grank = small ? lane : rtid;
    const int gwarps = small ? 1 : kW, gwarp = small ? 0 : rwarp;
    auto gsync = [&]() { if (small) __syncwarp(); else __syncthreads(); };

    if (kind == DOWN_FRESH || kind == DOWN_DYN) {
      const int s = lvl;
      if (!(view1 && s == 1)) {
        float* out = lam_at(s);
        const bool from_view = view1 && s == 2;
        const float* par = (s > 1 && !from_view) ? lam_at(s - 1) : nullptr;
        const unsigned char* rl = (s > 1) ? map_at(3 * (s - 2)) : nullptr;
        const unsigned* d0 = dec_at(s, 0);
        const unsigned char* rd0 = map_at(3 * (s - 1) + 1);
        // stage 1's row of path p at j1 < n1, from the channel row
        const unsigned* d1 = dec_at(1, 0);
        const unsigned char* r1 = map_at(1);
        const bool dyn = kind == DOWN_DYN;
        if ((n & 3) == 0) {
          // four pairs a step: 16-byte reads and writes, four decision
          // bits from one word (rows and offsets are multiples of 4)
          const bool xal = (reinterpret_cast<size_t>(x) & 15) == 0;
          auto stage1x4 = [&](int p, int j1) {
            unsigned dw = 0u;
            if (dyn1) {
              const int i = r1[p] * n1 + j1;
              dw = d1[i >> 5] >> (i & 31);
            }
            return fg_step4(dyn1, load4(x + j1, xal), load4(x + j1 + n1, xal), dw);
          };
          for (int q4 = grank; q4 < (P * n) >> 2; q4 += gsize) {
            const int e = q4 << 2, p = e >> ln, j = e & (n - 1);
            float4 va, vb;
            if (s == 1) {
              va = load4(x + j, xal);
              vb = load4(x + j + n, xal);
            } else if (from_view) {
              va = stage1x4(p, j);
              vb = stage1x4(p, j + n);
            } else {
              const float* row = par + rl[p] * 2 * n;
              va = load4(row + j, true);
              vb = load4(row + j + n, true);
            }
            unsigned dw = 0u;
            if (dyn) {
              const int i = rd0[p] * n + j;
              dw = d0[i >> 5] >> (i & 31);
            }
            *reinterpret_cast<float4*>(out + e) = fg_step4(dyn, va, vb, dw);
          }
        } else {
          auto stage1 = [&](int p, int j1) {
            return fg_step(dyn1, x[j1], x[j1 + n1], dyn1 ? bit_at(d1, r1[p] * n1 + j1) : 0u);
          };
          for (int e = grank; e < P * n; e += gsize) {
            const int p = e >> ln, j = e & (n - 1);
            float va, vb;
            if (s == 1) {
              va = x[j];
              vb = x[j + n];
            } else if (from_view) {
              va = stage1(p, j);
              vb = stage1(p, j + n);
            } else {
              const float* row = par + rl[p] * 2 * n;
              va = row[j];
              vb = row[j + n];
            }
            out[e] = fg_step(dyn, va, vb, dyn ? bit_at(d0, rd0[p] * n + j) : 0u);
          }
        }
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
      clk_mark_by(clk0, kClkRepSums);
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
          fork_reg(lane, P, pmv + s0, pmv + s1, npm, nperm, nbit);
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
    clk_count_by(clk0, kClkRounds, rounds);
    // 1. the n_min least-reliable positions of each path in order, and the
    //    signs' parity (SPC): by extraction, a warp a path, for
    //    kFastExtract <= n <= 1024; else each input's rank by (|v|, j) in
    //    its path, ranks < n_min giving the positions
    if (n >= kFastExtract && n <= 1024) {
      for (int p = gwarp; p < P; p += gwarps)
        extract_path(L + p * n, n, n_min, spc, p, sm, lane);
    } else {
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
            // rows start at multiples of 4 floats: 16-byte reads; four
            // partial counts, not one chain of n increments
            const float4* row4 = reinterpret_cast<const float4*>(row);
            int r4[4] = {0, 0, 0, 0}, b4[4] = {0, 0, 0, 0};
            for (int k4 = 0; k4 < (n >> 2); ++k4) {
              const float4 w4 = row4[k4];
              const float ak[4] = {fabsf(w4.x), fabsf(w4.y), fabsf(w4.z), fabsf(w4.w)};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int k = 4 * k4 + i;
                r4[i] += (ak[i] < av) | ((ak[i] == av) & (k < j));
                b4[i] += ak[i] < kBig;
              }
            }
            rank = (r4[0] + r4[1]) + (r4[2] + r4[3]);
            below = (b4[0] + b4[1]) + (b4[2] + b4[3]);
          } else {
            for (int k = 0; k < n; ++k) {
              const float ak = fabsf(row[k]);
              rank += (ak < av) | ((ak == av) & (k < j));
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
    }
    gsync();
    clk_mark_by(clk0, kClkSelect);
    // 2. the fork chain, warp 0, in registers: lane p < P holds the metric,
    //    node map and eta of survivor p and path p's least-reliable values
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
      // round r's penalty of path p is vals[r + first][p] (a read that no
      // round waits on); SPC's parity term vals[0][p] in v0
      const float v0 = lane < P ? sm.vals[0][lane] : 0.f;
      // the flips of each round on the line of survivor p, carried forward
      // (defer_flips walks the record back instead)
      unsigned fm = 0u;
      for (int r = 0; r < rounds; ++r) {
        const float vr = lane < P ? sm.vals[r + first][lane] : 0.f;
        float pen = __shfl_sync(kFull, vr, nm);
        const float f0 = __shfl_sync(kFull, v0, nm);
        if (spc) pen = pen + (1.f - 2.f * (float)eta) * f0;
        float npm; int nperm, nbit;
        fork_reg(lane, P, pmv + 0.f, pmv + pen, npm, nperm, nbit);
        nm = __shfl_sync(kFull, nm, nperm);
        eta = __shfl_sync(kFull, eta, nperm) ^ nbit;
        fm = __shfl_sync(kFull, fm, nperm) | ((unsigned)nbit << r);
        pmv = npm;
      }
      if (lane < P) {
        sm.flipm[lane] = (unsigned char)fm;
        sm.pm[lane] = pmv;
        sm.nmap[lane] = (unsigned char)nm;
        sm.bit[lane] = (unsigned char)eta;
        tperm[qq * P + lane] = (unsigned char)nm;
      }
      __syncwarp();
      fast_perm(maps, n_maps, sm.nmap, reset, lane);
    }
    gsync();
    clk_mark_by(clk0, kClkChain);
    // 3. decisions x (D), and u = x F^(x)k into the trajectory rows
    for (int base = gwarp * 32; base < cw * 32; base += gsize) {
      const int e = base + lane;
      unsigned xb = 0u;
      if (e < P * n) {
        const int p = e >> ln, j = e & (n - 1);
        const int src = sm.nmap[p];
        const unsigned fmp = sm.flipm[p];
        xb = L[src * n + j] < 0.f;
        if (spc && sm.poss[0][src] == j) xb ^= sm.bit[p];
        for (int r = 0; r < rounds; ++r)
          if (sm.poss[r + first][src] == j) xb ^= (fmp >> r) & 1u;
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
      clk_mark_by(clk0, kClkDecide);
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
  clk_mark_by(clk0, prev_slot);

  const size_t b = bq;
  auto traj_at = [&](int t, int slot) {
    return (trajw[slot * R + (t >> 5)] >> (t & 31)) & 1u;
  };
  auto ut_at = [&](int t) { return (utw[t >> 5] >> (t & 31)) & 1u; };
  if constexpr (OUT == kTrajectory) {
    uint8_t* tb = a.traj_bit + b * N * P;
    for (int i = tid; i < N * P; i += T) tb[i] = (uint8_t)traj_at(i / P, i % P);
    uint8_t* tp = a.traj_perm + b * Q * P;
    for (int i = tid; i < Q * P; i += T) tp[i] = tperm[i];
    if (tid < P) a.pm[b * P + tid] = sm.pm[tid];
    if constexpr (SRC == kMonteCarlo) {
      int8_t* u = a.u_true + b * N;
      for (int t = tid; t < N; t += T) u[t] = (int8_t)ut_at(t);
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
      err += traj_at(t, sidx[a.qrow[t] * P + best]) != ut_at(t);
    }
    err = block_sum<T>(err, sm, lane, warp);
    if (tid == 0) {
      a.counters[b] = err > 0;
      a.counters[a.B + b] = err;
    }
  }
}

#define SCL_KERNEL(NAME, T, MIN_BLOCKS, ...)                               \
  __global__ void __launch_bounds__(T, MIN_BLOCKS) NAME(SclArgs a) {       \
    clk_begin();                                                          \
    scl_body<__VA_ARGS__, T>(a);                                          \
    clk_end();                                                            \
  }

#define FAST_KERNEL(NAME, T, SRC, OUT)                                           \
  __global__ void __launch_bounds__(T, 65536 / kFastRegisters / (T)) NAME##_t##T( \
      SclArgs a) {                                                              \
    clk_begin();                                                                \
    fast_body<SRC, OUT, T>(a);                                                  \
    clk_end();                                                                  \
  }
#define FAST_KERNELS(T)                                 \
  FAST_KERNEL(scl_decode, T, kLlrIn, kSelect)           \
  FAST_KERNEL(scl_decode_traj, T, kLlrIn, kTrajectory)  \
  FAST_KERNEL(scl_mc_traj, T, kMonteCarlo, kTrajectory) \
  FAST_KERNEL(scl_mc_counters, T, kMonteCarlo, kCounters)

// Arikan, capacity 8: the redesigned body at 64 and 128 threads a
// codeword (`fast_threads`), each at kFastRegisters a thread: 16 and 8
// blocks an SM by the registers
FAST_KERNELS(64)
FAST_KERNELS(128)
// capacity 8 with l > 2 kernels, and the subtree kernel (K3; it also
// runs Arikan children): one instance a thread count of `general_threads`
// (32 and 64 threads a codeword), each at kBig8Registers a thread
#define BIG8_BLOCKS(T) (65536 / kBig8Registers / (T))
#define BIG8_KERNELS(T)                                                                 \
  SCL_KERNEL(scl_decode_big_t##T, T, BIG8_BLOCKS(T), kLlrIn, kSelect, true, 8)          \
  SCL_KERNEL(scl_decode_traj_big_t##T, T, BIG8_BLOCKS(T), kLlrIn, kTrajectory, true, 8) \
  SCL_KERNEL(scl_mc_traj_big_t##T, T, BIG8_BLOCKS(T), kMonteCarlo, kTrajectory, true, 8) \
  SCL_KERNEL(scl_mc_counters_big_t##T, T, BIG8_BLOCKS(T), kMonteCarlo, kCounters, true, 8) \
  SCL_KERNEL(scl_subtree_t##T, T, BIG8_BLOCKS(T), kPathBound, kSubtree, true, 8)
BIG8_KERNELS(32)
BIG8_KERNELS(64)
// capacity 8 at list size 1, two codewords a warp (`general_codewords`):
// K2, K4 and K5
#define BIG8_CW2_KERNEL(NAME, SRC, OUT)                                         \
  __global__ void __launch_bounds__(32, BIG8_BLOCKS(32)) NAME##_big_t32_cw2(    \
      SclArgs a) {                                                            \
    clk_begin();                                                              \
    scl_body<SRC, OUT, true, 8, 32, 2>(a);                                    \
    clk_end();                                                                \
  }
BIG8_CW2_KERNEL(scl_decode_traj, kLlrIn, kTrajectory)
BIG8_CW2_KERNEL(scl_mc_traj, kMonteCarlo, kTrajectory)
BIG8_CW2_KERNEL(scl_mc_counters, kMonteCarlo, kCounters)
// capacity 32 (8 < L <= 32; K1, K2, K4, K5, replacing pallas_scl.py
// `core_sel`, `core`, `core_mc`, `core_cnt` there): the fork table, the
// one-pass selection and the in-place flips (the note above `fork_table`);
// ~11 KB of `Small<32>`, 8-byte path maps a thread, 2 blocks an SM
SCL_KERNEL(scl_decode_c32, kThreads, 2, kLlrIn, kSelect, false, 32)
SCL_KERNEL(scl_decode_traj_c32, kThreads, 2, kLlrIn, kTrajectory, false, 32)
SCL_KERNEL(scl_mc_traj_c32, kThreads, 2, kMonteCarlo, kTrajectory, false, 32)
SCL_KERNEL(scl_mc_counters_c32, kThreads, 2, kMonteCarlo, kCounters, false, 32)
SCL_KERNEL(scl_decode_big_c32, kThreads, 2, kLlrIn, kSelect, true, 32)
SCL_KERNEL(scl_decode_traj_big_c32, kThreads, 2, kLlrIn, kTrajectory, true, 32)
SCL_KERNEL(scl_mc_traj_big_c32, kThreads, 2, kMonteCarlo, kTrajectory, true, 32)
SCL_KERNEL(scl_mc_counters_big_c32, kThreads, 2, kMonteCarlo, kCounters, true, 32)
// the subtree kernel at capacity 32: mixed_scl32's 13 children at L=32;
// its pm_in is path-bound, so `pm_sorted` starts false
SCL_KERNEL(scl_subtree_c32, kThreads, 2, kPathBound, kSubtree, true, 32)

// Every instance above, by name: the kernel it runs (0 scl_decode, 1
// scl_decode_traj, 2 scl_mc_traj, 3 scl_mc_counters, 4 scl_subtree), its
// list capacity, its threads (the launch bounds) and codewords a block,
// its body (the Arikan `fast_body` or `scl_body`) and whether it takes l >
// 2 kernels. ops/cuda_scl.py `launch_plan` chooses one by name; the
// library only launches it.
struct Instance {
  const char* name;
  void (*fn)(SclArgs);
  int kernel, cap, threads, codewords;
  bool fast, big;
};
#define INSTANCE(NAME, KERNEL, CAP, T, CW, FAST, BIG) \
  { #NAME, NAME, KERNEL, CAP, T, CW, FAST, BIG }
const Instance kInstances[] = {
    INSTANCE(scl_decode_t64, 0, 8, 64, 1, true, false),
    INSTANCE(scl_decode_traj_t64, 1, 8, 64, 1, true, false),
    INSTANCE(scl_mc_traj_t64, 2, 8, 64, 1, true, false),
    INSTANCE(scl_mc_counters_t64, 3, 8, 64, 1, true, false),
    INSTANCE(scl_decode_t128, 0, 8, 128, 1, true, false),
    INSTANCE(scl_decode_traj_t128, 1, 8, 128, 1, true, false),
    INSTANCE(scl_mc_traj_t128, 2, 8, 128, 1, true, false),
    INSTANCE(scl_mc_counters_t128, 3, 8, 128, 1, true, false),
    INSTANCE(scl_decode_big_t32, 0, 8, 32, 1, false, true),
    INSTANCE(scl_decode_traj_big_t32, 1, 8, 32, 1, false, true),
    INSTANCE(scl_mc_traj_big_t32, 2, 8, 32, 1, false, true),
    INSTANCE(scl_mc_counters_big_t32, 3, 8, 32, 1, false, true),
    INSTANCE(scl_subtree_t32, 4, 8, 32, 1, false, true),
    INSTANCE(scl_decode_big_t64, 0, 8, 64, 1, false, true),
    INSTANCE(scl_decode_traj_big_t64, 1, 8, 64, 1, false, true),
    INSTANCE(scl_mc_traj_big_t64, 2, 8, 64, 1, false, true),
    INSTANCE(scl_mc_counters_big_t64, 3, 8, 64, 1, false, true),
    INSTANCE(scl_subtree_t64, 4, 8, 64, 1, false, true),
    INSTANCE(scl_decode_traj_big_t32_cw2, 1, 8, 32, 2, false, true),
    INSTANCE(scl_mc_traj_big_t32_cw2, 2, 8, 32, 2, false, true),
    INSTANCE(scl_mc_counters_big_t32_cw2, 3, 8, 32, 2, false, true),
    INSTANCE(scl_decode_c32, 0, 32, kThreads, 1, false, false),
    INSTANCE(scl_decode_traj_c32, 1, 32, kThreads, 1, false, false),
    INSTANCE(scl_mc_traj_c32, 2, 32, kThreads, 1, false, false),
    INSTANCE(scl_mc_counters_c32, 3, 32, kThreads, 1, false, false),
    INSTANCE(scl_subtree_c32, 4, 32, kThreads, 1, false, true),
    INSTANCE(scl_decode_big_c32, 0, 32, kThreads, 1, false, true),
    INSTANCE(scl_decode_traj_big_c32, 1, 32, kThreads, 1, false, true),
    INSTANCE(scl_mc_traj_big_c32, 2, 32, kThreads, 1, false, true),
    INSTANCE(scl_mc_counters_big_c32, 3, 32, kThreads, 1, false, true),
};
constexpr int kInstanceCount = (int)(sizeof(kInstances) / sizeof(kInstances[0]));

// Dynamic shared memory a block of instance `in` takes for *a: the Arikan
// body's `fast_layout`; at capacity 32 one codeword's state; at capacity 8
// the stage tables, then each codeword's state (16-aligned past the first
// at two codewords a block).
size_t layout_smem(const Instance& in, const SclArgs& a) {
  const bool mc = in.kernel == 2 || in.kernel == 3;
  if (in.fast) return (size_t)fast_layout(a.N, a.m, a.P, a.Q, mc, a.view1 != 0).total;
  const int state = codeword_state_bytes(a, mc, in.kernel == 4);
  if (in.cap == 32) return (size_t)state;
  return (size_t)stage_copy_bytes(a.m)
         + (in.codewords == 2 ? 2 * (size_t)((state + 15) & ~15) : (size_t)state);
}

}  // namespace

extern "C" {

int scl_instance_count(void) { return kInstanceCount; }

// the name of instance i, null out of range
const char* scl_instance_name(int i) {
  return i >= 0 && i < kInstanceCount ? kInstances[i].name : nullptr;
}

// dynamic shared memory a block of instance i takes for *a; 0 out of range
size_t scl_smem_bytes(int i, const SclArgs* a) {
  return i >= 0 && i < kInstanceCount ? layout_smem(kInstances[i], *a) : 0;
}

// static shared memory a block of instance i; -1 out of range
int scl_static_smem_bytes(int i) {
  if (i < 0 || i >= kInstanceCount) return -1;
  const Instance& in = kInstances[i];
  if (in.fast) return (int)sizeof(Fast);
  return in.cap == 8 ? in.codewords * (int)sizeof(Small<8>) : (int)sizeof(Small<32>);
}

// Lets instance i take `bytes` of dynamic shared memory a block on the
// current device.
int scl_set_smem(int i, int bytes) {
  if (i < 0 || i >= kInstanceCount) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kInstances[i].fn,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The current device's SM limits (ops/cuda_scl.py `SmLimits`): shared
// memory an SM, what the runtime keeps of it a block, registers and blocks
// an SM, the most shared memory a block may use, and its SMs.
int scl_device_limits(int* out) {
  static const cudaDeviceAttr attrs[6] = {
      cudaDevAttrMaxSharedMemoryPerMultiprocessor, cudaDevAttrReservedSharedMemoryPerBlock,
      cudaDevAttrMaxRegistersPerMultiprocessor, cudaDevAttrMaxBlocksPerMultiprocessor,
      cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrMultiProcessorCount};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  for (int k = 0; k < 6 && err == cudaSuccess; ++k)
    err = cudaDeviceGetAttribute(out + k, attrs[k], dev);
  return (int)err;
}

// Launches instance i over the `count` codewords of the batch (a->B) from
// a->b0 on, `codewords` a block of `threads`, with its layout's dynamic
// shared memory. cudaErrorInvalidValue where i does not run `kernel` at
// a's list capacity and kernels (l > 2 or not), where `threads` and
// `codewords` are not the instance's, where *a is out of the kernels'
// range, or where [b0, b0 + count) is not in the batch or, short of its
// end, not whole blocks; b0 must be 0 but for K5 (kernel 3).
int scl_launch(int i, int kernel, int threads, int codewords, const SclArgs* a,
               int count, void* stream) {
  if (i < 0 || i >= kInstanceCount) return (int)cudaErrorInvalidValue;
  const Instance& in = kInstances[i];
  const int maps = a->n_maps + (kernel == 4 ? a->P : 0);
  if (in.kernel != kernel || in.cap != (a->P > 8 ? 32 : 8) || (a->big && !in.big)
      || in.threads != threads || in.codewords != codewords || a->P < 1 || a->P > 32
      || a->W > 32 || a->B < 1 || a->N < 2 || a->m < 1 || a->m + 1 > kMaxStages
      || (a->P > 8 && maps > kMapsPerThread32 * kThreads) || a->b0 < 0
      || (a->b0 != 0 && kernel != 3) || count < 1 || count > a->B - a->b0
      || (count < a->B - a->b0 && count % codewords != 0))
    return (int)cudaErrorInvalidValue;
  void (*const fn)(SclArgs) = in.fn;
  fn<<<(count + codewords - 1) / codewords, threads, layout_smem(in, *a),
       (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// blocks an SM of instance i for *a (occupancy API); -1 on error
int scl_blocks_per_sm(int i, const SclArgs* a) {
  int blocks = 0;
  if (i < 0 || i >= kInstanceCount
      || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &blocks, kInstances[i].fn, kInstances[i].threads, layout_smem(kInstances[i], *a))
             != cudaSuccess)
    return -1;
  return blocks;
}

int scl_args_bytes(void) { return (int)sizeof(SclArgs); }

int scl_stage_tab_bytes(void) { return (int)sizeof(StageTab); }

#ifdef SCL_CLOCK
// the op-kind clock: slots then the count of blocks measured
int scl_clock_slots(void) { return kClkSlots; }

// the stage keys of each slot: g_clock is [stage key][slot], then blocks
int scl_clock_stages(void) { return kClkStages; }

int scl_clock_reset(void) {
  static const unsigned long long zero[kClkCells + 1] = {};
  return (int)cudaMemcpyToSymbol(g_clock, zero, sizeof(zero));
}

int scl_clock_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clock,
                                   sizeof(unsigned long long) * (kClkCells + 1));
}
#endif

}  // extern "C"
