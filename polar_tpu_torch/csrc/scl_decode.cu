// CA-SCL decode of Arikan polar codes, one thread block per codeword.
//
// Replaces the TPU kernel polar_tpu/ops/pallas_scl.py
// build_pallas_scl_kernel(select=True) (the `pallas_call` in `core_sel`,
// reached through build_pallas_scl_decoder for list size > 1): the whole
// fast-SSCL op program (f/g DOWN, UP re-encode, R0/REP/R1/SPC/LEAF nodes,
// 2P -> P forks, lazy path maps) plus the in-kernel epilogue (suffix
// composition of the per-span survival permutations, CRC, first-index
// argmin). The plain PyTorch version is polar_tpu_torch/ops/scl.py; the
// two agree bit for bit, path metrics included.
//
// What bounds it on an H100: neither bytes nor arithmetic. A codeword
// moves 4N bytes in and N + 8 out, and the program is a few hundred
// thousand element operations, but they form a chain of ~316 dependent
// ops (and ~245 forks) whose widths shrink from P*N/2 to P elements.
// The kernel is latency-bound: block-wide barriers between ops, shared
// memory round trips, and warp shuffles in the forks.
//
// What the design does about it:
// - All decode state lives in shared memory for the whole decode (for
//   N=1024, L=8 about 58 KB: LLR buffers P*(N-1) f32, decisions
//   2*P*(N-1) u8, trajectory bits N*P u8, span perms Q*P u8), so three
//   blocks share an SM and hide each other's barriers. Device memory is
//   touched only for the channel LLRs, the op table and the outputs.
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 8;
constexpr int kMaxRounds = kMaxP + 1;   // SPC extracts up to P + 1 minima
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

enum OpKind {
  DOWN_FRESH = 0, DOWN_DYN = 1, UP = 2, R0 = 3, REP = 4, R1 = 5, SPC = 6,
  LEAF = 7, LEAF_FROZEN = 8
};

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

__global__ void __launch_bounds__(kThreads)
scl_decode_kernel(const float* __restrict__ llr, int8_t* __restrict__ u_out,
                  float* __restrict__ pm_out, uint8_t* __restrict__ ok_out,
                  const int4* __restrict__ ops, int n_ops,
                  const short* __restrict__ qrow, const short* __restrict__ pidx,
                  const unsigned* __restrict__ gmask, unsigned offmask,
                  int N, int m, int P, int Q, int K, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Small sm;
  float* lam = reinterpret_cast<float*>(smem);
  unsigned char* dec = smem + 4 * P * (N - 1);
  unsigned char* traj = dec + 2 * P * (N - 1);
  unsigned char* tperm = traj + N * P;
  unsigned char* sidx = tperm + Q * P;
  unsigned char* maps = sidx + Q * P;
  const int n_maps = 3 * m * P;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* x = llr + (size_t)blockIdx.x * N;

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
  for (int o = 0; o < n_ops; ++o) {
    const int4 op = ops[o];
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
        const int k = pidx[t];
        if (k < 0) continue;
        const unsigned bit = traj[t * P + sidx[qrow[t] * P + warp]];
        if (k < K) acc ^= bit ? gmask[k] : 0u;
        else rec |= bit << (k - K);
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        acc ^= __shfl_xor_sync(kFull, acc, off);
        rec |= __shfl_xor_sync(kFull, rec, off);
      }
    }
    if (lane == 0) sm.ok[warp] = (W == 0 || (acc ^ offmask) == rec) ? 1.f : 0.f;
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
    pm_out[blockIdx.x] = sm.pm[best];
    ok_out[blockIdx.x] = sm.ok[best] > 0.5f;
  }
  __syncthreads();
  const int best = sm.best;
  int8_t* u = u_out + (size_t)blockIdx.x * N;
  for (int t = tid; t < N; t += kThreads)
    u[t] = (int8_t)traj[t * P + sidx[qrow[t] * P + best]];
}

}  // namespace

extern "C" {

size_t scl_decode_smem_bytes(int N, int m, int P, int Q) {
  return (size_t)4 * P * (N - 1) + (size_t)2 * P * (N - 1) + (size_t)N * P
         + (size_t)2 * Q * P + (size_t)3 * m * P;
}

int scl_decode_launch(const void* llr, void* u, void* pm, void* ok,
                      const void* ops, int n_ops, const void* qrow,
                      const void* pidx, const void* gmask, unsigned offmask,
                      int N, int m, int P, int Q, int K, int W, int B,
                      void* stream) {
  if (P < 1 || P > kMaxP || W > 32 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = scl_decode_smem_bytes(N, m, P, Q);
  cudaError_t err = cudaFuncSetAttribute(
      scl_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  scl_decode_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)llr, (int8_t*)u, (float*)pm, (uint8_t*)ok,
      (const int4*)ops, n_ops, (const short*)qrow, (const short*)pidx,
      (const unsigned*)gmask, offmask, N, m, P, Q, K, W);
  return (int)cudaGetLastError();
}

int scl_decode_max_smem_bytes(void) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)
      != cudaSuccess) return -1;
  return v;
}

}  // extern "C"
