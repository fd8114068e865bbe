// Native golden SC/SCL polar decoder (C++), independent of the JAX path.
//
// Role (SURVEY.md §4 "Reference bit-match" + PARITY.md C14): the reference
// repo is a single-process C++ codec, but its mount is empty (SURVEY.md §0).
// This file is an independent C++ implementation of the same documented
// conventions — min-sum f/g, exact max-log marginals for large kernels,
// PM += |llr| path metrics, bit-major stable 2L->L sort, CRC-aided
// selection — used as the golden recorder for the bit-match replay harness
// (polar_tpu/sim/golden.py) and as a fast cross-check oracle. If/when the
// real reference appears, it slots into the same record format.
//
// Per-codeword, pointer-free, clarity over speed. Exposed via a C ABI and
// loaded with ctypes (no pybind11 in this environment).
//
// Build: see native/build.sh (g++ -O2 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <numeric>
#include <vector>

namespace {

struct KernelProc {
    int l = 0;
    std::vector<uint8_t> K;          // l*l row-major
    // tails[i]: all codewords of span(rows i+1..l-1), each l bits
    std::vector<std::vector<uint8_t>> tails;

    void init(int l_, const uint8_t* k) {
        l = l_;
        K.assign(k, k + l * l);
        tails.resize(l);
        for (int i = 0; i < l; ++i) {
            int nf = l - 1 - i;
            int cnt = 1 << nf;
            tails[i].assign((size_t)cnt * l, 0);
            for (int msg = 0; msg < cnt; ++msg) {
                uint8_t* w = &tails[i][(size_t)msg * l];
                for (int j = 0; j < nf; ++j)
                    if ((msg >> j) & 1)
                        for (int c = 0; c < l; ++c)
                            w[c] ^= K[(size_t)(i + 1 + j) * l + c];
            }
        }
    }

    // exact max-log (min-sum) marginal of input i given output llrs and
    // decided inputs u[0..i-1]; cost(x) = sum |llr_j| * [hard_j != x_j]
    double input_llr(int i, const double* lam, const uint8_t* prev_u) const {
        std::vector<uint8_t> base(l, 0);
        for (int j = 0; j < i; ++j)
            if (prev_u[j])
                for (int c = 0; c < l; ++c) base[c] ^= K[(size_t)j * l + c];
        double best[2] = {1e300, 1e300};
        int cnt = 1 << (l - 1 - i);
        for (int ui = 0; ui < 2; ++ui) {
            for (int msg = 0; msg < cnt; ++msg) {
                const uint8_t* t = &tails[i][(size_t)msg * l];
                double cost = 0;
                for (int c = 0; c < l; ++c) {
                    uint8_t x = t[c] ^ base[c] ^
                        (ui ? K[(size_t)i * l + c] : 0);
                    uint8_t hard = lam[c] < 0;
                    if (x != hard) cost += std::fabs(lam[c]);
                }
                if (cost < best[ui]) best[ui] = cost;
            }
        }
        return best[1] - best[0];
    }
};

struct Code {
    int N = 0, K = 0, m = 0;
    std::vector<int> factors, nsz;   // nsz[d] = N / prod(factors[0..d-1])
    std::vector<KernelProc> procs;
    std::vector<uint8_t> frozen;
    std::vector<int> info_pos;
    int crc_width = 0;
    uint32_t crc_poly = 0, crc_init = 0;

    void encode_sub(int stage, const uint8_t* u, int n, uint8_t* x) const {
        // apply kernels stage..m-1 (0-based) to the n-bit block
        std::vector<uint8_t> cur(u, u + n), nxt(n);
        int block = n;
        for (int s = stage; s < m; ++s) {
            int l = factors[s];
            int inner = block / l;   // positions per kernel output index
            // view cur as [l, inner] per outer repetition
            int reps = n / block;
            for (int r = 0; r < reps; ++r) {
                const uint8_t* cb = &cur[(size_t)r * block];
                uint8_t* nb = &nxt[(size_t)r * block];
                for (int a = 0; a < l; ++a)
                    for (int b = 0; b < inner; ++b) {
                        uint8_t v = 0;
                        for (int i = 0; i < l; ++i)
                            v ^= cb[i * inner + b] &
                                procs[s].K[(size_t)i * l + a];
                        nb[a * inner + b] = v;
                    }
            }
            cur.swap(nxt);
            block = inner;
            if (block == 0) break;
        }
        std::memcpy(x, cur.data(), n);
    }

    std::vector<uint8_t> crc_of(const uint8_t* bits, int n) const {
        uint32_t reg = crc_init, mask = (1u << crc_width) - 1u;
        for (int i = 0; i < n; ++i) {
            uint32_t fb = ((reg >> (crc_width - 1)) & 1u) ^ bits[i];
            reg = ((reg << 1) & mask) ^ (fb ? crc_poly : 0u);
        }
        std::vector<uint8_t> out(crc_width);
        for (int i = 0; i < crc_width; ++i)
            out[i] = (reg >> (crc_width - 1 - i)) & 1u;
        return out;
    }
};

struct Path {
    double pm = 0;
    std::vector<uint8_t> u;          // decided leaves so far
};

// LLR of the next leaf (index u_prefix.size()) via the recursive SC
// computation — identical contract to polar_tpu.oracle.llr_at_next_leaf.
double next_leaf_llr(const Code& c, const double* chan,
                     const std::vector<uint8_t>& prefix) {
    // iterative descent with explicit buffers
    std::vector<double> lam(chan, chan + c.N);
    const uint8_t* known = prefix.data();
    size_t known_len = prefix.size();
    int offset_leaves = 0;
    for (int s = 0; s < c.m; ++s) {
        int l = c.factors[s];
        int n_child = c.nsz[s + 1];
        int i_cur = (int)(known_len / (size_t)n_child);
        // hard re-encode of prior child blocks
        std::vector<uint8_t> prev((size_t)i_cur * n_child);
        for (int j = 0; j < i_cur; ++j)
            c.encode_sub(s + 1, known + (size_t)j * n_child, n_child,
                         &prev[(size_t)j * n_child]);
        std::vector<double> child(n_child);
        std::vector<double> kl(l);
        std::vector<uint8_t> pu(i_cur);
        for (int b = 0; b < n_child; ++b) {
            for (int i = 0; i < l; ++i) kl[i] = lam[(size_t)i * n_child + b];
            for (int j = 0; j < i_cur; ++j) pu[j] = prev[(size_t)j * n_child + b];
            child[b] = c.procs[s].input_llr(i_cur, kl.data(), pu.data());
        }
        lam.assign(child.begin(), child.end());
        known += (size_t)i_cur * n_child;
        known_len -= (size_t)i_cur * n_child;
        offset_leaves += i_cur * n_child;
    }
    return lam[0];
}

void decode_one(const Code& c, const double* chan, int L, uint8_t* u_out) {
    std::vector<Path> paths(1);
    for (int t = 0; t < c.N; ++t) {
        std::vector<double> lams(paths.size());
        for (size_t p = 0; p < paths.size(); ++p)
            lams[p] = next_leaf_llr(c, chan, paths[p].u);
        if (c.frozen[t]) {
            for (size_t p = 0; p < paths.size(); ++p) {
                if (lams[p] < 0) paths[p].pm += -lams[p];
                paths[p].u.push_back(0);
            }
        } else {
            size_t np = paths.size();
            // candidate order: bit-major (bit*L + path) — tie rule matches
            // lax.top_k / the numpy oracle
            std::vector<std::pair<double, size_t>> cand;
            cand.reserve(2 * np);
            for (int bit = 0; bit < 2; ++bit)
                for (size_t p = 0; p < np; ++p) {
                    double pen = ((lams[p] < 0) != (bit == 1))
                        ? std::fabs(lams[p]) : 0.0;
                    cand.emplace_back(paths[p].pm + pen, bit * np + p);
                }
            std::stable_sort(cand.begin(), cand.end(),
                             [](const auto& a, const auto& b) {
                                 return a.first < b.first;
                             });
            size_t keep = std::min((size_t)L, cand.size());
            std::vector<Path> nxt(keep);
            for (size_t k = 0; k < keep; ++k) {
                size_t ci = cand[k].second;
                size_t parent = ci % np;
                int bit = (int)(ci / np);
                nxt[k].pm = cand[k].first;
                nxt[k].u = paths[parent].u;
                nxt[k].u.push_back((uint8_t)bit);
            }
            paths.swap(nxt);
        }
    }
    // CRC selection: lowest-PM passing path, else lowest-PM
    std::stable_sort(paths.begin(), paths.end(),
                     [](const Path& a, const Path& b) { return a.pm < b.pm; });
    const Path* best = &paths[0];
    if (c.crc_width > 0) {
        for (const Path& p : paths) {
            std::vector<uint8_t> payload;
            for (int pos : c.info_pos) payload.push_back(p.u[pos]);
            std::vector<uint8_t> crc =
                c.crc_of(payload.data(), c.K);
            bool ok = std::equal(crc.begin(), crc.end(),
                                 payload.begin() + c.K);
            if (ok) { best = &p; break; }
        }
    }
    std::memcpy(u_out, best->u.data(), c.N);
}

}  // namespace

extern "C" {

void* ref_create(int m, const int* factors, const uint8_t* kernels_flat,
                 const uint8_t* frozen, int N, int K,
                 int crc_width, uint32_t crc_poly, uint32_t crc_init) {
    Code* c = new Code();
    c->N = N; c->K = K; c->m = m;
    c->factors.assign(factors, factors + m);
    c->nsz.resize(m + 1);
    c->nsz[0] = N;
    const uint8_t* kp = kernels_flat;
    c->procs.resize(m);
    for (int s = 0; s < m; ++s) {
        int l = c->factors[s];
        c->procs[s].init(l, kp);
        kp += l * l;
        c->nsz[s + 1] = c->nsz[s] / l;
    }
    c->frozen.assign(frozen, frozen + N);
    for (int i = 0; i < N; ++i)
        if (!frozen[i]) c->info_pos.push_back(i);
    c->crc_width = crc_width;
    c->crc_poly = crc_poly;
    c->crc_init = crc_init;
    return c;
}

void ref_destroy(void* h) { delete static_cast<Code*>(h); }

void ref_encode(void* h, const uint8_t* u, int batch, uint8_t* x_out) {
    Code* c = static_cast<Code*>(h);
    for (int b = 0; b < batch; ++b)
        c->encode_sub(0, u + (size_t)b * c->N, c->N,
                      x_out + (size_t)b * c->N);
}

void ref_decode_scl(void* h, const double* llrs, int batch, int L,
                    uint8_t* u_out) {
    Code* c = static_cast<Code*>(h);
    // frames are independent; decode_one only reads *c
#pragma omp parallel for schedule(dynamic)
    for (int b = 0; b < batch; ++b)
        decode_one(*c, llrs + (size_t)b * c->N, L,
                   u_out + (size_t)b * c->N);
}

}  // extern "C"
