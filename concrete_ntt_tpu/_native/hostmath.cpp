// Native host-math kernels for plan construction.
//
// The device compute path is JAX/XLA; this C++ library is the native
// runtime tier for everything that runs on the HOST at plan-build time —
// the same split as the reference, whose const-eval number theory
// (src/prime.rs, src/roots.rs) and twiddle/plan construction
// (prime32.rs:223-282,630-686) run in native Rust. Covered here:
//
//   * deterministic Miller-Rabin primality for all u64 (prime.rs:50-126)
//   * prime search in arithmetic progressions (prime.rs:130-180)
//   * Tonelli-Shanks primitive-root finding (roots.rs:31-91) — EXACTLY the
//     Python algorithm in utils/roots.py so twiddle tables are bit-identical
//   * negacyclic twiddle tables (prime32.rs:223-246 semantics)
//   * the four-step matrix builders for the int8 engine (ops/mxu32.py):
//     stage-range basis runs, shared-matrix factorization with verification
//   * int8 digit-plane packing for exact modular matmuls
//
// Exposed as a flat C ABI consumed via ctypes (no pybind11 in this image).
// Built lazily by concrete_ntt_tpu/_native/__init__.py with g++.

#include <cstdint>
#include <cstring>
#include <initializer_list>

using u64 = uint64_t;
using u128 = unsigned __int128;
using i64 = int64_t;

static inline u64 mulmod(u64 a, u64 b, u64 p) {
    return (u64)(((u128)a * b) % p);
}

// overflow-safe (a + b) mod p and (a - b) mod p for a, b in [0, p), any p < 2^64
static inline u64 addmod(u64 a, u64 b, u64 p) {
    u64 s = a + b;
    if (s < a) return s - p;  // wrapped: true sum = s + 2^64, result = s + (2^64 - p)
    return s >= p ? s - p : s;
}

static inline u64 submod(u64 a, u64 b, u64 p) {
    return a >= b ? a - b : a - b + p;  // wrapping add of p is exact
}

static inline u64 powmod(u64 a, u64 e, u64 p) {
    u64 r = 1 % p;
    a %= p;
    while (e) {
        if (e & 1) r = mulmod(r, a, p);
        a = mulmod(a, a, p);
        e >>= 1;
    }
    return r;
}

extern "C" {

// --- primality (deterministic Miller-Rabin, 12-base set as prime.rs:50-126)
int ntt_is_prime64(u64 n) {
    if (n < 2) return 0;
    for (u64 sp : {2ull, 3ull, 5ull, 7ull, 11ull, 13ull, 17ull, 19ull, 23ull,
                   29ull, 31ull, 37ull}) {
        if (n == sp) return 1;
        if (n % sp == 0) return 0;
    }
    u64 d = n - 1;
    int s = 0;
    while ((d & 1) == 0) { d >>= 1; s++; }
    for (u64 a : {2ull, 3ull, 5ull, 7ull, 11ull, 13ull, 17ull, 19ull, 23ull,
                  29ull, 31ull, 37ull}) {
        u64 x = powmod(a, d, n);
        if (x == 1 || x == n - 1) continue;
        bool composite = true;
        for (int i = 0; i < s - 1; i++) {
            x = mulmod(x, x, n);
            if (x == n - 1) { composite = false; break; }
        }
        if (composite) return 0;
    }
    return 1;
}

// largest prime == offset (mod factor) in [lo, hi], scanning x downward
// (prime.rs:130-180 semantics). Returns 0 if none.
u64 ntt_prime_in_ap(u64 factor, u64 offset, u64 lo, u64 hi) {
    if (hi < lo || factor == 0) return 0;
    // largest x with factor*x + offset <= hi
    if (hi < offset) return 0;
    u64 x = (hi - offset) / factor;
    while (true) {
        u128 cand = (u128)factor * x + offset;
        if (cand < lo) return 0;
        if (cand <= hi && ntt_is_prime64((u64)cand)) return (u64)cand;
        if (x == 0) return 0;
        x--;
    }
}

// --- Tonelli-Shanks chain, exactly utils/roots.py / roots.rs:31-91 ---
static u64 quadratic_nonresidue(u64 p) {
    u64 e = (p - 1) / 2;
    u64 z = 2;
    while (powmod(z, e, p) != p - 1) z++;
    return z;
}

static int sqrt_mod(u64 a, u64 p, u64* out) {
    a %= p;
    if (a == 0) { *out = 0; return 1; }
    if (powmod(a, (p - 1) / 2, p) != 1) return 0;
    u64 q = p - 1;
    int s = 0;
    while ((q & 1) == 0) { q >>= 1; s++; }
    if (s == 1) { *out = powmod(a, (p + 1) / 4, p); return 1; }
    u64 z = quadratic_nonresidue(p);
    int m = s;
    u64 c = powmod(z, q, p);
    u64 t = powmod(a, q, p);
    u64 r = powmod(a, (q + 1) / 2, p);
    while (t != 1) {
        int i = 0;
        u64 t2 = t;
        while (t2 != 1) { t2 = mulmod(t2, t2, p); i++; }
        u64 b = powmod(c, 1ull << (m - i - 1), p);
        m = i;
        c = mulmod(b, b, p);
        t = mulmod(t, c, p);
        r = mulmod(r, b, p);
    }
    *out = r;
    return 1;
}

// 0 = no such root (degree does not divide p-1 / sqrt chain failed)
u64 ntt_find_primitive_root64(u64 p, u64 degree) {
    if ((p - 1) % degree != 0) return 0;
    u64 w = p - 1;
    for (u64 k = 2; k < degree; k *= 2) {
        u64 nxt;
        if (!sqrt_mod(w, p, &nxt)) return 0;
        w = nxt;
    }
    return w;
}

static inline u64 bit_rev(int nbits, u64 i) {
    u64 r = 0;
    for (int b = 0; b < nbits; b++) r |= ((i >> b) & 1) << (nbits - 1 - b);
    return r;
}

// twid[bit_rev(k)] = psi^k ; inv_twid[bit_rev((n-k)%n)] = psi^k (k=0) else p - psi^k
// (golden/ntt.py negacyclic_twiddles == prime32.rs:223-246). Returns 0 on failure.
int ntt_twiddles(u64 p, u64 n, u64* twid, u64* inv_twid) {
    u64 psi = ntt_find_primitive_root64(p, 2 * n);
    if (psi == 0) return 0;
    int nbits = 0;
    while ((1ull << nbits) < n) nbits++;
    u64 wk = 1;
    for (u64 k = 0; k < n; k++) {
        twid[bit_rev(nbits, k)] = wk;
        inv_twid[bit_rev(nbits, (n - k) % n)] = (k == 0) ? wk : p - wk;
        wk = mulmod(wk, psi, p);
    }
    return 1;
}

// --- stage-range engines on [rows, n] u64 buffers (exact golden semantics) ---
static void fwd_stages(u64* data, i64 rows, i64 n, const u64* twid, u64 p,
                       int s0, int s1) {
    for (int s = s0; s < s1; s++) {
        i64 m = 1ll << s;
        i64 t = n >> (s + 1);
        for (i64 r = 0; r < rows; r++) {
            u64* row = data + r * n;
            for (i64 i = 0; i < m; i++) {
                u64 w = twid[m + i];
                u64* blk = row + i * 2 * t;
                for (i64 j = 0; j < t; j++) {
                    u64 z0 = blk[j], z1 = blk[j + t];
                    u64 wz1 = mulmod(z1, w, p);
                    blk[j] = addmod(z0, wz1, p);
                    blk[j + t] = submod(z0, wz1, p);
                }
            }
        }
    }
}

static void inv_stages(u64* data, i64 rows, i64 n, const u64* inv_twid, u64 p,
                       int s_hi, int s_lo) {
    for (int s = s_hi - 1; s >= s_lo; s--) {
        i64 m = 1ll << s;
        i64 t = n >> (s + 1);
        for (i64 r = 0; r < rows; r++) {
            u64* row = data + r * n;
            for (i64 i = 0; i < m; i++) {
                u64 w = inv_twid[m + i];
                u64* blk = row + i * 2 * t;
                for (i64 j = 0; j < t; j++) {
                    u64 z0 = blk[j], z1 = blk[j + t];
                    blk[j] = addmod(z0, z1, p);
                    blk[j + t] = mulmod(submod(z0, z1, p), w, p);
                }
            }
        }
    }
}

// Build the six four-step operators (ops/mxu32.py table semantics):
//   A[n1*n1], F[n2*n2], d[n1*n2], G[n2*n2], e[n1*n2], Ainv[n1*n1]
// Returns 0 on success; nonzero = factorization check failed.
int ntt_fourstep_build(u64 p, i64 n, i64 n1, u64* A, u64* F, u64* d, u64* G,
                       u64* e, u64* Ainv) {
    i64 n2 = n / n1;
    int k = 0;
    while ((1ll << k) < n1) k++;
    int log2n = 0;
    while ((1ll << log2n) < n) log2n++;

    u64* twid = new u64[2 * n];
    u64* inv_twid = twid + n;
    if (!ntt_twiddles(p, n, twid, inv_twid)) { delete[] twid; return 1; }

    u64* buf = new u64[(n1 > n2 ? n1 : n2) * n];

    // A: stages [0, k) on column-basis vectors; verify column-independence
    for (int col = 0; col < 2 && col < n2; col++) {
        std::memset(buf, 0, sizeof(u64) * n1 * n);
        for (i64 i = 0; i < n1; i++) buf[i * n + i * n2 + col] = 1;
        fwd_stages(buf, n1, n, twid, p, 0, k);
        for (i64 rr = 0; rr < n1; rr++)
            for (i64 i = 0; i < n1; i++) {
                u64 v = buf[i * n + rr * n2 + col];
                if (col == 0) A[rr * n1 + i] = v;
                else if (A[rr * n1 + i] != v) { delete[] twid; delete[] buf; return 2; }
            }
    }

    // Row ops fwd: B_r = F * diag(d_r)
    // buf2[j][r*n2 + kap] = B_r[kap][j]
    u64* B = new u64[n2 * n];
    for (i64 j = 0; j < n2; j++) {
        u64* row = B + j * n;
        std::memset(row, 0, sizeof(u64) * n);
        for (i64 r = 0; r < n1; r++) row[r * n2 + j] = 1;
        fwd_stages(row, 1, n, twid, p, k, log2n);
    }
    for (i64 kap = 0; kap < n2; kap++)
        for (i64 j = 0; j < n2; j++) F[kap * n2 + j] = B[j * n + 0 * n2 + kap];
    for (i64 r = 0; r < n1; r++) {
        for (i64 j = 0; j < n2; j++) {
            u64 f0inv = powmod(F[0 * n2 + j], p - 2, p);
            u64 dr = mulmod(B[j * n + r * n2 + 0], f0inv, p);
            d[r * n2 + j] = dr;
            for (i64 kap = 0; kap < n2; kap++)
                if (B[j * n + r * n2 + kap] != mulmod(F[kap * n2 + j], dr, p)) {
                    delete[] twid; delete[] buf; delete[] B; return 3;
                }
        }
    }

    // Row ops inv: C_r = diag(e_r) * G
    for (i64 j = 0; j < n2; j++) {
        u64* row = B + j * n;
        std::memset(row, 0, sizeof(u64) * n);
        for (i64 r = 0; r < n1; r++) row[r * n2 + j] = 1;
        inv_stages(row, 1, n, inv_twid, p, log2n, k);
    }
    for (i64 kap = 0; kap < n2; kap++)
        for (i64 j = 0; j < n2; j++) G[kap * n2 + j] = B[j * n + 0 * n2 + kap];
    for (i64 r = 0; r < n1; r++) {
        for (i64 kap = 0; kap < n2; kap++) {
            u64 g0inv = powmod(G[kap * n2 + 0], p - 2, p);
            u64 er = mulmod(B[0 * n + r * n2 + kap], g0inv, p);
            e[r * n2 + kap] = er;
            for (i64 j = 0; j < n2; j++)
                if (B[j * n + r * n2 + kap] != mulmod(e[r * n2 + kap], G[kap * n2 + j], p)) {
                    delete[] twid; delete[] buf; delete[] B; return 4;
                }
        }
    }

    // Ainv: inverse stages [k, 0) on column basis; verify column-independence
    for (int col = 0; col < 2 && col < n2; col++) {
        std::memset(buf, 0, sizeof(u64) * n1 * n);
        for (i64 i = 0; i < n1; i++) buf[i * n + i * n2 + col] = 1;
        inv_stages(buf, n1, n, inv_twid, p, k, 0);
        for (i64 rr = 0; rr < n1; rr++)
            for (i64 i = 0; i < n1; i++) {
                u64 v = buf[i * n + rr * n2 + col];
                if (col == 0) Ainv[rr * n1 + i] = v;
                else if (Ainv[rr * n1 + i] != v) { delete[] twid; delete[] buf; delete[] B; return 5; }
            }
    }

    delete[] twid;
    delete[] buf;
    delete[] B;
    return 0;
}

// int8 digit-plane packing (exactly ops/mxu32.py _prep_matrix, generalized):
// M[K*O] u64 (mod p) -> planes[(E*K) * (D*O)] int8, cvec[D*O] int32.
// E = operand digit planes, D = matrix digit planes (4 for p < 2^31,
// 8 for p < 2^62). Returns 0 on success; nonzero = digit/constant overflow.
int ntt_prep_matrix_d(const u64* M, i64 K, i64 O, u64 p, i64 E, i64 D,
                      int8_t* planes, int32_t* cvec) {
    i64* csum = new i64[D * O]();
    u64* Me = new u64[K * O];
    std::memcpy(Me, M, sizeof(u64) * K * O);
    for (i64 ee = 0; ee < E; ee++) {
        if (ee > 0)
            for (i64 t = 0; t < K * O; t++) Me[t] = (u64)(((u128)Me[t] << 8) % p);
        for (i64 kk = 0; kk < K; kk++)
            for (i64 oo = 0; oo < O; oo++) {
                // centered representative; compare in u64 first (p may
                // exceed 2^63, e.g. Goldilocks)
                u64 raw = Me[kk * O + oo];
                i64 v = (raw > p / 2) ? (i64)(raw - p) : (i64)raw;
                for (i64 dd = 0; dd < D; dd++) {
                    i64 r = ((v + 128) & 255) - 128;
                    planes[(ee * K + kk) * (D * O) + dd * O + oo] = (int8_t)r;
                    csum[dd * O + oo] += 128 * r;
                    v = (v - r) >> 8;
                }
                if (v != 0) { delete[] csum; delete[] Me; return 1; }
            }
    }
    for (i64 t = 0; t < D * O; t++) {
        i64 c = csum[t];
        if (c <= -(1ll << 27) || c >= (1ll << 27)) { delete[] csum; delete[] Me; return 2; }
        cvec[t] = (int32_t)(c + (1ll << 27));
    }
    delete[] csum;
    delete[] Me;
    return 0;
}

int ntt_prep_matrix(const u64* M, i64 K, i64 O, u64 p, i64 E, int8_t* planes,
                    int32_t* cvec) {
    return ntt_prep_matrix_d(M, K, O, p, E, 4, planes, cvec);
}

}  // extern "C"
