/* MP-MiMC over the BN254 scalar field on the host CPU: the port's copy of
 * native/mimc_bn254.c (mimc_set_rc, mimc_hash_rows, mimc_compress_pairs),
 * the commitment hash of the shrink layer (stark/commit_bn.py,
 * stark/machine_bn.py): 110-round x^5 MiMC in Miyaguchi-Preneel mode, the
 * round constants injected from Python (zktls_tpu_torch.snark.wrap) so the
 * two never drift.
 *
 * The scalar part below is the reference's arithmetic unchanged: 4x64-limb
 * Montgomery (CIOS), plain little-endian u64 limbs at the interface; its
 * entry points are now scalar_set_rc / scalar_hash_rows behind the
 * exported API at the end.  Two additions of the port, which change no
 * output:
 *   - an AVX-512 IFMA path: eight rows per vector, 5x52-bit limbs,
 *     Montgomery with R = 2^260 and lazily reduced products; every digest
 *     leaves it canonical, so it equals the scalar path bit for bit.  It is
 *     taken when the CPU has AVX-512 IFMA (checked at run time) unless
 *     mimc_set_vector(0) turns it off; a full-width shrink hashes ~3e8
 *     permutations, ten times faster this way than in the scalar code;
 *   - the OpenMP thread count, settable (mimc_set_threads) so that several
 *     processes on one host can share its cores.
 *
 * Built at first use by zktls_tpu_torch/utils/native.py with the system C
 * compiler (cc -O3 -shared -fPIC -fopenmp) into build/native/ and bound
 * with ctypes.  It needs OpenMP: a build without it is refused below.
 * This is host code, not a device kernel.
 */

#ifndef _OPENMP
#error "mimc_bn254_host.c must be built with OpenMP (-fopenmp)"
#endif

#include <omp.h>

#include <stdint.h>
#include <stddef.h>
#include <string.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;

static const u64 MOD[4] = {0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                           0xb85045b68181585dULL, 0x30644e72e131a029ULL};
static const u64 R2[4] = {0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL,
                          0x8c49833d53bb8085ULL, 0x0216d0b17f4e44a5ULL};
#define N0_INV 0xc2e1f593efffffffULL

#define MIMC_ROUNDS 110
static u64 RC[MIMC_ROUNDS][4];   /* Montgomery form, set at init */
static int rc_ready = 0;
static int n_threads = 0;       /* 0: OpenMP's default */

static int threads(void) {
    return n_threads > 0 ? n_threads : omp_get_max_threads();
}

static int geq(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return 0;
    }
    return 1;
}

static void sub_mod_if(u64 a[4]) {
    if (geq(a, MOD)) {
        u128 borrow = 0;
        for (int i = 0; i < 4; i++) {
            u128 d = (u128)a[i] - MOD[i] - borrow;
            a[i] = (u64)d;
            borrow = (d >> 64) & 1;
        }
    }
}

/* CIOS Montgomery multiplication: out = a*b*2^-256 mod MOD */
static void mont_mul(u64 out[4], const u64 a[4], const u64 b[4]) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 cur = (u128)a[j] * b[i] + t[j] + carry;
            t[j] = (u64)cur;
            carry = cur >> 64;
        }
        u128 cur = (u128)t[4] + carry;
        t[4] = (u64)cur;
        t[5] = (u64)(cur >> 64);
        u64 m = t[0] * N0_INV;
        carry = 0;
        u128 c0 = (u128)m * MOD[0] + t[0];
        carry = c0 >> 64;
        for (int j = 1; j < 4; j++) {
            u128 cur2 = (u128)m * MOD[j] + t[j] + carry;
            t[j - 1] = (u64)cur2;
            carry = cur2 >> 64;
        }
        u128 cur3 = (u128)t[4] + carry;
        t[3] = (u64)cur3;
        t[4] = t[5] + (u64)(cur3 >> 64);
        t[5] = 0;
    }
    memcpy(out, t, 32);
    sub_mod_if(out);
}

static void add_mod(u64 out[4], const u64 a[4], const u64 b[4]) {
    u128 carry = 0;
    u64 t[4];
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a[i] + b[i] + carry;
        t[i] = (u64)s;
        carry = s >> 64;
    }
    /* values < MOD < 2^254, so no limb-4 overflow */
    memcpy(out, t, 32);
    sub_mod_if(out);
}

static void to_mont(u64 out[4], const u64 a[4]) { mont_mul(out, a, R2); }

static void from_mont(u64 out[4], const u64 a[4]) {
    static const u64 one[4] = {1, 0, 0, 0};
    mont_mul(out, a, one);
}

/* x^5 in Montgomery form */
static void pow5(u64 out[4], const u64 x[4]) {
    u64 x2[4], x4[4];
    mont_mul(x2, x, x);
    mont_mul(x4, x2, x2);
    mont_mul(out, x4, x);
}

/* P(m, k): x = m; rounds x <- (x + k + c)^5.  All Montgomery. */
static void mimc_perm(u64 out[4], const u64 m[4], const u64 k[4]) {
    u64 x[4], t[4];
    memcpy(x, m, 32);
    for (int r = 0; r < MIMC_ROUNDS; r++) {
        add_mod(t, x, k);
        add_mod(t, t, RC[r]);
        pow5(x, t);
    }
    memcpy(out, x, 32);
}

/* Miyaguchi-Preneel step: h' = P(m, h) + h + m (Montgomery) */
static void mp_step(u64 h[4], const u64 m[4]) {
    u64 p[4];
    mimc_perm(p, m, h);
    add_mod(p, p, h);
    add_mod(h, p, m);
}

/* ---- the reference's exported API, scalar (plain-form u64[4] little-endian limbs) ---- */

/* rc: MIMC_ROUNDS x 4 plain limbs */
static int scalar_set_rc(const u64 *rc) {
    for (int r = 0; r < MIMC_ROUNDS; r++)
        to_mont(RC[r], rc + 4 * r);
    rc_ready = 1;
    return 0;
}

/* hash n rows of k field elements each: out[i] = MP-chain over row i.
 * elems: n*k*4 plain limbs; out: n*4 plain limbs. */
static void scalar_hash_rows(const u64 *elems, size_t n, size_t k,
                             u64 *out) {
#pragma omp parallel for schedule(static) num_threads(threads())
    for (size_t i = 0; i < n; i++) {
        u64 h[4] = {0, 0, 0, 0};
        for (size_t j = 0; j < k; j++) {
            u64 m[4];
            to_mont(m, elems + 4 * (i * k + j));
            mp_step(h, m);
        }
        from_mont(out + 4 * i, h);
    }
}

/* ---- the vector path (AVX-512 IFMA), the port's addition ---- */

#if defined(__x86_64__) && defined(__GNUC__)
#include <immintrin.h>
#define HAVE_VECTOR 1
#define M52 0xFFFFFFFFFFFFFULL

/* the vector Montgomery domain uses R' = 2^260 over 5x52-bit limbs */
static u64 P52[5], R2V[5], N0V;
static u64 RCV[MIMC_ROUNDS][5];   /* round constants * R' mod MOD */

static void to52(u64 out[5], const u64 w[4]) {
    out[0] = w[0] & M52;
    out[1] = ((w[0] >> 52) | (w[1] << 12)) & M52;
    out[2] = ((w[1] >> 40) | (w[2] << 24)) & M52;
    out[3] = ((w[2] >> 28) | (w[3] << 36)) & M52;
    out[4] = w[3] >> 16;
}

/* plain x * 2^e mod MOD by doubling (set-up only) */
static void shl_mod(u64 out[4], const u64 x[4], int e) {
    u64 t[4];
    memcpy(t, x, 32);
    while (geq(t, MOD)) sub_mod_if(t);
    for (int i = 0; i < e; i++) add_mod(t, t, t);
    memcpy(out, t, 32);
}

static void vector_set_rc(const u64 *rc) {
    u64 one[4] = {1, 0, 0, 0}, r2[4];
    to52(P52, MOD);
    N0V = N0_INV & M52;            /* -MOD^-1 mod 2^52 */
    shl_mod(r2, one, 520);
    to52(R2V, r2);
    for (int r = 0; r < MIMC_ROUNDS; r++) {
        u64 c[4];
        shl_mod(c, rc + 4 * r, 260);
        to52(RCV[r], c);
    }
}

#define VTARGET __attribute__((target("avx512f,avx512ifma")))
#define LO(acc, a, b) _mm512_madd52lo_epu64(acc, a, b)
#define HI(acc, a, b) _mm512_madd52hi_epu64(acc, a, b)

/* carry-propagate to 52-bit limbs (the top limb keeps the rest) */
VTARGET static inline void vnorm(__m512i t[5]) {
    const __m512i m = _mm512_set1_epi64(M52);
    for (int j = 0; j < 4; j++) {
        t[j + 1] = _mm512_add_epi64(t[j + 1], _mm512_srli_epi64(t[j], 52));
        t[j] = _mm512_and_si512(t[j], m);
    }
}

/* out = a*b*2^-260 mod MOD, lazily reduced: for normalized a, b < 2^256
 * the result is < a*b/2^260 + MOD < 2^252 + MOD < 1.34 MOD, normalized.
 * Every limb accumulator stays below 21 * 2^52: no 64-bit lane overflows. */
VTARGET static inline void vmul(__m512i out[5], const __m512i a[5],
                                const __m512i b[5]) {
    const __m512i z = _mm512_setzero_si512();
    const __m512i n0 = _mm512_set1_epi64(N0V);
    __m512i p[5];
    for (int j = 0; j < 5; j++) p[j] = _mm512_set1_epi64(P52[j]);
    __m512i t0 = z, t1 = z, t2 = z, t3 = z, t4 = z, t5 = z;
    for (int i = 0; i < 5; i++) {
        __m512i bi = b[i];
        t0 = LO(t0, a[0], bi); t1 = HI(t1, a[0], bi);
        t1 = LO(t1, a[1], bi); t2 = HI(t2, a[1], bi);
        t2 = LO(t2, a[2], bi); t3 = HI(t3, a[2], bi);
        t3 = LO(t3, a[3], bi); t4 = HI(t4, a[3], bi);
        t4 = LO(t4, a[4], bi); t5 = HI(t5, a[4], bi);
        __m512i m = LO(z, t0, n0);          /* t0 * n0 mod 2^52 */
        t0 = LO(t0, m, p[0]); t1 = HI(t1, m, p[0]);
        t1 = LO(t1, m, p[1]); t2 = HI(t2, m, p[1]);
        t2 = LO(t2, m, p[2]); t3 = HI(t3, m, p[2]);
        t3 = LO(t3, m, p[3]); t4 = HI(t4, m, p[3]);
        t4 = LO(t4, m, p[4]); t5 = HI(t5, m, p[4]);
        /* t0 = 0 mod 2^52 now: carry it up and shift one limb down */
        t1 = _mm512_add_epi64(t1, _mm512_srli_epi64(t0, 52));
        t0 = t1; t1 = t2; t2 = t3; t3 = t4; t4 = t5; t5 = z;
    }
    out[0] = t0; out[1] = t1; out[2] = t2; out[3] = t3; out[4] = t4;
    vnorm(out);
}

/* x <- x - MOD where x >= MOD (x normalized) */
VTARGET static inline void vsub_if_ge(__m512i x[5]) {
    const __m512i m = _mm512_set1_epi64(M52);
    __m512i d[5], borrow = _mm512_setzero_si512();
    for (int j = 0; j < 5; j++) {
        __m512i v = _mm512_sub_epi64(
            _mm512_sub_epi64(x[j], _mm512_set1_epi64(P52[j])), borrow);
        borrow = _mm512_srli_epi64(v, 63);
        d[j] = j < 4 ? _mm512_and_si512(v, m) : v;
    }
    __mmask8 ge = _mm512_cmpeq_epi64_mask(borrow, _mm512_setzero_si512());
    for (int j = 0; j < 5; j++) x[j] = _mm512_mask_blend_epi64(ge, x[j], d[j]);
}

/* Miyaguchi-Preneel step on eight lanes: h <- P(m, h) + h + m.  h is
 * canonical (< MOD) in and out; m is a lazily reduced Montgomery value
 * (< 1.07 MOD).  Round inputs x + h + c stay below 3.34 MOD < 2^256 and
 * products below 1.34 MOD, so no reduction is needed inside the
 * permutation. */
VTARGET static inline void vmp_step(__m512i h[5], const __m512i m[5]) {
    __m512i x[5], t[5], x2[5], x4[5];
    for (int j = 0; j < 5; j++) x[j] = m[j];
    for (int r = 0; r < MIMC_ROUNDS; r++) {
        for (int j = 0; j < 5; j++)
            t[j] = _mm512_add_epi64(_mm512_add_epi64(x[j], h[j]),
                                    _mm512_set1_epi64(RCV[r][j]));
        vnorm(t);
        vmul(x2, t, t);
        vmul(x4, x2, x2);
        vmul(x, x4, t);
    }
    for (int j = 0; j < 5; j++)
        h[j] = _mm512_add_epi64(_mm512_add_epi64(x[j], h[j]), m[j]);
    vnorm(h);                    /* < 1.34 MOD + MOD + 1.07 MOD < 4 MOD */
    for (int s = 0; s < 3; s++) vsub_if_ge(h);
}

/* rows i0 .. i0+nl-1 (nl <= 8; idle lanes repeat row i0) */
VTARGET static void vector_hash_group(const u64 *elems, size_t i0, int nl,
                                      size_t k, u64 *out) {
    __m512i h[5], m[5], r2[5], one[5];
    u64 lanes[5][8] __attribute__((aligned(64)));
    for (int j = 0; j < 5; j++) {
        h[j] = _mm512_setzero_si512();
        r2[j] = _mm512_set1_epi64(R2V[j]);
        one[j] = _mm512_set1_epi64(j == 0);
    }
    for (size_t e = 0; e < k; e++) {
        for (int l = 0; l < 8; l++) {
            u64 v[5];
            to52(v, elems + 4 * ((i0 + (l < nl ? l : 0)) * k + e));
            for (int j = 0; j < 5; j++) lanes[j][l] = v[j];
        }
        for (int j = 0; j < 5; j++) m[j] = _mm512_load_si512(lanes[j]);
        vmul(m, m, r2);               /* into Montgomery form */
        vmp_step(h, m);
    }
    vmul(h, h, one);                  /* out of Montgomery form: <= MOD */
    vsub_if_ge(h);
    for (int j = 0; j < 5; j++) _mm512_store_si512(lanes[j], h[j]);
    for (int l = 0; l < nl; l++) {
        u64 *w = out + 4 * (i0 + l);
        w[0] = lanes[0][l] | (lanes[1][l] << 52);
        w[1] = (lanes[1][l] >> 12) | (lanes[2][l] << 40);
        w[2] = (lanes[2][l] >> 24) | (lanes[3][l] << 28);
        w[3] = (lanes[3][l] >> 36) | (lanes[4][l] << 16);
    }
}

static void vector_hash_rows(const u64 *elems, size_t n, size_t k,
                             u64 *out) {
    size_t groups = (n + 7) / 8;
#pragma omp parallel for schedule(static) num_threads(threads())
    for (size_t g = 0; g < groups; g++) {
        size_t i0 = 8 * g;
        vector_hash_group(elems, i0, (int)(n - i0 < 8 ? n - i0 : 8), k,
                          out);
    }
}

static int vector_available(void) {
    __builtin_cpu_init();
    return __builtin_cpu_supports("avx512f")
        && __builtin_cpu_supports("avx512ifma");
}
#else
#define HAVE_VECTOR 0
static void vector_set_rc(const u64 *rc) { (void)rc; }
static void vector_hash_rows(const u64 *elems, size_t n, size_t k,
                             u64 *out) {
    (void)elems; (void)n; (void)k; (void)out;
}
static int vector_available(void) { return 0; }
#endif

/* ---- exported API (plain-form u64[4] little-endian limbs) ---- */

static int use_vector = 1;       /* mimc_set_vector */

/* rc: MIMC_ROUNDS x 4 plain limbs */
int mimc_set_rc(const u64 *rc) {
    scalar_set_rc(rc);
    vector_set_rc(rc);
    return 0;
}

/* hash n rows of k field elements each: out[i] = MP-chain over row i.
 * elems: n*k*4 plain limbs; out: n*4 plain limbs. */
void mimc_hash_rows(const u64 *elems, size_t n, size_t k, u64 *out) {
    if (!rc_ready) return;
    if (use_vector && vector_available())
        vector_hash_rows(elems, n, k, out);
    else
        scalar_hash_rows(elems, n, k, out);
}

/* compress n (left, right) digest pairs: out[i] = MP-chain over 2 elems.
 * pairs laid out [l0 r0 l1 r1 ...] as plain limbs. */
void mimc_compress_pairs(const u64 *pairs, size_t n, u64 *out) {
    mimc_hash_rows(pairs, n, 2, out);
}

/* OpenMP threads of mimc_hash_rows (n <= 0: OpenMP's default); returns
 * the count now in use */
int mimc_set_threads(int n) {
    n_threads = n > 0 ? n : 0;
    return threads();
}

int mimc_threads(void) { return threads(); }

/* take the vector path where the CPU has it (on != 0) or never; returns
 * whether mimc_hash_rows now takes it */
int mimc_set_vector(int on) {
    use_vector = on != 0;
    return use_vector && vector_available();
}
