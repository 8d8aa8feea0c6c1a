/* BN254 multi-scalar multiplication on the host CPU: the port's copy of
 * native/bn254_msm.c (bn254_msm_g1, bn254_g1_mul_batch, bn254_msm_g2,
 * bn254_g2_mul_batch), the Groth16 proving hot loop of
 * zktls_tpu_torch/snark/groth16.py: Pippenger bucket MSM and batched
 * fixed-base multiplication over the BN254 BASE field (4x64 Montgomery,
 * CIOS), Jacobian internally, plain-limb affine at the interface.
 *
 * The arithmetic below is the reference's, unchanged.  Built at first use
 * by zktls_tpu_torch/utils/native.py with the system C compiler
 * (cc -O3 -shared -fPIC -fopenmp) into build/native/ and bound with
 * ctypes; the fixed-base batches run their scalars on OpenMP threads, and
 * each output depends on its own scalar only, so the thread count changes
 * no result.  This is host code, not a device kernel.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>
#include <stdlib.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;

/* base field p (EIP-196) */
static const u64 PMOD[4] = {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                            0xb85045b68181585dULL, 0x30644e72e131a029ULL};
static const u64 PR2[4] = {0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL,
                           0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL};
#define PN0_INV 0x87d20782e4866389ULL

static int geqp(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return 0;
    }
    return 1;
}

static void subp_if(u64 a[4]) {
    if (geqp(a, PMOD)) {
        u128 borrow = 0;
        for (int i = 0; i < 4; i++) {
            u128 d = (u128)a[i] - PMOD[i] - borrow;
            a[i] = (u64)d;
            borrow = (d >> 64) & 1;
        }
    }
}

static void fmul(u64 out[4], const u64 a[4], const u64 b[4]) {
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
        u64 m = t[0] * PN0_INV;
        u128 c0 = (u128)m * PMOD[0] + t[0];
        carry = c0 >> 64;
        for (int j = 1; j < 4; j++) {
            u128 cur2 = (u128)m * PMOD[j] + t[j] + carry;
            t[j - 1] = (u64)cur2;
            carry = cur2 >> 64;
        }
        u128 cur3 = (u128)t[4] + carry;
        t[3] = (u64)cur3;
        t[4] = t[5] + (u64)(cur3 >> 64);
        t[5] = 0;
    }
    memcpy(out, t, 32);
    subp_if(out);
}

static void fadd(u64 out[4], const u64 a[4], const u64 b[4]) {
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a[i] + b[i] + carry;
        out[i] = (u64)s;
        carry = s >> 64;
    }
    subp_if(out);
}

static void fsub(u64 out[4], const u64 a[4], const u64 b[4]) {
    u128 borrow = 0;
    u64 t[4];
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - b[i] - borrow;
        t[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 s = (u128)t[i] + PMOD[i] + carry;
            t[i] = (u64)s;
            carry = s >> 64;
        }
    }
    memcpy(out, t, 32);
}

static void fdbl(u64 out[4], const u64 a[4]) { fadd(out, a, a); }

static int fzero(const u64 a[4]) {
    return (a[0] | a[1] | a[2] | a[3]) == 0;
}

static void to_montp(u64 out[4], const u64 a[4]) { fmul(out, a, PR2); }

static void from_montp(u64 out[4], const u64 a[4]) {
    static const u64 one[4] = {1, 0, 0, 0};
    fmul(out, a, one);
}

/* Jacobian point (Montgomery-form coordinates); Z = 0 means infinity */
typedef struct { u64 X[4], Y[4], Z[4]; } jac;

static void jac_set_inf(jac *p) { memset(p, 0, sizeof(*p)); }

static int jac_is_inf(const jac *p) { return fzero(p->Z); }

/* doubling (2009 Bernstein–Lange dbl-2009-l, a = 0) */
static void jac_dbl(jac *out, const jac *p) {
    if (jac_is_inf(p)) { *out = *p; return; }
    u64 A[4], B[4], C[4], D[4], E[4], F[4], t[4], t2[4];
    fmul(A, p->X, p->X);            /* A = X1^2 */
    fmul(B, p->Y, p->Y);            /* B = Y1^2 */
    fmul(C, B, B);                  /* C = B^2 */
    fadd(t, p->X, B);               /* (X1+B) */
    fmul(t, t, t);                  /* (X1+B)^2 */
    fsub(t, t, A);
    fsub(t, t, C);
    fdbl(D, t);                     /* D = 2((X1+B)^2 - A - C) */
    fdbl(E, A); fadd(E, E, A);      /* E = 3A */
    fmul(F, E, E);                  /* F = E^2 */
    fsub(t, F, D); fsub(t, t, D);   /* X3 = F - 2D */
    u64 X3[4]; memcpy(X3, t, 32);
    fsub(t, D, X3);
    fmul(t, E, t);                  /* E(D - X3) */
    fdbl(t2, C); fdbl(t2, t2); fdbl(t2, t2);  /* 8C */
    fsub(t, t, t2);                 /* Y3 */
    u64 Y3[4]; memcpy(Y3, t, 32);
    fmul(t, p->Y, p->Z);
    fdbl(t, t);                     /* Z3 = 2 Y1 Z1 */
    memcpy(out->X, X3, 32);
    memcpy(out->Y, Y3, 32);
    memcpy(out->Z, t, 32);
}

/* mixed addition: q is affine (Montgomery coords), add-2007-bl style */
static void jac_add_affine(jac *out, const jac *p, const u64 qx[4],
                           const u64 qy[4]) {
    if (jac_is_inf(p)) {
        memcpy(out->X, qx, 32);
        memcpy(out->Y, qy, 32);
        static const u64 one[4] = {1, 0, 0, 0};
        to_montp(out->Z, one);
        return;
    }
    u64 Z1Z1[4], U2[4], S2[4], H[4], HH[4], I[4], J[4], r[4], V[4];
    u64 t[4];
    fmul(Z1Z1, p->Z, p->Z);
    fmul(U2, qx, Z1Z1);
    fmul(S2, qy, p->Z);
    fmul(S2, S2, Z1Z1);
    fsub(H, U2, p->X);
    fsub(r, S2, p->Y);
    if (fzero(H)) {
        if (fzero(r)) { jac_dbl(out, p); return; }
        jac_set_inf(out);
        return;
    }
    fdbl(r, r);                     /* r = 2(S2 - Y1) */
    fmul(HH, H, H);
    fdbl(I, HH); fdbl(I, I);        /* I = 4 HH */
    fmul(J, H, I);
    fmul(V, p->X, I);
    fmul(t, r, r);
    fsub(t, t, J);
    fsub(t, t, V); fsub(t, t, V);   /* X3 = r^2 - J - 2V */
    u64 X3[4]; memcpy(X3, t, 32);
    fsub(t, V, X3);
    fmul(t, r, t);
    u64 t2[4];
    fmul(t2, p->Y, J);
    fdbl(t2, t2);
    fsub(t, t, t2);                 /* Y3 = r(V-X3) - 2 Y1 J */
    u64 Y3[4]; memcpy(Y3, t, 32);
    fadd(t, p->Z, H);
    fmul(t, t, t);
    fsub(t, t, Z1Z1);
    fsub(t, t, HH);                 /* Z3 = (Z1+H)^2 - Z1Z1 - HH */
    memcpy(out->X, X3, 32);
    memcpy(out->Y, Y3, 32);
    memcpy(out->Z, t, 32);
}

static void jac_add(jac *out, const jac *p, const jac *q) {
    if (jac_is_inf(p)) { *out = *q; return; }
    if (jac_is_inf(q)) { *out = *p; return; }
    u64 Z1Z1[4], Z2Z2[4], U1[4], U2[4], S1[4], S2[4], H[4], I[4], J[4];
    u64 r[4], V[4], t[4], t2[4];
    fmul(Z1Z1, p->Z, p->Z);
    fmul(Z2Z2, q->Z, q->Z);
    fmul(U1, p->X, Z2Z2);
    fmul(U2, q->X, Z1Z1);
    fmul(S1, p->Y, q->Z); fmul(S1, S1, Z2Z2);
    fmul(S2, q->Y, p->Z); fmul(S2, S2, Z1Z1);
    fsub(H, U2, U1);
    fsub(r, S2, S1);
    if (fzero(H)) {
        if (fzero(r)) { jac_dbl(out, p); return; }
        jac_set_inf(out);
        return;
    }
    fdbl(t, H); fmul(I, t, t);      /* I = (2H)^2 */
    fmul(J, H, I);
    fdbl(r, r);                     /* r = 2(S2-S1) */
    fmul(V, U1, I);
    fmul(t, r, r); fsub(t, t, J); fsub(t, t, V); fsub(t, t, V);
    u64 X3[4]; memcpy(X3, t, 32);
    fsub(t, V, X3); fmul(t, r, t);
    fmul(t2, S1, J); fdbl(t2, t2);
    fsub(t, t, t2);
    u64 Y3[4]; memcpy(Y3, t, 32);
    fadd(t, p->Z, q->Z); fmul(t, t, t);
    fsub(t, t, Z1Z1); fsub(t, t, Z2Z2); fmul(t, t, H);
    memcpy(out->X, X3, 32);
    memcpy(out->Y, Y3, 32);
    memcpy(out->Z, t, 32);
}

/* ---- exported API ----
 * points: n * 8 plain limbs (x0..3, y0..3); a point with x=y=0 is
 * treated as infinity.  scalars: n * 4 plain limbs.  out: 12 plain
 * limbs (Jacobian X, Y, Z) — the caller normalizes. */

void bn254_msm_g1(const u64 *points, const u64 *scalars, size_t n,
                  u64 *out) {
    const int c = 13;                     /* window bits */
    const int windows = (254 + c - 1) / c;
    const size_t nbuckets = ((size_t)1 << c) - 1;
    jac *buckets = malloc(nbuckets * sizeof(jac));
    /* pre-convert affine coords to Montgomery once */
    u64 *mont = malloc(n * 8 * sizeof(u64));
    for (size_t i = 0; i < n; i++) {
        to_montp(mont + 8 * i, points + 8 * i);
        to_montp(mont + 8 * i + 4, points + 8 * i + 4);
    }
    jac total;
    jac_set_inf(&total);
    for (int w = windows - 1; w >= 0; w--) {
        for (int k = 0; k < c; k++)
            jac_dbl(&total, &total);
        for (size_t b = 0; b < nbuckets; b++)
            jac_set_inf(&buckets[b]);
        int bit0 = w * c;
        for (size_t i = 0; i < n; i++) {
            const u64 *s = scalars + 4 * i;
            /* extract window bits [bit0, bit0+c) */
            u64 v = 0;
            int limb = bit0 >> 6, off = bit0 & 63;
            v = s[limb] >> off;
            if (off + c > 64 && limb + 1 < 4)
                v |= s[limb + 1] << (64 - off);
            v &= ((u64)1 << c) - 1;
            if (v == 0) continue;
            const u64 *px = points + 8 * i;
            if ((px[0] | px[1] | px[2] | px[3] | px[4] | px[5] | px[6]
                 | px[7]) == 0)
                continue;
            jac_add_affine(&buckets[v - 1], &buckets[v - 1],
                           mont + 8 * i, mont + 8 * i + 4);
        }
        /* bucket reduction: sum_{b} b * bucket[b] via running sums */
        jac run, acc;
        jac_set_inf(&run);
        jac_set_inf(&acc);
        for (size_t b = nbuckets; b > 0; b--) {
            jac_add(&run, &run, &buckets[b - 1]);
            jac_add(&acc, &acc, &run);
        }
        jac_add(&total, &total, &acc);
    }
    memcpy(out, total.X, 32);
    memcpy(out + 4, total.Y, 32);
    memcpy(out + 8, total.Z, 32);
    /* coordinates back to plain form */
    from_montp(out, out);
    from_montp(out + 4, out + 4);
    from_montp(out + 8, out + 8);
    free(buckets);
    free(mont);
}

/* ---- G2 (Fp2 = Fp[i]/(i^2+1)) -------------------------------------- */

typedef struct { u64 re[4], im[4]; } f2;

static void f2mul(f2 *out, const f2 *a, const f2 *b) {
    u64 t1[4], t2[4], t3[4], t4[4];
    fmul(t1, a->re, b->re);
    fmul(t2, a->im, b->im);
    fadd(t3, a->re, a->im);
    fadd(t4, b->re, b->im);
    fmul(t3, t3, t4);          /* (a.re+a.im)(b.re+b.im) */
    fsub(out->re, t1, t2);
    fsub(t3, t3, t1);
    fsub(out->im, t3, t2);
}

static void f2add(f2 *out, const f2 *a, const f2 *b) {
    fadd(out->re, a->re, b->re);
    fadd(out->im, a->im, b->im);
}

static void f2sub(f2 *out, const f2 *a, const f2 *b) {
    fsub(out->re, a->re, b->re);
    fsub(out->im, a->im, b->im);
}

static void f2dbl(f2 *out, const f2 *a) { f2add(out, a, a); }

static int f2zero(const f2 *a) { return fzero(a->re) && fzero(a->im); }

static void f2_to_mont(f2 *out, const u64 *plain8) {
    to_montp(out->re, plain8);
    to_montp(out->im, plain8 + 4);
}

static void f2_from_mont(u64 *plain8, const f2 *a) {
    from_montp(plain8, a->re);
    from_montp(plain8 + 4, a->im);
}

typedef struct { f2 X, Y, Z; } jac2;

static void jac2_set_inf(jac2 *p) { memset(p, 0, sizeof(*p)); }

static int jac2_is_inf(const jac2 *p) { return f2zero(&p->Z); }

static void jac2_dbl(jac2 *out, const jac2 *p) {
    if (jac2_is_inf(p)) { *out = *p; return; }
    f2 A, B, C, D, E, F, t, t2;
    f2mul(&A, &p->X, &p->X);
    f2mul(&B, &p->Y, &p->Y);
    f2mul(&C, &B, &B);
    f2add(&t, &p->X, &B);
    f2mul(&t, &t, &t);
    f2sub(&t, &t, &A);
    f2sub(&t, &t, &C);
    f2dbl(&D, &t);
    f2dbl(&E, &A); f2add(&E, &E, &A);
    f2mul(&F, &E, &E);
    f2sub(&t, &F, &D); f2sub(&t, &t, &D);
    f2 X3 = t;
    f2sub(&t, &D, &X3);
    f2mul(&t, &E, &t);
    f2dbl(&t2, &C); f2dbl(&t2, &t2); f2dbl(&t2, &t2);
    f2sub(&t, &t, &t2);
    f2 Y3 = t;
    f2mul(&t, &p->Y, &p->Z);
    f2dbl(&t, &t);
    out->X = X3; out->Y = Y3; out->Z = t;
}

static void jac2_add(jac2 *out, const jac2 *p, const jac2 *q) {
    if (jac2_is_inf(p)) { *out = *q; return; }
    if (jac2_is_inf(q)) { *out = *p; return; }
    f2 Z1Z1, Z2Z2, U1, U2, S1, S2, H, I, J, r, V, t, t2;
    f2mul(&Z1Z1, &p->Z, &p->Z);
    f2mul(&Z2Z2, &q->Z, &q->Z);
    f2mul(&U1, &p->X, &Z2Z2);
    f2mul(&U2, &q->X, &Z1Z1);
    f2mul(&S1, &p->Y, &q->Z); f2mul(&S1, &S1, &Z2Z2);
    f2mul(&S2, &q->Y, &p->Z); f2mul(&S2, &S2, &Z1Z1);
    f2sub(&H, &U2, &U1);
    f2sub(&r, &S2, &S1);
    if (f2zero(&H)) {
        if (f2zero(&r)) { jac2_dbl(out, p); return; }
        jac2_set_inf(out);
        return;
    }
    f2dbl(&t, &H); f2mul(&I, &t, &t);
    f2mul(&J, &H, &I);
    f2dbl(&r, &r);
    f2mul(&V, &U1, &I);
    f2mul(&t, &r, &r); f2sub(&t, &t, &J);
    f2sub(&t, &t, &V); f2sub(&t, &t, &V);
    f2 X3 = t;
    f2sub(&t, &V, &X3); f2mul(&t, &r, &t);
    f2mul(&t2, &S1, &J); f2dbl(&t2, &t2);
    f2sub(&t, &t, &t2);
    f2 Y3 = t;
    f2add(&t, &p->Z, &q->Z); f2mul(&t, &t, &t);
    f2sub(&t, &t, &Z1Z1); f2sub(&t, &t, &Z2Z2); f2mul(&t, &t, &H);
    out->X = X3; out->Y = Y3; out->Z = t;
}

/* batched fixed-base G2: base 16 plain limbs (x.re x.im y.re y.im),
 * out n * 24 plain limbs (Jacobian, f2 coords re||im). */
void bn254_g2_mul_batch(const u64 *base, const u64 *scalars, size_t n,
                        u64 *out) {
    const int c = 8;
    const int windows = (254 + c - 1) / c;
    const size_t tsize = ((size_t)1 << c) - 1;
    jac2 *table = malloc(windows * tsize * sizeof(jac2));
    jac2 cur;
    f2_to_mont(&cur.X, base);
    f2_to_mont(&cur.Y, base + 8);
    static const u64 one[4] = {1, 0, 0, 0};
    to_montp(cur.Z.re, one);
    memset(cur.Z.im, 0, 32);
    for (int w = 0; w < windows; w++) {
        jac2 acc;
        jac2_set_inf(&acc);
        for (size_t v = 1; v <= tsize; v++) {
            jac2_add(&acc, &acc, &cur);
            table[w * tsize + (v - 1)] = acc;
        }
        jac2_add(&cur, &acc, &cur);
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (size_t i = 0; i < n; i++) {
        const u64 *s = scalars + 4 * i;
        jac2 r;
        jac2_set_inf(&r);
        for (int w = 0; w < windows; w++) {
            int bit0 = w * c;
            u64 v = 0;
            int limb = bit0 >> 6, off = bit0 & 63;
            v = s[limb] >> off;
            if (off + c > 64 && limb + 1 < 4)
                v |= s[limb + 1] << (64 - off);
            v &= ((u64)1 << c) - 1;
            if (v)
                jac2_add(&r, &r, &table[w * tsize + (v - 1)]);
        }
        f2_from_mont(out + 24 * i, &r.X);
        f2_from_mont(out + 24 * i + 8, &r.Y);
        f2_from_mont(out + 24 * i + 16, &r.Z);
    }
    free(table);
}

/* G2 MSM (Pippenger over jac2; points n*16 plain limbs, out 24 limbs) */
void bn254_msm_g2(const u64 *points, const u64 *scalars, size_t n,
                  u64 *out) {
    const int c = 13;
    const int windows = (254 + c - 1) / c;
    const size_t nbuckets = ((size_t)1 << c) - 1;
    jac2 *buckets = malloc(nbuckets * sizeof(jac2));
    jac2 *aff = malloc(n * sizeof(jac2));
    static const u64 one[4] = {1, 0, 0, 0};
    for (size_t i = 0; i < n; i++) {
        f2_to_mont(&aff[i].X, points + 16 * i);
        f2_to_mont(&aff[i].Y, points + 16 * i + 8);
        to_montp(aff[i].Z.re, one);
        memset(aff[i].Z.im, 0, 32);
    }
    jac2 total;
    jac2_set_inf(&total);
    for (int w = windows - 1; w >= 0; w--) {
        for (int k = 0; k < c; k++)
            jac2_dbl(&total, &total);
        for (size_t b = 0; b < nbuckets; b++)
            jac2_set_inf(&buckets[b]);
        int bit0 = w * c;
        for (size_t i = 0; i < n; i++) {
            const u64 *s = scalars + 4 * i;
            u64 v = 0;
            int limb = bit0 >> 6, off = bit0 & 63;
            v = s[limb] >> off;
            if (off + c > 64 && limb + 1 < 4)
                v |= s[limb + 1] << (64 - off);
            v &= ((u64)1 << c) - 1;
            if (v == 0) continue;
            const u64 *px = points + 16 * i;
            int allz = 1;
            for (int k = 0; k < 16; k++)
                if (px[k]) { allz = 0; break; }
            if (allz) continue;
            jac2_add(&buckets[v - 1], &buckets[v - 1], &aff[i]);
        }
        jac2 run, acc;
        jac2_set_inf(&run);
        jac2_set_inf(&acc);
        for (size_t b = nbuckets; b > 0; b--) {
            jac2_add(&run, &run, &buckets[b - 1]);
            jac2_add(&acc, &acc, &run);
        }
        jac2_add(&total, &total, &acc);
    }
    f2_from_mont(out, &total.X);
    f2_from_mont(out + 8, &total.Y);
    f2_from_mont(out + 16, &total.Z);
    free(buckets);
    free(aff);
}

/* batched fixed-base: out[i] = scalars[i] * base, one shared window
 * table.  base: 8 plain limbs; out: n * 12 plain limbs (Jacobian). */
void bn254_g1_mul_batch(const u64 *base, const u64 *scalars, size_t n,
                        u64 *out) {
    const int c = 8;
    const int windows = (254 + c - 1) / c;   /* 32 windows */
    const size_t tsize = ((size_t)1 << c) - 1;
    /* table[w][v-1] = v * 2^(cw) * base, affine-in-Montgomery via jac */
    jac *table = malloc(windows * tsize * sizeof(jac));
    u64 bx[4], by[4];
    to_montp(bx, base);
    to_montp(by, base + 4);
    jac cur;
    memcpy(cur.X, bx, 32);
    memcpy(cur.Y, by, 32);
    static const u64 one[4] = {1, 0, 0, 0};
    to_montp(cur.Z, one);
    for (int w = 0; w < windows; w++) {
        jac acc;
        jac_set_inf(&acc);
        for (size_t v = 1; v <= tsize; v++) {
            jac_add(&acc, &acc, &cur);
            table[w * tsize + (v - 1)] = acc;
        }
        /* cur <<= c */
        jac_add(&cur, &acc, &cur);   /* acc = (2^c - 1)B_w; +B_w = 2^c B_w */
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (size_t i = 0; i < n; i++) {
        const u64 *s = scalars + 4 * i;
        jac r;
        jac_set_inf(&r);
        for (int w = 0; w < windows; w++) {
            int bit0 = w * c;
            u64 v = 0;
            int limb = bit0 >> 6, off = bit0 & 63;
            v = s[limb] >> off;
            if (off + c > 64 && limb + 1 < 4)
                v |= s[limb + 1] << (64 - off);
            v &= ((u64)1 << c) - 1;
            if (v)
                jac_add(&r, &r, &table[w * tsize + (v - 1)]);
        }
        memcpy(out + 12 * i, r.X, 32);
        memcpy(out + 12 * i + 4, r.Y, 32);
        memcpy(out + 12 * i + 8, r.Z, 32);
        from_montp(out + 12 * i, out + 12 * i);
        from_montp(out + 12 * i + 4, out + 12 * i + 4);
        from_montp(out + 12 * i + 8, out + 12 * i + 8);
    }
    free(table);
}
