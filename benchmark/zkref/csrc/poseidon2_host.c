/* Scalar Poseidon2 over Baby-Bear on the host CPU: the port's copy of
 * native/poseidon2.c (p2_set_params, p2_permute_batch, p2_hash_rows,
 * p2_compress_pairs), unchanged but for this comment.
 *
 * The verifier and the Fiat-Shamir challenger run thousands of sequential
 * permutations per proof (Merkle path checks, the transcript sponge):
 * serial work that stays on the host.  Two instances are kept: 0 = width
 * 16 (node compression, challenger), 1 = width 24 (rate-16 leaf sponge).
 * The parameters are injected once from Python
 * (zktls_tpu_torch.ops.poseidon2.get_params), so C and Python agree.
 * Every input value must be a canonical field element (< P).
 *
 * Built at first use by zktls_tpu_torch/utils/native.py with the system C
 * compiler (cc -O3 -shared -fPIC) into build/native/ and bound with ctypes.
 * This is host code, not a device kernel.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#define P 2013265921u
#define MAX_WIDTH 24
#define MAX_RF 8
#define MAX_RP 32
#define N_INST 2

typedef struct {
    uint32_t width, rf, rp;
    uint32_t ext_rc[MAX_RF][MAX_WIDTH];
    uint32_t int_rc[MAX_RP];
    uint32_t diag[MAX_WIDTH];
} P2Params;

static P2Params g_inst[N_INST];

static inline uint32_t addm(uint32_t a, uint32_t b) {
    uint32_t s = a + b;            /* both < P < 2^31: no overflow */
    return s >= P ? s - P : s;
}

static inline uint32_t mulm(uint32_t a, uint32_t b) {
    return (uint32_t)(((uint64_t)a * b) % P);
}

static inline uint32_t sbox7(uint32_t x) {
    uint32_t x2 = mulm(x, x);
    uint32_t x4 = mulm(x2, x2);
    return mulm(mulm(x4, x2), x);
}

static void external_matrix(const P2Params *p, uint32_t *s) {
    uint32_t sums[4] = {0, 0, 0, 0};
    uint32_t tmp[MAX_WIDTH];
    for (uint32_t i = 0; i < p->width; i += 4) {
        uint32_t x0 = s[i], x1 = s[i + 1], x2 = s[i + 2], x3 = s[i + 3];
        uint32_t t = addm(addm(x0, x1), addm(x2, x3));
        uint32_t y0 = addm(t, addm(x0, addm(x1, x1)));
        uint32_t y1 = addm(t, addm(x1, addm(x2, x2)));
        uint32_t y2 = addm(t, addm(x2, addm(x3, x3)));
        uint32_t y3 = addm(t, addm(x3, addm(x0, x0)));
        tmp[i] = y0; tmp[i + 1] = y1; tmp[i + 2] = y2; tmp[i + 3] = y3;
        sums[0] = addm(sums[0], y0);
        sums[1] = addm(sums[1], y1);
        sums[2] = addm(sums[2], y2);
        sums[3] = addm(sums[3], y3);
    }
    for (uint32_t i = 0; i < p->width; i++)
        s[i] = addm(tmp[i], sums[i & 3]);
}

int p2_set_params(uint32_t inst, uint32_t width, uint32_t rf, uint32_t rp,
                  const uint32_t *ext_rc, const uint32_t *int_rc,
                  const uint32_t *diag) {
    if (inst >= N_INST || width > MAX_WIDTH || (width & 3) ||
        rf > MAX_RF || rp > MAX_RP)
        return -1;
    P2Params *p = &g_inst[inst];
    p->width = width; p->rf = rf; p->rp = rp;
    for (uint32_t r = 0; r < rf; r++)
        memcpy(p->ext_rc[r], ext_rc + r * width, width * sizeof(uint32_t));
    memcpy(p->int_rc, int_rc, rp * sizeof(uint32_t));
    memcpy(p->diag, diag, width * sizeof(uint32_t));
    return 0;
}

static void permute(const P2Params *p, uint32_t *s) {
    uint32_t half = p->rf / 2;
    external_matrix(p, s);
    for (uint32_t r = 0; r < half; r++) {
        for (uint32_t i = 0; i < p->width; i++)
            s[i] = sbox7(addm(s[i], p->ext_rc[r][i]));
        external_matrix(p, s);
    }
    for (uint32_t r = 0; r < p->rp; r++) {
        s[0] = sbox7(addm(s[0], p->int_rc[r]));
        uint32_t tot = 0;
        for (uint32_t i = 0; i < p->width; i++)
            tot = addm(tot, s[i]);
        for (uint32_t i = 0; i < p->width; i++)
            s[i] = addm(tot, mulm(s[i], p->diag[i]));
    }
    for (uint32_t r = half; r < p->rf; r++) {
        for (uint32_t i = 0; i < p->width; i++)
            s[i] = sbox7(addm(s[i], p->ext_rc[r][i]));
        external_matrix(p, s);
    }
}

void p2_permute_batch(uint32_t inst, uint32_t *states, size_t n) {
    const P2Params *p = &g_inst[inst];
    for (size_t i = 0; i < n; i++)
        permute(p, states + i * p->width);
}

/* Sponge-hash rows of `row_width` values with the instance's rate
 * (width − 8 capacity) into 8-element digests — the Merkle leaf hash. */
void p2_hash_rows(uint32_t inst, const uint32_t *rows, size_t n,
                  size_t row_width, uint32_t *digests) {
    const P2Params *p = &g_inst[inst];
    size_t rate = p->width - 8;
    size_t n_blocks = (row_width + rate - 1) / rate;
    for (size_t i = 0; i < n; i++) {
        uint32_t state[MAX_WIDTH];
        memset(state, 0, p->width * sizeof(uint32_t));
        for (size_t blk = 0; blk < n_blocks; blk++) {
            for (size_t j = 0; j < rate; j++) {
                size_t col = blk * rate + j;
                if (col < row_width)
                    state[j] = addm(state[j], rows[i * row_width + col]);
            }
            permute(p, state);
        }
        memcpy(digests + i * 8, state, 8 * sizeof(uint32_t));
    }
}

/* 2-to-1 compression of sibling digest pairs (width-16 instance). */
void p2_compress_pairs(uint32_t inst, const uint32_t *pairs, size_t n,
                       uint32_t *out) {
    const P2Params *p = &g_inst[inst];
    for (size_t i = 0; i < n; i++) {
        uint32_t state[MAX_WIDTH];
        memcpy(state, pairs + i * 16, 16 * sizeof(uint32_t));
        permute(p, state);
        memcpy(out + i * 8, state, 8 * sizeof(uint32_t));
    }
}
