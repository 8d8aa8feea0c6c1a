"""Key-schedule AIR chip — binds the session's AEAD traffic keys to the
TLS 1.2 PRF chain rooted at the ECDHE premaster secret.

The reference gets this binding for free: the guest program's straight-line
execution derives master secret and key block from the premaster before
using the keys (SURVEY.md §3.4 "TLS-1.2 PRF"); a zkVM proof therefore
attests the whole derivation.  Here the machine equivalent is explicit
composition over the global bus:

  BUS_EC_RESULT ──→ intake row ──(KS_OUT byte pairs)──→ premaster secret
  rows (⊕opad proven via the nibble-xor table) ──(KS_PAD)──→ HMAC rows,
  which consume atomic SHA compression statements (BUS_SHA_HOP:
  compress(in, block) = out) for the OUTER HMAC walk:

      t1 = compress(IV, secret ⊕ opad)        [block pinned to the secret]
      out = compress(t1, ·)                    [inner digest block free]

  — sufficient to bind out to the secret (the inner chain and P_hash
  A-values ride inside the free block; forging a different `out` for the
  same secret needs a compression-function preimage).  The master-PRF
  outputs feed the master-secret rows the same way; the key-block PRF's
  outputs feed the assembly rows, which publish BUS_SESSION_KEY
  (obj, dir, kv, key, iv/salt) — consumed per record header by the GCM
  control chip, whose nonce salt limbs ride in the same payload.

So substituting a foreign AES key, a foreign master secret, or a foreign
record salt breaks the bus; the key provably equals
PRF(premaster, ·) with premaster the x-coordinate of the proven d·S
ladder result (stark/chips/ec.py).  Honest scope: x25519 sessions use a
free-premaster intake (xfr = 1 — the Montgomery-ladder row type is the
remaining gap), and label/seed inputs are free (they ride the unpinned
HMAC message block; any accepted substitution still requires inverting
SHA-256 compressions).

Sid scheme (per session, base B witness-chosen): intake = B, premaster
secret = B+1, master-PRF out1/out2 HMACs = B+2/B+3, master secret = B+4,
key-block-PRF out1/out2 = B+5/B+6.  Row-local sid offsets are
constraint-pinned, so the dataflow graph is structural, not prover-chosen.

Port copy of zktls_tpu.stark.chips.keyschedule (same names and values; host
code in numpy).
"""

from __future__ import annotations

import numpy as np

from ...guest.crypto.sha256 import _IV, compress
from ...ops.field_ref import P
from ..air import Air, AirBuilder
from ..bus import (
    BUS_EC_RESULT,
    BUS_KS_OUT,
    BUS_KS_PAD,
    BUS_SESSION_KEY,
    BUS_SHA_HOP,
    BUS_XOR,
    np_bus_inverse_terms,
)
from ..ext_val import ExtVal

__all__ = ["KeyScheduleAir", "keyschedule_trace", "KsSession"]

NL = 16
#: IV as the hop-payload's 16 (lo, hi) state limbs
_IV_LIMBS = []
for _w in _IV:
    _IV_LIMBS += [_w & 0xFFFF, _w >> 16]


def _swap(j: int) -> int:
    """Byte-pair index → (lo, hi) limb-column index (pair 2w = hi limb of
    word w = column 2w+1; pair 2w+1 = lo limb = column 2w)."""
    return j + 1 if j % 2 == 0 else j - 1


class _Layout:
    def __init__(self):
        self._n = 0
        self.slices: dict[str, slice] = {}

    def add(self, name, count):
        self.slices[name] = slice(self._n, self._n + count)
        self._n += count

    @property
    def width(self):
        return self._n

    def __getitem__(self, name):
        return self.slices[name]


def _build_layout() -> _Layout:
    L = _Layout()
    for nm in ("rt_in", "rt_sec", "rt_h1", "rt_h2", "rt_key"):
        L.add(nm, 1)
    L.add("sid0", 1)     # intake B / HMAC hsid / secret ssid / key bsid
    L.add("xfr", 1)      # free-premaster intake (x25519; documented gap)
    # intake
    L.add("rid", 1)
    L.add("nbv", 1)
    L.add("gbv", 1)
    L.add("xl", NL)
    L.add("yl", NL)
    L.add("ov", NL)      # the 16 published byte-pair values
    # secret byte-pair rows
    L.add("pidx", 1)
    L.add("s2", 1)
    L.add("t2", 1)
    L.add("nb0h", 1)     # nibbles of the pair's two bytes
    L.add("nb0l", 1)
    L.add("nb1h", 1)
    L.add("nb1l", 1)
    L.add("r0h", 1)      # ⊕opad nibbles (xor-table-proven)
    L.add("r0l", 1)
    L.add("r1h", 1)
    L.add("r1l", 1)
    L.add("mp", 1)       # pad-send multiplicity
    # HMAC rows
    L.add("h2nd", 1)     # second HMAC of its PRF (secret sid0 − 2)
    L.add("lc48", 1)     # 48-byte secret (master) vs 32 (premaster)
    L.add("blk", 32)     # the hop's message block (h1: opad block)
    L.add("t1", NL)      # h1's output state
    L.add("hin", NL)     # h2's input state (= prev row's t1)
    L.add("hout", NL)    # h2's output state (the HMAC digest)
    L.add("m_out", NL)   # per-pair KS_OUT send multiplicities (h2)
    # key assembly rows
    L.add("obj", 1)
    L.add("dirf", 1)
    L.add("kp", 8)       # key byte pairs
    L.add("ivp", 2)      # salt byte pairs
    L.add("mk", 1)       # SESSION_KEY send multiplicity (#records of dir)
    return L


LAYOUT = _build_layout()

#: perm ext layout
_SLOT = {}
_n = 0
for _nm, _k in (("main", 1), ("out", NL), ("ksout", 1), ("xor", 4),
                ("pad", 1), ("hop2", 1), ("padr", 24), ("kp", 8),
                ("ivp", 2), ("skey", 1), ("u", 1), ("acc", 1)):
    _SLOT[_nm] = _n
    _n += _k
PERM_EXTS = _n


class KeyScheduleAir(Air):
    width = LAYOUT.width
    num_public = 0
    max_constraint_degree = 3
    perm_width = 4 * PERM_EXTS
    num_perm_challenges = 2
    has_bus = True

    def eval(self, b: AirBuilder) -> None:
        L = LAYOUT

        def col(nm, nxt=False):
            return (b.next if nxt else b.local)[L[nm].start]

        def vec(nm, nxt=False):
            return (b.next_group if nxt else b.local_group)(L[nm])

        rt_in, rt_sec, rt_h1 = col("rt_in"), col("rt_sec"), col("rt_h1")
        rt_h2, rt_key = col("rt_h2"), col("rt_key")
        rts = [rt_in, rt_sec, rt_h1, rt_h2, rt_key]
        for c in rts + [col("xfr"), col("s2"), col("t2"), col("h2nd"),
                        col("lc48"), col("dirf")]:
            b.assert_bool(c)
        ssum = rt_in + rt_sec + rt_h1 + rt_h2 + rt_key
        b.assert_zero(ssum * (ssum - 1))     # at most one row type

        sid0 = col("sid0")
        XL, YL, OV = vec("xl"), vec("yl"), vec("ov")
        BLK, T1 = vec("blk"), vec("t1")
        HIN, HOUT = vec("hin"), vec("hout")
        MOUT = vec("m_out")
        KP, IVP = vec("kp"), vec("ivp")

        # intake: published values = x limbs reversed (premaster is the
        # big-endian x-coordinate) unless xfr (free premaster, x25519)
        for j in range(NL):
            b.assert_zero(rt_in * (1 - col("xfr"))
                          * (OV[j] - XL[NL - 1 - j]))
        # multiplicity columns live only on their row type (m_out also
        # carries the intake's send counts — a 48-byte premaster spans
        # two intake rows, the second publishing only 8 pairs)
        b.assert_zero_vec(MOUT * (1 - rt_h2 - rt_in), NL)
        b.assert_zero(col("mp") * (1 - rt_sec))
        b.assert_zero(col("mk") * (1 - rt_key))

        # HMAC pairing: an h1 row is followed by its h2 row
        b.when_first_row(rt_h2)
        b.when_last_row(rt_h1)
        nxt_h2 = col("rt_h2", nxt=True)
        b.when_transition(rt_h1 * (1 - nxt_h2))
        b.when_transition(nxt_h2 * (1 - rt_h1))
        b.when_transition(rt_h1 * (col("sid0", nxt=True) - sid0))
        b.assert_zero_vec(rt_h1 * (vec("hin", nxt=True) - T1), NL)

        # h1 block: positions past the secret are the 0x5c opad constant
        for j in range(16, 24):
            b.assert_zero(rt_h1 * (1 - col("lc48"))
                          * (BLK[_swap(j)] - 0x5C5C))
        for j in range(24, 32):
            b.assert_zero(rt_h1 * (BLK[_swap(j)] - 0x5C5C))

        # --- bus fingerprints ------------------------------------------
        gamma = b.challenges[0]

        def dpow(i):
            return b.challenges[1 + i]

        def inv(nm, i=0):
            return b.perm_ext(_SLOT[nm] + i)

        u_terms = []

        def recv(nm, i, fp, gate):
            e = inv(nm, i)
            b.assert_ext_zero(e * (gamma - fp) - 1)
            u_terms.append(-gate * e)

        def send(nm, i, fp, mult):
            e = inv(nm, i)
            b.assert_ext_zero(e * (gamma - fp) - 1)
            u_terms.append(mult * e)

        # main slot: type-selected primary message
        fp_ec = (ExtVal.from_base(BUS_EC_RESULT) + dpow(0) * col("rid")
                 + dpow(2) * col("nbv") + dpow(3) * col("gbv"))
        for j in range(NL):
            fp_ec = fp_ec + dpow(4 + j) * XL[j] + dpow(20 + j) * YL[j]
        recv("main", 0, fp_ec, rt_in * (1 - col("xfr")))

        # KS_OUT sends (intake + h2, shared slots)
        for j in range(NL):
            val = rt_in * OV[j] + rt_h2 * HOUT[_swap(j)]
            fp = (ExtVal.from_base(BUS_KS_OUT) + dpow(0) * sid0
                  + dpow(1) * j + dpow(2) * val)
            send("out", j, fp, MOUT[j])

        # secret rows: source receive, xor proofs, pad send
        pidx = col("pidx")
        pairval = (256 * (16 * col("nb0h") + col("nb0l"))
                   + 16 * col("nb1h") + col("nb1l"))
        padval = (256 * (16 * col("r0h") + col("r0l"))
                  + 16 * col("r1h") + col("r1l"))
        fp_src = (ExtVal.from_base(BUS_KS_OUT)
                  + dpow(0) * (sid0 - 2 + col("s2"))
                  + dpow(1) * (pidx - 16 * col("t2"))
                  + dpow(2) * pairval)
        recv("ksout", 0, fp_src, rt_sec)
        for i, (n_in, k, n_out) in enumerate(
                ((col("nb0h"), 5, col("r0h")),
                 (col("nb0l"), 0xC, col("r0l")),
                 (col("nb1h"), 5, col("r1h")),
                 (col("nb1l"), 0xC, col("r1l")))):
            fp = (ExtVal.from_base(BUS_XOR) + dpow(0) * n_in
                  + dpow(1) * k + dpow(2) * n_out)
            recv("xor", i, fp, rt_sec)
        fp_pad = (ExtVal.from_base(BUS_KS_PAD) + dpow(0) * sid0
                  + dpow(1) * pidx + dpow(2) * padval)
        send("pad", 0, fp_pad, col("mp"))

        # h1: hop receive (in = IV) + pad receives against the block
        fp_h1 = ExtVal.from_base(BUS_SHA_HOP)
        for i in range(NL):
            fp_h1 = fp_h1 + dpow(i) * _IV_LIMBS[i]
            fp_h1 = fp_h1 + dpow(48 + i) * T1[i]
        for i in range(32):
            fp_h1 = fp_h1 + dpow(16 + i) * BLK[i]
        e_h1 = inv("hop2", 0)
        # hop2 slot evaluates the type-selected hop fingerprint: h1's
        # (IV → t1) or h2's (hin → hout); both use the shared blk columns
        fp_h2 = ExtVal.from_base(BUS_SHA_HOP)
        for i in range(NL):
            fp_h2 = fp_h2 + dpow(i) * HIN[i]
            fp_h2 = fp_h2 + dpow(48 + i) * HOUT[i]
        for i in range(32):
            fp_h2 = fp_h2 + dpow(16 + i) * BLK[i]
        fp_hop = rt_h1 * fp_h1 + rt_h2 * fp_h2 \
            + (1 - rt_h1 - rt_h2) * ExtVal.from_base(BUS_SHA_HOP)
        b.assert_ext_zero(e_h1 * (gamma - fp_hop) - 1)
        u_terms.append(-(rt_h1 + rt_h2) * e_h1)
        for j in range(24):
            gate = rt_h1 if j < 16 else rt_h1 * col("lc48")
            fp = (ExtVal.from_base(BUS_KS_PAD)
                  + dpow(0) * (sid0 - 1 - col("h2nd"))
                  + dpow(1) * j + dpow(2) * BLK[_swap(j)])
            recv("padr", j, fp, gate)

        # key assembly: consume key/salt pairs, publish the session key
        dirf = col("dirf")
        for i in range(8):
            fp = (ExtVal.from_base(BUS_KS_OUT) + dpow(0) * (sid0 + 5)
                  + dpow(1) * (dirf * 8 + i) + dpow(2) * KP[i])
            recv("kp", i, fp, rt_key)
        for i in range(2):
            fp = (ExtVal.from_base(BUS_KS_OUT) + dpow(0) * (sid0 + 6)
                  + dpow(1) * (dirf * 2 + i) + dpow(2) * IVP[i])
            recv("ivp", i, fp, rt_key)
        fp_sk = (ExtVal.from_base(BUS_SESSION_KEY) + dpow(0) * col("obj")
                 + dpow(1) * dirf)
        for i in range(8):
            fp_sk = fp_sk + dpow(3 + i) * KP[i]
        for i in range(2):
            fp_sk = fp_sk + dpow(19 + i) * IVP[i]
        send("skey", 0, fp_sk, col("mk"))

        u = inv("u")
        acc = inv("acc")
        u_n = b.perm_ext(_SLOT["u"], nxt=True)
        acc_n = b.perm_ext(_SLOT["acc"], nxt=True)
        u_def = u_terms[0]
        for t in u_terms[1:]:
            u_def = u_def + t
        b.assert_ext_zero(u - u_def)
        b.assert_ext_zero((acc - u) * b.is_first_row)
        b.assert_ext_zero((acc_n - acc - u_n) * b.is_transition)
        for ell in range(4):
            b.when_last_row(acc.c[ell] - b.public[ell])

    # ------------------------------------------------------------------

    def generate_perm_trace(self, main, publics, challenges):
        L = LAYOUT
        n = main.shape[0]

        def c1(nm):
            return main[:, L[nm].start].astype(np.uint64)

        def cv(nm):
            return main[:, L[nm]].astype(np.uint64)

        rt_in, rt_sec = c1("rt_in"), c1("rt_sec")
        rt_h1, rt_h2, rt_key = c1("rt_h1"), c1("rt_h2"), c1("rt_key")
        sid0 = c1("sid0")
        xl, yl, ov = cv("xl"), cv("yl"), cv("ov")
        blk, t1 = cv("blk"), cv("t1")
        hin, hout = cv("hin"), cv("hout")
        mout, kp, ivp = cv("m_out"), cv("kp"), cv("ivp")
        zero = np.zeros(n, dtype=np.uint64)
        parts = []
        u_acc = np.zeros((n, 4), dtype=np.uint64)

        def add_recv(inv_e, gate):
            parts.append(inv_e)
            nonlocal u_acc
            u_acc = (u_acc + P
                     - (inv_e.astype(np.uint64) * gate[:, None]) % P) % P

        def add_send(inv_e, mult):
            parts.append(inv_e)
            nonlocal u_acc
            u_acc = (u_acc
                     + (inv_e.astype(np.uint64) * mult[:, None]) % P) % P

        pl = np.concatenate(
            [c1("rid")[:, None], zero[:, None], c1("nbv")[:, None],
             c1("gbv")[:, None], xl, yl], axis=1)
        add_recv(np_bus_inverse_terms(challenges, BUS_EC_RESULT, pl),
                 rt_in * (1 - c1("xfr")))
        for j in range(NL):
            val = (rt_in * ov[:, j] + rt_h2 * hout[:, _swap(j)]) % P
            pl = np.stack([sid0, np.full(n, j, dtype=np.uint64), val],
                          axis=1)
            add_send(np_bus_inverse_terms(challenges, BUS_KS_OUT, pl),
                     mout[:, j] % P)
        pairval = (256 * (16 * c1("nb0h") + c1("nb0l"))
                   + 16 * c1("nb1h") + c1("nb1l")) % P
        padval = (256 * (16 * c1("r0h") + c1("r0l"))
                  + 16 * c1("r1h") + c1("r1l")) % P
        pl = np.stack([(sid0 + P - 2 + c1("s2")) % P,
                       (c1("pidx") + P - 16 * c1("t2")) % P, pairval],
                      axis=1)
        add_recv(np_bus_inverse_terms(challenges, BUS_KS_OUT, pl), rt_sec)
        for n_in, k, n_out in ((c1("nb0h"), 5, c1("r0h")),
                               (c1("nb0l"), 0xC, c1("r0l")),
                               (c1("nb1h"), 5, c1("r1h")),
                               (c1("nb1l"), 0xC, c1("r1l"))):
            pl = np.stack([n_in, np.full(n, k, dtype=np.uint64), n_out],
                          axis=1)
            add_recv(np_bus_inverse_terms(challenges, BUS_XOR, pl),
                     rt_sec)
        pl = np.stack([sid0, c1("pidx"), padval], axis=1)
        add_send(np_bus_inverse_terms(challenges, BUS_KS_PAD, pl),
                 c1("mp"))
        # type-selected hop
        ivl = np.array(_IV_LIMBS, dtype=np.uint64)
        hop_in = (rt_h1[:, None] * ivl[None, :] + rt_h2[:, None] * hin) % P
        hop_out = (rt_h1[:, None] * t1 + rt_h2[:, None] * hout) % P
        hop_blk = ((rt_h1 + rt_h2)[:, None] * blk) % P
        pl = np.concatenate([hop_in, hop_blk, hop_out], axis=1)
        add_recv(np_bus_inverse_terms(challenges, BUS_SHA_HOP, pl),
                 (rt_h1 + rt_h2) % P)
        for j in range(24):
            gate = rt_h1 if j < 16 else (rt_h1 * c1("lc48")) % P
            pl = np.stack([(sid0 + P - 1 - c1("h2nd")) % P,
                           np.full(n, j, dtype=np.uint64),
                           blk[:, _swap(j)]], axis=1)
            add_recv(np_bus_inverse_terms(challenges, BUS_KS_PAD, pl),
                     gate)
        dirf = c1("dirf")
        for i in range(8):
            pl = np.stack([(sid0 + 5) % P, (dirf * 8 + i) % P,
                           kp[:, i]], axis=1)
            add_recv(np_bus_inverse_terms(challenges, BUS_KS_OUT, pl),
                     rt_key)
        for i in range(2):
            pl = np.stack([(sid0 + 6) % P, (dirf * 2 + i) % P,
                           ivp[:, i]], axis=1)
            add_recv(np_bus_inverse_terms(challenges, BUS_KS_OUT, pl),
                     rt_key)
        pl = np.concatenate(
            [c1("obj")[:, None], dirf[:, None], zero[:, None], kp,
             np.zeros((n, 8), dtype=np.uint64), ivp,
             np.zeros((n, 4), dtype=np.uint64)], axis=1)
        add_send(np_bus_inverse_terms(challenges, BUS_SESSION_KEY, pl),
                 c1("mk"))

        acc = np.cumsum(u_acc, axis=0) % P
        out = np.zeros((n, self.perm_width), dtype=np.uint32)
        off = 0
        for inv_e in parts:
            out[:, off : off + 4] = inv_e
            off += 4
        out[:, 4 * _SLOT["u"] : 4 * _SLOT["u"] + 4] = u_acc
        out[:, 4 * _SLOT["acc"] : 4 * _SLOT["acc"] + 4] = acc
        return out


# ---------------------------------------------------------------------------
# witness generation
# ---------------------------------------------------------------------------


def _pairs(data: bytes) -> list[int]:
    return [256 * data[2 * i] + data[2 * i + 1]
            for i in range(len(data) // 2)]


def _state_limbs(state) -> list[int]:
    out = []
    for w in state:
        out += [w & 0xFFFF, w >> 16]
    return out


def _block_limbs(block: bytes) -> list[int]:
    """64-byte block as the chip's 32 (lo, hi) word-major limbs."""
    out = []
    for i in range(16):
        w = int.from_bytes(block[4 * i : 4 * i + 4], "big")
        out += [w & 0xFFFF, w >> 16]
    return out


def _state_bytes(state) -> bytes:
    return b"".join(int(w).to_bytes(4, "big") for w in state)


def _hmac_outer(secret: bytes, msg: bytes):
    """The outer walk of HMAC-SHA256: returns (opad_block, t1_state,
    block2, out_state, digest_bytes) — the two compressions the
    key-schedule chip verifies (both recorded by hmac_sha256)."""
    import hashlib

    key = secret.ljust(64, b"\x00")
    opad = bytes(b ^ 0x5C for b in key)
    ipad = bytes(b ^ 0x36 for b in key)
    inner = hashlib.sha256(ipad + msg).digest()
    t1 = compress(_IV, opad)
    blk2 = inner + b"\x80" + b"\x00" * 23 + (96 * 8).to_bytes(8, "big")
    out = compress(t1, blk2)
    return opad, t1, blk2, out, _state_bytes(out)


class KsSession:
    """Witness inputs for one TLS 1.2 SHA-256/AES-128 session."""

    def __init__(self, premaster: bytes, master: bytes,
                 master_seed: bytes, kb_seed: bytes,
                 n_client_records: int, n_server_records: int,
                 ec_rid: int | None = None, ec_nbits: int = 0,
                 ec_point=None, obj: int = 1, sid_base: int = 0x1000):
        self.premaster = premaster
        self.master = master
        self.master_seed = master_seed      # "extended master secret"+hash
        self.kb_seed = kb_seed              # "key expansion"+randoms
        self.n_client = n_client_records
        self.n_server = n_server_records
        self.ec_rid = ec_rid                # None ⇒ free intake (x25519)
        self.ec_nbits = ec_nbits
        self.ec_point = ec_point            # (x, y) of the d·S result
        self.obj = obj
        self.sid_base = sid_base


def keyschedule_trace(sessions: list[KsSession], min_log_n: int = 6):
    """Build the key-schedule trace.  Returns (trace, hop_counts,
    xor_pairs) — hop_counts for the SHA chip's BUS_SHA_HOP sends,
    xor_pairs [(x, y)] for the xor-table multiplicities."""
    from ...guest.crypto.prf import hmac_sha256

    rows: list[dict] = []
    hop_counts: dict = {}
    xor_pairs: list[tuple[int, int]] = []

    def hop(state_in, block):
        key = (tuple(state_in), bytes(block))
        hop_counts[key] = hop_counts.get(key, 0) + 1

    for sess in sessions:
        B = sess.sid_base
        pm, master = sess.premaster, sess.master
        if len(pm) not in (32, 48) or len(master) != 48:
            raise ValueError("premaster must be 32/48B, master 48B")
        # intake row(s)
        row = dict(rt_in=1, sid0=B, m_out=[1] * NL)
        if sess.ec_rid is not None:
            x, y = sess.ec_point
            xl = [(x >> (16 * j)) & 0xFFFF for j in range(NL)]
            yl = [(y >> (16 * j)) & 0xFFFF for j in range(NL)]
            if x.to_bytes(32, "big") != pm:
                raise ValueError("EC result x != premaster")
            row.update(rid=sess.ec_rid, nbv=sess.ec_nbits, gbv=0,
                       xl=xl, yl=yl, ov=[xl[NL - 1 - j]
                                         for j in range(NL)])
        else:
            row.update(xfr=1, ov=_pairs(pm[:32]))
        rows.append(row)
        if len(pm) == 48:
            # pairs 16..23 ride a second (free) intake at sid B−1, which
            # the premaster rows reach via (s2=0, t2=1)
            extra = _pairs(pm[32:]) + [0] * 8
            rows.append(dict(rt_in=1, sid0=B - 1, xfr=1, ov=extra,
                             m_out=[1] * 8 + [0] * 8))

        # secret rows for pm (ssid B+1, src intake B = ssid−1 ⇒ s2=1,
        # t2=0) and master (ssid B+4; src B+2/B+3)
        def sec_rows(secret, ssid, srcs):
            for j in range(len(secret) // 2):
                b0, b1 = secret[2 * j], secret[2 * j + 1]
                s2, t2 = srcs(j)
                xor_pairs.extend([(b0 >> 4, 5), (b0 & 15, 0xC),
                                  (b1 >> 4, 5), (b1 & 15, 0xC)])
                rows.append(dict(
                    rt_sec=1, sid0=ssid, pidx=j, s2=s2, t2=t2,
                    nb0h=b0 >> 4, nb0l=b0 & 15, nb1h=b1 >> 4,
                    nb1l=b1 & 15,
                    r0h=(b0 >> 4) ^ 5, r0l=(b0 & 15) ^ 0xC,
                    r1h=(b1 >> 4) ^ 5, r1l=(b1 & 15) ^ 0xC,
                    mp=2))

        sec_rows(pm, B + 1, lambda j: (1, 0) if j < 16 else (0, 1))
        # HMAC rows: out_i = HMAC(secret, msg_i); msgs reproduce P_SHA256
        def hmac_rows(secret, msgs, hsids, lc48):
            outs = []
            for k, (msg, hsid) in enumerate(zip(msgs, hsids)):
                opad, t1s, blk2, outs_state, dig = _hmac_outer(secret,
                                                               msg)
                hop(_IV, opad)
                hop(t1s, blk2)
                rows.append(dict(rt_h1=1, sid0=hsid, h2nd=k, lc48=lc48,
                                 blk=_block_limbs(opad),
                                 t1=_state_limbs(t1s)))
                rows.append(dict(rt_h2=1, sid0=hsid,
                                 blk=_block_limbs(blk2),
                                 hin=_state_limbs(t1s),
                                 hout=_state_limbs(outs_state),
                                 m_out=[0] * NL))
                outs.append((dig, rows[-1]))
            return outs

        # master PRF: A1 = HMAC(pm, ls); out1 = HMAC(pm, A1+ls);
        # A2 = HMAC(pm, A1); out2 = HMAC(pm, A2+ls)
        ls = sess.master_seed
        a1 = hmac_sha256(pm, ls)
        a2 = hmac_sha256(pm, a1)
        m_outs = hmac_rows(pm, [a1 + ls, a2 + ls], [B + 2, B + 3],
                           1 if len(pm) == 48 else 0)
        if m_outs[0][0] + m_outs[1][0][:16] != master:
            raise ValueError("master PRF recomputation mismatch")
        # master consumed: out1 pairs 0..15 (all), out2 pairs 0..7
        for p in range(16):
            m_outs[0][1]["m_out"][_swap(p)] = 1
        for p in range(8):
            m_outs[1][1]["m_out"][_swap(p)] = 1
        sec_rows(master, B + 4,
                 lambda j: (0, 0) if j < 16 else (1, 1))
        # key-block PRF
        ls2 = sess.kb_seed
        a1k = hmac_sha256(master, ls2)
        a2k = hmac_sha256(master, a1k)
        k_outs = hmac_rows(master, [a1k + ls2, a2k + ls2],
                           [B + 5, B + 6], 1)
        key_block = k_outs[0][0] + k_outs[1][0][:8]
        for p in range(16):
            k_outs[0][1]["m_out"][_swap(p)] = 1
        for p in range(4):
            k_outs[1][1]["m_out"][_swap(p)] = 1
        # assembly rows (client dir 0, server dir 1)
        for dirf, mk in ((0, sess.n_client), (1, sess.n_server)):
            kbytes = key_block[16 * dirf : 16 * dirf + 16]
            ivbytes = key_block[32 + 4 * dirf : 32 + 4 * dirf + 4]
            rows.append(dict(rt_key=1, sid0=B, obj=sess.obj, dirf=dirf,
                             kp=_pairs(kbytes), ivp=_pairs(ivbytes),
                             mk=mk))

    n_real = len(rows)
    log_n = max(min_log_n, (n_real - 1).bit_length())
    n = 1 << log_n
    trace = np.zeros((n, LAYOUT.width), dtype=np.uint32)
    for r, row in enumerate(rows):
        for nm, val in row.items():
            if isinstance(val, list):
                trace[r, LAYOUT[nm]] = np.asarray(val, dtype=np.uint32)
            else:
                trace[r, LAYOUT[nm].start] = int(val) % P
    return trace, hop_counts, xor_pairs
