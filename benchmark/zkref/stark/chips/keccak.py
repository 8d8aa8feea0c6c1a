"""Keccak-256 AIR chip: proves the journal's request_hash / response_hash
over bus-bound application-stream bytes.

The reference's journal hashes are keccak256 over alloy primitives
(SURVEY.md §2.3; risc0 ships a dedicated keccak accelerator circuit,
§2.2.C).  The GCM data chip sends every decrypted application-stream
plaintext byte (BUS_HASH_BYTE: obj, dir, pos, byte), the chip absorbs
them in order into Keccak-f[1600], applies pad10*1 IN-AIR, and publishes
keccak256(stream) (BUS_HASH_RESULT: obj, dir, digest) which the verifier
matches against the journal's request_hash / response_hash.  Claiming a
hash of anything but the exact decrypted bytes breaks the global bus
balance.

Round-5 width redesign (the r4 chip was 5,903 columns × 256-row groups —
the machine's widest chip by 7× and the dominant term in the recursion
bill O(W·Q)):

  * ONE shared 1600-bit plane group `PL`, time-multiplexed: on lane and
    state rows it holds the state A, on θ-rows it holds the post-θ plane
    T — two rows per round instead of one wide row;
  * the χ and-plane W (1,600 cols) is GONE: χ is evaluated directly as a
    degree-3 expression in T bits, riding the full degree-5 budget that
    blowup 4 admits (folded degree 5(n−1) still divides into 4 quotient
    chunks of degree < n);
  * the θ parity carries q0/q1 (640 cols) are GONE: the column sum obeys
    the cubic (Σ−C)(Σ−C−2)(Σ−C−4) = 0 with C boolean;
  * the ι staging lane ch00 (64 cols) is GONE: the round-constant xor
    folds into the χ transition via the periodic rc patterns, which are
    supported only on θ-rows.

1,999 columns × 128-row groups — ~5.9× fewer trace cells per block.

Layout: 128-row groups, one group per 136-byte rate block:
  rows 0..16     lane rows — lane ℓ absorbs 8 bytes (per-byte consume
                 gates; ungated tail bytes are the pad10*1 padding,
                 value-constrained in-AIR); PL changes one lane per row
  rows 17..64    the 24 rounds, TWO rows each: row 17+2r holds T_r
                 (post-θ of A_r), row 18+2r holds A_{r+1} = χι(T_r);
                 C parities are committed on the A-rows {16, 18, …, 62}
  row 64         the final state; a final block publishes its digest here
  rows 65..127   idle (state carried)

Streams are group runs (register semantics like the parser's regions):
sg starts a stream from the zero state, fin marks its final block.  Dead
(live = 0) padding groups run the same constraint system over the empty
absorption (keccak-f of the zero state), so no constraint needs a
live-gate on the hot paths.

State bit order: bit 64·(x + 5y) + z; sponge byte b maps to lane b>>3,
bits 8·(b&7)..8·(b&7)+8 (LSB first) — so digest byte m is state bits
8m..8m+8.

Port copy of zktls_tpu.stark.chips.keccak (same names and values; host code
in numpy).
"""

from __future__ import annotations

import numpy as np

from ..air import Air, AirBuilder
from ..bus import BUS_HASH_BYTE, BUS_HASH_RESULT, np_bus_inverse_terms
from ..ext_val import ExtVal

__all__ = ["KeccakAir", "keccak_trace", "keccak256_ref", "GROUP_ROWS",
           "RATE"]

P = 2013265921
GROUP_ROWS = 128
RATE = 136
N_ROUNDS = 24
_ROW_FINAL = 17 + 2 * N_ROUNDS - 1   # 64: the A_24 row

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROT = [[0, 36, 3, 41, 18],
        [1, 44, 10, 45, 2],
        [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56],
        [27, 20, 39, 8, 14]]


def _lane(x: int, y: int) -> int:
    return x + 5 * y


def _bit(x: int, y: int, z: int) -> int:
    return 64 * _lane(x, y) + z


def _build_b_src() -> list[int]:
    """B-plane wiring: B[y][(2x+3y)%5][z] = T[x][y][(z − r[x][y]) % 64].
    Returns b_src[B bit index] = T bit index."""
    b_src = [0] * 1600
    for x in range(5):
        for y in range(5):
            X, Y = y, (2 * x + 3 * y) % 5
            r = _ROT[x][y]
            for z in range(64):
                b_src[_bit(X, Y, z)] = _bit(x, y, (z - r) % 64)
    return b_src


_B_SRC = _build_b_src()


class _Layout:
    def __init__(self):
        self._n = 0
        self.slices: dict[str, slice] = {}

    def add(self, name: str, count: int = 1) -> None:
        self.slices[name] = slice(self._n, self._n + count)
        self._n += count

    @property
    def width(self) -> int:
        return self._n

    def __getitem__(self, name: str) -> slice:
        return self.slices[name]


def _build_layout() -> _Layout:
    L = _Layout()
    L.add("live")      # group-constant
    L.add("sg")        # stream-start group flag
    L.add("fin")       # stream-final group flag
    L.add("cont")      # (1−sg)·live — continuation marker (degree aid)
    L.add("obj")       # session stream object id (stream register)
    L.add("dirs")      # 0 = request, 1 = response (stream register)
    L.add("blkc")      # block index within the stream (group-constant)
    L.add("g", 8)      # lane-row byte-consumed gates
    L.add("lb", 64)    # lane-row absorbed bits (8 bytes, LSB-first each)
    L.add("PL", 1600)  # the multiplexed plane: A on lane/A-rows, T on
    #                    θ-rows (value AFTER this row's action)
    L.add("C", 320)    # θ column parities (A-feed rows only)
    return L


LAYOUT = _build_layout()


class KeccakAir(Air):
    width = LAYOUT.width
    num_public = 0
    max_constraint_degree = 3
    #: 8 byte-receive invs ‖ result inv ‖ u ‖ acc
    perm_width = 4 * 11
    num_perm_challenges = 2
    has_bus = True

    def periodic_columns(self) -> list:
        z = np.zeros(GROUP_ROWS, dtype=np.uint32)
        p_row0 = z.copy(); p_row0[0] = 1
        p_lane = z.copy(); p_lane[0:17] = 1
        p_lane_nl = z.copy(); p_lane_nl[0:16] = 1    # next row is lane 1..16
        p_afeed = z.copy()                           # A-rows feeding a θ-row
        p_afeed[16:_ROW_FINAL:2] = 1                 # 16, 18, …, 62
        p_theta = z.copy()                           # θ-rows (T planes)
        p_theta[17:_ROW_FINAL:2] = 1                 # 17, 19, …, 63
        p_res = z.copy(); p_res[_ROW_FINAL] = 1
        p_last = z.copy(); p_last[GROUP_ROWS - 1] = 1
        p_idle = z.copy(); p_idle[_ROW_FINAL:GROUP_ROWS - 1] = 1
        lanev = z.copy(); lanev[0:17] = np.arange(17, dtype=np.uint32)
        lsel = np.zeros((17, GROUP_ROWS), dtype=np.uint32)
        for ell in range(17):
            lsel[ell, ell] = 1
        # round-constant bits, supported ON the θ-rows (the χ transition's
        # local row), so ι needs no extra gating
        rcbit = np.zeros((64, GROUP_ROWS), dtype=np.uint32)
        for rr in range(N_ROUNDS):
            for zz in range(64):
                rcbit[zz, 17 + 2 * rr] = (_RC[rr] >> zz) & 1
        return ([p_row0, p_lane, p_lane_nl, p_afeed, p_theta, p_res,
                 p_last, p_idle, lanev] + list(lsel) + list(rcbit))

    # ------------------------------------------------------------------

    def eval(self, b: AirBuilder) -> None:
        L = LAYOUT
        (p_row0, p_lane, p_lane_nl, p_afeed, p_theta, p_res, p_last,
         p_idle, lanev) = b.periodic[:9]
        lsel = b.periodic[9:26]
        rcbit = b.periodic[26:90]

        def c(name, i=0):
            return b.local[L[name].start + i]

        def n(name, i=0):
            return b.next[L[name].start + i]

        def Aslice(k, nxt=False):
            src = b.next_group if nxt else b.local_group
            return src(slice(L["PL"].start + 64 * k,
                             L["PL"].start + 64 * k + 64))

        tr = b.is_transition
        live, sg, fin, cont = c("live"), c("sg"), c("fin"), c("cont")
        for nm in ("live", "sg", "fin", "dirs"):
            b.assert_bool(c(nm))
        b.assert_zero(cont - (1 - sg) * live)
        G8 = b.local_group(L["g"])
        LB = b.local_group(L["lb"])
        A = b.local_group(L["PL"])
        NA = b.next_group(L["PL"])
        CC = b.local_group(L["C"])
        b.assert_zero_vec(G8 * (G8 - 1), 8)
        b.assert_zero_vec(LB * (LB - 1), 64)
        b.assert_zero_vec(A * (A - 1), 1600)
        b.assert_zero_vec(CC * (CC - 1), 320)
        b.assert_zero_vec((1 - live) * G8, 8)

        # --- group/stream structure ---
        for nm in ("live", "sg", "fin", "obj", "dirs", "blkc"):
            b.assert_zero(tr * (1 - p_last) * (n(nm) - c(nm)))
        b.assert_zero(sg * (1 - live))
        b.assert_zero(fin * (1 - live))
        b.when_first_row(live * (1 - sg))
        b.assert_zero(tr * p_last * n("live") * (1 - live))
        # a final block ends its stream; a non-final block continues it
        b.assert_zero(tr * p_last * n("live") * fin * (1 - n("sg")))
        b.assert_zero(tr * p_last * n("live") * (1 - fin) * n("sg"))
        b.assert_zero(tr * p_last * n("cont") * (n("blkc") - c("blkc") - 1))
        b.assert_zero(sg * c("blkc"))
        b.assert_zero(tr * p_last * n("cont")
                      * (n("obj") - c("obj")))
        b.assert_zero(tr * p_last * n("cont")
                      * (n("dirs") - c("dirs")))

        # --- absorption rows ---
        # stream start: the group's row 0 = lane 0 absorbed into zero
        b.assert_zero_vec(p_row0 * sg * (Aslice(0) - LB), 64)
        for k in range(1, 25):
            b.assert_zero_vec(p_row0 * sg * Aslice(k), 64)
        # lane rows 1..16: lane ℓ xors in, everything else holds
        for ell in range(1, 17):
            NLB = b.next_group(L["lb"])
            b.assert_zero_vec(
                tr * lsel[ell - 1] * (Aslice(ell, nxt=True) - Aslice(ell)
                                      - NLB + 2 * (Aslice(ell) * NLB)), 64)
        for k in range(25):
            # hold on transitions into lane rows other than k (the 16→17
            # transition WRITES the first θ plane, so no hold there)
            if 1 <= k <= 16:
                gate = p_lane_nl - lsel[k - 1]
            else:
                gate = p_lane_nl
            b.assert_zero_vec(tr * gate * (Aslice(k, nxt=True) - Aslice(k)),
                              64)
        # idle carry (rows 64..126)
        b.assert_zero_vec(tr * p_idle * (NA - A), 1600)
        # cross-group continuation: row 127 → row 0 absorbs lane 0 into
        # the carried state
        NLB0 = b.next_group(L["lb"])
        b.assert_zero_vec(
            tr * p_last * n("cont") * (Aslice(0, nxt=True) - Aslice(0)
                                       - NLB0 + 2 * (Aslice(0) * NLB0)), 64)
        for k in range(1, 25):
            b.assert_zero_vec(tr * p_last * n("cont")
                              * (Aslice(k, nxt=True) - Aslice(k)), 64)

        # --- pad10*1 ---
        for j in range(7):
            b.assert_zero(c("g", j + 1) * (1 - c("g", j)))
        b.assert_zero(tr * p_lane_nl * n("g", 0) * (1 - c("g", 7)))
        b.assert_zero_vec((1 - fin) * live * (1 - G8) * p_lane, 8)
        # the final block always ends in padding (its last byte is 0x80)
        b.assert_zero(lsel[16] * fin * c("g", 7))

        def byte_expr(j, nxt=False):
            src = b.next_group if nxt else b.local_group
            return b.dot_const(
                src(slice(L["lb"].start + 8 * j, L["lb"].start + 8 * j + 8)),
                [1 << i for i in range(8)])

        for j in range(1, 8):
            expr = byte_expr(j) - (c("g", j - 1) - c("g", j))
            if j == 7:
                expr = expr - 0x80 * lsel[16]
            b.assert_zero(p_lane * live * (1 - c("g", j)) * expr)
        # byte 0: at the group's first lane row the predecessor byte was
        # consumed (previous block full or stream start), so an ungated
        # byte 0 is the first pad byte
        b.assert_zero(p_row0 * live * (1 - c("g", 0))
                      * (byte_expr(0) - 1))
        b.assert_zero(tr * p_lane_nl * (1 - n("g", 0))
                      * (byte_expr(0, nxt=True)
                         - (c("g", 7) - n("g", 0))))

        # --- θ: column parities (cubic carry) + the T transition ---
        for x in range(5):
            Cx = b.local_group(slice(L["C"].start + 64 * x,
                                     L["C"].start + 64 * x + 64))
            total = None
            for y in range(5):
                Ay = Aslice(_lane(x, y))
                total = Ay if total is None else total + Ay
            # Σ ∈ {0..5}, parity C boolean ⇒ Σ − C ∈ {0, 2, 4}
            d = total - Cx
            b.assert_zero_vec(p_afeed * (d * (d - 2) * (d - 4)), 64)
        for x in range(5):
            Cm = b.local_group(slice(L["C"].start + 64 * ((x - 1) % 5),
                                     L["C"].start + 64 * ((x - 1) % 5) + 64))
            Cp = b.local_group(slice(L["C"].start + 64 * ((x + 1) % 5),
                                     L["C"].start + 64 * ((x + 1) % 5) + 64))
            Cp1 = Cp.roll(1)       # D bit z uses C[x+1][z−1]
            D = Cm + Cp1 - 2 * (Cm * Cp1)
            for y in range(5):
                k = _lane(x, y)
                Ay = Aslice(k)
                # next row (a θ-row) holds T = A ⊕ D
                b.assert_zero_vec(
                    tr * p_afeed * (Aslice(k, nxt=True) - Ay - D
                                    + 2 * (Ay * D)), 64)

        # --- χ + ι: θ-row T → next-row state, degree-3 in T bits ---
        def Bbit(i):
            return b.local[L["PL"].start + _B_SRC[i]]

        for k in range(25):
            for zz in range(64):
                i = 64 * k + zz
                bb = Bbit(i)
                b2 = Bbit(_bit((k % 5 + 2) % 5, k // 5, zz))
                b1 = Bbit(_bit((k % 5 + 1) % 5, k // 5, zz))
                w = b2 - b1 * b2
                chi = bb + w - 2 * (bb * w)
                nxt_bit = b.next[L["PL"].start + i]
                if k == 0:
                    # ι folds in via the rc patterns (supported only on
                    # θ-rows): A' = chi ⊕ rc
                    rc = rcbit[zz]
                    b.assert_zero(tr * (p_theta * (nxt_bit - chi)
                                        - rc * (1 - 2 * chi)))
                else:
                    b.assert_zero(tr * p_theta * (nxt_bit - chi))

        # --- bus ---
        gamma = b.challenges[0]

        def dpow(i):
            return b.challenges[1 + i]

        pos_base = c("blkc") * RATE + lanev * 8
        u_def = ExtVal.from_base(0)
        for j in range(8):
            fp = (ExtVal.from_base(BUS_HASH_BYTE) + dpow(0) * c("obj")
                  + dpow(1) * c("dirs") + dpow(2) * (pos_base + j)
                  + dpow(3) * byte_expr(j))
            iv = b.perm_ext(j)
            b.assert_ext_zero(iv * (gamma - fp) - 1)
            u_def = u_def - iv * (c("g", j) * p_lane)
        fp_res = (ExtVal.from_base(BUS_HASH_RESULT) + dpow(0) * c("obj")
                  + dpow(1) * c("dirs"))
        for ell in range(16):
            hi = b.dot_const(
                b.local_group(slice(L["PL"].start + 8 * (2 * ell),
                                    L["PL"].start + 8 * (2 * ell) + 8)),
                [1 << i for i in range(8)])
            lo = b.dot_const(
                b.local_group(slice(L["PL"].start + 8 * (2 * ell + 1),
                                    L["PL"].start + 8 * (2 * ell + 1) + 8)),
                [1 << i for i in range(8)])
            fp_res = fp_res + dpow(2 + ell) * (hi * 256 + lo)
        iv_res = b.perm_ext(8)
        b.assert_ext_zero(iv_res * (gamma - fp_res) - 1)
        u_def = u_def + iv_res * (fin * p_res)

        u = b.perm_ext(9)
        acc = b.perm_ext(10)
        u_n = b.perm_ext(9, nxt=True)
        acc_n = b.perm_ext(10, nxt=True)
        b.assert_ext_zero(u - u_def)
        b.assert_ext_zero((acc - u) * b.is_first_row)
        b.assert_ext_zero((acc_n - acc - u_n) * b.is_transition)
        for ell in range(4):
            b.when_last_row(acc.c[ell] - b.public[ell])

    # ------------------------------------------------------------------

    def generate_perm_trace(self, main, publics, challenges):
        L = LAYOUT
        nrows = main.shape[0]

        def col(name, i=0):
            return main[:, L[name].start + i].astype(np.uint64)

        r = np.arange(nrows)
        rowm = r % GROUP_ROWS
        p_lane = (rowm < 17).astype(np.uint64)
        p_res = (rowm == _ROW_FINAL).astype(np.uint64)
        lanev = np.where(rowm < 17, rowm, 0).astype(np.uint64)
        POW8 = np.array([1 << i for i in range(8)], dtype=np.uint64)
        lb = main[:, L["lb"]].astype(np.uint64)
        parts = []
        u = np.zeros((nrows, 4), dtype=np.uint64)
        pos_base = (col("blkc") * RATE + lanev * 8) % P
        for j in range(8):
            byte = (lb[:, 8 * j : 8 * j + 8] * POW8).sum(axis=1) % P
            pl = np.stack([col("obj"), col("dirs"),
                           (pos_base + j) % P, byte], axis=1)
            iv = np_bus_inverse_terms(challenges, BUS_HASH_BYTE, pl)
            parts.append(iv)
            u = (u + P * np.ones_like(u)
                 - iv.astype(np.uint64) * (col("g", j) * p_lane)[:, None]
                 ) % P
        Ab = main[:, L["PL"]].astype(np.uint64)
        limbs = np.zeros((nrows, 16), dtype=np.uint64)
        for ell in range(16):
            hi = (Ab[:, 8 * (2 * ell): 8 * (2 * ell) + 8] * POW8).sum(axis=1)
            lo = (Ab[:, 8 * (2 * ell + 1): 8 * (2 * ell + 1) + 8]
                  * POW8).sum(axis=1)
            limbs[:, ell] = (hi * 256 + lo) % P
        res_pl = np.concatenate(
            [col("obj")[:, None], col("dirs")[:, None], limbs], axis=1)
        iv_res = np_bus_inverse_terms(challenges, BUS_HASH_RESULT, res_pl)
        parts.append(iv_res)
        u = (u + iv_res.astype(np.uint64)
             * (col("fin") * p_res)[:, None]) % P
        acc = np.cumsum(u, axis=0) % P
        parts += [u, acc]
        return np.concatenate(parts, axis=1).astype(np.uint32)


# ---------------------------------------------------------------------------
# reference implementation + witness generation
# ---------------------------------------------------------------------------


def _rot(v: int, k: int) -> int:
    return ((v << k) | (v >> (64 - k))) & (1 << 64) - 1


def _theta_T(lanes: list[int]) -> list[int]:
    """The post-θ plane of a state (lane order, pre-ρ/π)."""
    C = [lanes[x] ^ lanes[x + 5] ^ lanes[x + 10] ^ lanes[x + 15]
         ^ lanes[x + 20] for x in range(5)]
    D = [C[(x - 1) % 5] ^ _rot(C[(x + 1) % 5], 1) for x in range(5)]
    return [lanes[i] ^ D[i % 5] for i in range(25)]


def _round_from_T(T: list[int], rnd: int) -> list[int]:
    """ρ/π + χ + ι applied to a post-θ plane."""
    B = [0] * 25
    for x in range(5):
        for y in range(5):
            B[_lane(y, (2 * x + 3 * y) % 5)] = _rot(T[_lane(x, y)],
                                                    _ROT[x][y])
    A = [(B[i] ^ ((~B[(i % 5 + 1) % 5 + 5 * (i // 5)])
                  & B[(i % 5 + 2) % 5 + 5 * (i // 5)])) & ((1 << 64) - 1)
         for i in range(25)]
    A[0] ^= _RC[rnd]
    return A


def _keccak_f(lanes: list[int]) -> list[int]:
    A = list(lanes)
    for rnd in range(N_ROUNDS):
        A = _round_from_T(_theta_T(A), rnd)
    return A


def keccak256_ref(data: bytes) -> bytes:
    """Reference keccak-256 (validated against the guest's keccak in
    tests)."""
    lanes = [0] * 25
    padded = bytearray(data)
    padlen = RATE - (len(data) % RATE)
    padded += b"\x00" * padlen
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    for off in range(0, len(padded), RATE):
        blk = padded[off : off + RATE]
        for ell in range(17):
            lanes[ell] ^= int.from_bytes(blk[8 * ell : 8 * ell + 8],
                                         "little")
        lanes = _keccak_f(lanes)
    out = b"".join(lanes[i].to_bytes(8, "little") for i in range(4))
    return out


_AFEED_ROWS = np.arange(16, _ROW_FINAL, 2)     # 16, 18, …, 62


def _fill_planes(grp: np.ndarray, row_states: np.ndarray) -> None:
    """Vectorized fill of PL (+ C on A-feed rows) for (128, 25) uint64
    per-row plane snapshots (A or T per the row schedule)."""
    L = LAYOUT
    nrow = row_states.shape[0]
    shifts = np.arange(64, dtype=np.uint64)
    bits = ((row_states[:, :, None] >> shifts) & 1).astype(np.uint32)
    grp[:, L["PL"]] = bits.reshape(nrow, 1600)
    # θ parities on the A-feed rows (these rows hold genuine states)
    af = bits[_AFEED_ROWS].reshape(len(_AFEED_ROWS), 5, 5, 64)
    colsum = af.sum(axis=1)                     # [rows, x, 64]
    cbit = (colsum & 1).astype(np.uint32)
    C_full = np.zeros((nrow, 320), dtype=np.uint32)
    C_full[_AFEED_ROWS] = cbit.reshape(len(_AFEED_ROWS), 320)
    grp[:, L["C"]] = C_full


def _block_states(lanes: list[int]) -> tuple[np.ndarray, list[int]]:
    """The (128, 25) per-row plane schedule for one block, starting from
    the fully absorbed state `lanes` at row 16.  Rows 0..15 are filled by
    the caller (partial absorption).  Returns (states, final_lanes)."""
    rs = np.zeros((GROUP_ROWS, 25), dtype=np.uint64)
    state = list(lanes)
    rs[16] = np.array(state, dtype=np.uint64)
    for rr in range(N_ROUNDS):
        T = _theta_T(state)
        rs[17 + 2 * rr] = np.array(T, dtype=np.uint64)
        state = _round_from_T(T, rr)
        rs[18 + 2 * rr] = np.array(state, dtype=np.uint64)
    rs[_ROW_FINAL + 1:] = np.array(state, dtype=np.uint64)[None, :]
    return rs, state


def keccak_trace(streams: list[tuple[int, int, bytes]],
                 min_log_n: int = 7):
    """streams: [(obj, dirs, data)] — one sponge per stream.  Returns
    (trace, [])."""
    L = LAYOUT
    groups: list[np.ndarray] = []
    for obj, dirs, data in streams:
        padded = bytearray(data)
        padlen = RATE - (len(data) % RATE)
        padded += b"\x00" * padlen
        padded[len(data)] ^= 0x01
        padded[-1] ^= 0x80
        n_blocks = len(padded) // RATE
        lanes = [0] * 25
        for blk_i in range(n_blocks):
            grp = np.zeros((GROUP_ROWS, L.width), dtype=np.uint32)
            grp[:, L["live"].start] = 1
            grp[:, L["sg"].start] = 1 if blk_i == 0 else 0
            grp[:, L["fin"].start] = 1 if blk_i == n_blocks - 1 else 0
            grp[:, L["cont"].start] = 0 if blk_i == 0 else 1
            grp[:, L["obj"].start] = obj % P
            grp[:, L["dirs"].start] = dirs
            grp[:, L["blkc"].start] = blk_i
            blk = padded[RATE * blk_i : RATE * blk_i + RATE]
            consumed = len(data) - RATE * blk_i    # message bytes left
            row_states = np.zeros((GROUP_ROWS, 25), dtype=np.uint64)
            for ell in range(17):
                for j in range(8):
                    byte_pos = 8 * ell + j
                    byv = blk[byte_pos]
                    for i in range(8):
                        grp[ell, L["lb"].start + 8 * j + i] = (byv >> i) & 1
                    if byte_pos < consumed:
                        grp[ell, L["g"].start + j] = 1
                lanes[ell] ^= int.from_bytes(blk[8 * ell : 8 * ell + 8],
                                             "little")
                row_states[ell] = np.array(lanes, dtype=np.uint64)
            rounds, lanes = _block_states(lanes)
            row_states[16:] = rounds[16:]
            _fill_planes(grp, row_states)
            groups.append(grp)

    if not groups:
        raise ValueError("need at least one stream")
    full = np.concatenate(groups, axis=0)
    n_real = full.shape[0]
    log_n = max(min_log_n, (n_real - 1).bit_length())
    n = 1 << log_n
    if n > n_real:
        # dead groups: the empty absorption over the zero state
        dead = np.zeros((GROUP_ROWS, L.width), dtype=np.uint32)
        row_states, _ = _block_states([0] * 25)
        _fill_planes(dead, row_states)
        reps = (n - n_real) // GROUP_ROWS
        full = np.concatenate([full] + [dead] * reps, axis=0)
    return full, []
