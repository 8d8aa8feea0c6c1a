"""Recursion verifier-VM AIR chip: one straight-line instruction per row.

The reference verifies inner STARK proofs with a recursion VM whose
program is compiled from the verifier (sp1-recursion-{core,compiler},
risc0-circuit-recursion, SURVEY.md §2.2.B/C).  This chip is the
equivalent execution table:

  * the PROGRAM lives in PREPROCESSED columns: every instruction field
    (opcode one-hot, operand/result indices, immediates, multiplicities,
    receive flags) is part of a fixed matrix committed at setup whose
    Merkle root is the recursion VERIFYING KEY — outer verification costs
    O(queries), not O(program length), and the wrap circuit only ever
    touches the vk root;
  * per-session inputs (transcript-header residues, the inner proof's
    public bus-message payloads) enter through PUB rows: the verifier
    sends (BUS_VM_PUB, k, value) messages carrying the session values, so
    the program — and hence the vk — is a pure function of the inner
    proof's SHAPE, never of journal content;
  * dataflow is SSA over the bus: a row's result is sent as
    (BUS_VM_VAL, idx, 4 ext limbs) with multiplicity = its consumer
    count; operand slots receive the same messages;
  * hashing is delegated to the sponge chips: HABS sends operand a's
    base limb to (sid, seq, lane), HOUT receives a sponge output lane
    (chips/sponge.py; width/mode pinned via imm2/imm1).

Values are quartic-extension elements (4 base limbs).  Ops:

  CONST   out = imm
  ADD/SUB out = a ± b
  MUL     out = a · b            (b replaced by imm when ub = 1)
  SEL     out = a·b + (1−a)·c    (a must be a BIT output)
  BIT     out = low bit of a (boolean-constrained); out2 = (a − out)/2;
          base-only: a's high limbs asserted zero
  HABS    absorb a (base-only) into sponge (sid=ib, seq=ic, lane=imm0)
  HOUT    out = sponge output lane (base; high limbs zeroed)
  AZERO   assert a = 0
  WIT     out = free witness (proof data; pinned by later hash/eq checks)
  MAC     out = a + b_eff·c  (fused multiply-add, still degree 3)
  PUB     out = public-input value k = imm0 (base; verifier-sent)

Port copy of zktls_tpu.stark.chips.vm (same names and values; host code
in numpy, sized for millions of rows: the perm trace's inverse columns on
host threads, its running sum in uint64, the program's fields read in one
pass).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from itertools import chain
from operator import attrgetter

import numpy as np

from ...ops.field_ref import P
from ..air import Air, AirBuilder
from ..bus import (
    BUS_HASH_ABS,
    BUS_HASH_ABS24,
    BUS_HASH_OUT,
    BUS_HASH_OUT24,
    BUS_VM_PUB,
    BUS_VM_VAL,
    np_bus_inverse_terms,
)
from ..ext_val import ExtVal

__all__ = ["VmAir", "vm_trace", "vm_preprocessed", "OPS", "Instr",
           "instr_payload"]

OPS = ["const", "add", "sub", "mul", "sel", "bit", "habs", "hout",
       "azero", "wit", "mac", "pub"]
OP_IDX = {name: i for i, name in enumerate(OPS)}


class Instr:
    """One program row.  ia/ib/ic: operand value indices; io1/io2:
    result indices; imm: 4 base limbs; m1/m2: result consumer counts;
    ra/rb/rc2: operand-receive flags; ub: b-from-imm flag.  For hash ops
    (ib, ic) carry (sid, seq) and imm carries (lane, absorb-mode,
    width-flag); for pub ops imm0 is the public-input index."""

    __slots__ = ("op", "ia", "ib", "ic", "io1", "io2", "imm", "m1", "m2",
                 "ra", "rb", "rc2", "ub")

    def __init__(self, op, ia=0, ib=0, ic=0, io1=0, io2=0, imm=(0, 0, 0, 0),
                 m1=0, m2=0, ra=0, rb=0, rc2=0, ub=0):
        self.op = op
        self.ia, self.ib, self.ic = ia, ib, ic
        self.io1, self.io2 = io1, io2
        self.imm = tuple(int(v) % P for v in imm)
        self.m1, self.m2 = m1, m2
        self.ra, self.rb, self.rc2 = ra, rb, rc2
        self.ub = ub


def instr_payload(pc: int, ins: Instr) -> list[int]:
    """Canonical field list of one instruction (program fingerprinting /
    stream-equality tests)."""
    return ([pc, OP_IDX[ins.op], ins.ia, ins.ib, ins.ic, ins.io1,
             ins.io2] + list(ins.imm)
            + [ins.m1, ins.m2, ins.ra, ins.rb, ins.rc2, ins.ub])


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


def _build_pre_layout() -> _Layout:
    """Preprocessed (program) columns — vk-committed, not prover-chosen."""
    L = _Layout()
    L.add("live")
    L.add("s", len(OPS))    # opcode one-hot
    L.add("ia"); L.add("ib"); L.add("ic")
    L.add("io1"); L.add("io2")
    L.add("imm", 4)
    L.add("m1"); L.add("m2")
    L.add("ra"); L.add("rb"); L.add("rc2")
    L.add("ub")
    return L


def _build_main_layout() -> _Layout:
    """Witness columns — the dataflow values."""
    L = _Layout()
    L.add("a", 4); L.add("b", 4); L.add("c", 4)
    L.add("beff", 4)        # ub·imm + (1−ub)·b
    L.add("o1", 4); L.add("o2", 4)
    return L


PRE_LAYOUT = _build_pre_layout()
LAYOUT = _build_main_layout()
#: rows per piece of the perm trace's inverse columns
_PERM_ROWS = 1 << 20

#: quartic extension: x⁴ = W_EXT (ops/field_ref.py)
from ...ops.field_ref import W_EXT  # noqa: E402


def _ext_mul_limbs(a, b):
    """Limb expressions of a·b over F_p[x]/(x⁴ − W_EXT)."""
    def m(i, j):
        return a[i] * b[j]

    return [
        m(0, 0) + W_EXT * (m(1, 3) + m(2, 2) + m(3, 1)),
        m(0, 1) + m(1, 0) + W_EXT * (m(2, 3) + m(3, 2)),
        m(0, 2) + m(1, 1) + m(2, 0) + W_EXT * m(3, 3),
        m(0, 3) + m(1, 2) + m(2, 1) + m(3, 0),
    ]


class VmAir(Air):
    width = LAYOUT.width
    preprocessed_width = PRE_LAYOUT.width
    num_public = 0
    max_constraint_degree = 3
    #: a/b/c recvs ‖ o1/o2 sends ‖ habs send ‖ hout recv ‖ pub recv
    #: ‖ u ‖ acc
    perm_width = 4 * 10
    num_perm_challenges = 2
    has_bus = True
    name = "VmAir"

    def eval(self, b: AirBuilder) -> None:
        L = LAYOUT
        PL = PRE_LAYOUT

        def col(name, i=0):
            return b.local[L[name].start + i]

        def pre(name, i=0):
            return b.pre_local[PL[name].start + i]

        # program fields are vk-committed — no constraints needed ON them;
        # everything below is gated BY them
        live = pre("live")
        s = [pre("s", i) for i in range(len(OPS))]
        A = [col("a", i) for i in range(4)]
        B_ = [col("b", i) for i in range(4)]
        C = [col("c", i) for i in range(4)]
        BE = [col("beff", i) for i in range(4)]
        O1 = [col("o1", i) for i in range(4)]
        O2 = [col("o2", i) for i in range(4)]
        IMM = [pre("imm", i) for i in range(4)]

        # b_eff = ub·imm + (1−ub)·b
        ub = pre("ub")
        for i in range(4):
            b.assert_zero(BE[i] - (ub * IMM[i] + (1 - ub) * B_[i]))

        # --- op semantics, each gated by its one-hot flag ---
        (s_const, s_add, s_sub, s_mul, s_sel, s_bit, s_habs, s_hout,
         s_az, _s_wit, s_mac, s_pub) = s   # wit: output unconstrained
        for i in range(4):
            b.assert_zero(s_const * (O1[i] - IMM[i]))
            b.assert_zero(s_add * (O1[i] - A[i] - BE[i]))
            b.assert_zero(s_sub * (O1[i] - A[i] + BE[i]))
            b.assert_zero(s_az * A[i])
        mul_limbs = _ext_mul_limbs(BE, C)
        mul_ab = _ext_mul_limbs(A, BE)
        for i in range(4):
            b.assert_zero(s_mul * (O1[i] - mul_ab[i]))
            # MAC: out = a + b_eff·c  (fused multiply-add — the DEEP dot
            # products halve their row count with it)
            b.assert_zero(s_mac * (O1[i] - A[i] - mul_limbs[i]))
        # SEL: out = a0·b + (1−a0)·c  (a is a bit in limb 0)
        for i in range(4):
            b.assert_zero(s_sel * (O1[i] - A[0] * BE[i]
                                   - (1 - A[0]) * C[i]))
        # BIT: o1 = bit of a0; o2 = (a0 − o1)/2; a base-only
        b.assert_zero(s_bit * O1[0] * (O1[0] - 1))
        b.assert_zero(s_bit * (A[0] - O1[0] - 2 * O2[0]))
        for i in range(1, 4):
            b.assert_zero(s_bit * A[i])
            b.assert_zero(s_bit * O1[i])
            b.assert_zero(s_bit * O2[i])
        # HABS: a base-only
        for i in range(1, 4):
            b.assert_zero(s_habs * A[i])
        # HOUT / PUB: out high limbs zero (the received value is limb 0)
        for i in range(1, 4):
            b.assert_zero(s_hout * O1[i])
            b.assert_zero(s_pub * O1[i])

        # --- bus ---
        gamma = b.challenges[0]

        def dpow(i):
            return b.challenges[1 + i]

        def fp_val(idx, limbs):
            f = ExtVal.from_base(BUS_VM_VAL) + dpow(0) * idx
            for i in range(4):
                f = f + dpow(1 + i) * limbs[i]
            return f

        fp_a = fp_val(pre("ia"), A)
        fp_b = fp_val(pre("ib"), B_)
        fp_c = fp_val(pre("ic"), C)
        fp_o1 = fp_val(pre("io1"), O1)
        fp_o2 = fp_val(pre("io2"), O2)
        # hash-bus fingerprints: (sid=ib, seq=ic, lane=imm0, value, am=imm1)
        # with the WIDTH-SPECIFIC tag selected by imm2 (0 → Sponge16 tags,
        # 1 → Sponge24 tags) — mode and width are program-pinned.
        fp_habs = (ExtVal.from_base(BUS_HASH_ABS)
                   + (BUS_HASH_ABS24 - BUS_HASH_ABS) * IMM[2]
                   + dpow(0) * pre("ib")
                   + dpow(1) * pre("ic") + dpow(2) * IMM[0]
                   + dpow(3) * A[0] + dpow(4) * IMM[1])
        fp_hout = (ExtVal.from_base(BUS_HASH_OUT)
                   + (BUS_HASH_OUT24 - BUS_HASH_OUT) * IMM[2]
                   + dpow(0) * pre("ib")
                   + dpow(1) * pre("ic") + dpow(2) * IMM[0]
                   + dpow(3) * O1[0])
        # public-input receive: (k = imm0, value)
        fp_pub = (ExtVal.from_base(BUS_VM_PUB) + dpow(0) * IMM[0]
                  + dpow(1) * O1[0])
        fps = [fp_a, fp_b, fp_c, fp_o1, fp_o2, fp_habs, fp_hout, fp_pub]
        ivs = []
        for k, f in enumerate(fps):
            iv = b.perm_ext(k)
            b.assert_ext_zero(iv * (gamma - f) - 1)
            ivs.append(iv)
        (iv_a, iv_b, iv_c, iv_o1, iv_o2, iv_habs, iv_hout, iv_pub) = ivs
        # multiplicities/flags are preprocessed: dead rows have them all 0
        u_def = (iv_o1 * pre("m1") + iv_o2 * pre("m2")
                 + iv_habs * s_habs
                 - iv_a * pre("ra") - iv_b * pre("rb")
                 - iv_c * pre("rc2") - iv_hout * s_hout
                 - iv_pub * s_pub)
        u = b.perm_ext(8)
        acc = b.perm_ext(9)
        u_n = b.perm_ext(8, nxt=True)
        acc_n = b.perm_ext(9, nxt=True)
        b.assert_ext_zero(u - u_def)
        b.assert_ext_zero((acc - u) * b.is_first_row)
        b.assert_ext_zero((acc_n - acc - u_n) * b.is_transition)
        for ell in range(4):
            b.when_last_row(acc.c[ell] - b.public[ell])
        _ = live  # live gating is implicit: all flags vanish on dead rows

    # ------------------------------------------------------------------

    def generate_perm_trace(self, main, publics, challenges,
                            preprocessed=None):
        L = LAYOUT
        PL = PRE_LAYOUT
        if preprocessed is None:
            raise ValueError("VmAir needs its preprocessed program matrix")

        def pcol1(name, i=0):
            return preprocessed[:, PL[name].start + i].astype(np.uint64)

        def pcols(name):
            return preprocessed[:, PL[name]].astype(np.uint64)

        def cols(name):
            return main[:, L[name]].astype(np.uint64)

        s = pcols("s")
        ia, ib, ic = pcol1("ia"), pcol1("ib"), pcol1("ic")
        io1, io2 = pcol1("io1"), pcol1("io2")
        imm = pcols("imm")
        m1, m2 = pcol1("m1"), pcol1("m2")
        ra, rb, rc2 = pcol1("ra"), pcol1("rb"), pcol1("rc2")
        a, b_, c = cols("a"), cols("b"), cols("c")
        o1, o2 = cols("o1"), cols("o2")

        def val_msg(idx, limbs):
            return BUS_VM_VAL, np.concatenate([idx[:, None], limbs], axis=1)

        tag_abs = (BUS_HASH_ABS
                   + (BUS_HASH_ABS24 - BUS_HASH_ABS) * imm[:, 2])
        tag_out = (BUS_HASH_OUT
                   + (BUS_HASH_OUT24 - BUS_HASH_OUT) * imm[:, 2])
        msgs = [val_msg(ia, a), val_msg(ib, b_), val_msg(ic, c),
                val_msg(io1, o1), val_msg(io2, o2),
                (tag_abs, np.stack([ib, ic, imm[:, 0], a[:, 0], imm[:, 1]],
                                   axis=1)),
                (tag_out, np.stack([ib, ic, imm[:, 0], o1[:, 0]], axis=1)),
                (BUS_VM_PUB, np.stack([imm[:, 0], o1[:, 0]], axis=1))]
        # the eight inverse columns are independent row by row, and numpy's
        # array loops release the GIL: host threads take (column, row
        # block) pieces (a full-scale program is millions of rows; blocks
        # bound each thread's temporaries)
        n = main.shape[0]
        ivs = [np.empty((n, 4), dtype=np.uint64) for _ in msgs]

        def fill(job):
            k, r0 = job
            tag, payload = msgs[k]
            if isinstance(tag, np.ndarray):
                tag = tag[r0 : r0 + _PERM_ROWS]
            ivs[k][r0 : r0 + _PERM_ROWS] = np_bus_inverse_terms(
                challenges, tag, payload[r0 : r0 + _PERM_ROWS])

        with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
            list(pool.map(fill, [(k, r0) for k in range(len(msgs))
                                 for r0 in range(0, n, _PERM_ROWS)]))
        iv_a, iv_b, iv_c, iv_o1, iv_o2, iv_habs, iv_hout, iv_pub = ivs
        s_habs = s[:, OP_IDX["habs"]]
        s_hout = s[:, OP_IDX["hout"]]
        s_pub = s[:, OP_IDX["pub"]]
        u = (iv_o1.astype(np.uint64) * m1[:, None]
             + iv_o2.astype(np.uint64) * m2[:, None]
             + iv_habs.astype(np.uint64) * s_habs[:, None]) % P
        neg = (iv_a.astype(np.uint64) * ra[:, None]
               + iv_b.astype(np.uint64) * rb[:, None]
               + iv_c.astype(np.uint64) * rc2[:, None]
               + iv_hout.astype(np.uint64) * s_hout[:, None]
               + iv_pub.astype(np.uint64) * s_pub[:, None]) % P
        u = (u + P - neg) % P
        # uint64 running sums are exact while n·(p − 1) < 2^64, i.e. for
        # fewer than 2^33 rows; the reference sums Python ints
        if u.shape[0] >= 1 << 33:
            raise ValueError("VmAir perm trace: too many rows for uint64")
        acc = np.cumsum(u, axis=0) % P
        return np.concatenate(
            [iv_a, iv_b, iv_c, iv_o1, iv_o2, iv_habs, iv_hout, iv_pub,
             u.astype(np.uint64), acc.astype(np.uint64)],
            axis=1).astype(np.uint32)


# ---------------------------------------------------------------------------
# witness generation
# ---------------------------------------------------------------------------


_FIELDS = ("ia", "ib", "ic", "io1", "io2", "m1", "m2", "ra", "rb", "rc2",
           "ub")


def _gather_fields(program: list[Instr]):
    """The program's fields as arrays, each read in one pass over the
    instructions through C-level getters (full-scale programs are millions
    of rows)."""
    m = len(program)
    ops = np.fromiter(map(OP_IDX.__getitem__, map(attrgetter("op"), program)),
                      np.int64, m)
    flat = np.fromiter(chain.from_iterable(map(attrgetter(*_FIELDS),
                                               program)),
                       np.int64, m * len(_FIELDS)).reshape(m, len(_FIELDS))
    flat %= P
    f = {nm: flat[:, k].astype(np.uint32) for k, nm in enumerate(_FIELDS)}
    imm = np.fromiter(chain.from_iterable(map(attrgetter("imm"), program)),
                      np.int64, 4 * m).reshape(m, 4).astype(np.uint32)
    return ops, f, imm


def _height(program: list[Instr], min_log_n: int) -> int:
    n_real = max(len(program), 1)
    return max(min_log_n, (n_real - 1).bit_length())


def vm_preprocessed(program: list[Instr], min_log_n: int = 4) -> np.ndarray:
    """The FIXED program matrix — a pure function of the program; its
    machine commitment root is the recursion verifying key."""
    PL = PRE_LAYOUT
    n = 1 << _height(program, min_log_n)
    pre = np.zeros((n, PL.width), dtype=np.uint32)
    m = len(program)
    if m == 0:
        return pre
    ops, f, imm = _gather_fields(program)
    pre[:m, PL["live"].start] = 1
    pre[np.arange(m), PL["s"].start + ops] = 1
    for nm, arr in f.items():
        pre[:m, PL[nm].start] = arr
    pre[:m, PL["imm"]] = imm
    return pre


def vm_trace(program: list[Instr], values: dict[int, tuple],
             min_log_n: int = 4):
    """Build the VM witness trace from the program and the resolved value
    map (idx → 4 base limbs, produced by the recursion interpreter).
    Vectorized: full-scale recursion programs are millions of rows."""
    L = LAYOUT
    n = 1 << _height(program, min_log_n)
    trace = np.zeros((n, L.width), dtype=np.uint32)
    m = len(program)
    if m == 0:
        return trace, []
    _ops, f, imm = _gather_fields(program)
    # value table: idx → limbs (idx 0 = the zero value)
    keys = np.fromiter(values.keys(), np.int64, len(values))
    vt = np.zeros((int(keys.max(initial=0)) + 1, 4), dtype=np.uint32)
    vt[keys] = np.fromiter(chain.from_iterable(values.values()), np.int64,
                           4 * len(values)).reshape(-1, 4)
    a = vt[f["ia"]] * f["ra"][:, None]
    bv = vt[f["ib"]] * f["rb"][:, None]
    c = vt[f["ic"]] * f["rc2"][:, None]
    beff = np.where(f["ub"][:, None].astype(bool), imm, bv)
    trace[:m, L["a"]] = a
    trace[:m, L["b"]] = bv
    trace[:m, L["c"]] = c
    trace[:m, L["beff"]] = beff
    trace[:m, L["o1"]] = vt[f["io1"]]
    trace[:m, L["o2"]] = vt[f["io2"]]
    return trace, []
