"""Recursion: verify a machine STARK proof inside a machine STARK proof.

The reference compresses proofs (and ultimately reaches its Groth16 wrap)
through recursion circuits that verify inner STARKs
(sp1-recursion-{core,compiler,circuit}, risc0-circuit-recursion —
SURVEY.md §2.2.B/C).  The TPU-native equivalent here is a *verifier VM*:
`build_program` traces the exact logic of `machine.verify_machine` for a
fixed inner geometry into a straight-line program over three chips —

  * VmAir          one extension-field instruction per row (chips/vm.py);
  * Sponge16Air    every Fiat-Shamir duplex + Merkle 2-to-1 compression;
  * Sponge24Air    every Merkle leaf sponge —

glued by the machine bus.  The program lives in the VM chip's
PREPROCESSED columns: its Merkle root is the verifying key
(RecursionVK), computed once per statement geometry — the program is a
pure function of (inner shape, message structure, configs), never of
session values, which enter through PUB rows as verifier-sent
(BUS_VM_PUB, k, value) messages.  Verification against a vk is
O(outer proof): the program is never rebuilt (round-4's O(L)
per-instruction messaging is gone).  Soundness: every witness value the
program uses is either (a) hashed into the Fiat-Shamir transcript
through the sponge chips, (b) checked against a Merkle root through the
compression chain, or (c) constrained by the emitted field equations —
exactly the checks the host verifier performs, one instruction at a
time.

Cost shape: the inner machine's total opened width W and query count Q
dominate (O(W·Q) VM rows + O(W·Q/16) sponge rows).  Two applications
chain to the on-chain seal: compress (Poseidon2-committed outer,
recursion_prove) and shrink (BN254/MiMC-committed outer,
recursion_prove_bn — stark/machine_bn.py), whose verifier the Groth16
wrap circuit arithmetizes (snark/stark_wrap.py).

Port copy of zktls_tpu.stark.recursion, both halves (same names and
values; the program build and the chips' traces on the host, the outer
machine proof through the port's `prove_machine` — or, for the shrink,
`machine_bn.prove_machine_bn` — on the caller's device).  `trusted_vk`
reads its cache directory from its `cache_dir` argument only (default
`~/.local/zktlsd/vk`).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..ops.field_ref import Fp4, P, two_adic_root
from ..utils.spans import Stages
from .air import Air, AirBuilder, scalar_vec_hooks
from .bus import BUS_SP16_CHAIN, BUS_VM_PUB, MAX_PAYLOAD
from .challenger import Challenger
from .chips.sponge import Sponge16Air, Sponge24Air, SpongeRow, sponge_trace
from .chips.vm import Instr, VmAir, vm_preprocessed, vm_trace
from .config import DEFAULT_CONFIG, StarkConfig
from .ext_val import ExtVal
from .machine import (
    CHUNKED_DEEP_BYTES,
    POSEIDON2,
    SPILL_BYTES,
    ChipInstance,
    MachineProof,
    _machine_order,
    _observe_header,
    preprocessed_root,
    prove_machine,
    verify_machine,
)
from .verifier import _EXT_BASIS, VerificationError

__all__ = ["MachineShape", "RecursionVK", "recursion_prove",
           "recursion_verify", "recursion_vk", "trusted_vk",
           "build_program", "outer_airs", "RecursionVKBN",
           "recursion_prove_bn", "recursion_verify_bn"]

_X = Fp4(0, 1, 0, 0)
LEAF_RATE = 16


@dataclass(frozen=True)
class MachineShape:
    """The inner proof's public geometry — everything the program's
    structure depends on besides (binding, public_messages, config)."""

    chips: tuple          # ((name, log_n, publics tuple), …) machine order
    fri_roots: int
    fri_final: int

    @classmethod
    def of(cls, proof: MachineProof) -> "MachineShape":
        return cls(
            chips=tuple((c.name, c.log_n, tuple(c.publics))
                        for c in proof.chips),
            fri_roots=len(proof.fri_roots),
            fri_final=len(proof.fri_final),
        )

    def to_bytes(self) -> bytes:
        from ..core import cbor

        return cbor.dumps({
            "chips": [[n, l, list(p)] for n, l, p in self.chips],
            "fr": self.fri_roots, "ff": self.fri_final})

    @classmethod
    def from_bytes(cls, data: bytes) -> "MachineShape":
        from ..core import cbor

        obj = cbor.loads(data)
        return cls(chips=tuple((c[0], c[1], tuple(c[2]))
                               for c in obj["chips"]),
                   fri_roots=obj["fr"], fri_final=obj["ff"])


class Val:
    """SSA value handle with field-operator overloading (ints and Fp4
    constants lift via immediate operands)."""

    __slots__ = ("prog", "idx")

    def __init__(self, prog, idx):
        self.prog = prog
        self.idx = idx

    @staticmethod
    def _ok(o) -> bool:
        return isinstance(o, (Val, int, Fp4))

    def __add__(self, o):
        if not self._ok(o):
            return NotImplemented   # defer to ScalarVec/ExtVal reflected op
        return self.prog.add(self, o)
    __radd__ = __add__

    def __sub__(self, o):
        if not self._ok(o):
            return NotImplemented
        return self.prog.sub(self, o)

    def __rsub__(self, o):
        if not self._ok(o):
            return NotImplemented
        return self.prog.sub(o, self)

    def __mul__(self, o):
        if not self._ok(o):
            return NotImplemented
        return self.prog.mul(self, o)
    __rmul__ = __mul__

    def __neg__(self):
        return self.prog.sub(0, self)


def _fp4(v) -> Fp4:
    if isinstance(v, Fp4):
        return v
    return Fp4(int(v) % P)


class Prog:
    """Program builder + concrete interpreter (values tracked so the
    prover fills the witness; `strict=False` skips value sanity for the
    verifier-side structural rebuild)."""

    def __init__(self, strict: bool = True):
        self.instrs: list[Instr] = []
        self.vals: dict[int, Fp4] = {0: Fp4(0)}
        self.next_idx = 1
        self.uses: dict[int, int] = {}
        self.strict = strict
        #: per-session public inputs, in PUB-row order — the verifier
        #: sends (BUS_VM_PUB, k, value) for each (vm chip pub receive)
        self.pub_values: list[int] = []
        # sponge bookkeeping: rows per width; states per (sid, seq)
        self.sp_rows: dict[int, list] = {16: [], 24: []}
        self.sp_states: dict[tuple, list] = {}
        self.sp_chain: dict[int, list] = {}   # sid -> host chain state
        self.sp_out_mults: dict[tuple, int] = {}
        self._next_sid = 1
        from ..ops.poseidon2 import Poseidon2

        self._perm = {16: Poseidon2(16), 24: Poseidon2(24)}
        #: verifier-sent chain-state messages: (sid, seq, state list)
        self.chain_seeds: list[tuple] = []

    # -- low-level emission ------------------------------------------------

    def _new(self, value: Fp4) -> Val:
        idx = self.next_idx
        self.next_idx += 1
        self.vals[idx] = value
        return Val(self, idx)

    def _use(self, v: Val) -> int:
        self.uses[v.idx] = self.uses.get(v.idx, 0) + 1
        return v.idx

    def _emit(self, **kw) -> None:
        self.instrs.append(Instr(**kw))

    def const(self, v) -> Val:
        v = _fp4(v)
        out = self._new(v)
        self._emit(op="const", io1=out.idx, imm=v.c)
        return out

    def wit(self, v) -> Val:
        out = self._new(_fp4(v) if self.strict else _fp4(v))
        self._emit(op="wit", io1=out.idx)
        return out

    def pub(self, v) -> Val:
        """A per-session public input (base value): the row RECEIVES the
        value from a verifier-sent (BUS_VM_PUB, k, value) message, so the
        program structure — and the vk — never embeds session data."""
        v = _fp4(v)
        if tuple(v.c[1:]) != (0, 0, 0):
            raise VerificationError("public inputs must be base values")
        out = self._new(v)
        k = len(self.pub_values)
        self.pub_values.append(int(v.c[0]))
        self._emit(op="pub", io1=out.idx, imm=(k, 0, 0, 0))
        return out

    def _binop(self, op, a, b) -> Val:
        if not isinstance(a, Val) and not isinstance(b, Val):
            av, bv = _fp4(a), _fp4(b)
            r = (av + bv if op == "add" else av - bv if op == "sub"
                 else av * bv)
            return self.const(r)
        if not isinstance(a, Val):
            if op == "add":
                return self._binop("add", b, a)
            if op == "mul":
                return self._binop("mul", b, a)
            # const − Val: emit via SUB with a = const value
            a = self.const(a)
        if not isinstance(b, Val):
            bv = _fp4(b)
            av = self.vals[a.idx]
            r = (av + bv if op == "add" else av - bv if op == "sub"
                 else av * bv)
            out = self._new(r)
            self._emit(op=op, ia=self._use(a), io1=out.idx, imm=bv.c,
                       ra=1, ub=1)
            return out
        av, bv = self.vals[a.idx], self.vals[b.idx]
        r = (av + bv if op == "add" else av - bv if op == "sub"
             else av * bv)
        out = self._new(r)
        self._emit(op=op, ia=self._use(a), ib=self._use(b), io1=out.idx,
                   ra=1, rb=1)
        return out

    def add(self, a, b) -> Val:
        return self._binop("add", a, b)

    def sub(self, a, b) -> Val:
        return self._binop("sub", a, b)

    def mul(self, a, b) -> Val:
        return self._binop("mul", a, b)

    def mac(self, a: Val, b, c: Val) -> Val:
        """a + b·c in one instruction (b may be an immediate)."""
        if not isinstance(a, Val):
            a = self.const(a)
        if not isinstance(c, Val):
            return self.add(a, self.mul(c, b)) if isinstance(b, Val) \
                else self.add(a, _fp4(b) * _fp4(c))
        if isinstance(b, Val):
            r = self.vals[a.idx] + self.vals[b.idx] * self.vals[c.idx]
            out = self._new(r)
            self._emit(op="mac", ia=self._use(a), ib=self._use(b),
                       ic=self._use(c), io1=out.idx, ra=1, rb=1, rc2=1)
            return out
        bv = _fp4(b)
        r = self.vals[a.idx] + bv * self.vals[c.idx]
        out = self._new(r)
        self._emit(op="mac", ia=self._use(a), ic=self._use(c),
                   io1=out.idx, imm=bv.c, ra=1, rc2=1, ub=1)
        return out

    def sel(self, bit: Val, x: Val, y: Val) -> Val:
        """bit·x + (1−bit)·y — bit must be a BIT output."""
        bv = self.vals[bit.idx]
        r = self.vals[x.idx] if bv == Fp4(1) else self.vals[y.idx]
        out = self._new(r)
        self._emit(op="sel", ia=self._use(bit), ib=self._use(x),
                   ic=self._use(y), io1=out.idx, ra=1, rb=1, rc2=1)
        return out

    def assert_zero(self, a: Val) -> None:
        if self.strict and self.vals[a.idx] != Fp4(0):
            raise VerificationError(
                "recursion witness: assertion failed at "
                f"instr {len(self.instrs)}")
        self._emit(op="azero", ia=self._use(a), ra=1)

    def assert_eq(self, a: Val, b) -> None:
        self.assert_zero(self.sub(a, b))

    def inv(self, a: Val) -> Val:
        av = self.vals[a.idx]
        try:
            w = av.inv()
        except ZeroDivisionError:
            w = Fp4(0)
        wv = self.wit(w)
        self.assert_eq(self.mul(a, wv), 1)
        return wv

    def div(self, a, b: Val) -> Val:
        return self.mul(a, self.inv(b))

    def bits(self, a: Val, n: int) -> list[Val]:
        """Decompose a base-only value into n bits (LSB first) plus a
        canonicity guard when n = 31."""
        av = int(self.vals[a.idx].c[0])
        cur = a
        out = []
        for i in range(n):
            bval = (av >> i) & 1
            rval = (av >> (i + 1))
            b = self._new(Fp4(bval))
            r = self._new(Fp4(rval))
            self._emit(op="bit", ia=self._use(cur), io1=b.idx, io2=r.idx,
                       ra=1)
            out.append(b)
            cur = r
        return out, cur

    def bits31(self, a: Val) -> list[Val]:
        bs, rem = self.bits(a, 31)
        self.assert_zero(rem)
        # canonicity: value ≤ p − 1 = 2^31 − 2^27.  Non-canonical values
        # are exactly those with bits 27..30 all 1 AND some low bit set
        # (p − 1 itself is 1111·2^27 with zero low bits, and must be
        # accepted — an honest Fiat-Shamir sample hits it with
        # probability 2^-31 per decomposition).
        t = self.mul(bs[30], bs[29])
        t = self.mul(t, bs[28])
        t = self.mul(t, bs[27])
        low = bs[0]
        for i in range(1, 27):
            low = self.add(low, bs[i])
        self.assert_zero(self.mul(t, low))
        return bs

    def combine4(self, limbs: list[Val]) -> Val:
        """c0 + c1·X + c2·X² + c3·X³ from 4 base-only values."""
        acc = self.mac(limbs[2], _X, limbs[3])
        acc = self.mac(limbs[1], _X, acc)
        return self.mac(limbs[0], _X, acc)

    # -- sponge plumbing ----------------------------------------------------

    def new_sid(self) -> int:
        sid = self._next_sid
        self._next_sid += 1
        return sid

    def sponge_row(self, w: int, sid: int, seq: int,
                   absorbs: dict[int, Val], additive: bool = False,
                   has_next: bool = True, fresh_state=None) -> None:
        """One duplex: emits HABS per absorbed lane and records the chip
        row; the host permutation tracks the chain state.  imm carries
        (lane, absorb-mode, width-flag) so the program — not the prover —
        pins the sponge's mode and width (chips/vm.py fp_habs)."""
        wflag = 1 if w == 24 else 0
        for lane, v in absorbs.items():
            if self.strict and tuple(self.vals[v.idx].c[1:]) != (0, 0, 0):
                raise VerificationError("absorbing a non-base value")
            self._emit(op="habs", ia=self._use(v), ib=sid, ic=seq,
                       imm=(lane, 1 if additive else 0, wflag, 0), ra=1)
        if seq == 0:
            prev = [0] * w
        elif fresh_state is not None:
            prev = list(fresh_state)
        else:
            prev = self.sp_chain[sid]
        s_in = list(prev)
        vals = {lane: int(self.vals[v.idx].c[0])
                for lane, v in absorbs.items()}
        for lane, value in vals.items():
            s_in[lane] = (s_in[lane] + value) % P if additive else value
        out = self._perm[w].permute_ints(s_in)
        self.sp_chain[sid] = out
        self.sp_states[(sid, seq)] = out
        self.sp_rows[w].append(
            (SpongeRow(sid, seq, vals, {}, has_next, additive,
                       fresh_state), len(self.instrs)))

    def sponge_out(self, w: int, sid: int, seq: int, lane: int) -> Val:
        out = self._new(Fp4(self.sp_states[(sid, seq)][lane]))
        self._emit(op="hout", ib=sid, ic=seq,
                   imm=(lane, 0, 1 if w == 24 else 0, 0), io1=out.idx)
        key = (w, sid, seq, lane)
        self.sp_out_mults[key] = self.sp_out_mults.get(key, 0) + 1
        return out

    # -- finalization --------------------------------------------------------

    def finalize(self):
        """Renumber sponge sids to each chip's dense trace-order
        numbering, then patch producer multiplicities and sponge output
        multiplicities; mark last rows of sponge chains."""
        self._renumber_sids()
        produced: dict[int, int] = {}
        for i, ins in enumerate(self.instrs):
            if ins.op in ("const", "add", "sub", "mul", "sel", "hout",
                          "wit", "mac", "pub"):
                produced[ins.io1] = i
                ins.m1 = self.uses.get(ins.io1, 0)
            if ins.op == "bit":
                produced[ins.io1] = i
                produced[ins.io2] = i
                ins.m1 = self.uses.get(ins.io1, 0)
                ins.m2 = self.uses.get(ins.io2, 0)
        for w in (16, 24):
            rows = [r for r, _pos in self.sp_rows[w]]
            present = {(r.sid, r.seq) for r in rows}
            for row in rows:
                row.out_mults = {
                    lane: self.sp_out_mults[(w, row.sid, row.seq, lane)]
                    for lane in range(8)
                    if (w, row.sid, row.seq, lane) in self.sp_out_mults}
                row.has_next = (row.sid, row.seq + 1) in present
        return self

    def _renumber_sids(self) -> None:
        """The sponge chips enforce (sid, seq) uniqueness with a dense
        stride-1 sid discipline per chip (chips/sponge.py).  Globally
        allocated sids have per-width gaps, so remap each width's sids to
        1, 2, … in first-appearance (= trace) order and rewrite every
        reference: sponge rows, habs/hout instruction ib fields (width
        identified by imm2), and the verifier chain-seed messages."""
        maps = {16: {}, 24: {}}
        for w in (16, 24):
            m = maps[w]
            for row, _pos in self.sp_rows[w]:
                if row.sid not in m:
                    m[row.sid] = len(m) + 1
            for row, _pos in self.sp_rows[w]:
                row.sid = m[row.sid]
        for ins in self.instrs:
            if ins.op in ("habs", "hout"):
                ins.ib = maps[24 if ins.imm[2] else 16][ins.ib]
        self.chain_seeds = [(maps[16][sid], seq, state)
                            for sid, seq, state in self.chain_seeds]
        self.sp_out_mults = {
            (w, maps[w][sid], seq, lane): v
            for (w, sid, seq, lane), v in self.sp_out_mults.items()}


# ---------------------------------------------------------------------------
# the verifier compiler
# ---------------------------------------------------------------------------


class _ProgChallenger:
    """Mirror of stark.challenger.Challenger over program values, seeded
    with the precomputed post-header state (verifier-supplied via a chain
    message)."""

    def __init__(self, prog: Prog, state: list[int], buffered: list[int]):
        self.prog = prog
        self.sid = prog.new_sid()
        # seq starts at 1: seq 0 means "fresh = zero state" to the chip,
        # but this chain CONTINUES from the precomputed header state the
        # verifier supplies as a chain message at seq 1
        self.seq = 1
        # buffered header residues are SESSION data (they depend on the
        # journal bytes) — route them through PUB rows, not immediates
        self.buf: list[Val] = [prog.pub(v) for v in buffered]
        self.out_n = 0
        self.header_state = list(state)
        prog.chain_seeds.append((self.sid, 1, list(state)))
        self._first = True

    def _duplex(self) -> None:
        absorbs = {i: v for i, v in enumerate(self.buf)}
        self.prog.sponge_row(
            16, self.sid, self.seq, absorbs,
            fresh_state=self.header_state if self._first else None)
        self._first = False
        self.buf = []
        self.seq += 1
        self.out_n = 8

    def observe(self, v: Val) -> None:
        self.out_n = 0
        self.buf.append(v)
        if len(self.buf) == 8:
            self._duplex()

    def observe_many(self, vs) -> None:
        for v in vs:
            self.observe(v)

    def sample(self) -> Val:
        if self.buf or self.out_n == 0:
            self._duplex()
        self.out_n -= 1
        return self.prog.sponge_out(16, self.sid, self.seq - 1,
                                    self.out_n)

    def sample_ext(self):
        limbs = [self.sample() for _ in range(4)]
        return limbs, self.prog.combine4(limbs)

    def sample_bits(self, k: int):
        v = self.sample()
        bs = self.prog.bits31(v)
        return bs[:k]

    def check_witness(self, pow_bits: int, witness: Val) -> None:
        self.observe(witness)
        if pow_bits:
            s = self.sample()
            bs = self.prog.bits31(s)
            acc = None
            for i in range(pow_bits):
                acc = bs[i] if acc is None else self.prog.add(acc, bs[i])
            # all low bits zero ⇔ their sum is zero (bits are boolean)
            self.prog.assert_zero(acc)


def _leaf_hash24(prog: Prog, vals: list[Val]) -> list[Val]:
    """hash_row_ints: width-24 sponge, rate 16, additive absorb."""
    sid = prog.new_sid()
    n_blocks = max(-(-len(vals) // LEAF_RATE), 1)
    for bi in range(n_blocks):
        chunk = {j: vals[bi * LEAF_RATE + j]
                 for j in range(LEAF_RATE)
                 if bi * LEAF_RATE + j < len(vals)}
        prog.sponge_row(24, sid, bi, chunk, additive=True,
                        has_next=bi < n_blocks - 1)
    return [prog.sponge_out(24, sid, n_blocks - 1, k) for k in range(8)]


def _compress16(prog: Prog, left: list[Val], right: list[Val]) -> list[Val]:
    sid = prog.new_sid()
    absorbs = {i: left[i] for i in range(8)}
    absorbs.update({8 + i: right[i] for i in range(8)})
    prog.sponge_row(16, sid, 0, absorbs, has_next=False)
    return [prog.sponge_out(16, sid, 0, k) for k in range(8)]


def _verify_path_vm(prog: Prog, leaf: list[Val], index_bits: list[Val],
                    path: list[list[Val]], root: list[Val]) -> None:
    node = leaf
    for level, sib in enumerate(path):
        bit = index_bits[level]
        l = [prog.sel(bit, sib[j], node[j]) for j in range(8)]
        r = [prog.sel(bit, node[j], sib[j]) for j in range(8)]
        node = _compress16(prog, l, r)
    for j in range(8):
        prog.assert_eq(node[j], root[j])


def _pow_chain(prog: Prog, x: Val, n: int) -> list[Val]:
    """[1?, x, x², …] — powers as values (index 0 is the constant 1)."""
    out = [prog.const(1), x]
    for _ in range(2, n):
        out.append(prog.mul(out[-1], x))
    return out[:n] if n else []


def _index_value(prog: Prog, bits: list[Val]) -> Val:
    acc = None
    for i, b in enumerate(bits):
        acc = (prog.mul(b, 1 << i) if acc is None
               else prog.mac(acc, 1 << i, b))
    return acc if acc is not None else prog.const(0)


def _domain_x(prog: Prog, bits: list[Val], log_N: int, shift: int) -> Val:
    """x = shift·g^j from j's bits: Π sel(b_i, g^{2^i}, 1)."""
    g = two_adic_root(log_N)
    acc = prog.const(shift)
    one = prog.const(1)
    gp = g
    for b in bits:     # j may have fewer bits than log_N (FRI half-domains)
        c = prog.const(gp)
        f = prog.sel(b, c, one)
        acc = prog.mul(acc, f)
        gp = gp * gp % P
    return acc


def _eval_periodic_vm(prog: Prog, pattern, zeta_pows: dict, n: int):
    """Periodic interpolant at ζ^{n/m}: constant coefficients, Horner in
    the precomputed power y = ζ^{n/m}."""
    m = len(pattern)
    w = two_adic_root(m.bit_length() - 1)
    w_inv = pow(w, P - 2, P)
    m_inv = pow(m, P - 2, P)
    coeffs = []
    for k in range(m):
        step = pow(w_inv, k, P)
        acc = 0
        wk = 1
        for j in range(m):
            acc = (acc + int(pattern[j]) * wk) % P
            wk = wk * step % P
        coeffs.append(acc * m_inv % P)
    y = zeta_pows[n // m]
    out = prog.const(coeffs[-1])
    for c in reversed(coeffs[:-1]):
        out = prog.mul(out, y)
        out = prog.add(out, c)
    return out


def _fold_constraints_vm(prog: Prog, air: Air, local, nxt, public, sels,
                         alpha: Val, periodic, perm_local, perm_next,
                         challenge_limbs, pre_local=(), pre_next=()) -> Val:
    acc = [prog.const(0)]
    apow = [prog.const(1)]

    def fold(expr):
        if not isinstance(expr, Val):
            expr = prog.const(expr)
        acc[0] = prog.mac(acc[0], apow[0], expr)
        apow[0] = prog.mul(apow[0], alpha)

    builder = AirBuilder(
        local=list(local), next=list(nxt), public=list(public),
        is_first_row=sels["is_first_row"],
        is_last_row=sels["is_last_row"],
        is_transition=sels["is_transition"],
        _fold=fold, periodic=list(periodic),
        perm_local=list(perm_local), perm_next=list(perm_next),
        challenges=[ExtVal(*limbs) for limbs in challenge_limbs],
        pre_local=list(pre_local), pre_next=list(pre_next),
        **scalar_vec_hooks(fold, lambda v: prog.const(v)),
    )
    air.eval(builder)
    return acc[0]


def build_program(airs: list[Air], shape: MachineShape, binding: bytes,
                  public_messages: list[tuple],
                  config: StarkConfig = DEFAULT_CONFIG,
                  proof: MachineProof | None = None,
                  preprocessed_roots: dict[str, list[int]] | None = None,
                  ) -> Prog:
    """Trace verify_machine into a program.  With `proof` (prover side)
    the interpreter fills concrete values and every assert is checked;
    without it a shape-identical dummy runs (verifier-side rebuild).
    preprocessed_roots: the INNER machine's vk roots, for inner chips
    with fixed columns (e.g. a compress-layer VmAir being re-verified by
    the shrink layer) — they become program CONSTANTS, so the outer vk
    commits to them."""
    strict = proof is not None
    preprocessed_roots = preprocessed_roots or {}
    if proof is None:
        proof = _dummy_proof(airs, shape, config)
    prog = Prog(strict=strict)
    air_by_name = {a.name: a for a in airs}

    # geometry checks (compile-time, mirrors verify_machine)
    if sorted(c.name for c in proof.chips) != sorted(air_by_name):
        raise VerificationError("chip name multiset != air set")
    expect_order = _machine_order(
        proof.chips, lambda c: c.log_n + config.log_blowup,
        lambda c: c.name)
    if [c.name for c in proof.chips] != [c.name for c in expect_order]:
        raise VerificationError("chip order not canonical")
    log_N_max = proof.chips[0].log_n + config.log_blowup
    geo = []
    for cp in proof.chips:
        air = air_by_name[cp.name]
        log_N = cp.log_n + config.log_blowup
        if (1 << log_N) <= config.fri_final_size:
            raise VerificationError("chip domain below fri_final_size")
        k = log_N_max - log_N
        s_i = pow(config.shift, 1 << k, P)
        ew = getattr(air, "preprocessed_width", 0)
        if ew and cp.name not in preprocessed_roots:
            raise VerificationError(
                f"{cp.name}: inner vk missing preprocessed root")
        if len(cp.publics) != air.num_public or \
                len(cp.tl) != air.width or len(cp.tn) != air.width or \
                len(cp.pl) != air.perm_width or \
                len(cp.pn) != air.perm_width or \
                len(cp.el) != ew or len(cp.en) != ew or \
                len(cp.qe) != 4 * config.blowup or \
                (cp.perm_root is not None) != bool(air.perm_width) or \
                len(cp.bus_sum) != 4:
            raise VerificationError("bad proof shape")
        geo.append((cp, air, 1 << cp.log_n, log_N, s_i))

    # --- precompute the post-header challenger state (all constants) ---
    hch = Challenger()
    _observe_header(POSEIDON2, hch, binding,
                    [(cp.name, cp.log_n, cp.publics,
                      preprocessed_roots.get(cp.name))
                     for cp in proof.chips])
    ch = _ProgChallenger(prog, hch.state, [v % P for v in hch.input_buf])

    # --- transcript replay over witness values ---
    def wit_many(vals):
        return [prog.wit(v) for v in vals]

    troots = {}
    for cp in proof.chips:
        troots[cp.name] = wit_many(cp.trace_root)
        ch.observe_many(troots[cp.name])
    gamma_l, gamma = ch.sample_ext()
    delta_l, delta = ch.sample_ext()
    # the machine challenge vector [γ, δ, δ², …] — chips consume the
    # LIMBS, so δ powers are built by limb-level ext multiplication
    chal_limbs = [gamma_l, delta_l]
    prev = delta_l
    for _ in range(1, MAX_PAYLOAD):
        prev = _ext_mul_limbs_vm(prog, prev, delta_l)
        chal_limbs.append(prev)
    challenges_vals = [prog.combine4(limbs) for limbs in chal_limbs]

    perm_roots = {}
    bus_sums = {}
    for cp, air, *_ in geo:
        if air.perm_width:
            perm_roots[cp.name] = wit_many(cp.perm_root)
            ch.observe_many(perm_roots[cp.name])
            bus_sums[cp.name] = wit_many(cp.bus_sum)
            ch.observe_many(bus_sums[cp.name])
            if not getattr(air, "has_bus", False):
                for limb in bus_sums[cp.name]:
                    prog.assert_zero(limb)
    _alpha_l, alpha = ch.sample_ext()
    qroots = {}
    for cp in proof.chips:
        qroots[cp.name] = wit_many(cp.quotient_root)
        ch.observe_many(qroots[cp.name])
    _zeta_l, zeta = ch.sample_ext()
    evals = {}
    for cp in proof.chips:
        ev = {}
        for key in ("tl", "tn", "pl", "pn", "qe", "el", "en"):
            rows = []
            for v in getattr(cp, key):
                limbs = wit_many(v.c)
                ch.observe_many(limbs)
                rows.append((limbs, prog.combine4(limbs)))
            ev[key] = rows
        evals[cp.name] = ev
    _beta_l, beta = ch.sample_ext()
    fri_root_vals = []
    fold_betas = []
    n_layers = 0
    size = 1 << log_N_max
    while size > config.fri_final_size:
        size //= 2
        n_layers += 1
    if len(proof.fri_roots) != n_layers or \
            len(proof.fri_final) != size:
        raise VerificationError("bad FRI shape")
    for root in proof.fri_roots:
        rv = wit_many(root)
        fri_root_vals.append(rv)
        ch.observe_many(rv)
        _bl, bval = ch.sample_ext()
        fold_betas.append(bval)
    final_vals = []
    for v in proof.fri_final:
        limbs = wit_many(v.c)
        ch.observe_many(limbs)
        final_vals.append((limbs, prog.combine4(limbs)))
    pow_wit = prog.wit(proof.pow_witness)
    ch.check_witness(config.pow_bits, pow_wit)
    if len(proof.queries) != config.num_queries:
        raise VerificationError("bad query count")
    query_bits = [ch.sample_bits(log_N_max)
                  for _ in range(config.num_queries)]

    # --- global bus balance ---
    total = prog.const(0)
    for cp in proof.chips:
        if cp.name in bus_sums:
            total = prog.add(total, prog.combine4(bus_sums[cp.name]))
    for entry in public_messages:
        tag, payload = entry[0], entry[1]
        mult = entry[2] if len(entry) > 2 else -1
        fp = prog.const(tag)
        for i, pv in enumerate(payload):
            # payload values are session data (journal bytes, stream
            # commitments) — PUB rows keep them out of the program/vk
            fp = prog.mac(fp, prog.pub(int(pv) % P),
                          challenges_vals[1 + i])
        term = prog.inv(prog.sub(challenges_vals[0], fp))
        if mult == 1:
            total = prog.add(total, term)
        elif mult == -1:
            total = prog.sub(total, term)
        else:
            total = prog.add(total, prog.mul(term, mult % P))
    prog.assert_zero(total)

    # --- per-chip DEEP-ALI constraint identity at ζ ---
    zeta_pow_cache: dict[int, Val] = {1: zeta}

    def zeta_pow(k: int) -> Val:
        if k not in zeta_pow_cache:
            half = zeta_pow(k // 2)
            sq = prog.mul(half, half)
            zeta_pow_cache[k] = (prog.mul(sq, zeta) if k % 2 else sq)
        return zeta_pow_cache[k]

    g_zetas = {}
    for cp, air, n, log_N, s_i in geo:
        g = two_adic_root(cp.log_n)
        z_h = prog.sub(zeta_pow(n), 1)
        g_last = pow(g, n - 1, P)
        sels = {
            "is_first_row": prog.div(z_h, prog.sub(zeta, 1)),
            "is_last_row": prog.div(z_h, prog.sub(zeta, g_last)),
            "is_transition": prog.sub(zeta, g_last),
        }
        zp_map = {}
        for pattern in air.periodic_columns():
            m = len(pattern)
            zp_map[n // m] = zeta_pow(n // m)
        periodic_at_zeta = [
            _eval_periodic_vm(prog, pattern, zp_map, n)
            for pattern in air.periodic_columns()]
        ev = evals[cp.name]
        publics_full = ([prog.const(v) for v in cp.publics]
                        + bus_sums.get(cp.name,
                                       [prog.const(0)] * 4))
        folded = _fold_constraints_vm(
            prog, air,
            [v for _l, v in ev["tl"]], [v for _l, v in ev["tn"]],
            publics_full, sels, alpha, periodic_at_zeta,
            [v for _l, v in ev["pl"]], [v for _l, v in ev["pn"]],
            chal_limbs,
            pre_local=[v for _l, v in ev["el"]],
            pre_next=[v for _l, v in ev["en"]])
        zeta_n = zeta_pow(n)
        q_at = prog.const(0)
        zpow = prog.const(1)
        for k in range(config.blowup):
            chunk = prog.const(0)
            for ell in range(4):
                t = prog.mul(ev["qe"][4 * k + ell][1], _EXT_BASIS[ell])
                chunk = prog.add(chunk, t)
            q_at = prog.add(q_at, prog.mul(zpow, chunk))
            zpow = prog.mul(zpow, zeta_n)
        prog.assert_zero(prog.sub(folded, prog.mul(z_h, q_at)))
        g_zetas[cp.name] = prog.mul(zeta, two_adic_root(cp.log_n))

    # β-power table (global ordering, as the prover/verifier build it)
    total_terms = 0
    offs = {}
    for cp, air, n, log_N, s_i in geo:
        ew = getattr(air, "preprocessed_width", 0)
        w_z = air.width + ew + air.perm_width + 4 * config.blowup
        w_gz = air.width + ew + air.perm_width
        offs[cp.name] = (total_terms, w_z, w_gz)
        total_terms += w_z + w_gz
    bpows = _pow_chain(prog, beta, total_terms + 1)
    # per-chip eval-side β-sums (query-independent); DEEP column order
    # matches the machine prover: [trace ‖ pre ‖ perm ‖ quotient] at ζ,
    # [trace ‖ pre ‖ perm] at g·ζ
    ev_sums = {}
    beta_acc_consts = {}
    for cp, air, n, log_N, s_i in geo:
        off, w_z, w_gz = offs[cp.name]
        ev = evals[cp.name]
        sz = prog.const(0)
        vec_z = ([v for _l, v in ev["tl"]] + [v for _l, v in ev["el"]]
                 + [v for _l, v in ev["pl"]] + [v for _l, v in ev["qe"]])
        for i, v in enumerate(vec_z):
            sz = prog.mac(sz, bpows[i], v)
        sgz = prog.const(0)
        vec_gz = ([v for _l, v in ev["tn"]] + [v for _l, v in ev["en"]]
                  + [v for _l, v in ev["pn"]])
        for i, v in enumerate(vec_gz):
            sgz = prog.mac(sgz, bpows[w_z + i], v)
        ev_sums[cp.name] = (sz, sgz, w_z, w_gz)

    # --- per-query checks ---
    for qi, (mq, bits) in enumerate(zip(proof.queries, query_bits)):
        if len(mq.openings) != len(geo):
            raise VerificationError("bad opening count")
        scaled: dict[int, Val] = {}
        beta_off = 0
        for (cp, air, n, log_N, s_i), op in zip(geo, mq.openings):
            w = air.width
            pw = air.perm_width
            ew = getattr(air, "preprocessed_width", 0)
            if len(op.trace_row) != w or \
                    len(op.quotient_row) != 4 * config.blowup or \
                    (pw and len(op.perm_row) != pw) or \
                    len(op.pre_row) != ew:
                raise VerificationError("bad opened row")
            jbits = bits[:log_N]
            trow = wit_many([v % P for v in op.trace_row])
            qrow = wit_many([v % P for v in op.quotient_row])
            prow = wit_many([v % P for v in op.perm_row]) if pw else []
            erow = wit_many([v % P for v in op.pre_row]) if ew else []
            # Merkle openings
            path_t = [wit_many(h) for h in op.trace_path]
            _verify_path_vm(prog, _leaf_hash24(prog, trow), jbits,
                            path_t, troots[cp.name])
            path_q = [wit_many(h) for h in op.quotient_path]
            _verify_path_vm(prog, _leaf_hash24(prog, qrow), jbits,
                            path_q, qroots[cp.name])
            if pw:
                path_p = [wit_many(h) for h in op.perm_path]
                _verify_path_vm(prog, _leaf_hash24(prog, prow), jbits,
                                path_p, perm_roots[cp.name])
            if ew:
                # the preprocessed root is the INNER vk — a program
                # constant, so the outer vk commits to it
                root_c = [prog.const(v)
                          for v in preprocessed_roots[cp.name]]
                path_e = [wit_many(h) for h in op.pre_path]
                _verify_path_vm(prog, _leaf_hash24(prog, erow), jbits,
                                path_e, root_c)
            # DEEP reduced opening
            off, w_z, w_gz = offs[cp.name]
            sz, sgz, _wz, _wgz = ev_sums[cp.name]
            num_z = prog.const(0)
            vec = trow + erow + prow + qrow
            for i, v in enumerate(vec):
                num_z = prog.mac(num_z, bpows[i], v)
            num_z = prog.sub(num_z, sz)
            num_gz = prog.const(0)
            for i, v in enumerate(trow + erow + prow):
                num_gz = prog.mac(num_gz, bpows[w_z + i], v)
            num_gz = prog.sub(num_gz, sgz)
            x = _domain_x(prog, jbits, log_N, s_i)
            r = prog.add(
                prog.div(num_z, prog.sub(x, zeta)),
                prog.div(num_gz, prog.sub(x, g_zetas[cp.name])))
            # scale by the global β offset
            r = prog.mul(r, bpows[beta_off])
            scaled[log_N] = (prog.add(scaled[log_N], r)
                             if log_N in scaled else r)
            beta_off += w_z + w_gz
        # FRI walk
        v = prog.const(0)
        cur_bits = bits
        cur_shift = config.shift
        for ell, step in enumerate(mq.fri_steps):
            log_l = log_N_max - ell
            if log_l in scaled:
                v = prog.add(v, scaled[log_l])
            a_l = wit_many(step.pair[0].c)
            b_l = wit_many(step.pair[1].c)
            leaf = _leaf_hash24(prog, a_l + b_l)
            jbits = cur_bits[: log_l - 1]
            _verify_path_vm(prog, leaf, jbits,
                            [wit_many(h) for h in step.path],
                            fri_root_vals[ell])
            av = prog.combine4(a_l)
            bv = prog.combine4(b_l)
            top = cur_bits[log_l - 1]
            mine = prog.sel(top, bv, av)
            prog.assert_eq(mine, v)
            x_j = _domain_x(prog, jbits, log_l, cur_shift)
            half_sum = prog.mul(prog.add(av, bv), pow(2, P - 2, P))
            diff = prog.mul(prog.sub(av, bv), pow(2, P - 2, P))
            v = prog.mac(half_sum, fold_betas[ell],
                         prog.div(diff, x_j))
            cur_shift = cur_shift * cur_shift % P
            cur_bits = jbits
        # v == fri_final[qq]: qq = remaining bits select among final vals
        fv = _select_tree(prog, [c for _l, c in final_vals], cur_bits)
        prog.assert_eq(v, fv)

    # --- final-layer low-degree check (linear in the final values) ---
    _final_low_degree_vm(prog, [c for _l, c in final_vals], config,
                         n_layers)
    return prog.finalize()


def _ext_mul_limbs_vm(prog: Prog, a: list[Val], b: list[Val]) -> list[Val]:
    """Limb quadruple of the product of two base-limb quadruples (the
    quartic tower arithmetic, emitted as base ops)."""
    from ..ops.field_ref import W_EXT

    acc = [None] * 7
    for i in range(4):
        for j in range(4):
            if acc[i + j] is None:
                acc[i + j] = prog.mul(a[i], b[j])
            else:
                acc[i + j] = prog.mac(acc[i + j], a[i], b[j])
    out = []
    for k in range(4):
        v = acc[k]
        if k + 4 <= 6 and acc[k + 4] is not None:
            v = prog.mac(v, W_EXT, acc[k + 4])
        out.append(v)
    return out


def _select_tree(prog: Prog, vals: list[Val], bits: list[Val]) -> Val:
    """vals[j] for j = Σ bits_i·2^i — LSB-first adjacent-pair tree."""
    cur = list(vals)
    for b in bits:
        cur = [prog.sel(b, cur[2 * t + 1], cur[2 * t])
               for t in range(len(cur) // 2)]
        if len(cur) == 1:
            break
    return cur[0]


def _final_low_degree_vm(prog: Prog, vals: list[Val],
                         config: StarkConfig, n_layers: int) -> None:
    size = len(vals)
    log_size = size.bit_length() - 1
    shift = config.shift
    for _ in range(n_layers):
        shift = shift * shift % P
    w_f = two_adic_root(log_size)
    size_inv = pow(size, P - 2, P)
    w_inv = pow(w_f, P - 2, P)
    shift_inv = pow(shift, P - 2, P)
    max_deg = size // config.blowup
    _ = (size_inv, shift_inv)   # nonzero scales: coeff = 0 ⇔ acc = 0
    for k in range(max_deg, size):
        step = pow(w_inv, k, P)
        acc = prog.const(0)
        wk = 1
        for i in range(size):
            acc = prog.mac(acc, wk, vals[i])
            wk = wk * step % P
        prog.assert_zero(acc)


def _dummy_proof(airs, shape: MachineShape,
                 config: StarkConfig) -> MachineProof:
    """A zero-valued proof with the given shape (verifier-side program
    rebuild: values never affect the instruction stream)."""
    from .machine import ChipOpening, ChipProof, MachineQuery
    from .proof import FriStep

    air_by_name = {a.name: a for a in airs}
    chips = []
    for name, log_n, publics in shape.chips:
        air = air_by_name[name]
        ew = getattr(air, "preprocessed_width", 0)
        chips.append(ChipProof(
            name=name, log_n=log_n, publics=list(publics),
            bus_sum=[0, 0, 0, 0], trace_root=[0] * 8,
            quotient_root=[0] * 8,
            perm_root=[0] * 8 if air.perm_width else None,
            tl=[Fp4(0)] * air.width, tn=[Fp4(0)] * air.width,
            pl=[Fp4(0)] * air.perm_width,
            pn=[Fp4(0)] * air.perm_width,
            qe=[Fp4(0)] * (4 * config.blowup),
            el=[Fp4(0)] * ew, en=[Fp4(0)] * ew))
    log_N_max = shape.chips[0][1] + config.log_blowup
    queries = []
    for _ in range(config.num_queries):
        openings = []
        for name, log_n, _p in shape.chips:
            air = air_by_name[name]
            ew = getattr(air, "preprocessed_width", 0)
            log_N = log_n + config.log_blowup
            openings.append(ChipOpening(
                trace_row=[0] * air.width,
                trace_path=[[0] * 8] * log_N,
                quotient_row=[0] * (4 * config.blowup),
                quotient_path=[[0] * 8] * log_N,
                perm_row=[0] * air.perm_width,
                perm_path=([[0] * 8] * log_N if air.perm_width else []),
                pre_row=[0] * ew,
                pre_path=([[0] * 8] * log_N if ew else []),
            ))
        steps = []
        size = 1 << log_N_max
        ell = 0
        while size > config.fri_final_size:
            steps.append(FriStep(pair=(Fp4(0), Fp4(0)),
                                 path=[[0] * 8] * (log_N_max - ell - 1)))
            size //= 2
            ell += 1
        queries.append(MachineQuery(index=0, openings=openings,
                                    fri_steps=steps))
    return MachineProof(
        chips=chips, fri_roots=[[0] * 8] * shape.fri_roots,
        fri_final=[Fp4(0)] * shape.fri_final, pow_witness=0,
        queries=queries)


# ---------------------------------------------------------------------------
# prove / verify the recursion layer
# ---------------------------------------------------------------------------


def outer_airs() -> list[Air]:
    return [VmAir(), Sponge16Air(), Sponge24Air()]


@dataclass(frozen=True)
class RecursionVK:
    """The recursion verifying key: the inner shape plus the Merkle root
    of the VM chip's PREPROCESSED program matrix.  A pure function of
    (inner shape, message structure, configs) — never of session values —
    so it is computed once at setup (recursion_vk) and reused; the wrap
    circuit ultimately embeds exactly this root."""

    shape: MachineShape
    program_root: tuple
    n_instrs: int
    n_pubs: int

    def to_bytes(self) -> bytes:
        from ..core import cbor

        return cbor.dumps({
            "shape": self.shape.to_bytes(),
            "root": list(self.program_root),
            "ni": self.n_instrs, "np": self.n_pubs})

    @classmethod
    def from_bytes(cls, data: bytes) -> "RecursionVK":
        from ..core import cbor

        obj = cbor.loads(data)
        return cls(shape=MachineShape.from_bytes(obj["shape"]),
                   program_root=tuple(obj["root"]),
                   n_instrs=obj["ni"], n_pubs=obj["np"])


def _session_messages(shape: MachineShape, binding: bytes,
                      public_messages: list[tuple] | None,
                      preprocessed_roots: dict | None = None,
                      ) -> list[tuple]:
    """The verifier-side bus messages of the OUTER proof, computable in
    O(|binding| + |messages|) without touching the program: the
    challenger chain seed (the post-header sponge state) and one
    (BUS_VM_PUB, k, value) message per session input, in the exact order
    build_program emits PUB rows (header residues, then message payload
    values)."""
    pre = preprocessed_roots or {}
    hch = Challenger()
    _observe_header(POSEIDON2, hch, binding,
                    [(n, l, list(p), pre.get(n))
                     for n, l, p in shape.chips])
    pubs = [v % P for v in hch.input_buf]
    for entry in (public_messages or []):
        pubs.extend(int(v) % P for v in entry[1])
    msgs = [(BUS_SP16_CHAIN, [1, 1] + [v % P for v in hch.state], 1)]
    msgs += [(BUS_VM_PUB, [k, v], 1) for k, v in enumerate(pubs)]
    return msgs


def _outer_chips(prog: Prog):
    values = {idx: v.c for idx, v in prog.vals.items()}
    vtrace, _ = vm_trace(prog.instrs, values)
    chips = [ChipInstance(air=VmAir(), trace=vtrace, publics=[],
                          preprocessed=vm_preprocessed(prog.instrs))]
    for w, air in ((16, Sponge16Air()), (24, Sponge24Air())):
        rows = [r for r, _pos in prog.sp_rows[w]]
        # an unused width proves an all-dead trace (live = 0 everywhere;
        # the dead-row padding satisfies the chain discipline on its own)
        trace, _, _states = sponge_trace(air, rows)
        chips.append(ChipInstance(air=air, trace=trace, publics=[]))
    return chips


def _vk_from_prog(prog: Prog, shape: MachineShape,
                  outer_config: StarkConfig, device=None) -> RecursionVK:
    pre = vm_preprocessed(prog.instrs)
    log_n_vm = pre.shape[0].bit_length() - 1
    heights = [log_n_vm]
    for w, air in ((16, Sponge16Air()), (24, Sponge24Air())):
        n_real = max(len(prog.sp_rows[w]), 1)
        heights.append(max(4, (n_real - 1).bit_length()))
    root = preprocessed_root(VmAir(), pre, max(heights), log_n_vm,
                             outer_config, device=device)
    return RecursionVK(shape=shape, program_root=tuple(root),
                       n_instrs=len(prog.instrs),
                       n_pubs=len(prog.pub_values))


def recursion_vk(airs: list[Air], shape: MachineShape,
                 binding: bytes = b"",
                 public_message_structure: list[tuple] | None = None,
                 inner_config: StarkConfig = DEFAULT_CONFIG,
                 outer_config: StarkConfig | None = None,
                 inner_preprocessed_roots: dict | None = None,
                 device=None) -> RecursionVK:
    """Setup: build the (session-value-independent) program for this
    inner shape/message structure and commit it.  Session VALUES never
    reach the program (PUB rows); `binding` matters only through its
    LENGTH (it sets the header-residue pub count), so any representative
    binding of the session's journal length yields the same vk.
    device: where the program matrix is committed (`prove_machine`'s)."""
    prog = build_program(airs, shape, binding,
                         public_message_structure or [],
                         inner_config, proof=None,
                         preprocessed_roots=inner_preprocessed_roots)
    return _vk_from_prog(prog, shape, outer_config or inner_config,
                         device=device)


def trusted_vk(airs: list[Air], shape: MachineShape, binding: bytes,
               public_messages: list[tuple] | None = None,
               inner_config: StarkConfig = DEFAULT_CONFIG,
               outer_config: StarkConfig | None = None,
               cache_dir: str | None = None,
               inner_preprocessed_roots: dict | None = None,
               device=None) -> RecursionVK:
    """The VERIFIER's vk for this statement geometry, from a local trust
    cache: a prover-supplied program root is never trusted — the verifier
    derives the root itself once per (shape, message structure, configs,
    binding length) and caches it (the cache dir mirrors the reference's
    artifact cache `$HOME/.local/zktlsd`, utils.rs:23-30).  cache_dir:
    the cache directory (default `~/.local/zktlsd/vk`); device: where a
    missing root is derived."""
    import hashlib
    import os
    import pathlib

    h = hashlib.sha256()
    h.update(shape.to_bytes())
    h.update(len(binding).to_bytes(8, "big"))
    for name in sorted(inner_preprocessed_roots or {}):
        h.update(name.encode())
        h.update(repr(list(inner_preprocessed_roots[name])).encode())
    for entry in (public_messages or []):
        mult = entry[2] if len(entry) > 2 else -1
        h.update(b"%d:%d:%d;" % (entry[0], len(entry[1]), mult))
    for cfg in (inner_config, outer_config or inner_config):
        h.update(repr((cfg.log_blowup, cfg.num_queries, cfg.pow_bits,
                       cfg.shift, cfg.fri_final_size)).encode())
    key = h.hexdigest()
    base = pathlib.Path(cache_dir or os.path.join(
        os.path.expanduser("~"), ".local", "zktlsd", "vk"))
    path = base / f"rvk-{key}.bin"
    if path.exists():
        try:
            vk = RecursionVK.from_bytes(path.read_bytes())
            if vk.shape == shape:
                return vk
        except Exception:
            pass   # corrupt cache entry: rebuild below
    vk = recursion_vk(airs, shape, binding, public_messages,
                      inner_config, outer_config,
                      inner_preprocessed_roots=inner_preprocessed_roots,
                      device=device)
    try:
        base.mkdir(parents=True, exist_ok=True)
        path.write_bytes(vk.to_bytes())
    except OSError:
        pass   # read-only cache dir: still return the derived vk
    return vk


def recursion_prove(airs: list[Air], proof: MachineProof, binding: bytes,
                    public_messages: list[tuple] | None = None,
                    inner_config: StarkConfig = DEFAULT_CONFIG,
                    outer_config: StarkConfig | None = None,
                    timings: dict | None = None,
                    inner_preprocessed_roots: dict | None = None,
                    device=None, spill_bytes: float = SPILL_BYTES,
                    chunked_deep_bytes: float = CHUNKED_DEEP_BYTES):
    """Compress: prove "I verified this machine proof" as ONE machine
    proof over (VmAir, Sponge16Air, Sponge24Air) with the program in the
    VM chip's vk-committed preprocessed columns.  Returns
    (vk, outer_proof).

    The vk's program root is the VmAir preprocessed root the outer prove
    commits (the reference commits the program matrix a second time for
    it, through preprocessed_root, at the same coset: the same root).

    device, spill_bytes, chunked_deep_bytes: passed to `prove_machine`
    (the CUDA card by default).  timings: if given, receives the host
    seconds of `build_program` and `outer_chips` (VM and sponge traces),
    then the outer `prove_machine`'s stages."""
    shape = MachineShape.of(proof)
    with Stages(timings, "build_program") as stages:
        prog = build_program(airs, shape, binding,
                             public_messages or [], inner_config,
                             proof=proof,
                             preprocessed_roots=inner_preprocessed_roots)
        stages.next("outer_chips")
        chips = _outer_chips(prog)
    outer_binding = binding + shape.to_bytes()
    roots: dict = {}
    outer = prove_machine(
        chips, binding=outer_binding,
        config=outer_config or inner_config, device=device,
        timings=timings, spill_bytes=spill_bytes,
        chunked_deep_bytes=chunked_deep_bytes, vk_roots=roots)
    vk = RecursionVK(shape=shape, program_root=tuple(roots["VmAir"]),
                     n_instrs=len(prog.instrs), n_pubs=len(prog.pub_values))
    return vk, outer


@dataclass(frozen=True)
class RecursionVKBN:
    """Verifying key of a BN-committed (shrink) recursion layer: the
    inner shape, the MiMC root of the VM program matrix, and the inner
    machine's own preprocessed roots (pinned — they are program
    constants, so they are already inside program_root; carried here for
    the verifier's session-message derivation)."""

    shape: MachineShape
    program_root: int
    inner_preprocessed_roots: tuple   # ((name, (limb, …)), …)
    n_instrs: int
    n_pubs: int

    def to_bytes(self) -> bytes:
        from ..core import cbor

        return cbor.dumps({
            "shape": self.shape.to_bytes(),
            "root": int(self.program_root).to_bytes(32, "big"),
            "ipr": [[n, list(r)] for n, r in
                    self.inner_preprocessed_roots],
            "ni": self.n_instrs, "np": self.n_pubs})

    @classmethod
    def from_bytes(cls, data: bytes) -> "RecursionVKBN":
        from ..core import cbor

        obj = cbor.loads(data)
        return cls(shape=MachineShape.from_bytes(obj["shape"]),
                   program_root=int.from_bytes(obj["root"], "big"),
                   inner_preprocessed_roots=tuple(
                       (n, tuple(r)) for n, r in obj["ipr"]),
                   n_instrs=obj["ni"], n_pubs=obj["np"])


def recursion_prove_bn(airs: list[Air], proof: MachineProof,
                       binding: bytes,
                       public_messages: list[tuple] | None = None,
                       inner_config: StarkConfig = DEFAULT_CONFIG,
                       outer_config: StarkConfig | None = None,
                       inner_preprocessed_roots: dict | None = None,
                       timings: dict | None = None, device=None):
    """The SHRINK layer: same verifier-VM program as recursion_prove,
    but the outer machine commits with BN254/MiMC (stark/machine_bn.py)
    so the Groth16 wrap circuit can verify it cheaply.  The inner proof
    here is typically a compress-layer proof (VM + sponge chips, with
    the compress program root passed as inner_preprocessed_roots).
    Returns (RecursionVKBN, MachineProofBN).

    The vk's program root is the VmAir preprocessed root the outer prove
    commits (the reference commits the program matrix a second time for
    it, through preprocessed_root_bn, at the same coset: the same root).

    device: where the outer prove runs (`prove_machine`'s rule: the CUDA
    card by default).  timings: if given, receives the seconds of
    `build_program`, `outer_chips`, the outer `prove_machine_bn`'s stages,
    `mimc_s` and `prove_bn_s`."""
    from .machine_bn import prove_machine_bn

    shape = MachineShape.of(proof)
    with Stages(timings, "build_program") as stages:
        prog = build_program(airs, shape, binding,
                             public_messages or [], inner_config,
                             proof=proof,
                             preprocessed_roots=inner_preprocessed_roots)
        stages.next("outer_chips")
        chips = _outer_chips(prog)
    outer_binding = binding + shape.to_bytes()
    ocfg = outer_config or inner_config
    roots: dict = {}
    outer = prove_machine_bn(chips, binding=outer_binding, config=ocfg,
                             timings=timings, device=device, vk_roots=roots)
    vk = RecursionVKBN(
        shape=shape, program_root=roots["VmAir"],
        inner_preprocessed_roots=tuple(
            (n, tuple(r))
            for n, r in sorted((inner_preprocessed_roots or {}).items())),
        n_instrs=len(prog.instrs), n_pubs=len(prog.pub_values))
    return vk, outer


def recursion_verify_bn(vk: RecursionVKBN, outer_proof, binding: bytes,
                        public_messages: list[tuple] | None = None,
                        outer_config: StarkConfig = DEFAULT_CONFIG,
                        ) -> bool:
    """Verify a shrink-layer proof in O(outer proof): session messages
    are derived directly from (binding, messages, vk), the program root
    comes from the vk — exactly the computation the wrap circuit
    arithmetizes.  Host only."""
    from .machine_bn import verify_machine_bn

    msgs = _session_messages(vk.shape, binding, public_messages,
                             dict((n, list(r))
                                  for n, r in vk.inner_preprocessed_roots))
    outer_binding = binding + vk.shape.to_bytes()
    return verify_machine_bn(
        outer_airs(), outer_proof, binding=outer_binding,
        public_messages=msgs, config=outer_config,
        preprocessed_roots={"VmAir": vk.program_root})


def recursion_verify(airs: list[Air], shape, outer_proof: MachineProof,
                     binding: bytes,
                     public_messages: list[tuple] | None = None,
                     inner_config: StarkConfig = DEFAULT_CONFIG,
                     outer_config: StarkConfig | None = None,
                     inner_preprocessed_roots: dict | None = None,
                     device=None) -> bool:
    """Verify the compress layer.  `shape` may be a RecursionVK (fast
    path: O(outer proof) — the program is NEVER rebuilt, its commitment
    root comes from the vk) or a bare MachineShape (setup path: the
    program is rebuilt once to derive the vk, then verified the same
    way; device: where that rebuild commits the program)."""
    if isinstance(shape, RecursionVK):
        vk = shape
    else:
        vk = recursion_vk(airs, shape, binding, public_messages,
                          inner_config, outer_config,
                          inner_preprocessed_roots=inner_preprocessed_roots,
                          device=device)
    outer_binding = binding + vk.shape.to_bytes()
    msgs = _session_messages(vk.shape, binding, public_messages,
                             inner_preprocessed_roots)
    return verify_machine(
        outer_airs(), outer_proof, binding=outer_binding,
        public_messages=msgs,
        config=outer_config or inner_config,
        preprocessed_roots={"VmAir": list(vk.program_root)})
