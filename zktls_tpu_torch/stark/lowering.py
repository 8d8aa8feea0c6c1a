"""Constraint-VM lowering: AIR constraints → a level-batched instruction
tape, executed over the commitment domain with torch ops.

Port of zktls_tpu.stark.lowering.  The lowering is host-side and copied
as is: each AIR is lowered ONCE to

  * a table of used leaf columns (trace/next/perm/perm-next/selectors/
    periodic) gathered into a register file,
  * level-scheduled batches of field ops — all independent same-shape ops
    of a level execute as ONE vectorized gather→op→scatter over the whole
    evaluation block,
  * `mat_const` banks kept as single modular matmuls
    (ops.babybear.matmul_mod),
  * per-level FOLD steps that combine finished constraints with their
    α-power rows via a runtime-weight modular matmul.

The executor (`eval_quotient_vm`) walks that tape on tensors of the
device the LDE lives on: gather, op, scatter into the register file;
the same row-block rule as the reference bounds the register file.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..ops import babybear as bb
from ..ops import ext as ex
from ..ops.field_ref import P, Fp4
from ..utils.spans import span

__all__ = ["lower_air", "eval_quotient_vm", "row_block", "Plan"]

# leaf matrix kinds (U-region sources)
ONE, LOCAL, NEXT, PERM, PERMNEXT, SEL, PERIODIC, PRE, PRENEXT = range(9)
# SEL columns: 0=is_first_row, 1=is_last_row, 2=is_transition

_ADD, _SUB, _MUL, _NEG = "add", "sub", "mul", "neg"


class Sym:
    """A symbolic base-field value: a node id in the lowering context."""

    __slots__ = ("ctx", "nid")

    def __init__(self, ctx: "LoweringCtx", nid: int):
        self.ctx = ctx
        self.nid = nid

    def _coerce(self, o):
        if isinstance(o, Sym):
            return o.nid
        if isinstance(o, (int, np.integer)):
            return self.ctx.const(int(o))
        return None

    def __add__(self, o):
        b = self._coerce(o)
        if b is None:
            return NotImplemented
        return Sym(self.ctx, self.ctx.node(_ADD, self.nid, b))
    __radd__ = __add__

    def __sub__(self, o):
        b = self._coerce(o)
        if b is None:
            return NotImplemented
        return Sym(self.ctx, self.ctx.node(_SUB, self.nid, b))

    def __rsub__(self, o):
        b = self._coerce(o)
        if b is None:
            return NotImplemented
        return Sym(self.ctx, self.ctx.node(_SUB, b, self.nid))

    def __mul__(self, o):
        b = self._coerce(o)
        if b is None:
            return NotImplemented
        return Sym(self.ctx, self.ctx.node(_MUL, self.nid, b))
    __rmul__ = __mul__

    def __neg__(self):
        return Sym(self.ctx, self.ctx.node(_NEG, self.nid, self.nid))


class LoweringCtx:
    """Node table with hash-consing + constant folding."""

    def __init__(self):
        # node i: (op, a, b, aux); leaves: op in {"leaf","scalar","const"}
        self.ops: list[tuple] = []
        self.memo: dict = {}
        self.scalar_class: list[bool] = []   # per node
        self.const_val: list[int | None] = []
        self._one: int | None = None

    def _push(self, key, op, a, b, aux, scalar, cval=None) -> int:
        nid = len(self.ops)
        self.ops.append((op, a, b, aux))
        self.scalar_class.append(scalar)
        self.const_val.append(cval)
        self.memo[key] = nid
        return nid

    def leaf(self, mat: int, col: int) -> int:
        key = ("leaf", mat, col)
        if key in self.memo:
            return self.memo[key]
        return self._push(key, "leaf", 0, 0, (mat, col), False)

    def scalar(self, idx: int) -> int:
        key = ("scalar", idx)
        if key in self.memo:
            return self.memo[key]
        return self._push(key, "scalar", 0, 0, idx, True)

    def const(self, v: int) -> int:
        v = int(v) % P
        key = ("const", v)
        if key in self.memo:
            return self.memo[key]
        return self._push(key, "const", 0, 0, v, True, cval=v)

    def node(self, op: str, a: int, b: int) -> int:
        ca, cb = self.const_val[a], self.const_val[b]
        # constant folding
        if ca is not None and cb is not None:
            if op == _ADD:
                return self.const(ca + cb)
            if op == _SUB:
                return self.const(ca - cb)
            if op == _MUL:
                return self.const(ca * cb)
            if op == _NEG:
                return self.const(-ca)
        # identity peepholes (masks like [1]*29+[0]*3 hit these heavily)
        if op == _ADD:
            if ca == 0:
                return b
            if cb == 0:
                return a
        elif op == _SUB:
            if cb == 0:
                return a
        elif op == _MUL:
            if ca == 0 or cb == 0:
                return self.const(0)
            if ca == 1:
                return b
            if cb == 1:
                return a
        if op in (_ADD, _MUL) and a > b:
            a, b = b, a                      # canonicalize commutative keys
        key = (op, a, b)
        if key in self.memo:
            return self.memo[key]
        scalar = self.scalar_class[a] and self.scalar_class[b]
        return self._push(key, op, a, b, None, scalar)

    def one_leaf(self) -> int:
        if self._one is None:
            self._one = self.leaf(ONE, 0)
        return self._one

    def matmul(self, items: Sequence[Sym], weights_2d) -> list[Sym]:
        w = np.asarray(weights_2d, dtype=object)
        if w.ndim != 2:
            raise ValueError("mat_const weights must be 2-D")
        k, m = w.shape
        if k != len(items):
            raise ValueError(
                f"mat_const: {len(items)} items vs {k} weight rows")
        ids = [it.nid if isinstance(it, Sym) else self.const(int(it))
               for it in items]
        if all(self.scalar_class[i] for i in ids):
            # scalar-only group: plain expression dots (host-evaluated)
            outs = []
            for j in range(m):
                acc = self.const(0)
                for i in range(k):
                    t = self.node(_MUL, ids[i], self.const(int(w[i, j])))
                    acc = self.node(_ADD, acc, t)
                outs.append(Sym(self, acc))
            return outs
        # materialize scalar lanes as columns via the ONE leaf
        col_ids = [i if not self.scalar_class[i]
                   else self.node(_MUL, self.one_leaf(), i) for i in ids]
        w_u32 = np.array([[int(x) % P for x in row] for row in w],
                         dtype=np.uint32)
        key = ("matmul", tuple(col_ids), w_u32.tobytes())
        if key in self.memo:
            mm = self.memo[key]
        else:
            mm = self._push(key, "matmul", 0, 0,
                            (tuple(col_ids), w_u32), False)
        outs = []
        for j in range(m):
            okey = ("mmout", mm, j)
            if okey in self.memo:
                oid = self.memo[okey]
            else:
                oid = self._push(okey, "mmout", mm, 0, j, False)
            outs.append(Sym(self, oid))
        return outs


# ---------------------------------------------------------------------------
# plan: the executable schedule
# ---------------------------------------------------------------------------


@dataclass
class OpBatch:
    op: str                 # add/sub/mul/neg
    a_ref: np.ndarray       # (L,) combined-register indices
    b_ref: np.ndarray | None    # (L,) register indices (RR) or None
    b_scal: np.ndarray | None   # (L,) scalar-table indices (RS/SR) or None
    scalar_left: bool       # SR pattern (sub only)
    out_slot: np.ndarray    # (L,) slot indices (0-based in slot region)


@dataclass
class MatmulBatch:
    in_ref: np.ndarray      # (k,) combined-register indices
    weights: np.ndarray     # (k, m) plain uint32
    out_slot: np.ndarray    # (m,)


@dataclass
class FoldBatch:
    slot_ref: np.ndarray    # (K,) combined-register indices
    apow_idx: np.ndarray    # (K,) constraint indices


@dataclass
class Plan:
    # leaf gather index arrays (into source matrices), defining U layout
    local_idx: np.ndarray
    next_idx: np.ndarray
    perm_idx: np.ndarray
    permnext_idx: np.ndarray
    sel_idx: np.ndarray       # subset of {0,1,2}
    periodic_idx: np.ndarray
    pre_idx: np.ndarray
    prenext_idx: np.ndarray
    has_one: bool
    w_u: int
    n_slots: int
    batches: list             # OpBatch | MatmulBatch | FoldBatch
    scalar_prog: list         # [(op, a, b, aux)] over scalar ids, topo order
    scalar_slot: dict         # node id -> scalar table position
    n_scalars: int
    n_constraints: int
    const_folds: list         # [(constraint_idx, scalar_table_pos_or_const)]
    #: folds that are scalar-class: (cidx, scalar-node id)
    max_matmul_k: int = 0


def _trace_air(air, n_public: int, n_challenges: int):
    """Run air.eval with the symbolic backend; returns (ctx, folds)."""
    from .air import AirBuilder, ScalarVec
    from .ext_val import ExtVal

    ctx = LoweringCtx()
    n_periodic = len(air.periodic_columns())

    # scalar table layout: publics [0, n_public) then challenge limbs
    publics = [Sym(ctx, ctx.scalar(i)) for i in range(n_public)]
    chals = [ExtVal(*[Sym(ctx, ctx.scalar(n_public + 4 * c + ell))
                      for ell in range(4)])
             for c in range(n_challenges)]

    local = [Sym(ctx, ctx.leaf(LOCAL, j)) for j in range(air.width)]
    nxt = [Sym(ctx, ctx.leaf(NEXT, j)) for j in range(air.width)]
    perm_local = [Sym(ctx, ctx.leaf(PERM, j)) for j in range(air.perm_width)]
    perm_next = [Sym(ctx, ctx.leaf(PERMNEXT, j))
                 for j in range(air.perm_width)]
    periodic = [Sym(ctx, ctx.leaf(PERIODIC, i)) for i in range(n_periodic)]
    pre_w = getattr(air, "preprocessed_width", 0)
    pre_local = [Sym(ctx, ctx.leaf(PRE, j)) for j in range(pre_w)]
    pre_next = [Sym(ctx, ctx.leaf(PRENEXT, j)) for j in range(pre_w)]

    folds: list[int] = []

    def fold(expr):
        if isinstance(expr, Sym):
            folds.append(expr.nid)
        elif isinstance(expr, int):
            folds.append(ctx.const(expr))
        else:
            raise TypeError(f"cannot fold {type(expr)}")

    def fold_vec(expr):
        for e in expr.items:
            fold(e)

    def group(seq, sl):
        return ScalarVec(list(seq)[sl])

    def const_vec(values):
        return ScalarVec(Sym(ctx, ctx.const(int(v))) for v in values)

    def dot_const(g, weights):
        return ctx.matmul(list(g.items),
                          [[int(w)] for w in weights])[0]

    def mat_const(g, weights_2d):
        return ScalarVec(ctx.matmul(list(g.items), weights_2d))

    builder = AirBuilder(
        local=local, next=nxt, public=publics,
        is_first_row=Sym(ctx, ctx.leaf(SEL, 0)),
        is_last_row=Sym(ctx, ctx.leaf(SEL, 1)),
        is_transition=Sym(ctx, ctx.leaf(SEL, 2)),
        _fold=fold,
        periodic=periodic,
        perm_local=perm_local,
        perm_next=perm_next,
        challenges=chals,
        pre_local=pre_local,
        pre_next=pre_next,
        _fold_vec=fold_vec, _group=group, _const_vec=const_vec,
        _dot_const=dot_const, _mat_const=mat_const,
    )
    air.eval(builder)
    return ctx, folds


def _build_plan(ctx: LoweringCtx, folds: list[int]) -> Plan:
    ops = ctx.ops
    n = len(ops)
    sc = ctx.scalar_class

    # reachability from folds
    needed = np.zeros(n, dtype=bool)
    stack = list(dict.fromkeys(folds))
    while stack:
        i = stack.pop()
        if needed[i]:
            continue
        needed[i] = True
        op, a, b, aux = ops[i]
        if op in (_ADD, _SUB, _MUL):
            stack.append(a)
            stack.append(b)
        elif op == _NEG:
            stack.append(a)
        elif op == "matmul":
            stack.extend(aux[0])
        elif op == "mmout":
            stack.append(a)

    # scalar program (host-evaluated): topo order = node id order
    scalar_slot: dict[int, int] = {}
    scalar_prog: list[tuple] = []
    for i in range(n):
        if not needed[i] or not sc[i]:
            continue
        op, a, b, aux = ops[i]
        scalar_slot[i] = len(scalar_slot)
        scalar_prog.append((op, scalar_slot.get(a, -1),
                            scalar_slot.get(b, -1), aux))

    # levels for column-class nodes
    level = np.zeros(n, dtype=np.int32)
    used_leaves: dict[tuple, bool] = {}
    for i in range(n):
        if not needed[i] or sc[i]:
            continue
        op, a, b, aux = ops[i]
        if op == "leaf":
            used_leaves[aux] = True
            level[i] = 0
        elif op in (_ADD, _SUB, _MUL):
            la = level[a] if not sc[a] else 0
            lb = level[b] if not sc[b] else 0
            level[i] = 1 + max(la, lb)
        elif op == _NEG:
            level[i] = 1 + (level[a] if not sc[a] else 0)
        elif op == "matmul":
            level[i] = 1 + max((level[j] if not sc[j] else 0)
                               for j in aux[0])
        elif op == "mmout":
            level[i] = level[a]

    # U layout: ONE + used leaves grouped by matrix kind
    def kind_cols(kind):
        return sorted(c for (k, c) in used_leaves if k == kind)

    has_one = (ONE, 0) in used_leaves
    local_idx = np.array(kind_cols(LOCAL), dtype=np.int32)
    next_idx = np.array(kind_cols(NEXT), dtype=np.int32)
    perm_idx = np.array(kind_cols(PERM), dtype=np.int32)
    permnext_idx = np.array(kind_cols(PERMNEXT), dtype=np.int32)
    sel_idx = np.array(kind_cols(SEL), dtype=np.int32)
    periodic_idx = np.array(kind_cols(PERIODIC), dtype=np.int32)
    pre_idx = np.array(kind_cols(PRE), dtype=np.int32)
    prenext_idx = np.array(kind_cols(PRENEXT), dtype=np.int32)

    u_pos: dict[tuple, int] = {}
    pos = 0
    if has_one:
        u_pos[(ONE, 0)] = pos
        pos += 1
    for kind, idx in ((LOCAL, local_idx), (NEXT, next_idx),
                      (PERM, perm_idx), (PERMNEXT, permnext_idx),
                      (SEL, sel_idx), (PERIODIC, periodic_idx),
                      (PRE, pre_idx), (PRENEXT, prenext_idx)):
        for c in idx:
            u_pos[(kind, int(c))] = pos
            pos += 1
    w_u = pos

    # group column nodes into batches by (level, kind)
    by_level: dict[int, dict, ] = {}
    max_level = 0
    col_nodes = []
    for i in range(n):
        if not needed[i] or sc[i]:
            continue
        op = ops[i][0]
        if op in ("leaf", "mmout"):
            continue
        col_nodes.append(i)
        max_level = max(max_level, int(level[i]))

    # fold level: column folds fold at their producing level; scalar folds
    # fold into the host constant
    const_folds: list[tuple[int, int]] = []
    fold_by_level: dict[int, list[tuple[int, int]]] = {}
    for cidx, nid in enumerate(folds):
        if sc[nid]:
            const_folds.append((cidx, nid))
        else:
            lv = int(level[nid])
            if ops[nid][0] == "mmout":
                lv = int(level[ops[nid][1]])
            fold_by_level.setdefault(lv, []).append((cidx, nid))

    # emit batches level by level
    raw_batches: list[tuple] = []    # ("op",op,pattern,[(nid,a,b)]) etc.
    for lv in range(1, max_level + 1):
        groups: dict[tuple, list] = {}
        mms: list[int] = []
        for i in col_nodes:
            if level[i] != lv:
                continue
            op, a, b, aux = ops[i]
            if op == "matmul":
                mms.append(i)
                continue
            if op == _NEG:
                groups.setdefault((_NEG, "R"), []).append((i, a, -1))
                continue
            a_s, b_s = sc[a], sc[b]
            if op in (_ADD, _MUL) and a_s:
                a, b = b, a
                a_s, b_s = b_s, a_s
            if a_s and b_s:
                raise AssertionError("scalar-scalar op classified as column")
            if a_s:   # sub only: scalar-left
                groups.setdefault((op, "SR"), []).append((i, b, a))
            elif b_s:
                groups.setdefault((op, "RS"), []).append((i, a, b))
            else:
                groups.setdefault((op, "RR"), []).append((i, a, b))
        for key in sorted(groups):
            raw_batches.append(("op", key[0], key[1], groups[key]))
        for mm in sorted(mms):
            raw_batches.append(("matmul", mm))
        if lv in fold_by_level:
            # chunk folds so the runtime matmul stays int32-exact
            items = fold_by_level[lv]
            for k0 in range(0, len(items), 8192):
                raw_batches.append(("fold", items[k0 : k0 + 8192]))
    # level-0 folds (a fold of a bare leaf column)
    if 0 in fold_by_level:
        raw_batches.append(("fold", fold_by_level[0]))

    # last-use batch per node (for slot liveness)
    last_use: dict[int, int] = {}
    for bi, rb in enumerate(raw_batches):
        if rb[0] == "op":
            for (i, a, b) in rb[3]:
                if not sc[a] and ops[a][0] != "leaf":
                    last_use[a] = bi
                if rb[2] == "RR" and b >= 0 and not sc[b] \
                        and ops[b][0] != "leaf":
                    last_use[b] = bi
        elif rb[0] == "matmul":
            mm = rb[1]
            for j in ops[mm][3][0]:
                if not sc[j] and ops[j][0] != "leaf":
                    last_use[j] = bi
        else:
            for (cidx, nid) in rb[1]:
                last_use[nid] = bi

    # slot allocation
    slot_of: dict[int, int] = {}
    free: list[int] = []
    n_slots = 0
    expiry: dict[int, list[int]] = {}

    def alloc(nid: int, cur_bi: int) -> int:
        nonlocal n_slots
        if free:
            s = free.pop()
        else:
            s = n_slots
            n_slots += 1
        slot_of[nid] = s
        # a slot is freed AFTER the batch of its last use completes; a
        # never-consumed output (dead matmul lane) dies with its own batch
        bi = last_use.get(nid, cur_bi)
        expiry.setdefault(bi, []).append(s)
        return s

    def ref(nid: int) -> int:
        op = ops[nid][0]
        if op == "leaf":
            return u_pos[ops[nid][3]]
        return w_u + slot_of[nid]

    max_mm_k = 0
    batches: list = []
    for bi, rb in enumerate(raw_batches):
        if rb[0] == "op":
            _, op, pat, items = rb
            a_ref = np.array([ref(a) for (_, a, _) in items],
                             dtype=np.int32)
            if pat == "RR":
                b_ref = np.array([ref(b) for (_, _, b) in items],
                                 dtype=np.int32)
                b_scal = None
            elif pat == "R":
                b_ref = None
                b_scal = None
            else:
                b_ref = None
                b_scal = np.array([scalar_slot[b] for (_, _, b) in items],
                                  dtype=np.int32)
            out = np.array([alloc(i, bi) for (i, _, _) in items],
                           dtype=np.int32)
            batches.append(OpBatch(op=op, a_ref=a_ref, b_ref=b_ref,
                                   b_scal=b_scal, scalar_left=(pat == "SR"),
                                   out_slot=out))
        elif rb[0] == "matmul":
            mm = rb[1]
            in_ids, w_arr = ops[mm][3]
            in_ref = np.array([ref(j) for j in in_ids], dtype=np.int32)
            max_mm_k = max(max_mm_k, len(in_ids))
            # allocate slots for each mmout of this matmul
            outs = []
            m = w_arr.shape[1]
            for j in range(m):
                okey = ("mmout", mm, j)
                oid = ctx.memo.get(okey)
                if oid is not None and needed[oid]:
                    outs.append(alloc(oid, bi))
                else:
                    outs.append(alloc(-mm * 10000 - j - 2, bi))  # dead lane
            batches.append(MatmulBatch(in_ref=in_ref, weights=w_arr,
                                       out_slot=np.array(outs,
                                                         dtype=np.int32)))
        else:
            items = rb[1]
            slot_ref = np.array([ref(nid) for (_, nid) in items],
                                dtype=np.int32)
            apow_idx = np.array([cidx for (cidx, _) in items],
                                dtype=np.int32)
            batches.append(FoldBatch(slot_ref=slot_ref, apow_idx=apow_idx))
        for s in expiry.get(bi, ()):
            free.append(s)

    return Plan(
        local_idx=local_idx, next_idx=next_idx, perm_idx=perm_idx,
        permnext_idx=permnext_idx, sel_idx=sel_idx,
        periodic_idx=periodic_idx, pre_idx=pre_idx,
        prenext_idx=prenext_idx, has_one=has_one, w_u=w_u,
        n_slots=n_slots, batches=batches, scalar_prog=scalar_prog,
        scalar_slot=scalar_slot, n_scalars=len(scalar_prog),
        n_constraints=len(folds), const_folds=const_folds,
        max_matmul_k=max_mm_k,
    )


_PLAN_CACHE: dict[tuple, Plan] = {}


def lower_air(air, n_public: int, n_challenges: int) -> Plan:
    """Lower an AIR to its constraint-VM plan (cached by chip name +
    public/challenge arity — chip names uniquely determine constraints)."""
    key = (air.name, n_public, n_challenges)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        with span(f"zktls.lower_air:{air.name}"):
            ctx, folds = _trace_air(air, n_public, n_challenges)
            plan = _build_plan(ctx, folds)
        _PLAN_CACHE[key] = plan
    return plan


# ---------------------------------------------------------------------------
# prove-time execution
# ---------------------------------------------------------------------------


def _eval_scalars(plan: Plan, publics: list[int],
                  challenges: list) -> np.ndarray:
    """Evaluate the scalar program with plain Python ints mod P.
    Scalar leaves: publics then challenge limbs."""
    limbs: list[int] = []
    for c in challenges:
        limbs.extend(int(x) for x in
                     (c.c if isinstance(c, Fp4) else c))
    table = [0] * plan.n_scalars
    for pos, (op, a, b, aux) in enumerate(plan.scalar_prog):
        if op == "scalar":
            i = aux
            table[pos] = (publics[i] if i < len(publics)
                          else limbs[i - len(publics)]) % P
        elif op == "const":
            table[pos] = aux
        elif op == _ADD:
            table[pos] = (table[a] + table[b]) % P
        elif op == _SUB:
            table[pos] = (table[a] - table[b]) % P
        elif op == _MUL:
            table[pos] = (table[a] * table[b]) % P
        elif op == _NEG:
            table[pos] = (-table[a]) % P
        else:  # pragma: no cover
            raise AssertionError(f"scalar op {op}")
    return np.array(table, dtype=np.uint32)


def _plan_tensors(plan: Plan, device: torch.device) -> list:
    """The plan's index arrays as int64 tensors on `device`, one entry per
    batch (built per call; the tape holds a few hundred small arrays)."""
    def t(a):
        return None if a is None else torch.from_numpy(
            a.astype(np.int64)).to(device)

    out = []
    for batch in plan.batches:
        if isinstance(batch, OpBatch):
            out.append((t(batch.a_ref), t(batch.b_ref), t(batch.b_scal),
                        t(plan.w_u + batch.out_slot)))
        elif isinstance(batch, MatmulBatch):
            out.append((t(batch.in_ref), torch.from_numpy(
                batch.weights.astype(np.int64)).to(device),
                t(plan.w_u + batch.out_slot)))
        else:
            out.append((t(batch.slot_ref), t(batch.apow_idx)))
    return out


def _eval_block(plan: Plan, idx: list, leaves: list, s_mont, apow_plain,
                acc0):
    """One row block of the VM: build the register file from the leaf
    blocks, run the tape, return the (B, 4) Montgomery accumulator."""
    B = leaves[0].shape[0]
    dev = leaves[0].device
    parts = []
    if plan.has_one:
        parts.append(torch.full((B, 1), bb.MONT_R, dtype=bb.DTYPE,
                                device=dev))
    for blk, cols in zip(leaves, (plan.local_idx, plan.next_idx,
                                  plan.perm_idx, plan.permnext_idx,
                                  plan.sel_idx, plan.periodic_idx,
                                  plan.pre_idx, plan.prenext_idx)):
        if cols.size:
            parts.append(blk[:, torch.from_numpy(cols.astype(np.int64))
                             .to(dev)])
    if plan.n_slots:
        parts.append(torch.zeros((B, plan.n_slots), dtype=bb.DTYPE,
                                 device=dev))
    regs = torch.cat(parts, dim=1)
    acc = acc0[None, :].expand(B, 4)

    for batch, ix in zip(plan.batches, idx):
        if isinstance(batch, OpBatch):
            a_ref, b_ref, b_scal, out_cols = ix
            a = regs[:, a_ref]
            if b_ref is not None:
                b = regs[:, b_ref]
            elif b_scal is not None:
                b = s_mont[b_scal][None, :]
            else:
                b = None
            if batch.op == _ADD:
                out = bb.add(a, b)
            elif batch.op == _MUL:
                out = bb.mul(a, b)
            elif batch.op == _SUB:
                out = bb.sub(b, a) if batch.scalar_left else bb.sub(a, b)
            else:
                out = bb.neg(a)
            regs[:, out_cols] = out
        elif isinstance(batch, MatmulBatch):
            in_ref, weights, out_cols = ix
            regs[:, out_cols] = bb.matmul_mod_rt(regs[:, in_ref], weights)
        else:  # FoldBatch
            slot_ref, apow_idx = ix
            acc = ex.ext_add(acc, bb.matmul_mod_rt(regs[:, slot_ref],
                                                   apow_plain[apow_idx]))
    return acc


def row_block(mat: torch.Tensor, start: int, rows: int,
              device: torch.device) -> torch.Tensor:
    """Rows [start, start + rows) of `mat`, cyclically (row N is row 0), as
    a field tensor on `device`.  `mat` may be resident or spilled to the
    host (machine.py keeps large matrices there as int32)."""
    N = mat.shape[0]
    start %= N
    if start + rows <= N:
        blk = mat[start:start + rows]
    else:
        blk = torch.cat([mat[start:], mat[:start + rows - N]], dim=0)
    return blk.to(device=device, dtype=bb.DTYPE, non_blocking=True)


def eval_quotient_vm(air, lde, perm_lde, challenges, publics_full,
                     apow_plain: np.ndarray, sels_m: dict, inv_zh_m,
                     periodic_stack, log_blowup: int, pre_lde=None):
    """Evaluate all constraints over the commit domain via the constraint
    VM, fold with α powers, divide by Z_H.  Returns (N, 4) Montgomery
    quotient values on the selectors' device.

    The trace, perm and preprocessed LDEs are read in row blocks (each
    block with its next-row block, the rows `blowup` further on), so they
    may live on the host (spilled) while the VM runs on the card.

    apow_plain: (n_constraints, 4) PLAIN-form α powers (the VM folds with
    a modular matmul whose weight side is plain)."""
    plan = lower_air(air, len(publics_full), len(challenges))
    if apow_plain.shape[0] != max(plan.n_constraints, 1):
        raise AssertionError(
            f"{air.name}: apow rows {apow_plain.shape[0]} != "
            f"constraint count {plan.n_constraints}")
    dev = inv_zh_m.device
    s_table = _eval_scalars(plan, [int(v) % P for v in publics_full],
                            challenges)
    s_mont = bb.from_numpy(bb.np_to_mont(s_table), dev)

    # host fold of scalar-only constraints → constant acc seed
    acc0 = Fp4(0)
    for (cidx, nid) in plan.const_folds:
        pos = plan.scalar_slot[nid]
        acc0 = acc0 + Fp4(*[int(x) for x in apow_plain[cidx]]) \
            * int(s_table[pos])
    acc0_m = bb.from_numpy(bb.np_to_mont(np.array(acc0.c, dtype=np.uint32)),
                           dev)

    N = lde.shape[0]
    shift = 1 << log_blowup
    if pre_lde is None:
        pre_lde = torch.zeros((N, 0), dtype=bb.DTYPE, device=dev)
    sels_full = torch.stack(
        [sels_m["is_first_row"], sels_m["is_last_row"],
         sels_m["is_transition"]], dim=1)                   # (N, 3)
    periodic_full = periodic_stack.T                        # (N, n_per)

    # block size: keep the register file ≲ 2^28 entries (on the CPU,
    # ≲ bb.CPU_BLOCK_BYTES)
    width = plan.w_u + plan.n_slots + 8
    limit = 1 << 30 if dev.type != "cpu" else bb.CPU_BLOCK_BYTES
    B = N
    while B > 8192 and B * width * 4 > limit:
        B //= 2

    idx = _plan_tensors(plan, dev)
    apow_t = bb.from_numpy(apow_plain, dev)
    accs = []
    for r0 in range(0, N, B):
        rows = slice(r0, r0 + B)
        leaves = [row_block(lde, r0, B, dev),
                  row_block(lde, r0 + shift, B, dev),
                  row_block(perm_lde, r0, B, dev),
                  row_block(perm_lde, r0 + shift, B, dev),
                  sels_full[rows], periodic_full[rows],
                  row_block(pre_lde, r0, B, dev),
                  row_block(pre_lde, r0 + shift, B, dev)]
        accs.append(_eval_block(plan, idx, leaves, s_mont, apow_t, acc0_m))
    acc = torch.cat(accs, dim=0)
    return ex.ext_scale(acc, inv_zh_m)
