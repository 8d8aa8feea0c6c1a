"""AIR (algebraic intermediate representation) abstraction.

Port copy of zktls_tpu.stark.air.  An AIR describes one
table ("chip"): its column count and a polynomial constraint evaluator
written once and executed over several algebras:

  * prover: symbolic values (stark/lowering.py) — the constraints are
    lowered once to a constraint-VM plan that the prover runs on tensors;
  * verifier: values are host `Fp4` scalars at the out-of-domain point ζ —
    the same Python constraint code re-evaluates the fold for the DEEP-ALI
    consistency check.

(The reference's `BBCol` tensor algebra served only its direct-eval
quotient path, which the port does not carry.)

Constraint selectors follow the Lagrange-selector scheme: the AIR multiplies
each constraint by `is_first_row` = Z_H(x)/(x−s), `is_last_row` =
Z_H(x)/(x−s·g^{n−1}) or `is_transition` = (x − s·g^{n−1}), and the prover
divides the folded sum by Z_H(x) = x^n − s^n once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

from ..ops import babybear as bb
from ..ops.field_ref import Fp4

__all__ = ["Air", "AirBuilder", "ScalarVec", "scalar_vec_hooks"]


class ScalarVec:
    """A column group on a scalar backend: a list of algebra elements (Fp4
    at ζ, symbolic values in the lowering) with elementwise, roll and
    indexing operators."""

    __slots__ = ("items",)

    def __init__(self, items):
        self.items = list(items)

    def _pair(self, o):
        if isinstance(o, ScalarVec):
            if len(o.items) != len(self.items):
                raise ValueError("group width mismatch")
            return o.items
        return [o] * len(self.items)

    def __add__(self, o):
        return ScalarVec(a + b_ for a, b_ in zip(self.items, self._pair(o)))
    __radd__ = __add__

    def __sub__(self, o):
        return ScalarVec(a - b_ for a, b_ in zip(self.items, self._pair(o)))

    def __rsub__(self, o):
        return ScalarVec(b_ - a for a, b_ in zip(self.items, self._pair(o)))

    def __mul__(self, o):
        return ScalarVec(a * b_ for a, b_ in zip(self.items, self._pair(o)))
    __rmul__ = __mul__

    def __neg__(self):
        return ScalarVec(-a for a in self.items)

    def roll(self, shift: int) -> "ScalarVec":
        k = len(self.items)
        return ScalarVec(self.items[(i - shift) % k] for i in range(k))

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return ScalarVec(self.items[idx])
        return self.items[idx]

    def __len__(self):
        return len(self.items)


@dataclass
class AirBuilder:
    """The evaluation context handed to Air.eval.

    All members are algebra values (symbolic in the lowering, Fp4 on the
    verifier); `assert_zero` folds α^i · expr into the accumulator via the
    injected fold function.  `periodic` holds the evaluations of the AIR's
    declared periodic columns (period-m patterns like SHA-256 round
    constants — untrusted commitment is unnecessary because the verifier
    evaluates the degree-<m interpolant itself at ζ^{n/m}).
    """

    local: Sequence[Any]
    next: Sequence[Any]
    public: Sequence[Any]
    is_first_row: Any
    is_last_row: Any
    is_transition: Any
    _fold: Callable[[Any], None]
    periodic: Sequence[Any] = ()
    #: LogUp permutation columns (second commitment round) + the lookup
    #: challenges sampled between the two rounds
    perm_local: Sequence[Any] = ()
    perm_next: Sequence[Any] = ()
    challenges: Sequence[Any] = ()
    #: preprocessed (fixed) columns: committed once at setup, root carried
    #: in the verifying key rather than the proof — the machine equivalent
    #: of Plonky3 preprocessed traces.  The recursion VM keeps its PROGRAM
    #: here, making outer verification O(queries), not O(program).
    pre_local: Sequence[Any] = ()
    pre_next: Sequence[Any] = ()
    constraint_count: int = 0
    #: vector-API hooks, injected per backend (None = scalar fallback)
    _fold_vec: Callable[[Any], None] | None = None
    _group: Callable[[Sequence[Any], slice], Any] | None = None
    _const_vec: Callable[[Sequence[int]], Any] | None = None
    _dot_const: Callable[[Any, Sequence[int]], Any] | None = None
    _mat_const: Callable[[Any, Any], Any] | None = None

    def assert_zero(self, expr) -> None:
        self._fold(expr)
        self.constraint_count += 1

    def assert_eq(self, a, b) -> None:
        self.assert_zero(a - b)

    def assert_bool(self, a) -> None:
        self.assert_zero(a * (a - 1))

    def when_first_row(self, expr) -> None:
        self.assert_zero(self.is_first_row * expr)

    def when_last_row(self, expr) -> None:
        self.assert_zero(self.is_last_row * expr)

    def when_transition(self, expr) -> None:
        self.assert_zero(self.is_transition * expr)

    # -- vector API: whole constraint groups folded at once --------------

    def local_group(self, sl: slice):
        """The local-row columns sl as one group value (a ScalarVec)."""
        return self._group(self.local, sl)

    def next_group(self, sl: slice):
        return self._group(self.next, sl)

    def pre_group(self, sl: slice, nxt: bool = False):
        """Preprocessed columns sl as one group value."""
        return self._group(self.pre_next if nxt else self.pre_local, sl)

    def const_vec(self, values: Sequence[int]):
        """A constant row-vector group (e.g. masks, powers of two)."""
        return self._const_vec(values)

    def dot_const(self, group, weights: Sequence[int]):
        """Linear combination along the group axis with constant integer
        weights — the limb-packing primitive Σᵢ gᵢ·wᵢ."""
        return self._dot_const(group, weights)

    def mat_const(self, group, weights_2d):
        """Constant-matrix product along the group axis: (N, k) group ×
        (k, m) integer weights → (N, m) group.  The prover lowers this to
        ONE exact Baby-Bear matmul (ops.babybear.matmul_mod), so banks of
        constant-weight dots cost one int8 matrix product instead of
        thousands of elementwise ops."""
        return self._mat_const(group, weights_2d)

    def assert_zero_vec(self, expr, count: int) -> None:
        """Fold `count` constraints (one per group lane) with consecutive
        challenge powers in a single matrix operation."""
        self._fold_vec(expr)
        self.constraint_count += count

    # -- extension-valued constraints (LogUp columns) --------------------

    def perm_group(self, sl: slice, nxt: bool = False):
        """Permutation-trace columns sl as one group value — supports
        strided slices, e.g. limb ℓ of every committed extension element
        via slice(ℓ, 4k, 4).  Lets chips with many lookups evaluate all
        their inverse checks as a handful of wide vector ops."""
        src = self.perm_next if nxt else self.perm_local
        return self._group(src, sl)

    def perm_ext_group(self, count: int, nxt: bool = False):
        """The first `count` committed extension elements as ONE ExtVal
        whose limbs are (N, count) groups — the vectorized counterpart of
        perm_ext for chips that check many inverses with one expression."""
        from .ext_val import ExtVal

        return ExtVal(*[self.perm_group(slice(ell, 4 * count, 4), nxt=nxt)
                        for ell in range(4)])

    def perm_ext(self, i: int, nxt: bool = False):
        """The i-th extension element of the permutation trace (4 base
        columns [4i, 4i+4)) as an ExtVal."""
        from .ext_val import ExtVal

        src = self.perm_next if nxt else self.perm_local
        return ExtVal(*src[4 * i : 4 * i + 4])

    def assert_ext_zero(self, ev) -> None:
        """Assert an extension-field expression vanishes (4 limb folds)."""
        for limb in ev.limbs():
            self.assert_zero(limb)


class Air:
    """Base class for chips.  Subclasses set `width` (trace columns),
    `num_public` and implement eval(builder)."""

    width: int = 0
    num_public: int = 0
    #: fixed-column count: a chip with preprocessed_width > 0 is
    #: instantiated with a setup-time matrix whose Merkle root lives in
    #: the verifying key (machine.py prove/verify take it separately)
    preprocessed_width: int = 0
    #: max total degree of any asserted expression in the trace values
    #: (selector multipliers included).  Bounds the quotient degree; the
    #: prover checks it fits the configured blowup.
    max_constraint_degree: int = 3
    #: LogUp support: base-column count of the permutation trace (a multiple
    #: of 4 — extension elements) and how many challenges to sample between
    #: the main and permutation commitment rounds.
    perm_width: int = 0
    num_perm_challenges: int = 0
    #: global-bus participation (machine proofs): when True the LAST
    #: extension element of the permutation trace is the chip's bus
    #: accumulator; its final-row value is exposed as the chip's bus sum
    #: (appended to the public values) and Σ over chips must cancel against
    #: the verifier's public receives (stark/bus.py).
    has_bus: bool = False

    name: str = ""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if not cls.name:
            cls.name = cls.__name__

    def eval(self, builder: AirBuilder) -> None:  # pragma: no cover
        raise NotImplementedError

    def periodic_columns(self) -> list:
        """Fixed periodic column patterns: a list of numpy uint32 arrays,
        each a power-of-two length dividing every trace height this AIR is
        used with.  Available to eval() as builder.periodic."""
        return []

    def generate_perm_trace(self, main, public_values, challenges):
        """LogUp witness generation: given the main trace (numpy (n, width)
        plain uint32) and the sampled Fp4 challenges, return the permutation
        trace as plain uint32 (n, perm_width).  Called between the two
        commitment rounds; only when perm_width > 0."""
        raise NotImplementedError

    def perm_trace_m(self, main, main_m, public_values, challenges, **kw):
        """The machine prover's perm trace: generate_perm_trace's values
        as a Montgomery field tensor (n, perm_width) on main_m's device.
        main: the plain numpy main trace; main_m: the same trace in
        Montgomery form on the chip's device; kw: `preprocessed=` for a
        preprocessed chip.  This version runs generate_perm_trace on the
        host and uploads its result; a chip may override it with device
        ops that give the same values."""
        perm = self.generate_perm_trace(main, public_values, challenges,
                                        **kw)
        return bb.to_mont(bb.from_numpy(perm, main_m.device))

    def fold_constraints_scalar(self, local: Sequence[Fp4], nxt: Sequence[Fp4],
                                public: Sequence[int], sels: dict,
                                alpha: Fp4, periodic: Sequence[Fp4] = (),
                                perm_local: Sequence[Fp4] = (),
                                perm_next: Sequence[Fp4] = (),
                                challenges: Sequence = (),
                                pre_local: Sequence[Fp4] = (),
                                pre_next: Sequence[Fp4] = (),
                                ) -> Fp4:
        """Verifier-side: same fold at the out-of-domain point ζ."""
        from .ext_val import ExtVal

        acc = [Fp4(0)]
        alpha_pow = [Fp4(1)]

        def fold(expr):
            if not isinstance(expr, Fp4):
                expr = Fp4.from_base(expr)
            acc[0] = acc[0] + alpha_pow[0] * expr
            alpha_pow[0] = alpha_pow[0] * alpha

        builder = AirBuilder(
            local=list(local),
            next=list(nxt),
            public=[Fp4.from_base(v) for v in public],
            is_first_row=sels["is_first_row"],
            is_last_row=sels["is_last_row"],
            is_transition=sels["is_transition"],
            _fold=fold,
            periodic=list(periodic),
            perm_local=list(perm_local),
            perm_next=list(perm_next),
            challenges=[ExtVal.from_fp4(c) for c in challenges],
            pre_local=list(pre_local),
            pre_next=list(pre_next),
            **scalar_vec_hooks(fold, lambda v: Fp4(v)),
        )
        self.eval(builder)
        return acc[0]


def scalar_vec_hooks(fold: Callable[[Any], None],
                     make_const: Callable[[int], Any]) -> dict:
    """Vector-API hooks for any scalar backend (verifier Fp4, debug ints,
    constraint counting): groups are ScalarVecs, vector folds loop."""

    def fold_vec(expr: ScalarVec):
        for e in expr.items:
            fold(e)

    def group(seq, sl: slice):
        return ScalarVec(list(seq)[sl])

    def const_vec(values):
        return ScalarVec(make_const(int(v)) for v in values)

    def dot_const(g: ScalarVec, weights):
        acc = None
        for item, w_ in zip(g.items, weights):
            term = item * int(w_)
            acc = term if acc is None else acc + term
        return acc

    def mat_const(g: ScalarVec, weights_2d):
        if len(weights_2d) != len(g.items):
            raise ValueError(
                f"mat_const: {len(g.items)} items vs "
                f"{len(weights_2d)} weight rows")
        cols = len(weights_2d[0])
        # fast path: all-Fp4 items × integer weights — numpy limb-wise
        # (the ModMul chips' point-evaluation matrices are (256, 511);
        # the Python loop was the host verifier's hottest spot)
        if g.items and all(isinstance(v, Fp4) for v in g.items):
            import numpy as _np

            from ..ops.field_ref import P as _P

            arr = _np.array([[int(x) for x in v.c] for v in g.items],
                            dtype=_np.uint64)              # (L, 4)
            w = _np.asarray(weights_2d, dtype=_np.uint64) % _P  # (L, m)
            out_l = _np.empty((cols, 4), dtype=_np.uint64)
            for ell in range(4):
                prod = (arr[:, ell][:, None] * w) % _P      # < 2^62
                out_l[:, ell] = prod.sum(axis=0) % _P       # L ≤ 2^25 ok
            return ScalarVec(
                Fp4(*[int(x) for x in row]) for row in out_l)
        out = []
        for j in range(cols):
            acc = None
            for item, row in zip(g.items, weights_2d):
                term = item * int(row[j])
                acc = term if acc is None else acc + term
            out.append(acc)
        return ScalarVec(out)

    return {"_fold_vec": fold_vec, "_group": group,
            "_const_vec": const_vec, "_dot_const": dot_const,
            "_mat_const": mat_const}
