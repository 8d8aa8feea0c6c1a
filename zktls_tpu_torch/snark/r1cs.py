"""R1CS constraint system over the BN254 scalar field.

The arithmetization target of the Groth16 wrap.  A constraint is
⟨a, z⟩·⟨b, z⟩ = ⟨c, z⟩ over the assignment vector
z = [1 ‖ public inputs ‖ private witness]; linear combinations are sparse
{var_index: coeff} dicts.

Port copy of zktls_tpu.snark.r1cs (same names and values): the port's
circuits are the reference's constraint for constraint.
"""

from __future__ import annotations

from .bn254 import R

__all__ = ["R1CS", "LC"]

LC = dict  # {var_index: coefficient}


class R1CS:
    def __init__(self) -> None:
        self.n_public = 0          # public inputs occupy z[1..n_public]
        self.n_vars = 1            # z[0] = 1
        self.constraints: list[tuple[dict, dict, dict]] = []
        self._assignment: list[int] = [1]

    # -- variables ---------------------------------------------------------

    def public_input(self, value: int = 0) -> int:
        """Allocate the next public input (must be allocated before any
        witness variable)."""
        if self.n_vars != self.n_public + 1:
            raise ValueError("public inputs must be allocated first")
        self.n_public += 1
        return self._alloc(value)

    def witness(self, value: int = 0) -> int:
        return self._alloc(value)

    def _alloc(self, value: int) -> int:
        idx = self.n_vars
        self.n_vars += 1
        self._assignment.append(int(value) % R)
        return idx

    def set_value(self, idx: int, value: int) -> None:
        self._assignment[idx] = int(value) % R

    def value(self, lc: dict) -> int:
        return sum(self._assignment[i] * c for i, c in lc.items()) % R

    # -- constraints ---------------------------------------------------------

    def constrain(self, a: dict, b: dict, c: dict) -> None:
        self.constraints.append((dict(a), dict(b), dict(c)))

    def mul(self, a: dict, b: dict) -> int:
        """Allocate out = ⟨a,z⟩·⟨b,z⟩ with its defining constraint."""
        out = self.witness(self.value(a) * self.value(b) % R)
        self.constrain(a, b, {out: 1})
        return out

    def enforce_eq(self, a: dict, b: dict) -> None:
        self.constrain(a, {0: 1}, b)

    def assignment(self) -> list[int]:
        return list(self._assignment)

    def check(self) -> bool:
        """Direct satisfaction check of the current assignment."""
        z = self._assignment
        for a, b, c in self.constraints:
            av = sum(z[i] * v for i, v in a.items()) % R
            bv = sum(z[i] * v for i, v in b.items()) % R
            cv = sum(z[i] * v for i, v in c.items()) % R
            if av * bv % R != cv:
                return False
        return True
