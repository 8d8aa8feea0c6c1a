"""BN254 (alt_bn128) field constants.

Port of the constants of zktls_tpu.snark.bn254 that the shrink layer
needs: the base field P and the scalar field R (EIP-196).  The curve
arithmetic and the pairing wait for the Groth16 wrap.
"""

from __future__ import annotations

__all__ = ["P", "R"]

#: base field and scalar field (EIP-196)
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
