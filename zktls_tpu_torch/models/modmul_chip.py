"""Guest-witness → ModMul chip bridge: prove the recorded modular
multiplications of every big-integer operation in the session — ECDHE
shared-secret derivation, ECDSA certificate / ServerKeyExchange / origin-
signature checks, x25519/ed25519, and RSA signature verification (the
reference's bigint/EC precompile workload, SURVEY.md §2.2.B `sp1-curves`;
§3.4 "ECDHE scalar-mult", "webpki RSA/ECDSA verify", "secp256k1
signature").  Events are routed to width-class chip instances
(stark/chips/modmul.py): 256-bit one-hot curve moduli, 384-bit for P-384,
and witnessed-modulus RSA widths.

Port copy of zktls_tpu.models.modmul_chip (same names and values; host code
in numpy)."""

from __future__ import annotations

from ..stark.chips.modmul import (
    MODULI_256,
    MODULI_384,
    modmul_air_256,
    modmul_air_384,
    modmul_air_rsa,
)
from ..stark.machine import ChipInstance

__all__ = ["modmul_instances", "modmul_air", "modmul_instance"]

_SET_256 = set(MODULI_256)
_SET_384 = set(MODULI_384)


def modmul_air():
    return modmul_air_256()


def _rsa_bits(m: int) -> int:
    for bits in (1024, 2048, 4096):
        if m.bit_length() <= bits:
            return bits
    raise ValueError(f"modulus too wide for the RSA chips: "
                     f"{m.bit_length()} bits")


def modmul_instances(events, sends: dict | None = None
                     ) -> list[ChipInstance]:
    """Route events to width-class chips; one ChipInstance per width that
    has events.  Every recorded modulus is covered: curve moduli by the
    one-hot 256/384 chips, anything else by a witnessed-modulus RSA
    width.

    sends: {(a, b, r, m): count} — BUS_MODMUL consumption counts from
    composition chips (EC schedule, Poly1305 accounting); routed to the
    fixed-moduli width chips, which publish each statement with the
    matching multiplicity.  Counts whose modulus lands on an RSA width
    raise (those chips have no bus)."""
    airs = {}
    buckets: dict[str, list] = {}
    send_buckets: dict[str, dict] = {}
    for ev in events:
        if ev.m in _SET_256:
            air = modmul_air_256()
        elif ev.m in _SET_384:
            air = modmul_air_384()
        else:
            air = modmul_air_rsa(_rsa_bits(ev.m))
        airs[air.name] = air
        buckets.setdefault(air.name, []).append(ev)
    for key, cnt in (sends or {}).items():
        if not cnt:
            continue
        m = key[3]
        if m in _SET_256:
            name = modmul_air_256().name
        elif m in _SET_384:
            name = modmul_air_384().name
        else:
            raise ValueError("bus sends need a fixed-set modulus")
        send_buckets.setdefault(name, {})[key] = cnt
    out = []
    for name, evs in sorted(buckets.items()):
        air = airs[name]
        kw = {}
        if name in send_buckets:
            kw["sends"] = send_buckets[name]
        trace, publics = air.trace(evs, **kw)
        out.append(ChipInstance(air=air, trace=trace, publics=publics))
    return out


def modmul_instance(events) -> ChipInstance:
    """The 256-bit instance alone (single-chip tests)."""
    evs = [ev for ev in events if ev.m in _SET_256]
    trace, publics = modmul_air_256().trace(evs)
    return ChipInstance(air=modmul_air_256(), trace=trace, publics=publics)
