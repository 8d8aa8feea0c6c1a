"""Global LogUp bus: the cross-chip glue of the machine STARK.

The reference's multi-table STARK is glued by LogUp-style lookup and
permutation arguments between chips (sp1-core-machine, SURVEY.md §2.2.B):
every chip interaction — a SHA-256 compression consuming its input state,
the AES-GCM control table consuming keystream blocks, the verifier
consuming a result digest — is a *message* sent (+) or received (−) on one
global bus.  The machine proof exposes each chip's cumulative bus sum, and
verification checks

    Σ_chips bus_sum  −  Σ_public-receives 1/(γ − fp(msg))  ==  0

which holds (whp over γ, δ) iff the multiset of sent messages equals the
multiset of received messages.  Message fingerprint:

    fp(tag, payload) = tag + Σ_i δ^{i+1} · payload_i

Tags are ≥ 0x100 so bus fingerprints can never collide, as polynomials in
δ, with in-chip byte-table tuples x + δ·y (x < 256) that share the same
(γ, δ) challenges.

Port copy of zktls_tpu.stark.bus (same names and values).
"""

from __future__ import annotations

import numpy as np

from ..ops.field_ref import Fp4, P

__all__ = [
    "BUS_SHA_STATE", "BUS_SHA_RESULT", "BUS_SHA512_STATE",
    "BUS_SHA512_RESULT", "BUS_CHACHA_BLOCK", "BUS_CHACHA_KS",
    "BUS_POLY_CT", "BUS_SP16_CHAIN",
    "BUS_SP24_CHAIN", "BUS_HASH_ABS", "BUS_HASH_OUT", "BUS_HASH_ABS24",
    "BUS_HASH_OUT24", "BUS_VM_VAL",
    "BUS_VM_INSTR", "BUS_VM_PUB", "BUS_EC_BASE",
    "BUS_EC_RESULT", "BUS_SESSION_KEY", "BUS_SHA_HOP", "BUS_KS_OUT",
    "BUS_KS_PAD", "MODMUL_CLASS_384",
    "BUS_AES_ENC", "BUS_GCM_H",
    "BUS_GCM_MASK", "BUS_GCM_TAG", "BUS_GCM_RECORD", "BUS_MODMUL",
    "BUS_SHA_BLOCK", "BUS_GCM_CT", "BUS_GCM_AAD", "BUS_GCM_LEN",
    "BUS_GCM_KS", "BUS_CT_BYTE", "BUS_PARSE_REC", "BUS_NONCE_BYTE",
    "BUS_TAG_BYTE", "BUS_XOR", "BUS_FILTERED", "BUS_HASH_BYTE",
    "BUS_HASH_RESULT",
    "RESULT_TAG_JOURNAL", "RESULT_TAG_STREAM",
    "MAX_PAYLOAD", "NUM_MACHINE_CHALLENGES",
    "bus_fingerprint", "bus_term", "delta_powers",
    "u16_limbs", "digest_limbs", "np_bus_inverse_terms",
    "aes_enc_payload",
]

# ---------------------------------------------------------------------------
# message tags (≥ 0x100; byte-table tuples occupy constants < 0x100)
# ---------------------------------------------------------------------------

#: SHA-256 chaining: (obj, seq, state 16×u16) — a compression receives its
#: input state at (obj, seq) and sends its output at (obj, seq+1) once per
#: consumer, grounding every digest in a chain that starts at the IV.
BUS_SHA_STATE = 0x101
#: (result_tag, digest 16×u16) — a tagged final compression publishes its
#: digest; the verifier receives it against journal-derived values.
BUS_SHA_RESULT = 0x102
#: (event_id, kv, key_lo 8×u16, key_hi 8×u16, input 8×u16, output 8×u16)
#: — one AES block encryption, sent by the AES chip, received by the GCM
#: control chip.  kv = 0: AES-128 (key_hi = 0); kv = 1: AES-256 (key =
#: key_lo ‖ key_hi).  The variant flag is IN the fingerprint, so an
#: AES-256 block can never satisfy an AES-128 receive (or vice versa).
BUS_AES_ENC = 0x103
#: (event_id, H 8×u16) — the GHASH key H = E_K(0^16), sent by the GCM
#: control chip, received by the GHASH chip at the event's start.
BUS_GCM_H = 0x104
#: (event_id, mask 8×u16) — the tag whitening E_K(J0), control → GHASH.
BUS_GCM_MASK = 0x105
#: (event_id, tag 8×u16) — tag = S ⊕ E_K(J0), GHASH → control.
BUS_GCM_TAG = 0x106
#: (event_id, nonce 6×u16, tag 8×u16, n_blocks) — the public record header
#: from the journal; the verifier sends it, the control chip receives it.
BUS_GCM_RECORD = 0x107
#: (mclass, a k×u16, b k×u16, r k×u16) — one proven modular multiplication
#: a·b ≡ r (mod m), published by a fixed-moduli ModMul width chip with a
#: witnessed send multiplicity (k = limbs/2: 16 at the 256-bit width, 24
#: at 384).  mclass is the chip-set modulus index (256-bit classes 0..,
#: 384-bit classes offset by MODMUL_CLASS_384) so a multiplication can
#: only satisfy a consumer expecting the same modulus.  Consumers: the EC
#: schedule chip (group-law slopes/products), the Poly1305 accounting in
#: the ChaCha record-control chip.  Sends of proven statements need no
#: multiplicity range check: every row's payload is its own AIR-proven
#: (a, b, r) event, so any net-positive send of a value implies a row
#: proving it.
BUS_MODMUL = 0x108
#: (obj, seq, half, 16×u16) — one 32-byte half of a compression's message
#: block, sent by the SHA chip for expose-flagged (xb) chains, received by
#: the stream-parser chip.  Binds the parser's byte column to the exact
#: preimage of the journal's stream_sha256.
BUS_SHA_BLOCK = 0x109
#: (eid, blk_idx, block 8×u16) — one 16-byte ciphertext block (zero-padded),
#: sent by the GCM data chip, received by the GHASH chip at the matching
#: ct-block group.
BUS_GCM_CT = 0x10A
#: (eid, aad_block 8×u16) — the single zero-padded AAD block, control → GHASH.
BUS_GCM_AAD = 0x10B
#: (eid, len_block 8×u16) — the final GHASH length block
#: (aad_bits ‖ ct_bits), control → GHASH.
BUS_GCM_LEN = 0x10C
#: (eid, blk_idx, keystream 8×u16) — one keystream block E_K(ctr),
#: control → GCM data chip (for plaintext recovery).
BUS_GCM_KS = 0x10D
#: (eid, crem, byte, rpos, is_resp, v13, obj, dir, isrb) — one ciphertext
#: byte located in the stream tape (crem = remaining ct bytes incl. this
#: one; rpos = the byte's app-stream position for app-stream bytes, P−1
#: sentinel otherwise; dir = 0 client/request, 1 server/response; isrb =
#: app-stream-byte marker, is_resp minus the TLS 1.3 inner-content-type
#: byte), parser → GCM data chip.
BUS_CT_BYTE = 0x10E
#: (eid, seqno, rectype, ct_len, v13, is_resp) — one parsed GCM record's
#: public metadata, parser → control chip.
BUS_PARSE_REC = 0x10F
#: (eid, nrem, byte) — one TLS 1.2 explicit-nonce byte (nrem = 8..1
#: countdown), parser → control chip.
BUS_NONCE_BYTE = 0x110
#: (eid, trem, byte) — one record tag byte (trem = 16..1), parser → control.
BUS_TAG_BYTE = 0x111
#: (x, y, x^y) over 4-bit nibbles — the xor lookup table chip's rows,
#: consumed by the GCM data chip's plaintext = ct ⊕ keystream checks.
BUS_XOR = 0x112
#: (obj, dir, pos, byte) — one journal filtered-response byte at response
#: position pos (sent by the VERIFIER from public journal data; obj is the
#: session's stream hash-object id, dir = 1), received by the GCM data
#: chip at the matching plaintext byte.
BUS_FILTERED = 0x113
#: (obj, dir, pos, byte) — one application-stream plaintext byte (dir 0 =
#: request, 1 = response), GCM data chip → keccak chip.
BUS_HASH_BYTE = 0x114
#: (obj, dir, digest 16×u16) — keccak256 of an application stream,
#: keccak chip → verifier (the journal's request_hash / response_hash).
BUS_HASH_RESULT = 0x115
#: (obj, seq, iv384, state 32×u16) — SHA-512-family chaining (the SHA-384
#: suites' transcript/PRF compressions; semantics mirror BUS_SHA_STATE,
#: with iv384 marking chains rooted at the SHA-384 IV).
BUS_SHA512_STATE = 0x116
#: (result_tag, digest 32×u16) — a tagged SHA-512-family digest.
BUS_SHA512_RESULT = 0x117
#: (eid, ctr_lo, ctr_hi, half, key 16×u16, block-half 16×u16,
#: nonce 6×u16) — one 64-byte ChaCha20 keystream block in two halves,
#: published by the ChaCha20 chip with per-half witnessed multiplicities;
#: consumed by the ChaCha record-control chip (the otk half at ctr = 0
#: and every data-keystream half).  The nonce limbs in the payload bind
#: each consumed block to the journal-pinned record nonce.  Payload 42.
BUS_CHACHA_BLOCK = 0x118
#: recursion machine (stark/recursion.py) — sponge chain state:
#: (sid, seq, state w×field) between consecutive duplexes of an instance.
BUS_SP16_CHAIN = 0x119
BUS_SP24_CHAIN = 0x11A
#: (sid, seq, lane, value, am) — a value absorbed into a sponge lane,
#: VM chip → sponge chip.  `am` pins the absorb mode (0 = overwrite
#: duplex, 1 = additive leaf sponge) so the mode is program-controlled,
#: not a free prover bit.  The tag is WIDTH-SPECIFIC (…ABS = Sponge16,
#: …ABS24 = Sponge24): each sponge chip enforces (sid, seq) uniqueness
#: only within its own trace, so the namespaces must be disjoint or a
#: width-24 row could soak up a width-16 absorb.
BUS_HASH_ABS = 0x11B
#: (sid, seq, lane, value) — a sponge output lane, sponge chip → VM.
#: Width-split like the absorb tag.
BUS_HASH_OUT = 0x11C
BUS_HASH_ABS24 = 0x11F
BUS_HASH_OUT24 = 0x120
#: (idx, v0..v3) — VM dataflow: SSA value idx (4 ext limbs), produced
#: once (multiplicity = consumer count), received per use.
BUS_VM_VAL = 0x11D
#: (pc, op, ia, ib, ic, io1, io2, imm0..3, m1, m2, ra, rb, rc2, ub) —
#: one VM instruction.  LEGACY: the program now lives in the VM chip's
#: preprocessed columns (vk-committed); this tag is retained only for
#: payload-format tooling.
BUS_VM_INSTR = 0x11E
#: (k, value) — the k-th per-session public input of a recursion
#: program (transcript-header residues, inner public-message payloads),
#: sent by the VERIFIER, received by the VM's PUB row.  Keeps the
#: program — and the vk — independent of journal content.
BUS_VM_PUB = 0x121
#: (bid, curve_class, x 16×u16, y 16×u16) — a PUBLIC base-point
#: declaration for an EC ladder (e.g. the curve generator G), sent by
#: the VERIFIER (+1), consumed by the EC schedule chip's start row —
#: pinning the ladder's addend to a known point.  Witness bases (the
#: server's key-exchange point) consume nothing; binding them to the
#: handshake transcript is the documented transcript-locator gap.
BUS_EC_BASE = 0x122
#: (rid, curve_class, n_bits, x 16×u16, y 16×u16) — a finished ladder's
#: result point (n_bits = scalar bit-length processed), published with a
#: witnessed multiplicity for external consumers (the key-schedule
#: chip's premaster input, the verifier).
BUS_EC_RESULT = 0x123
#: (obj, dir, kv, key 16×u16, iv 6×u16) — one direction's AEAD traffic
#: key + static IV/salt, sent by the key-schedule chip (which proved its
#: PRF/HKDF derivation), received by the record-control chips that use
#: the key in their AES/ChaCha block messages.  Payload 25.
BUS_SESSION_KEY = 0x125
#: (in_state 16×u16, block 32×u16, out_state 16×u16) — ONE proven
#: SHA-256 compression `compress(in, block) = out` as a self-contained
#: value-level statement (no chain coordinates), sent by the SHA chip
#: with a witnessed multiplicity.  Consumers (the key-schedule chip)
#: walk Merkle–Damgård chains by VALUE — in_{k+1} = out_k — which is
#: graft-proof: the (block, out) pair is atomic per compression, so no
#: second chain sharing an (obj, seq) prefix can substitute its state.
BUS_SHA_HOP = 0x126
#: (sid, idx, value) — key-schedule internal dataflow: byte-pair `idx` of
#: hash-object/secret `sid` (value = 256·b_{2i} + b_{2i+1}, big-endian
#: pair), sent by producer rows (EC-result intake, HMAC output rows),
#: received by secret-byte rows.
BUS_KS_OUT = 0x127
#: (sid, idx, padlimb) — byte-pair idx of secret sid xored with the HMAC
#: opad (0x5c5c…), sent by secret rows (xor-table-proven), received by
#: the key-schedule HMAC rows against their block limbs.
BUS_KS_PAD = 0x128
#: (eid, blk_idx, limbs 8×u16 LE byte pairs) — one 16-byte slice of a
#: ChaCha20 record's data keystream (blocks ctr ≥ 1), sent by the ChaCha
#: record-control chip (which consumed the proven 32-byte halves from
#: BUS_CHACHA_BLOCK), received by the ChaCha data chip for the
#: plaintext xor.  The LE pairing (b[2j] + 256·b[2j+1]) matches the
#: ChaCha chip's native LE-u32 lo/hi limb order — no byteswap anywhere.
BUS_CHACHA_KS = 0x129
#: (eid, blk_idx, limbs 8×u16 LE byte pairs) — one zero-padded 16-byte
#: ciphertext block of a ChaCha record, sent by the data chip (which
#: received the bytes from the stream parser), received by the control
#: chip's Poly1305 accumulation rows: the block value Σ limbs·2^16j is
#: exactly the little-endian Poly1305 message block (before + 2^128).
BUS_POLY_CT = 0x12A

#: result tags for BUS_SHA_RESULT
RESULT_TAG_JOURNAL = 1   # digest of the committed journal bytes
RESULT_TAG_STREAM = 2    # digest of the full stream tape (in the journal)

#: maximum payload length any message uses (MODMUL at the 384-bit width:
#: 1 + 3·24 = 73; MODMUL-256: 1 + 3·16 = 49; CHACHA_BLOCK: 4+32+6 = 42;
#: SHA512_STATE: 3 + 32 = 35; EC_STATE: 4 + 32 = 36)
MAX_PAYLOAD = 73

#: mclass offset of the 384-bit ModMul chip's modulus set (disjoint
#: namespaces across width chips — payload lengths differ, so this is
#: belt-and-braces against structured collisions)
MODMUL_CLASS_384 = 16

#: machine challenge vector: [γ, δ, δ², …, δ^MAX_PAYLOAD] — powers are
#: host-precomputed so in-AIR fingerprints stay degree 1 in trace columns.
NUM_MACHINE_CHALLENGES = 1 + MAX_PAYLOAD


def delta_powers(delta: Fp4, count: int = MAX_PAYLOAD) -> list[Fp4]:
    """[δ, δ², …, δ^count]."""
    out = []
    acc = Fp4(1)
    for _ in range(count):
        acc = acc * delta
        out.append(acc)
    return out


def bus_fingerprint(challenges: list[Fp4], tag: int,
                    payload: list[int]) -> Fp4:
    """Host-side fingerprint: tag + Σ δ^{i+1}·payload_i.  `challenges` is
    the machine challenge vector [γ, δ, δ², …]."""
    if len(payload) > MAX_PAYLOAD:
        raise ValueError(f"payload too long: {len(payload)}")
    fp = Fp4(tag)
    for i, v in enumerate(payload):
        fp = fp + challenges[1 + i] * (int(v) % P)
    return fp


def bus_term(challenges: list[Fp4], tag: int, payload: list[int]) -> Fp4:
    """1/(γ − fp) — the LogUp term one message contributes."""
    return (challenges[0] - bus_fingerprint(challenges, tag, payload)).inv()


def aes_enc_payload(eid: int, key: bytes, inp: bytes,
                    out: bytes) -> list[int]:
    """The BUS_AES_ENC payload for a block encryption: (eid, kv, key_lo,
    key_hi, input, output) with kv/key_hi derived from the key length."""
    if len(key) == 16:
        kv, key_lo, key_hi = 0, key, b"\x00" * 16
    elif len(key) == 32:
        kv, key_lo, key_hi = 1, key[:16], key[16:]
    else:
        raise ValueError("AES key must be 16 or 32 bytes")
    return ([eid, kv] + u16_limbs(key_lo) + u16_limbs(key_hi)
            + u16_limbs(inp) + u16_limbs(out))


def u16_limbs(data: bytes) -> list[int]:
    """Big-endian 16-bit limbs of a byte string (even length)."""
    if len(data) % 2:
        raise ValueError("need even byte length")
    return [int.from_bytes(data[i : i + 2], "big")
            for i in range(0, len(data), 2)]


def digest_limbs(digest32: bytes) -> list[int]:
    """A 32-byte digest as the 16 u16 limbs used in SHA bus payloads
    (word-major: each u32 word contributes (lo, hi) 16-bit limbs, matching
    the SHA chip's h_state column layout)."""
    if len(digest32) != 32:
        raise ValueError("need a 32-byte digest")
    out = []
    for i in range(0, 32, 4):
        word = int.from_bytes(digest32[i : i + 4], "big")
        out.append(word & 0xFFFF)
        out.append(word >> 16)
    return out


def np_bus_inverse_terms(challenges: list[Fp4], tag,
                         payload_cols: np.ndarray) -> np.ndarray:
    """Vectorized witness helper: for payload rows (n, k) of plain ints,
    return (n, 4) uint64 values of 1/(γ − fp(tag, row)).  Used by chips'
    generate_perm_trace.  `tag` may be a per-row uint64 array (the VM's
    width-selected hash-bus tags)."""
    from .lookup import np_ext_inverse

    n, k = payload_cols.shape
    acc = np.zeros((n, 4), dtype=np.uint64)
    g = np.array(challenges[0].c, dtype=np.uint64)
    acc[:] = g[None, :]
    if isinstance(tag, np.ndarray):
        acc[:, 0] = (acc[:, 0] + P - tag.astype(np.uint64) % P) % P
    else:
        acc[:, 0] = (acc[:, 0] + P - tag % P) % P
    for i in range(k):
        d = np.array(challenges[1 + i].c, dtype=np.uint64)
        contrib = (d[None, :] * (payload_cols[:, i].astype(np.uint64)
                                 % P)[:, None]) % P
        acc = (acc + P - contrib) % P
    return np_ext_inverse(acc)
