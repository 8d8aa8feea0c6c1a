"""AES-128/192/256 block cipher (FIPS 197) with round-state exposure.

The guest decrypts TLS records with AES-GCM (reference guest crypto is
RustCrypto's aes/ghash, SURVEY.md §2.2.A).  Implemented from the spec;
`encrypt_block_trace` exposes every round state for AES AIR-chip witness
generation.  Cross-checked against `cryptography` in tests.

Port copy of zktls_tpu.guest.crypto.aes (same names and values; host code in
numpy).
"""

from __future__ import annotations

__all__ = ["AES", "SBOX"]

# S-box generated from the spec (multiplicative inverse in GF(2^8) + affine map)
def _build_sbox() -> list[int]:
    # GF(2^8) inverse via exp/log tables over generator 3
    exp = [0] * 510
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        # multiply by generator 0x03 = x ^ (x*2)
        x ^= (x << 1) ^ (0x1B if x & 0x80 else 0)
        x &= 0xFF
    for i in range(255, 510):
        exp[i] = exp[i - 255]
    sbox = [0] * 256
    for v in range(256):
        inv = 0 if v == 0 else exp[255 - log[v]]
        b = inv
        res = inv
        for _ in range(4):
            b = ((b << 1) | (b >> 7)) & 0xFF
            res ^= b
        sbox[v] = res ^ 0x63
    return sbox


SBOX = _build_sbox()

_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x1B) & 0xFF if a & 0x100 else a


def _mul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a = _xtime(a)
        b >>= 1
    return out


class AES:
    """Key-scheduled AES; 16-byte block encrypt (decrypt is unused: GCM only
    ever uses the forward cipher)."""

    def __init__(self, key: bytes):
        if len(key) not in (16, 24, 32):
            raise ValueError("AES key must be 16/24/32 bytes")
        self.key = bytes(key)
        nk = len(key) // 4
        self.rounds = nk + 6
        words = [list(key[4 * i : 4 * i + 4]) for i in range(nk)]
        for i in range(nk, 4 * (self.rounds + 1)):
            t = list(words[i - 1])
            if i % nk == 0:
                t = t[1:] + t[:1]
                t = [SBOX[b] for b in t]
                t[0] ^= _RCON[i // nk - 1]
            elif nk > 6 and i % nk == 4:
                t = [SBOX[b] for b in t]
            words.append([a ^ b for a, b in zip(words[i - nk], t)])
        self.round_keys = [
            bytes(sum((words[4 * r + c] for c in range(4)), []))
            for r in range(self.rounds + 1)
        ]

    # -- state helpers: state is a 16-byte column-major array as in the spec --

    @staticmethod
    def _sub_bytes(s: bytearray) -> None:
        for i in range(16):
            s[i] = SBOX[s[i]]

    @staticmethod
    def _shift_rows(s: bytearray) -> bytearray:
        out = bytearray(16)
        for c in range(4):
            for r in range(4):
                out[4 * c + r] = s[4 * ((c + r) % 4) + r]
        return out

    @staticmethod
    def _mix_columns(s: bytearray) -> bytearray:
        out = bytearray(16)
        for c in range(4):
            col = s[4 * c : 4 * c + 4]
            out[4 * c + 0] = _mul(col[0], 2) ^ _mul(col[1], 3) ^ col[2] ^ col[3]
            out[4 * c + 1] = col[0] ^ _mul(col[1], 2) ^ _mul(col[2], 3) ^ col[3]
            out[4 * c + 2] = col[0] ^ col[1] ^ _mul(col[2], 2) ^ _mul(col[3], 3)
            out[4 * c + 3] = _mul(col[0], 3) ^ col[1] ^ col[2] ^ _mul(col[3], 2)
        return out

    def encrypt_block_trace(self, block: bytes) -> tuple[bytes, list[bytes]]:
        """Encrypt one block, returning (ciphertext, per-round states after
        AddRoundKey) — the AES AIR chip's witness rows."""
        if len(block) != 16:
            raise ValueError("AES block must be 16 bytes")
        s = bytearray(x ^ k for x, k in zip(block, self.round_keys[0]))
        states = [bytes(s)]
        for rnd in range(1, self.rounds):
            self._sub_bytes(s)
            s = self._shift_rows(s)
            s = self._mix_columns(s)
            s = bytearray(x ^ k for x, k in zip(s, self.round_keys[rnd]))
            states.append(bytes(s))
        self._sub_bytes(s)
        s = self._shift_rows(s)
        s = bytearray(x ^ k for x, k in zip(s, self.round_keys[self.rounds]))
        states.append(bytes(s))
        return bytes(s), states

    def encrypt_block(self, block: bytes) -> bytes:
        return self.encrypt_block_trace(block)[0]
