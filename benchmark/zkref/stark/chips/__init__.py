"""The port's chip AIRs, by name (the names are the reference's).

Every chip of a TLS session the reference proves — the AES-128/256-GCM,
SHA-256/384 and ChaCha20-Poly1305 suites of TLS 1.2 and 1.3 — plus the
ModMul chip's other width classes (one `ModMulAir` class at 384 bits and
the RSA widths).  The recursion chips (`vm.VmAir`, `sponge.Sponge16Air`,
`sponge.Sponge24Air`) and `bytes_table.ByteRangeAir` are ported beside
them but, as in the reference's registry, not registered: the compress
rung builds its outer machine from `stark.recursion.outer_airs()`.
"""

from functools import partial

from .aes128 import Aes128Air
from .aes256 import Aes256Air
from .chacha import ChaCha20Air
from .chacha_control import ChaChaControlAir
from .ec import EcScheduleAir
from .gcm_control import GcmControlAir
from .gcm_data import ChaChaDataAir, GcmDataAir
from .ghash import GhashAir
from .keccak import KeccakAir
from .keyschedule import KeyScheduleAir
from .modmul import modmul_air_256, modmul_air_384, modmul_air_rsa
from .sha256 import Sha256Air
from .sha512 import Sha512Air
from .stream_parser import StreamParserAir
from .xor_table import XorTableAir

#: zero-argument AIR constructor by chip name
AIRS = {
    "Sha256Air": Sha256Air,
    "Sha512Air": Sha512Air,
    "Aes128Air": Aes128Air,
    "Aes256Air": Aes256Air,
    "GhashAir": GhashAir,
    "GcmControlAir": GcmControlAir,
    "StreamParserAir": StreamParserAir,
    "GcmDataAir": GcmDataAir,
    "XorTableAir": XorTableAir,
    "KeccakAir": KeccakAir,
    "ChaCha20Air": ChaCha20Air,
    "ChaChaControlAir": ChaChaControlAir,
    "ChaChaDataAir": ChaChaDataAir,
    "EcScheduleAir": EcScheduleAir,
    "KeyScheduleAir": KeyScheduleAir,
    "ModMul256Air": modmul_air_256,
    "ModMul384Air": modmul_air_384,
    "ModMulRsa1024Air": partial(modmul_air_rsa, 1024),
    "ModMulRsa2048Air": partial(modmul_air_rsa, 2048),
    "ModMulRsa4096Air": partial(modmul_air_rsa, 4096),
}
