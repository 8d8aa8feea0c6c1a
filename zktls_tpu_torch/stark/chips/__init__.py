"""The port's chip AIRs, by name (the names are the reference's).

The twelve chips of a TLS 1.2 ECDHE-RSA-AES128-GCM-SHA256 session, plus the
ModMul chip's other width classes (one `ModMulAir` class at 384 bits and
the RSA widths).  Not ported: Aes256Air, Sha512Air, ChaCha20Air,
ChaChaControlAir, ChaChaDataAir, the sponge and VM chips.
"""

from functools import partial

from .aes128 import Aes128Air
from .ec import EcScheduleAir
from .gcm_control import GcmControlAir
from .gcm_data import GcmDataAir
from .ghash import GhashAir
from .keccak import KeccakAir
from .keyschedule import KeyScheduleAir
from .modmul import modmul_air_256, modmul_air_384, modmul_air_rsa
from .sha256 import Sha256Air
from .stream_parser import StreamParserAir
from .xor_table import XorTableAir

#: zero-argument AIR constructor by chip name
AIRS = {
    "Sha256Air": Sha256Air,
    "Aes128Air": Aes128Air,
    "GhashAir": GhashAir,
    "GcmControlAir": GcmControlAir,
    "StreamParserAir": StreamParserAir,
    "GcmDataAir": GcmDataAir,
    "XorTableAir": XorTableAir,
    "KeccakAir": KeccakAir,
    "EcScheduleAir": EcScheduleAir,
    "KeyScheduleAir": KeyScheduleAir,
    "ModMul256Air": modmul_air_256,
    "ModMul384Air": modmul_air_384,
    "ModMulRsa1024Air": partial(modmul_air_rsa, 1024),
    "ModMulRsa2048Air": partial(modmul_air_rsa, 2048),
    "ModMulRsa4096Air": partial(modmul_air_rsa, 4096),
}
