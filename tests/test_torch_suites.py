"""The SHA-384 and ChaCha20-Poly1305 suites' chips in the port against the
JAX package's:

  * the five chips these suites add (Sha512Air, Aes256Air, ChaCha20Air,
    ChaChaControlAir, ChaChaDataAir) lower to the same constraint-VM plan
    in both packages, field by field;
  * on loopback sessions of 0xC030, 0x1302, 0xCCA8 and 0x1303 recorded
    here (the short "hello" body), the port's build_chip_instances gives
    the reference's chips — names, order, traces, publics and each chip's
    LogUp perm trace at fixed challenges — and the global bus closes
    against journal_public_messages, but not after a filtered byte of the
    journal changes;
  * the committed sessions replay to what workload.SESSIONS records for
    them (suite, chain report, journal length, chip names and shapes);
  * aes_instances routes 16- and 32-byte keys to Aes128Air and Aes256Air
    with the global event ids, as the reference does;
  * a small three-chip machine of Sha512Air, Aes256Air and ChaCha20Air,
    proved by the port on the CPU with its bus closed by public messages,
    is accepted by both packages' verify_machine, and a tampered message
    is rejected by both.

Exact equality throughout; no JAX prover runs here."""

import random
import struct

import numpy as np
import pytest

from zktls_tpu.core.types import GuestInput as JGuestInput
from zktls_tpu.guest.crypto.gcm import GCMEvent as JGCMEvent
from zktls_tpu.guest.program import run_guest as jrun_guest
from zktls_tpu.models.aes128_chip import aes_instances as jaes_instances
from zktls_tpu.ops.field_ref import Fp4 as JFp4
from zktls_tpu.provers import stark as jstark
from zktls_tpu.stark import lowering as jlowering
from zktls_tpu.stark import machine as jmachine
from zktls_tpu.stark.bus import delta_powers as jdelta_powers
from zktls_tpu.stark.config import StarkConfig as JStarkConfig
from zktls_tpu.stark.verifier import VerificationError as JVerificationError
from zktls_tpu_torch.core.types import GuestInput
from zktls_tpu_torch.guest.crypto.aes import AES
from zktls_tpu_torch.guest.crypto.chacha import chacha20_block
from zktls_tpu_torch.guest.crypto.gcm import GCMEvent
from zktls_tpu_torch.guest.crypto.sha512 import SHA512Recorder
from zktls_tpu_torch.guest.program import run_guest
from zktls_tpu_torch.models.aes128_chip import aes_instances
from zktls_tpu_torch.ops.field_ref import Fp4
from zktls_tpu_torch.provers import stark as tstark
from zktls_tpu_torch.stark import lowering as tlowering
from zktls_tpu_torch.stark import machine as tmachine
from zktls_tpu_torch.stark.bus import (
    BUS_AES_ENC,
    BUS_CHACHA_BLOCK,
    BUS_GCM_RECORD,
    BUS_SHA512_RESULT,
    MAX_PAYLOAD,
    bus_term,
    delta_powers,
)
from zktls_tpu_torch.stark.chips import AIRS
from zktls_tpu_torch.stark.chips.aes256 import LAYOUT as AES256_LAYOUT
from zktls_tpu_torch.stark.chips.aes256 import Aes256Air, aes256_trace
from zktls_tpu_torch.stark.chips.chacha import ChaCha20Air, chacha_trace
from zktls_tpu_torch.stark.chips.sha512 import Sha512Air, sha512_trace
from zktls_tpu_torch.stark.config import StarkConfig
from zktls_tpu_torch.stark.verifier import VerificationError
from zktls_tpu_torch.workload import SESSIONS

from .test_suites import _record_session, cert_pair  # noqa: F401
from .test_torch_chips import BINDING, CFG, N_CHALLENGES, _same
from .torch_threads import torch_threads_per_worker  # noqa: F401

NEW_CHIPS = ["Sha512Air", "Aes256Air", "ChaCha20Air", "ChaChaControlAir",
             "ChaChaDataAir"]

_AES = ["GhashAir", "GcmControlAir", "StreamParserAir", "GcmDataAir",
        "XorTableAir", "KeccakAir"]
_CHACHA = ["ChaChaControlAir", "StreamParserAir", "ChaChaDataAir",
           "XorTableAir", "KeccakAir", "ChaCha20Air"]
_RSA = ["ModMul256Air", "ModMulRsa2048Air"]
#: suite → (how the loopback server is held to it, its chips in build
#: order).  The server's default group is x25519, whose ladder no chip
#: proves, so the TLS 1.2 sessions have no EcScheduleAir either.
SUITES = {
    0xC030: (dict(tls12_ciphers="ECDHE-RSA-AES256-GCM-SHA384"),
             ["Sha256Air", "Sha512Air", "Aes256Air"] + _AES + _RSA),
    0x1302: (dict(offered=[0x1302]),
             ["Sha256Air", "Sha512Air", "Aes256Air"] + _AES + _RSA),
    0xCCA8: (dict(tls12_ciphers="ECDHE-RSA-CHACHA20-POLY1305"),
             ["Sha256Air"] + _CHACHA + _RSA),
    0x1303: (dict(offered=[0x1303]), ["Sha256Air"] + _CHACHA + _RSA),
}
CHIP_CASES = [(s, k) for s, (_, names) in SUITES.items()
              for k in range(len(names))]

#: fixed machine challenges (γ, then δ's powers), as tests/test_suites.py
GAMMA, DELTA = (61, 2, 9, 30), (19, 23, 4, 7)


@pytest.mark.parametrize("name", NEW_CHIPS)
def test_lowered_plan_equals_reference(name):
    """lower_air(air, n_public, n_challenges) gives the reference's Plan,
    at the machine's arity (publics + the 4-limb bus sum)."""
    air = AIRS[name]()
    ref_air = jstark._air_registry()[name]()
    n_public = air.num_public + 4
    assert (air.name, air.width, air.num_public, air.perm_width) == \
        (ref_air.name, ref_air.width, ref_air.num_public, ref_air.perm_width)
    _same(tlowering.lower_air(air, n_public, N_CHALLENGES),
          jlowering.lower_air(ref_air, n_public, N_CHALLENGES))


def test_registry_is_the_reference_without_recursion_chips():
    assert set(AIRS) == set(jstark._air_registry())


@pytest.fixture(scope="module")
def sessions(cert_pair):  # noqa: F811
    """suite → both packages' replay of one loopback session and the chips
    each builds from it; perm traces are filled in on first use."""
    out = {}
    for suite, (kw, _) in SUITES.items():
        gi_bytes = _record_session(cert_pair, **kw).to_cbor()
        mine = run_guest(GuestInput.from_cbor(gi_bytes),
                         require_trust_anchor=False)
        ref = jrun_guest(JGuestInput.from_cbor(gi_bytes),
                         require_trust_anchor=False)
        out[suite] = {"out": mine, "chips": tstark.build_chip_instances(mine),
                      "ref_chips": jstark.build_chip_instances(ref),
                      "perms": {}}
    return out


def _perm(session, k):
    """Chip k's perm trace at the fixed challenges, in both packages."""
    if k not in session["perms"]:
        ch = [Fp4(*GAMMA)] + delta_powers(Fp4(*DELTA), MAX_PAYLOAD)
        jch = [JFp4(*GAMMA)] + jdelta_powers(JFp4(*DELTA), MAX_PAYLOAD)
        c, r = session["chips"][k], session["ref_chips"][k]
        session["perms"][k] = (
            c.air.generate_perm_trace(c.trace, c.publics, ch),
            np.asarray(r.air.generate_perm_trace(r.trace, r.publics, jch)))
    return session["perms"][k]


@pytest.mark.parametrize("suite", SUITES, ids=lambda s: f"{s:04x}")
def test_chip_set_equals_reference(sessions, suite):
    """The same chips in the same order; journal_airs names them too."""
    s = sessions[suite]
    assert s["out"].replay.cipher_suite.id == suite
    names = [c.air.name for c in s["chips"]]
    assert names == [c.air.name for c in s["ref_chips"]] == SUITES[suite][1]
    proof = _proof_naming(names)
    journal = s["out"].journal
    assert sorted(a.name for a in tstark.journal_airs(journal, proof)) == \
        sorted(a.name for a in jstark.journal_airs(journal, proof)) == \
        sorted(names)


def _proof_naming(names):
    class _Chip:
        def __init__(self, name):
            self.name = name

    class _Proof:
        chips = [_Chip(n) for n in names]
    return _Proof()


@pytest.mark.parametrize("suite,k", CHIP_CASES,
                         ids=[f"{s:04x}-{SUITES[s][1][k]}"
                              for s, k in CHIP_CASES])
def test_chip_instance_equals_reference(sessions, suite, k):
    """Each chip's trace, publics and perm trace (fixed challenges) equal
    the reference's."""
    s = sessions[suite]
    mine, ref = s["chips"][k], s["ref_chips"][k]
    assert mine.air.name == ref.air.name == SUITES[suite][1][k]
    assert (mine.air.width, mine.air.perm_width) == \
        (ref.air.width, ref.air.perm_width)
    np.testing.assert_array_equal(mine.trace, np.asarray(ref.trace))
    assert mine.publics == [int(v) for v in ref.publics]
    perm, ref_perm = _perm(s, k)
    np.testing.assert_array_equal(perm, ref_perm)


def _balance(bus_sums, msgs):
    ch = [Fp4(*GAMMA)] + delta_powers(Fp4(*DELTA), MAX_PAYLOAD)
    total = Fp4(0)
    for t in bus_sums:
        total = total + t
    for tag, payload, mult in msgs:
        t = bus_term(ch, tag, payload)
        total = total + (t if mult > 0 else Fp4(0) - t)
    return total


@pytest.mark.parametrize("suite", SUITES, ids=lambda s: f"{s:04x}")
def test_bus_balances_against_journal(sessions, suite):
    """The chips' bus sums plus the journal's messages cancel (the
    messages equal the reference's), and a changed record tag does not."""
    s = sessions[suite]
    sums = [Fp4(*[int(v) for v in _perm(s, k)[0][-1, -4:]])
            for k in range(len(s["chips"]))]
    journal = s["out"].journal
    msgs = tstark.journal_public_messages(journal)
    assert msgs == jstark.journal_public_messages(journal)
    assert _balance(sums, msgs) == Fp4(0)
    # the "hello" body has no filtered range: change a record header's
    # first tag limb instead
    k = next(i for i, m in enumerate(msgs) if m[0] == BUS_GCM_RECORD)
    tag, payload, mult = msgs[k]
    bad = list(msgs)
    bad[k] = (tag, payload[:7] + [payload[7] ^ 1] + payload[8:], mult)
    assert _balance(sums, bad) != Fp4(0)


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_committed_session_matches_registry(name):
    """Each committed session replays to the suite, chain report and
    journal length workload.SESSIONS records, and builds its chips."""
    spec = SESSIONS[name]
    out = run_guest(GuestInput.from_cbor(spec.guest_input.read_bytes()),
                    require_trust_anchor=False)
    assert out.replay.cipher_suite.id == spec.suite
    assert out.chain == spec.chain
    assert len(out.journal) == spec.journal_bytes
    assert tuple((c.air.name, *c.trace.shape)
                 for c in tstark.build_chip_instances(out)) == spec.chips


def test_aes_instances_route_mixed_keys():
    """16-byte keys go to Aes128Air, 32-byte keys to Aes256Air; the event
    ids stay the global enumeration (so the control chip's receives match
    whichever chip served the block)."""
    rng = random.Random(20261017)
    args = []
    for key_len in (16, 32, 16, 32):
        args.append(dict(key=rng.randbytes(key_len), nonce=rng.randbytes(12),
                         counter_blocks=[rng.randbytes(16)
                                         for _ in range(2)]))
    mine = aes_instances([GCMEvent(**_gcm_fields(GCMEvent, a))
                          for a in args])
    ref = jaes_instances([JGCMEvent(**_gcm_fields(JGCMEvent, a))
                          for a in args])
    assert [c.air.name for c in mine] == [c.air.name for c in ref] == \
        ["Aes128Air", "Aes256Air"]
    for m, r in zip(mine, ref):
        np.testing.assert_array_equal(m.trace, np.asarray(r.trace))
        assert m.publics == [int(v) for v in r.publics]
    # events 1 and 3 (the 32-byte keys) are the AES-256 chip's real groups,
    # each H, J0 and two counter blocks: eids 1,1,1,1,3,3,3,3 at the end
    eids = mine[1].trace[15::16, AES256_LAYOUT["eid"].start]
    assert eids[-8:].tolist() == [1] * 4 + [3] * 4


def _gcm_fields(cls, fields):
    """A GCMEvent's constructor arguments: the given fields, the rest empty
    (the AES chips read key, nonce and counter blocks only)."""
    import dataclasses

    full = {f.name: b"" for f in dataclasses.fields(cls)
            if f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING}
    full.update(fields)
    return full


# ---------------------------------------------------------------------------
# a small machine of the new chips, proved by the port on the CPU
# ---------------------------------------------------------------------------


def _small_machine():
    """(chips, the public messages that close their bus)."""
    rng = random.Random(20261017)
    rec = SHA512Recorder()
    rec.new384(rng.randbytes(200)).digest(result_tag=9)
    trace512, _ = sha512_trace(rec.events)
    limbs = [(w >> (16 * part)) & 0xFFFF
             for w in rec.events[-1].state_out for part in range(4)]
    msgs = [(BUS_SHA512_RESULT, [9] + limbs, -1)]

    key = rng.randbytes(32)
    blocks = [(eid, key, rng.randbytes(16)) for eid in (4, 5)]
    trace256, _ = aes256_trace(blocks)
    for eid, k, inb in blocks:
        out = AES(k).encrypt_block(inb)
        msgs.append((BUS_AES_ENC, [eid, 1] + _be16(k) + _be16(inb)
                     + _be16(out), -1))

    ckey, nonce = rng.randbytes(32), rng.randbytes(12)
    ctrace, _ = chacha_trace([(7, ckey, nonce, 0), (7, ckey, nonce, 1)],
                             consumed={(7, 0, 0): 1, (7, 1, 1): 1})
    for ctr, half in ((0, 0), (1, 1)):
        words = struct.unpack("<16I", chacha20_block(ckey, ctr, nonce))
        msgs.append((BUS_CHACHA_BLOCK, [7, ctr & 0xFFFF, ctr >> 16, half]
                     + _le16(ckey) + _le16(struct.pack(
                         "<8I", *words[8 * half : 8 * half + 8]))
                     + _le16(nonce), -1))
    chips = [tmachine.ChipInstance(air=Sha512Air(), trace=trace512,
                                   publics=[]),
             tmachine.ChipInstance(air=Aes256Air(), trace=trace256,
                                   publics=[]),
             tmachine.ChipInstance(air=ChaCha20Air(), trace=ctrace,
                                   publics=[])]
    return chips, msgs


def _be16(data: bytes) -> list[int]:
    return [(data[i] << 8) | data[i + 1] for i in range(0, len(data), 2)]


def _le16(data: bytes) -> list[int]:
    return [data[i] | (data[i + 1] << 8) for i in range(0, len(data), 2)]


@pytest.fixture(scope="module")
def small():
    chips, msgs = _small_machine()
    proof = tmachine.prove_machine(chips, BINDING, StarkConfig(**CFG),
                                   device="cpu").to_bytes()
    return {"chips": chips, "msgs": msgs, "proof": proof}


def test_small_machine_shape(small):
    shapes = {c.air.name: c.trace.shape for c in small["chips"]}
    assert shapes == {"Sha512Air": (256, 1186), "Aes256Air": (256, 987),
                      "ChaCha20Air": (64, 1147)}


def _verifiers():
    """(package, verify(airs names, proof bytes, msgs), its error)."""
    def port(names, blob, msgs):
        return tmachine.verify_machine(
            [AIRS[n]() for n in names], tmachine.MachineProof.from_bytes(blob),
            BINDING, msgs, StarkConfig(**CFG))

    def ref(names, blob, msgs):
        registry = jstark._air_registry()
        return jmachine.verify_machine(
            [registry[n]() for n in names],
            jmachine.MachineProof.from_bytes(blob), BINDING, msgs,
            JStarkConfig(**CFG))

    return {"port": (port, VerificationError),
            "reference": (ref, JVerificationError)}


@pytest.mark.parametrize("package", ["port", "reference"])
@pytest.mark.parametrize("tampered", [None, BUS_SHA512_RESULT, BUS_AES_ENC,
                                      BUS_CHACHA_BLOCK],
                         ids=["none", "sha512", "aes256", "chacha"])
def test_small_machine_verifies(small, package, tampered):
    """Both verifiers accept the port's proof, and reject it when one
    limb of a chip's closing message changes."""
    verify, error = _verifiers()[package]
    names = [c.air.name for c in small["chips"]]
    msgs = list(small["msgs"])
    if tampered is None:
        assert verify(names, small["proof"], msgs)
        return
    k = next(i for i, m in enumerate(msgs) if m[0] == tampered)
    tag, payload, mult = msgs[k]
    msgs[k] = (tag, payload[:-1] + [payload[-1] ^ 1], mult)
    with pytest.raises(error, match="bus imbalance"):
        verify(names, small["proof"], msgs)
