"""The port's session path against the JAX package's, on the recorded
TLS 1.2 ECDHE(P-256)-RSA-AES128-GCM-SHA256 loopback session committed in
zktls_tpu_torch/data/: each package replays the committed GuestInput with
its own run_guest, and the port's build_chip_instances, journal helpers and
LogUp perm traces give exactly the reference's values on it.  Exact
equality throughout (field elements and bytes); no proof is made here.
(tests/test_torch_guest.py holds the two replays equal field by field.)"""

import numpy as np
import pytest

from zktls_tpu.core.types import GuestInput
from zktls_tpu.guest.program import run_guest
from zktls_tpu.ops.field_ref import Fp4 as JFp4
from zktls_tpu.provers import stark as jstark
from zktls_tpu.stark.bus import delta_powers as jdelta_powers
from zktls_tpu_torch.core.types import GuestInput as TGuestInput
from zktls_tpu_torch.guest.program import run_guest as trun_guest
from zktls_tpu_torch.ops import babybear as bb
from zktls_tpu_torch.ops.field_ref import Fp4
from zktls_tpu_torch.provers import stark as tstark
from zktls_tpu_torch.stark.bus import (
    BUS_FILTERED,
    MAX_PAYLOAD,
    bus_term,
    delta_powers,
)
from zktls_tpu_torch.stark.verifier import VerificationError
from zktls_tpu_torch.workload import SESSION_GUEST_INPUT

from .torch_threads import torch_threads_per_worker  # noqa: F401

#: the twelve chips of the session, in build order
SESSION_CHIPS = ["Sha256Air", "Aes128Air", "GhashAir", "GcmControlAir",
                 "StreamParserAir", "GcmDataAir", "XorTableAir", "KeccakAir",
                 "EcScheduleAir", "KeyScheduleAir", "ModMul256Air",
                 "ModMulRsa2048Air"]

#: fixed machine challenges (γ, then δ's powers), as tests/test_suites.py
GAMMA, DELTA = (61, 2, 9, 30), (19, 23, 4, 7)


@pytest.fixture(scope="module")
def session():
    """One derivation for the module: each package's replay of the
    committed GuestInput and its chips."""
    gi_bytes = SESSION_GUEST_INPUT.read_bytes()
    ref_out = run_guest(GuestInput.from_cbor(gi_bytes),
                        require_trust_anchor=False)
    out = trun_guest(TGuestInput.from_cbor(gi_bytes),
                     require_trust_anchor=False)
    return {"ref_out": ref_out, "ref_chips":
            jstark.build_chip_instances(ref_out),
            "out": out, "chips": tstark.build_chip_instances(out)}


def _machine_challenges():
    return [Fp4(*GAMMA)] + delta_powers(Fp4(*DELTA), MAX_PAYLOAD)


def _balance(bus_sums, msgs, challenges):
    total = Fp4(0)
    for s in bus_sums:
        total = total + s
    for tag, payload, mult in msgs:
        t = bus_term(challenges, tag, payload)
        total = total + (t if mult > 0 else Fp4(0) - t)
    return total


def test_chip_set_equals_reference(session):
    """(b) the same twelve chips in the same order."""
    names = [c.air.name for c in session["chips"]]
    assert names == [c.air.name for c in session["ref_chips"]]
    assert names == SESSION_CHIPS


@pytest.mark.parametrize("k", range(len(SESSION_CHIPS)),
                         ids=SESSION_CHIPS)
def test_chip_instance_equals_reference(session, k):
    """(b) each chip's trace and publics equal the reference's."""
    mine, ref = session["chips"][k], session["ref_chips"][k]
    assert mine.air.name == ref.air.name == SESSION_CHIPS[k]
    np.testing.assert_array_equal(mine.trace, np.asarray(ref.trace))
    assert mine.publics == [int(v) for v in ref.publics]
    assert (mine.air.width, mine.air.perm_width) == \
        (ref.air.width, ref.air.perm_width)


def test_journal_messages_and_airs_equal_reference(session):
    """(c) journal_public_messages equal; journal_airs names the same
    AIRs, and rejects a chip the port has not ported."""
    journal = session["out"].journal
    assert tstark.journal_public_messages(journal) == \
        jstark.journal_public_messages(journal)

    def proof_naming(names):
        class _Chip:
            def __init__(self, name):
                self.name = name

        class _Proof:
            chips = [_Chip(n) for n in names]
        return _Proof()

    names = [c.air.name for c in session["chips"]]
    mine = sorted(a.name for a in tstark.journal_airs(
        journal, proof_naming(names)))
    ref = sorted(a.name for a in jstark.journal_airs(
        journal, proof_naming(names)))
    assert mine == ref == sorted(names)
    with pytest.raises(VerificationError, match="unknown chip"):
        tstark.journal_airs(journal, proof_naming(names + ["Sponge16Air"]))
    with pytest.raises(VerificationError, match="missing required"):
        tstark.journal_airs(journal, proof_naming(names[1:]))


@pytest.fixture(scope="module")
def perms(session):
    """Each chip's perm trace at the fixed challenges, in both packages."""
    ch = _machine_challenges()
    jch = [JFp4(*GAMMA)] + jdelta_powers(JFp4(*DELTA), MAX_PAYLOAD)
    return [(c.air.generate_perm_trace(c.trace, c.publics, ch),
             np.asarray(r.air.generate_perm_trace(r.trace, r.publics, jch)))
            for c, r in zip(session["chips"], session["ref_chips"])]


@pytest.mark.parametrize("k", range(len(SESSION_CHIPS)),
                         ids=SESSION_CHIPS)
def test_perm_trace_equals_reference(perms, k):
    """(d) at fixed challenges the chip's perm trace equals the
    reference's."""
    mine, want = perms[k]
    np.testing.assert_array_equal(mine, want)


@pytest.mark.parametrize("k", [SESSION_CHIPS.index("ModMul256Air"),
                               SESSION_CHIPS.index("ModMulRsa2048Air")],
                         ids=["ModMul256Air", "ModMulRsa2048Air"])
def test_perm_trace_m_equals_reference(session, perms, k):
    """(d) the ModMul chips' torch perm trace (Air.perm_trace_m, what the
    machine prover runs), out of Montgomery form, equals the reference's
    at the fixed challenges."""
    c = session["chips"][k]
    got = c.air.perm_trace_m(c.trace, bb.to_mont(bb.from_numpy(c.trace)),
                             c.publics, _machine_challenges())
    np.testing.assert_array_equal(bb.np_from_mont(bb.to_numpy(got)),
                                  perms[k][1])


def test_bus_balances_against_journal(session, perms):
    """(d) the chips' bus sums plus the journal's messages cancel, and a
    changed filtered byte does not."""
    ch = _machine_challenges()
    sums = [Fp4(*[int(v) for v in mine[-1, -4:]]) for mine, _ in perms]
    msgs = tstark.journal_public_messages(session["out"].journal)
    assert _balance(sums, msgs, ch) == Fp4(0)
    k = next(i for i, m in enumerate(msgs) if m[0] == BUS_FILTERED)
    tag, payload, mult = msgs[k]
    bad = list(msgs)
    bad[k] = (tag, payload[:3] + [payload[3] ^ 1], mult)
    assert _balance(sums, bad, ch) != Fp4(0)
