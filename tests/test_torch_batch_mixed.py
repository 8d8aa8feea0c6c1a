"""Mixed and ChaCha batches: the port's merge against the JAX package's on
two batches of the committed sessions.

* c02f + 0x1302 (TLS 1.2 AES-128-GCM beside TLS 1.3 AES-256-GCM-SHA384):
  the port's 14 merged chips and their perm traces at fixed challenges
  equal the reference's, and the bus balances against the batch's
  messages.
* 0x1303 + 0x1303 (ChaCha20-Poly1305): the reference's merge never merges
  `chacha_events` and builds the stream-binding inputs only for AES-GCM
  sessions, so it gives four chips and a bus that does not balance.  The
  port gives the same four chips and the same non-zero bus total: this
  pins the inherited limit, it does not fix it.

Exact equality; no proof is made here."""

import numpy as np
import pytest

from zktls_tpu.core.types import GuestInput
from zktls_tpu.guest.program import run_guest
from zktls_tpu.ops.field_ref import Fp4 as JFp4
from zktls_tpu.provers import stark as jstark
from zktls_tpu.stark.bus import bus_term as jbus_term
from zktls_tpu.stark.bus import delta_powers as jdelta_powers
from zktls_tpu_torch.core.types import GuestInput as TGuestInput
from zktls_tpu_torch.guest.program import run_guest as trun_guest
from zktls_tpu_torch.ops.field_ref import Fp4
from zktls_tpu_torch.provers import stark as tstark
from zktls_tpu_torch.stark.bus import MAX_PAYLOAD, bus_term, delta_powers
from zktls_tpu_torch.workload import SESSIONS

from .torch_threads import torch_threads_per_worker  # noqa: F401

#: fixed machine challenges (γ, then δ's powers), as tests/test_suites.py
GAMMA, DELTA = (61, 2, 9, 30), (19, 23, 4, 7)

MIXED_CHIPS = ["Sha256Air", "Sha512Air", "Aes128Air", "Aes256Air",
               "GhashAir", "GcmControlAir", "StreamParserAir", "GcmDataAir",
               "XorTableAir", "KeccakAir", "EcScheduleAir", "KeyScheduleAir",
               "ModMul256Air", "ModMulRsa2048Air"]
CHACHA_CHIPS = ["Sha256Air", "ChaCha20Air", "ModMul256Air",
                "ModMulRsa2048Air"]


def _merged(names):
    """Both packages' merged chips of a batch, their perm traces at the
    fixed challenges, the journals, and each package's bus total (chip
    sums plus the batch's public messages)."""
    gis = [SESSIONS[n].guest_input.read_bytes() for n in names]
    ref_outs = [run_guest(GuestInput.from_cbor(b),
                          require_trust_anchor=False) for b in gis]
    outs = [trun_guest(TGuestInput.from_cbor(b), require_trust_anchor=False)
            for b in gis]
    ref_chips = jstark.build_chip_instances(
        jstark.merge_guest_outputs(ref_outs))
    chips = tstark.build_chip_instances(tstark.merge_guest_outputs(outs))
    ch = [Fp4(*GAMMA)] + delta_powers(Fp4(*DELTA), MAX_PAYLOAD)
    jch = [JFp4(*GAMMA)] + jdelta_powers(JFp4(*DELTA), MAX_PAYLOAD)
    perms = [(c.air.generate_perm_trace(c.trace, c.publics, ch),
              np.asarray(r.air.generate_perm_trace(r.trace, r.publics, jch)))
             for c, r in zip(chips, ref_chips)]
    journals = [o.journal for o in outs]
    total, ref_total = Fp4(0), JFp4(0)
    for c, (mine, want) in zip(chips, perms):
        if c.air.has_bus:
            total = total + Fp4(*[int(v) for v in mine[-1, -4:]])
            ref_total = ref_total + JFp4(*[int(v) for v in want[-1, -4:]])
    for tag, payload, mult in tstark.batch_public_messages(journals):
        total = total + mult * bus_term(ch, tag, payload)
    for tag, payload, mult in jstark.batch_public_messages(journals):
        ref_total = ref_total + mult * jbus_term(jch, tag, payload)
    return {"chips": chips, "ref_chips": ref_chips, "perms": perms,
            "journals": journals, "ref_journals": [o.journal
                                                   for o in ref_outs],
            "total": total, "ref_total": ref_total}


@pytest.fixture(scope="module")
def mixed():
    return _merged(["c02f", "1302"])


@pytest.fixture(scope="module")
def chacha():
    return _merged(["1303", "1303"])


def test_mixed_chip_set_equals_reference(mixed):
    names = [c.air.name for c in mixed["chips"]]
    assert names == [c.air.name for c in mixed["ref_chips"]] == MIXED_CHIPS
    assert mixed["journals"] == mixed["ref_journals"]
    assert tstark.batch_public_messages(mixed["journals"]) == \
        jstark.batch_public_messages(mixed["journals"])


@pytest.mark.parametrize("k", range(len(MIXED_CHIPS)), ids=MIXED_CHIPS)
def test_mixed_chip_and_perm_trace_equal_reference(mixed, k):
    mine, ref = mixed["chips"][k], mixed["ref_chips"][k]
    np.testing.assert_array_equal(mine.trace, np.asarray(ref.trace))
    assert mine.publics == [int(v) for v in ref.publics]
    np.testing.assert_array_equal(*mixed["perms"][k])


def test_mixed_bus_balances(mixed):
    assert mixed["total"] == Fp4(0)
    assert tuple(mixed["ref_total"].c) == (0, 0, 0, 0)


def test_chacha_batch_keeps_the_reference_limit(chacha):
    """Four chips, the reference's traces and perm traces, and the
    reference's same non-zero bus total."""
    names = [c.air.name for c in chacha["chips"]]
    assert names == [c.air.name for c in chacha["ref_chips"]] == CHACHA_CHIPS
    for (mine, ref), (perm, ref_perm) in zip(
            zip(chacha["chips"], chacha["ref_chips"]), chacha["perms"]):
        np.testing.assert_array_equal(mine.trace, np.asarray(ref.trace))
        np.testing.assert_array_equal(perm, ref_perm)
    assert chacha["total"] != Fp4(0)
    assert chacha["total"].c == tuple(int(v) for v in chacha["ref_total"].c)
