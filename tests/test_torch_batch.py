"""The port's batch path against the JAX package's on `c02f_x2`, the
committed TLS 1.2 c02f session twice: each package replays both sessions
with its own run_guest and merges them with its own merge_guest_outputs;
the port's merged chips (names, order, traces, publics, perm traces at
fixed challenges), batch public messages and journal_airs equal the
reference's; the bus balances against the batch's messages and a changed
filtered byte of the second journal unbalances it (the checks of
tests/test_batch_balance.py, which needs an absent fixture); and
`StarkGuestProver.prove_batch` / `verify_batch` hand the merged chips and
the batch's binding and messages to the machine prover and verifier.
Exact equality; no proof is made here (scripts/session_proof_cpu.py
--batch c02f_x2 makes the batch's CPU proof).

The merged StreamParserAir trace (the same in both packages) breaks one
constraint of the reference's AIR at the start of the second session's
region: the bcnt reset (zktls_tpu/stark/chips/stream_parser.py:276)
forces bcnt = 0 there, while the trace counts the region's first byte as
the first-row rule (:273) and the region-end length check (:280-284)
require.  So neither package can prove a batch its verifier accepts;
`test_parser_region_start_breaks_the_reference_constraint` pins that."""

import numpy as np
import pytest
import torch

from zktls_tpu.core.types import GuestInput
from zktls_tpu.guest.program import run_guest
from zktls_tpu.ops.field_ref import Fp4 as JFp4
from zktls_tpu.provers import stark as jstark
from zktls_tpu.stark.bus import delta_powers as jdelta_powers
from zktls_tpu.stark.chips.stream_parser import LAYOUT as JLAYOUT
from zktls_tpu.stark.debug import check_trace
from zktls_tpu_torch.core.types import GuestInput as TGuestInput
from zktls_tpu_torch.guest import roots
from zktls_tpu_torch.guest.program import run_guest as trun_guest
from zktls_tpu_torch.ops.field_ref import Fp4
from zktls_tpu_torch.provers import stark as tstark
from zktls_tpu_torch.stark.bus import (
    BUS_FILTERED,
    MAX_PAYLOAD,
    bus_term,
    delta_powers,
)
from zktls_tpu_torch.workload import BATCHES, SESSIONS

from .torch_threads import torch_threads_per_worker  # noqa: F401

BATCH = BATCHES["c02f_x2"]
CHIPS = [c[0] for c in BATCH.chips]

#: fixed machine challenges (γ, then δ's powers), as tests/test_suites.py
GAMMA, DELTA = (61, 2, 9, 30), (19, 23, 4, 7)


def _gi_bytes(name: str) -> bytes:
    return SESSIONS[name].guest_input.read_bytes()


@pytest.fixture(scope="module")
def batch():
    """One derivation for the module: each package's replays of the two
    sessions, its merged chips, and their perm traces at the fixed
    challenges."""
    ref_outs = [run_guest(GuestInput.from_cbor(_gi_bytes(n)),
                          require_trust_anchor=False)
                for n in BATCH.sessions]
    outs = [trun_guest(TGuestInput.from_cbor(_gi_bytes(n)),
                       require_trust_anchor=False)
            for n in BATCH.sessions]
    ref_chips = jstark.build_chip_instances(
        jstark.merge_guest_outputs(ref_outs))
    chips = tstark.build_chip_instances(tstark.merge_guest_outputs(outs))
    ch = [Fp4(*GAMMA)] + delta_powers(Fp4(*DELTA), MAX_PAYLOAD)
    jch = [JFp4(*GAMMA)] + jdelta_powers(JFp4(*DELTA), MAX_PAYLOAD)
    perms = [(c.air.generate_perm_trace(c.trace, c.publics, ch),
              np.asarray(r.air.generate_perm_trace(r.trace, r.publics, jch)))
             for c, r in zip(chips, ref_chips)]
    return {"ref_chips": ref_chips, "chips": chips, "perms": perms,
            "journals": [o.journal for o in outs], "challenges": ch,
            "ref_journals": [o.journal for o in ref_outs]}


def test_chip_set_equals_reference_and_workload(batch):
    names = [c.air.name for c in batch["chips"]]
    assert names == [c.air.name for c in batch["ref_chips"]] == CHIPS
    assert tuple((c.air.name, *c.trace.shape, c.air.perm_width)
                 for c in batch["chips"]) == BATCH.chips
    assert batch["journals"] == batch["ref_journals"]


@pytest.mark.parametrize("k", range(len(CHIPS)), ids=CHIPS)
def test_chip_instance_equals_reference(batch, k):
    mine, ref = batch["chips"][k], batch["ref_chips"][k]
    np.testing.assert_array_equal(mine.trace, np.asarray(ref.trace))
    assert mine.publics == [int(v) for v in ref.publics]


@pytest.mark.parametrize("k", range(len(CHIPS)), ids=CHIPS)
def test_perm_trace_equals_reference(batch, k):
    mine, want = batch["perms"][k]
    np.testing.assert_array_equal(mine, want)


def _proof_naming(names):
    class _Chip:
        def __init__(self, name):
            self.name = name

    class _Proof:
        chips = [_Chip(n) for n in names]
    return _Proof()


def test_batch_messages_and_airs_equal_reference(batch):
    journals = batch["journals"]
    msgs = tstark.batch_public_messages(journals)
    assert msgs == jstark.batch_public_messages(journals)
    # the second session's messages carry its stream object id and the
    # event ids after the first session's records
    first = tstark.journal_public_messages(journals[0])
    assert msgs[:len(first)] == first
    assert any(m[0] == BUS_FILTERED and m[1][0] == 2 for m in msgs)
    proof = _proof_naming(CHIPS)
    assert sorted(a.name for a in tstark.journal_airs(journals, proof)) == \
        sorted(a.name for a in jstark.journal_airs(journals, proof)) == \
        sorted(CHIPS)


def _balance(sums, msgs, challenges):
    total = Fp4(0)
    for s in sums:
        total = total + s
    for tag, payload, mult in msgs:
        total = total + mult * bus_term(challenges, tag, payload)
    return total


def test_bus_balances_and_second_journal_tamper_breaks_it(batch):
    ch = batch["challenges"]
    sums = [Fp4(*[int(v) for v in mine[-1, -4:]])
            for (mine, _), c in zip(batch["perms"], batch["chips"])
            if c.air.has_bus]
    msgs = tstark.batch_public_messages(batch["journals"])
    assert _balance(sums, msgs, ch) == Fp4(0)
    k = next(i for i, m in enumerate(msgs)
             if m[0] == BUS_FILTERED and m[1][0] == 2)
    tag, payload, mult = msgs[k]
    bad = list(msgs)
    bad[k] = (tag, payload[:3] + [payload[3] ^ 1], mult)
    assert _balance(sums, bad, ch) != Fp4(0)


def test_parser_region_start_breaks_the_reference_constraint(batch):
    """The reference's constraint checker on two 64-row blocks around the
    second session's region start: one violation, the bcnt reset, on the
    boundary transition; the same blocks of the first region are clean."""
    k = CHIPS.index("StreamParserAir")
    ref = batch["ref_chips"][k]
    trace = np.asarray(ref.trace)
    perm = batch["perms"][k][1]
    start = int(np.flatnonzero(trace[:, JLAYOUT["rs"].start])[1])
    assert start % 64 == 0 and trace[start, JLAYOUT["obj"].start] == 2
    jch = [JFp4(*GAMMA)] + jdelta_powers(JFp4(*DELTA), MAX_PAYLOAD)

    def interior_failures(r0):
        rows = slice(r0 - 64, r0 + 64)
        publics = [int(v) for v in ref.publics] + \
            [int(v) for v in perm[-1, -4:]]
        fails = check_trace(ref.air, trace[rows], publics,
                            perm_trace=perm[rows], challenges=jch,
                            max_failures=10_000)
        # rows 0 and 127 answer to first/last-row rules of a whole trace
        return [(r0 - 64 + row, c) for row, c in fails if 0 < row < 127]

    fails = interior_failures(start)
    assert len(fails) == 1 and fails[0][0] == start - 1
    assert interior_failures(start - 128) == []


def test_merge_of_one_session_is_the_session(batch):
    out = trun_guest(TGuestInput.from_cbor(_gi_bytes("c02f")),
                     require_trust_anchor=False)
    assert tstark.merge_guest_outputs([out]) is out


@pytest.fixture
def anchored(monkeypatch):
    """The loopback certificate's SPKI hash in the port's trust store."""
    leaf = bytes.fromhex(SESSIONS["c02f"].chain["root_spki_sha256"])
    store = roots.anchor_spki_hashes()
    monkeypatch.setattr(roots, "anchor_spki_hashes", lambda: store | {leaf})


def test_prove_batch_hands_over_the_reference_chips(batch, anchored,
                                                    monkeypatch):
    """prove_batch: run_guest per session, the merged chips, bound to the
    concatenated journals, on the prover's device; verify_batch: the same
    binding and the batch's messages."""
    seen = {}

    class _Proof:
        def to_bytes(self):
            return b"proof"

    def fake_prove_machine(chips, binding, config, device, timings):
        seen.update(chips=chips, binding=binding, device=device)
        return _Proof()

    monkeypatch.setattr(tstark, "prove_machine", fake_prove_machine)
    gis = [TGuestInput.from_cbor(_gi_bytes(n)) for n in BATCH.sessions]
    prover = tstark.StarkGuestProver(device="cpu")
    timings: dict = {}
    journals, proof = prover.prove_batch(gis, timings=timings)
    assert (journals, proof) == (batch["journals"], b"proof")
    assert seen["binding"] == b"".join(journals)
    assert seen["device"] == torch.device("cpu")
    assert set(timings) == {"run_guest", "build_chip_instances"}
    assert [c.air.name for c in seen["chips"]] == CHIPS
    for mine, ref in zip(seen["chips"], batch["ref_chips"]):
        np.testing.assert_array_equal(mine.trace, np.asarray(ref.trace))

    checked = {}

    def fake_verify_machine(airs, mp, binding, public_messages, config):
        checked.update(airs=sorted(a.name for a in airs), binding=binding,
                       msgs=public_messages)
        return True

    class _Parsed:
        chips = _proof_naming(CHIPS).chips

    monkeypatch.setattr(tstark, "verify_machine", fake_verify_machine)
    monkeypatch.setattr(tstark.MachineProof, "from_bytes",
                        classmethod(lambda cls, data: _Parsed()))
    assert prover.verify_batch(journals, b"proof")
    assert checked == {"airs": sorted(CHIPS), "binding": b"".join(journals),
                       "msgs": jstark.batch_public_messages(journals)}
