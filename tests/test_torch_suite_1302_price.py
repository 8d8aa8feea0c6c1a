"""The benchmark's `tls13_x25519_aes256gcm` configuration on the CPU: one
TLS 1.3 AES-256-GCM-SHA384 (0x1302) session over x25519, recorded by the
benchmark's own generator (`benchmark/traffic.py`) under its `price512`
mix, replayed and built by the port:

  * the port's chips, in build order and at their heights, are the
    configuration's `chips` and the committed 0x1302 session's
    (`workload.SESSIONS["1302"]`);
  * Sha512Air's and Aes256Air's traces, publics and LogUp perm traces at
    fixed challenges equal the JAX package's, built from its own replay of
    the same recording;
  * every SHA-384 digest the replay takes (transcript hashes, HKDF's
    HMACs, the certificate's hashes) is what Sha512Air's result row holds
    (the last row of the group of that hash's last compression, whose
    `dig` columns the chip's bus messages read) and equals `hashlib`'s
    over the same message;
  * the port's journal is the frozen replay's (`benchmark/zkref`, the
    judge of the benchmark's `correct`) and states what the server sent.

Exact equality throughout; no proof is made here."""

import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest

from zktls_tpu.core.types import GuestInput as JGuestInput
from zktls_tpu.guest.program import run_guest as jrun_guest
from zktls_tpu.models.aes128_chip import aes_instances as jaes_instances
from zktls_tpu.ops.field_ref import Fp4 as JFp4
from zktls_tpu.stark.bus import delta_powers as jdelta_powers
from zktls_tpu.stark.chips.sha512 import Sha512Air as JSha512Air
from zktls_tpu.stark.chips.sha512 import sha512_trace as jsha512_trace
from zktls_tpu_torch.core.types import GuestInput
from zktls_tpu_torch.guest.crypto import sha512 as tsha512
from zktls_tpu_torch.guest.program import run_guest
from zktls_tpu_torch.ops.field_ref import Fp4
from zktls_tpu_torch.provers.stark import build_chip_instances
from zktls_tpu_torch.stark.bus import MAX_PAYLOAD, delta_powers
from zktls_tpu_torch.stark.chips.sha512 import GROUP_ROWS, LAYOUT
from zktls_tpu_torch.workload import SESSIONS

from .torch_threads import torch_threads_per_worker  # noqa: F401

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

import reference  # noqa: E402
import traffic  # noqa: E402

CONFIG = traffic.load_json("configs", "tls13_x25519_aes256gcm")
SEED = 2**31 + 1302
#: fixed machine challenges (γ, then δ's powers), as tests/test_suites.py
GAMMA, DELTA = (61, 2, 9, 30), (19, 23, 4, 7)


@pytest.fixture(scope="module")
def recorded():
    """(GuestInput CBOR, what the server sent) of session 0 of a price512
    run of this configuration."""
    (gi, sent), = traffic.record(CONFIG, traffic.load_json(
        "traffic", "price512"), SEED, [0])
    return gi, sent


class _DigestLog:
    """Wraps the port's SHA-512 family so each recorded hash keeps the
    bytes it was given; `entries` gets (recorder, index of the hash's last
    compression, hashlib name, message, digest) for every digest taken."""

    def __init__(self, monkeypatch):
        self.entries = []
        cls = tsha512.SHA512
        update, copy, digest = cls.update, cls.copy, cls.digest

        def logged_update(h, data):
            h._msg = getattr(h, "_msg", b"") + bytes(data)
            return update(h, data)

        def logged_copy(h):
            c = copy(h)
            c._msg = getattr(h, "_msg", b"")
            return c

        def logged_digest(h, result_tag=0):
            out = digest(h, result_tag)
            if h._recorder is not None:
                name = "sha384" if isinstance(h, tsha512.SHA384) \
                    else "sha512"
                self.entries.append((h._recorder,
                                     len(h._recorder.events) - 1, name,
                                     getattr(h, "_msg", b""), out))
            return out

        monkeypatch.setattr(cls, "update", logged_update)
        monkeypatch.setattr(cls, "copy", logged_copy)
        monkeypatch.setattr(cls, "digest", logged_digest)


@pytest.fixture(scope="module")
def port(recorded):
    """The port's replay (with every SHA-384/512 digest logged) and its
    chips by name."""
    with pytest.MonkeyPatch.context() as mp:
        log = _DigestLog(mp)
        out = run_guest(GuestInput.from_cbor(recorded[0]),
                        require_trust_anchor=False)
    chips = build_chip_instances(out)
    return {"out": out, "chips": chips, "digests": log.entries,
            "by_name": {c.air.name: c for c in chips}}


@pytest.fixture(scope="module")
def jax_chips(recorded):
    """The JAX package's Sha512Air and Aes256Air, (air, trace, publics),
    from its own replay."""
    ref = jrun_guest(JGuestInput.from_cbor(recorded[0]),
                     require_trust_anchor=False)
    trace, publics = jsha512_trace(ref.replay.sha512_recorder.events)
    aes, = jaes_instances(ref.replay.gcm_events)
    return {"Sha512Air": (JSha512Air(), trace, publics),
            "Aes256Air": (aes.air, aes.trace, aes.publics)}


def test_chips_are_the_configurations_and_the_committed_sessions(port):
    out = port["out"]
    assert out.replay.cipher_suite.id == int(CONFIG["tls"]["suite"], 16)
    shapes = tuple((c.air.name, *c.trace.shape) for c in port["chips"])
    assert shapes == SESSIONS["1302"].chips
    assert [name for name, _, _ in shapes] == CONFIG["chips"]


@pytest.mark.parametrize("name", ["Sha512Air", "Aes256Air"])
def test_chip_equals_the_jax_packages(port, jax_chips, name):
    chip = port["by_name"][name]
    ref_air, trace, publics = jax_chips[name]
    assert ref_air.name == name
    np.testing.assert_array_equal(chip.trace, np.asarray(trace))
    assert chip.publics == [int(v) for v in publics]
    ch = [Fp4(*GAMMA)] + delta_powers(Fp4(*DELTA), MAX_PAYLOAD)
    jch = [JFp4(*GAMMA)] + jdelta_powers(JFp4(*DELTA), MAX_PAYLOAD)
    np.testing.assert_array_equal(
        chip.air.generate_perm_trace(chip.trace, chip.publics, ch),
        np.asarray(ref_air.generate_perm_trace(trace, publics, jch)))


def test_sha512air_groups_hold_hashlibs_digests(port):
    rec = port["out"].replay.sha512_recorder
    trace = port["by_name"]["Sha512Air"].trace
    pad = trace.shape[0] // GROUP_ROWS - len(rec.events)
    dig, has_tag = LAYOUT["dig"], LAYOUT["has_tag"].start
    mine = [(i, name, msg, out)
            for r, i, name, msg, out in port["digests"] if r is rec]
    assert mine and {name for _, name, _, _ in mine} == {"sha384"}
    checked = set()
    for i, name, msg, out in mine:
        group = pad + i
        row = trace[(group + 1) * GROUP_ROWS - 1]
        limbs = [int(v) for v in row[dig]]
        words = [sum(limbs[4 * w + k] << (16 * k) for k in range(4))
                 for w in range(8)]
        got = b"".join(w.to_bytes(8, "big") for w in words)[:len(out)]
        assert got == out == hashlib.new(name, msg).digest()
        checked.add(group)
    assert len(checked) == len(mine)
    # a result published with a tag would be one of these rows
    tagged = np.flatnonzero(trace[GROUP_ROWS - 1::GROUP_ROWS, has_tag])
    assert set(tagged.tolist()) <= checked


def test_journal_is_the_frozen_replays_and_states_what_was_sent(
        recorded, port):
    gi, sent = recorded
    journal = port["out"].journal
    assert journal == reference.replay_journal(gi)
    spki = traffic.leaf_spki_sha256(CONFIG)
    assert reference.answer_diff(journal, reference.expected_answer(
        sent, CONFIG, spki)) == []
