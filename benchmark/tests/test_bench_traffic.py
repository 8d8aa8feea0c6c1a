"""The traffic generator: a seed fixes the bodies and the client's draws, and
the frozen recorder's sessions replay to the chip shapes each cell
expects."""

import numpy as np
import pytest

import traffic


@pytest.mark.parametrize("mix", ["price512"])
def test_seed_fixes_bodies_and_client_draws(mix):
    m = traffic.load_json("traffic", mix)
    for seed in (0, 2**31 + 11, 7 * 2**40):
        a, b = traffic.session_rng(seed, 3), traffic.session_rng(seed, 3)
        assert traffic.response_records(m, a) == traffic.response_records(m, b)
        assert a.bytes(64) == b.bytes(64)
    one = traffic.response_records(m, traffic.session_rng(5, 0))
    other = traffic.response_records(m, traffic.session_rng(5, 1))
    assert one != other
    assert [len(r) for r in one] == [len(r) for r in other]
    assert len(one) == m["records"]
    body = b"".join(one).split(b"\r\n\r\n", 1)[1]
    assert len(body) == m["body_bytes"]
    assert m["filter"]["prefix"].encode() in body


def test_recordings_of_a_seed_agree_but_for_the_server():
    """Two recordings of one session index: the same request, response and
    client draws (the server's own draws differ)."""
    from zkref.core.types import GuestInput

    cfg = traffic.load_json("configs", "tls13_x25519_chacha20")
    mix = traffic.load_json("traffic", "price512")
    (a, sa), = traffic.record(cfg, mix, 2**31 + 3, [4])
    (b, sb), = traffic.record(cfg, mix, 2**31 + 3, [4])
    assert sa == sb
    ga, gb = GuestInput.from_cbor(a), GuestInput.from_cbor(b)
    assert ga.response.random == gb.response.random
    assert ga.response.response == gb.response.response == sa.response
    assert ga.response.time == gb.response.time


def _shapes(gi_cbor):
    from zktls_tpu_torch.core.types import GuestInput
    from zktls_tpu_torch.guest.program import run_guest
    from zktls_tpu_torch.provers.stark import build_chip_instances

    out = run_guest(GuestInput.from_cbor(gi_cbor), require_trust_anchor=False)
    return [[c.air.name, c.trace.shape[0], c.air.width]
            for c in build_chip_instances(out)]


@pytest.mark.parametrize("config,session", [
    ("tls12_p256_aes128gcm", "c02f"), ("tls13_x25519_chacha20", "1303")])
def test_price512_has_the_committed_sessions_shapes(config, session):
    from zktls_tpu_torch.workload import SESSIONS

    cfg = traffic.load_json("configs", config)
    mix = traffic.load_json("traffic", "price512")
    (gi, _), = traffic.record(cfg, mix, 2**31 + 17, [0])
    shapes = _shapes(gi)
    assert shapes == [list(c) for c in SESSIONS[session].chips]
    assert [name for name, _, _ in shapes] == cfg["chips"]


@pytest.mark.parametrize("config", ["tls12_p256_aes128gcm",
                                    "tls13_x25519_chacha20"])
def test_an_answer_of_the_references_size_has_price512s_shapes(config):
    """The reference's recorded answer is about 445 bytes of plaintext;
    price512's 512-byte body (584 bytes of response) builds every chip at
    the same height."""
    cfg = traffic.load_json("configs", config)
    mix = traffic.load_json("traffic", "price512")
    small = dict(mix, body_bytes=374)
    (gi, sent), = traffic.record(cfg, small, 12345, [1])
    assert len(sent.response) == 446
    (gi512, _), = traffic.record(cfg, mix, 12345, [1])
    assert _shapes(gi) == _shapes(gi512)


def test_session_rng_takes_any_integer():
    for seed in (-1, 0, 2**31, 2**64 + 5):
        assert isinstance(traffic.session_rng(seed, 0), np.random.Generator)
    assert (traffic.session_rng(-1, 0).bytes(8)
            != traffic.session_rng(1, 0).bytes(8))
