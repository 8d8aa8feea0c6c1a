"""The port's `prove` command and StarkGuestProver.prove against the JAX
package's, on the committed loopback session.  Its self-signed certificate
anchors to no root of the store, so — as chip_smoke.py does on the card —
the leaf's own SPKI hash is added to the trust store of each package for
these tests; verify_chain then publishes that same hash, and the journal is
the bytes run_guest(require_trust_anchor=False) gives.  No proof is made:
prove_machine is replaced by a stub that records what it was given."""

import json
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from zktls_tpu.cli import main as jmain
from zktls_tpu.core.legacy import (
    LegacyGuestInput,
    LegacyRequest,
    LegacyTemplate,
)
from zktls_tpu.core.types import FilteredResponse
from zktls_tpu.core.types import GuestInput as JGuestInput
from zktls_tpu.guest import roots as jroots
from zktls_tpu.guest.program import run_guest as jrun_guest
from zktls_tpu.provers import stark as jstark
from zktls_tpu_torch.cli import main
from zktls_tpu_torch.core.types import GuestInput, Request
from zktls_tpu_torch.guest import roots
from zktls_tpu_torch.provers import stark as tstark
from zktls_tpu_torch.provers.mock import MockProver
from zktls_tpu_torch.workload import SESSION_GUEST_INPUT

from .torch_threads import torch_threads_per_worker  # noqa: F401

#: SHA-256 of the session leaf's SubjectPublicKeyInfo
LEAF_SPKI = bytes.fromhex(
    "90b0c5f1760d339a3d12a1abf60ccd08760d542d1c38259654c95efb485ed45c")


@pytest.fixture
def anchored(monkeypatch):
    """Both packages' trust stores with the session leaf added."""
    for mod in (roots, jroots):
        store = mod.anchor_spki_hashes() | {LEAF_SPKI}
        monkeypatch.setattr(mod, "anchor_spki_hashes", lambda s=store: s)


@pytest.fixture
def request_json(tmp_path) -> str:
    gi = GuestInput.from_cbor(SESSION_GUEST_INPUT.read_bytes())
    p = tmp_path / "request.json"
    p.write_text(gi.request.to_json())
    return str(p)


@pytest.fixture(scope="module")
def reference():
    """The reference's journal and chips of the committed session."""
    out = jrun_guest(JGuestInput.from_cbor(SESSION_GUEST_INPUT.read_bytes()),
                     require_trust_anchor=False)
    return out.journal, jstark.build_chip_instances(out)


def test_prove_mock_writes_the_reference_journal(anchored, request_json,
                                                 tmp_path, capsys,
                                                 reference):
    args = ["prove", "-i", request_json, "-t", "evm", "--mock",
            "--fixture", str(SESSION_GUEST_INPUT)]
    assert main(args + ["-o", str(tmp_path / "port.json")]) == 0
    printed = capsys.readouterr().out
    assert jmain(args + ["-o", str(tmp_path / "ref.json")]) == 0
    assert capsys.readouterr().out == printed
    mine = json.loads((tmp_path / "port.json").read_text())
    assert mine == json.loads((tmp_path / "ref.json").read_text())
    assert mine["journal"] == "0x" + reference[0].hex()
    assert mine["proof"] == "0x" and mine["target_chain"] == "evm"


def test_prove_mock_reads_a_legacy_schema_fixture(anchored, request_json,
                                                  tmp_path, reference):
    """The committed session rewritten in the legacy schema (the request as
    a redaction template): both CLIs fall back to it and give the same
    journal."""
    gi = JGuestInput.from_cbor(SESSION_GUEST_INPUT.read_bytes())
    req, resp = gi.request.request_info, gi.response
    host = req.request.index(b"localhost")
    legacy = LegacyGuestInput(
        request=LegacyRequest(
            url=req.remote_addr, server_name=req.server_name,
            template=LegacyTemplate(
                template_hash=bytes(32),
                template=req.request.replace(b"localhost", b"", 1),
                offsets=[host], fields=[b"localhost"],
                unencrypted_offset=0),
            encrypted_key=b""),
        time=resp.time, stream=resp.stream, random=resp.random,
        response=resp.response,
        filtered_responses=[FilteredResponse(begin=b, length=n, bytes=c)
                            for b, n, c in zip(
                                resp.filtered_responses_begin,
                                resp.filtered_responses_length,
                                resp.filtered_responses)])
    fixture = tmp_path / "legacy.cbor"
    fixture.write_bytes(legacy.to_cbor())
    with pytest.raises(Exception):      # not the current schema
        GuestInput.from_cbor(fixture.read_bytes())
    args = ["prove", "-i", request_json, "--mock", "--fixture", str(fixture)]
    assert main(args + ["-o", str(tmp_path / "port.json")]) == 0
    assert jmain(args + ["-o", str(tmp_path / "ref.json")]) == 0
    mine = json.loads((tmp_path / "port.json").read_text())
    assert mine == json.loads((tmp_path / "ref.json").read_text())
    assert mine["journal"] == "0x" + reference[0].hex()


def test_prove_mock_refuses_the_unanchored_session(request_json, capsys):
    """Without the patch both CLIs report the chain, as the reference
    does."""
    args = ["prove", "-i", request_json, "--mock",
            "--fixture", str(SESSION_GUEST_INPUT)]
    assert main(args) == 1
    assert "does not anchor" in capsys.readouterr().err
    assert jmain(args) == 1
    assert "does not anchor" in capsys.readouterr().err


def test_prove_rejects_a_tampered_fixture(anchored, request_json, tmp_path,
                                          capsys):
    gi = GuestInput.from_cbor(SESSION_GUEST_INPUT.read_bytes())
    stream = bytearray(gi.response.stream)
    stream[-30] ^= 1
    gi.response.stream = bytes(stream)
    bad = tmp_path / "bad.cbor"
    bad.write_bytes(gi.to_cbor())
    assert main(["prove", "-i", request_json, "--mock",
                 "--fixture", str(bad)]) == 1
    assert "error" in capsys.readouterr().err
    assert main(["prove", "-i", request_json, "--mock",
                 "--fixture", str(request_json)]) == 1
    assert "not a recorded session" in capsys.readouterr().err


def test_prove_missing_input_file(capsys):
    assert main(["prove", "-i", "/nonexistent.json", "--mock"]) == 2
    assert "does not exist" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [
    ["prove", "--network"], ["prove"], ["serve"]],
    ids=["network", "live", "serve"])
def test_unported_modes_exit_1(request_json, tmp_path, capsys, extra):
    """Live recording (no --fixture), the remote prover and the prover
    service, all ported now, exit 1 with the error when their peer or port
    is not there — a closed port to record from or prove at, a port
    already taken to serve on — and are not run some other way."""
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    port = taken.getsockname()[1]
    try:
        if extra == ["serve"]:
            taken.listen(1)
            args = ["serve", "-p", "mock", "--port", str(port)]
            want = "in use"
        elif extra == ["prove"]:
            taken.close()
            req = tmp_path / "closed.json"
            req.write_text(Request.from_json(pathlib.Path(
                request_json).read_text()).to_json().replace(
                    GuestInput.from_cbor(SESSION_GUEST_INPUT.read_bytes())
                    .request.request_info.remote_addr, f"127.0.0.1:{port}"))
            args = ["prove", "-i", str(req), "--mock"]
            want = "refused"
        else:
            taken.close()
            args = ["prove", "-i", request_json, "--fixture",
                    str(SESSION_GUEST_INPUT), "--network", "--server",
                    f"http://127.0.0.1:{port}"]
            want = "remote prove failed"
        assert main(args) == 1
        assert want in capsys.readouterr().err
    finally:
        taken.close()


def test_prove_compress_compresses_then_verifies(anchored, request_json,
                                                 monkeypatch, capsys,
                                                 reference):
    """`prove -p stark --compress`: the prover's compress, then its
    verify_compressed, each on the bytes the step before gave; the
    compressed blob is what the command prints.  The prover runs on the
    CPU with its machine proof and recursion stubbed."""
    calls = []

    class _Prover(tstark.StarkGuestProver):
        def __init__(self):
            super().__init__(device="cpu")

        def prove(self, guest_input, timings=None):
            journal = tstark.run_guest(guest_input).journal
            calls.append(("prove", journal))
            return journal, b"inner proof"

        def compress(self, journal, proof, outer_config=None,
                     timings=None):
            calls.append(("compress", journal, proof))
            return b"compressed blob"

        def verify_compressed(self, journal, blob, outer_config=None,
                              cache_dir=None):
            calls.append(("verify_compressed", journal, blob))
            return True

    monkeypatch.setattr(tstark, "StarkGuestProver", _Prover)
    assert main(["prove", "-i", request_json, "-p", "stark", "--fixture",
                 str(SESSION_GUEST_INPUT), "--compress"]) == 0
    journal = reference[0]
    assert calls == [("prove", journal),
                     ("compress", journal, b"inner proof"),
                     ("verify_compressed", journal, b"compressed blob")]
    assert capsys.readouterr().out.splitlines()[-1] == \
        "proof: 0x" + b"compressed blob".hex()


def test_prove_wrap_wraps_then_verifies(anchored, request_json, monkeypatch,
                                        capsys, reference):
    """`prove -p stark --wrap`: the prover's wrap (with a timings dict),
    then its verify_wrapped, each on the bytes the step before gave; the
    sealed blob is what the command prints, and --wrap takes precedence
    over --compress as in the reference.  The prover runs on the CPU with
    its machine proof and wrap stubbed."""
    calls = []

    class _Prover(tstark.StarkGuestProver):
        def __init__(self):
            super().__init__(device="cpu")

        def prove(self, guest_input, timings=None):
            journal = tstark.run_guest(guest_input).journal
            calls.append(("prove", journal))
            return journal, b"inner proof"

        def wrap(self, journal, proof, groth16_keys=None,
                 shrink_config=None, timings=None, **kw):
            calls.append(("wrap", journal, proof, timings))
            return b"sealed blob"

        def verify_wrapped(self, journal, blob):
            calls.append(("verify_wrapped", journal, blob))
            return True

    monkeypatch.setattr(tstark, "StarkGuestProver", _Prover)
    assert main(["prove", "-i", request_json, "-p", "stark", "--fixture",
                 str(SESSION_GUEST_INPUT), "--wrap", "--compress"]) == 0
    journal = reference[0]
    assert calls == [("prove", journal),
                     ("wrap", journal, b"inner proof", {}),
                     ("verify_wrapped", journal, b"sealed blob")]
    assert capsys.readouterr().out.splitlines()[-1] == \
        "proof: 0x" + b"sealed blob".hex()


def test_export_verifier_writes_the_reference_files(tmp_path, capsys):
    """`export-verifier -t evm -o DIR`: the port's three files are the
    JAX package's bytes, and the command prints one line per file as the
    reference does."""
    mine, ref = tmp_path / "port", tmp_path / "ref"
    assert main(["export-verifier", "-t", "evm", "-o", str(mine)]) == 0
    printed = capsys.readouterr().out
    assert jmain(["export-verifier", "-t", "evm", "-o", str(ref)]) == 0
    assert capsys.readouterr().out == printed.replace(str(mine), str(ref))
    names = sorted(p.name for p in mine.iterdir())
    assert names == ["Groth16Verifier.sol", "ZkTlsVerifier.sol", "vk.json"]
    for name in names:
        assert (mine / name).read_bytes() == (ref / name).read_bytes()


def test_prove_mock_compress_as_the_reference(anchored, request_json,
                                              monkeypatch, capsys):
    """`--mock --compress`: the mock proof is empty, so both CLIs skip the
    compress step and print the same lines; a prover without `compress`
    that returns proof bytes gets the reference's "--compress needs the
    stark prover" (exit code 2)."""
    args = ["prove", "-i", request_json, "--mock", "--compress",
            "--fixture", str(SESSION_GUEST_INPUT)]
    assert main(args) == 0
    printed = capsys.readouterr().out
    assert jmain(args) == 0
    assert capsys.readouterr().out == printed
    assert printed.splitlines()[-1] == "proof: 0x"
    monkeypatch.setattr(MockProver, "prove",
                        lambda self, gi: (b"journal", b"proof"))
    assert main(args) == 2
    assert "--compress needs the stark prover" in capsys.readouterr().err


def test_stark_prover_proves_the_reference_chips(anchored, monkeypatch,
                                                  reference):
    """StarkGuestProver(device="cpu").prove: run_guest, then the
    reference's chips, bound to the journal, on the device asked for."""
    seen = {}

    class _Proof:
        def to_bytes(self):
            return b"proof"

    def fake_prove_machine(chips, binding, config, device, timings):
        seen.update(chips=chips, binding=binding, config=config,
                    device=device)
        return _Proof()

    monkeypatch.setattr(tstark, "prove_machine", fake_prove_machine)
    gi = GuestInput.from_cbor(SESSION_GUEST_INPUT.read_bytes())
    timings: dict = {}
    prover = tstark.StarkGuestProver(device="cpu")
    journal, proof = prover.prove(gi, timings=timings)
    ref_journal, ref_chips = reference
    assert (journal, proof) == (ref_journal, b"proof")
    assert seen["binding"] == journal
    assert seen["device"] == torch.device("cpu")
    assert seen["config"] is prover.config
    assert set(timings) == {"run_guest", "build_chip_instances"}
    assert [c.air.name for c in seen["chips"]] == \
        [c.air.name for c in ref_chips]
    for mine, ref in zip(seen["chips"], ref_chips):
        np.testing.assert_array_equal(mine.trace, np.asarray(ref.trace))
        assert mine.publics == [int(v) for v in ref.publics]
    assert MockProver().prove(gi) == (journal, b"")


def test_stark_prover_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstark.StarkGuestProver()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstark.StarkGuestProver(device="cuda")
    assert tstark.StarkGuestProver(device="cpu").device.type == "cpu"


def test_cli_replays_without_jax_or_cryptography(request_json):
    """The port's `prove` command in a process of its own: the replay runs
    (and refuses the unanchored session) with no module of jax, zktls_tpu
    or cryptography imported."""
    code = (
        "import sys\n"
        "from zktls_tpu_torch.cli import main\n"
        f"rc = main(['prove', '-i', {request_json!r}, '--mock', "
        f"'--fixture', {str(SESSION_GUEST_INPUT)!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'zktls_tpu', 'cryptography'))\n"
        "print(rc, bad)\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.stdout.strip() == "1 []", res.stdout + res.stderr
    assert "does not anchor" in res.stderr


def test_native_and_batch_path_without_jax_or_cryptography():
    """The host Poseidon2, MiMC and MSM libraries (one MSM of 64 points
    through C), the batch path (two sessions' replays,
    merge_guest_outputs, build_chip_instances, batch_public_messages), the
    compress and shrink rungs' modules, the Groth16 layer's (snark/,
    verifier_export), the RV32IM executor (routez/) and the multi-device
    modules (parallel/, one sharded NTT on two CPU shards) in a process of
    their own import no module of jax, zktls_tpu or cryptography."""
    code = (
        "import sys\n"
        "from zktls_tpu_torch.ops.poseidon2 import Poseidon2\n"
        "from zktls_tpu_torch.provers import stark\n"
        "from zktls_tpu_torch.stark import debug, recursion\n"
        "from zktls_tpu_torch.stark import commit_bn, machine_bn\n"
        "from zktls_tpu_torch.snark import wrap\n"
        "from zktls_tpu_torch.snark import bn254, groth16, r1cs, "
        "stark_wrap\n"
        "from zktls_tpu_torch import verifier_export\n"
        "from zktls_tpu_torch import routez\n"
        "from zktls_tpu_torch.parallel import mesh, ntt as pntt\n"
        "from zktls_tpu_torch.ops.ntt import ntt\n"
        "import torch\n"
        "x = torch.arange(1, 17, dtype=torch.int64)\n"
        "assert torch.equal(pntt.ntt_sharded(x, mesh.make_mesh("
        "1, 2, ['cpu'] * 2)), ntt(x))\n"
        "pts = bn254.g1_base_mul_batch(list(range(1, 65)))\n"
        "assert bn254.msm_g1(pts, [1] * 64) == "
        "bn254.g1_mul(bn254.G1, 64 * 65 // 2)\n"
        "from zktls_tpu_torch.stark.chips import bytes_table\n"
        "from zktls_tpu_torch import profile_prove\n"
        "from zktls_tpu_torch.workload import batch_machine\n"
        "assert len(Poseidon2(24).permute_ints(list(range(24)))) == 24\n"
        "import numpy as np\n"
        "m = np.arange(36, dtype=np.uint32).reshape(4, 9)\n"
        "assert commit_bn.MimcTree(m).root == "
        "commit_bn.MimcTree(m, native=False).root\n"
        "chips, journals = batch_machine('c02f_x2')\n"
        "msgs = stark.batch_public_messages(journals)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'zktls_tpu', 'cryptography'))\n"
        "print(len(chips), len(journals), bool(msgs), bad)\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.stdout.strip() == "12 2 True []", res.stdout + res.stderr
