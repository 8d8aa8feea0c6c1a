"""`BENCHMARK.json`'s rules that its files alone can show, the frozen
Poseidon2 arithmetic against the port's own count, and the import check."""

import json
import subprocess
import sys

import pytest

import manifest
import peaks
import traffic


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_manifest_has_no_problems(bench):
    assert manifest.problems(bench) == []


def test_names_and_units_use_the_allowed_characters(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert manifest.NAME.fullmatch(m["name"]), m["name"]
        assert manifest.UNIT.fullmatch(m["unit"]), m["unit"]
    for w in bench["workloads"]:
        for key in ("name", "config", "traffic"):
            assert manifest.NAME.fullmatch(w[key]), w[key]
        assert len(w["why"]) <= 200 and "\n" not in w["why"]


def test_each_layer_metric_moves_an_end_to_end_metric_of_its_cells(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in manifest.metrics_of(bench, w["name"],
                                                      "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = manifest.metrics_of(bench, w["name"], "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (m["name"], w["name"])


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_config_files_state_the_default_stark_config(bench):
    from zktls_tpu_torch.stark.config import DEFAULT_CONFIG

    for c in bench["configs"]:
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        for key, value in cfg["stark"].items():
            assert getattr(DEFAULT_CONFIG, key) == value, key


@pytest.mark.parametrize("session", ["c02f", "1302", "1303"])
def test_frozen_poseidon2_count_is_the_ports(session):
    from zktls_tpu_torch.profile_prove import _poseidon2_work
    from zktls_tpu_torch.stark.chips import AIRS
    from zktls_tpu_torch.stark.config import DEFAULT_CONFIG
    from zktls_tpu_torch.workload import SESSIONS

    chips = [(rows, AIRS[name]().width, AIRS[name]().perm_width)
             for name, rows, _ in SESSIONS[session].chips]
    ours = peaks.poseidon2_work(
        [c + (0,) for c in chips],
        traffic.load_json("configs", "tls12_p256_aes128gcm")["stark"])
    assert ours["states"] == _poseidon2_work(chips, DEFAULT_CONFIG)


def test_the_harness_loads_no_jax():
    """After loading the harness, its readers and the program's prover, no
    top-level module is jax, jaxlib, flax or the JAX package (names
    compared whole: the port's name begins with the JAX package's)."""
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "import run, manifest, traffic, reference, peaks, devtrace\n"
        "import zkref.host.input_builder, zkref.guest.program\n"
        "import zkref.stark.machine, zkref.stark.chips\n"
        "import zktls_tpu_torch.provers.stark\n"
        "b = manifest.load()\n"
        "[manifest.reader(m['name']) for m in b['end_to_end'] + "
        "b['per_layer']]\n"
        "print(run.forbidden_modules(), 'zktls_tpu_torch' in sys.modules)\n")
    out = subprocess.run(
        [sys.executable, "-c", code, str(manifest.HERE),
         str(manifest.ROOT)], capture_output=True, text=True, check=True,
        timeout=300)
    assert out.stdout.split("\n")[-2] == "[] True"
