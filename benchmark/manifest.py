"""`BENCHMARK.json` at the checkout's root: the cells, the metrics and where
the harness finds each one's files.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by its name: `configs/<config>.json`,
`traffic/<traffic>.json`, `metrics/<metric>.py` (a `read(ctx)` that
returns the value, or None when it finds nothing to read).  `problems`
lists the breaches of the manifest's rules that a file alone can show.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(manifest: dict, cell_name: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics a cell reports."""
    return [m for m in manifest[kind]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str):
    """`metrics/<name>.py`'s `read`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def problems(manifest: dict) -> list[str]:
    out = []
    names = ([c["name"] for c in manifest["configs"]]
             + [w["name"] for w in manifest["workloads"]]
             + [m["name"] for m in manifest["end_to_end"]]
             + [m["name"] for m in manifest["per_layer"]]
             + [w["config"] for w in manifest["workloads"]]
             + [w["traffic"] for w in manifest["workloads"]]
             + [k for c in manifest["configs"] for k in c["reduced"]])
    out += [f"bad name {n!r}" for n in names if not NAME.fullmatch(n)]
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            if not UNIT.fullmatch(m["unit"]):
                out.append(f"bad unit {m['unit']!r} of {m['name']}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"bad better of {m['name']}")
            if m["source"] not in SOURCES:
                out.append(f"bad source of {m['name']}")
            if not (HERE / "metrics" / f"{m['name']}.py").is_file():
                out.append(f"no reader for {m['name']}")
    for m in manifest["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"end-to-end {m['name']} not from the host or trace")
    e2e_names = {m["name"] for m in manifest["end_to_end"]}
    for w in manifest["workloads"]:
        e2e = {m["name"] for m in metrics_of(manifest, w["name"],
                                              "end_to_end")}
        layer = metrics_of(manifest, w["name"], "per_layer")
        if "setup_s" not in e2e or len(e2e) < 2 or not layer:
            out.append(f"{w['name']} reports too few metrics")
        for m in layer:
            if m["moves"] not in e2e:
                out.append(f"{m['name']} moves {m['moves']}, which "
                           f"{w['name']} does not report")
        if not (HERE / "configs" / f"{w['config']}.json").is_file():
            out.append(f"no configuration file for {w['config']}")
        if not (HERE / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"no traffic file for {w['traffic']}")
    for m in manifest["per_layer"]:
        if m["moves"] not in e2e_names:
            out.append(f"{m['name']} moves an unknown metric")
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    if len(set(pairs)) != len(pairs):
        out.append("a configuration and traffic pair appears twice")
    for c in manifest["configs"]:
        path = ROOT / c["file"]
        if not path.is_file():
            out.append(f"no file {c['file']}")
            continue
        data = json.loads(path.read_text())
        if data.get("reduced") != c["reduced"]:
            out.append(f"{c['name']}: reduced differs from its file")
        if data.get("source") != c["source"]:
            out.append(f"{c['name']}: source differs from its file")
    return out
