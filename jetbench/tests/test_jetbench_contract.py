"""``BENCHMARK.json`` against the rules its checker holds it to, the files
the harness looks up by name, and the imports of the benchmark."""

import ast
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def line_text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line_text(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert BENCH["paths"] == ["jetbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_text(c["source"]) and line_text(c["why"])
        assert c["file"].startswith("jetbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line_text(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert line_text(m["layer"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_cells_metrics_and_their_files():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert {w["config"] for w in cells.values()} == \
        {c["name"] for c in BENCH["configs"]}
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == \
        len(cells)
    four = sum(w["chips"] == 4 for w in cells.values())
    assert four <= max(1, math.floor(len(cells) / 4))
    for w in cells.values():
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        cfg = json.loads((ROOT / {c["name"]: c for c in BENCH["configs"]}
                          [w["config"]]["file"]).read_text())
        assert (HERE / "drivers" / f"{cfg['driver']}.py").is_file()
        ends = [m for m in e2e.values()
                if w["name"] in m.get("workloads", [w["name"]])]
        layers = [m for m in BENCH["per_layer"]
                  if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2
        assert layers
        for m in layers:
            # a per-layer metric moves an end-to-end metric of its cells
            assert m["moves"] in {e["name"] for e in ends}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= set(cells)
    assert {m["moves"] for m in BENCH["per_layer"]} == {"events_per_s"}


def imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for path in files:
        tops = {name.split(".")[0] for name in imports_of(path)}
        assert not tops & FORBIDDEN, path
        if "reference" in path.relative_to(HERE).parts:
            assert "repro_torch" not in tops, path


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "q5-paper.catchup8", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "needs 1 CUDA devices" in proc.stderr
