"""BENCHMARK.json and the files it names: the shapes the benchmark's
contract fixes, and a throwaway cell found by name in a temporary
directory with no edit to a committed file."""

from __future__ import annotations

import json
import re
import time

import pytest

from portbench import harness
from portbench.tests.conftest import copy_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert all(PATH.match(p) and ".." not in p for p in MANIFEST["paths"])
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check with 24 cells fits the driver's 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_configs():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []


def test_workloads_and_their_files():
    names = [w["name"] for w in MANIFEST["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}
    assert len(pairs) == len(names)
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(names) // 4)
    bench = harness.Bench()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        cell = bench.cell(w["name"])
        assert cell.workload["why"] == w["why"]
        bench.find("drivers", f"{cell.traffic['driver']}.py")
        bench.find("systems", f"{cell.config['system']}.py")
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert cell.workload["limits"]


def test_metrics():
    seen = set()
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in MANIFEST["end_to_end"])
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in SOURCES
        layers.setdefault(m["layer"], set()).add(m["name"])
        harness.Bench().find("metrics", f"{m['name'].split('.')[0]}.py")
        for w in m["workloads"]:
            # each listed cell reports the metric it moves
            cell = harness.Bench().cell(w)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells


def test_a_cell_added_as_new_files_is_found(tmp_path):
    """A throwaway configuration, traffic mix, driver and per-layer metric,
    added as new files to a copy of the benchmark in a temporary directory
    (no committed file edited), run by name through the harness."""
    root = tmp_path
    pb = root / "portbench"
    copy_bench(root)
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["configs"].append({"name": "toy", "source": "https://example.org",
                                "file": "portbench/configs/toy.json",
                                "reduced": [], "why": "a toy"})
    manifest["workloads"].append({"name": "toy_cell", "config": "toy",
                                  "traffic": "toy_mix", "chips": 1,
                                  "why": "a throwaway cell"})
    manifest["end_to_end"].append({"name": "toy_per_s", "unit": "1/s",
                                   "better": "higher", "bound": 0.05,
                                   "source": "host_clock",
                                   "workloads": ["toy_cell"]})
    manifest["per_layer"].append({"name": "toy_count.toy", "unit": "count",
                                  "better": "higher",
                                  "source": "program_counter",
                                  "layer": "Toy", "moves": "toy_per_s",
                                  "workloads": ["toy_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    (pb / "configs" / "toy.json").write_text(json.dumps({"size": 3}))
    (pb / "workloads" / "toy_cell.json").write_text(json.dumps(
        {"name": "toy_cell", "config": "toy", "traffic": "toy_mix",
         "chips": 1, "why": "a throwaway cell", "limits": {"err": 0.5}}))
    (pb / "traffic" / "toy_mix.json").write_text(json.dumps(
        {"driver": "toy_driver", "trace_requests": 2}))
    (pb / "drivers" / "toy_driver.py").write_text(
        "import time\n"
        "def prepare(run):\n"
        "    run.system = type('S', (), {'timings': {}})()\n"
        "def request(run, i):\n"
        "    return i\n"
        "def window(run):\n"
        "    t0 = time.perf_counter(); n = 0\n"
        "    while time.perf_counter() - t0 < run.seconds:\n"
        "        request(run, n); n += 1\n"
        "    run.window_s = time.perf_counter() - t0\n"
        "    run.state['attempted'] = n\n"
        "def end_to_end(run):\n"
        "    return {'toy_per_s': run.state['attempted'] / run.window_s}\n"
        "def release(run):\n"
        "    pass\n"
        "def check(run):\n"
        "    return {'err': (0.0, run.cell.workload['limits']['err'])}, 0\n")
    (pb / "metrics" / "toy_count.py").write_text(
        "def read(run):\n    return run.state['attempted']\n")
    bench = harness.Bench(root)
    # the committed cells are still found through the committed files
    assert bench.cell("bie_solve").config["n"] == 2048
    out = harness.execute(bench, "toy_cell", 5, 0.05, False, "cpu",
                          time.perf_counter())
    assert out["correct"] and set(out["metrics"]) == {"toy_per_s",
                                                      "setup_s"}
    out = harness.execute(bench, "toy_cell", 5, 0.05, True, "cpu",
                          time.perf_counter())
    assert set(out["metrics"]) == {"toy_count.toy"}


def test_a_cell_that_disagrees_with_the_manifest_is_refused(tmp_path):
    manifest = json.loads(json.dumps(MANIFEST))
    copy_bench(tmp_path)
    w = json.loads((harness.ROOT / "portbench" / "workloads"
                    / "bie_solve.json").read_text())
    w["chips"] = 4
    (tmp_path / "portbench" / "workloads" / "bie_solve.json").write_text(
        json.dumps(w))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    with pytest.raises(harness.BenchError, match="chips"):
        harness.Bench(tmp_path).cell("bie_solve")
