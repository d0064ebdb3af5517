"""The harness finds every configuration, cell, traffic kind and per-layer
metric by name, a new one is a set of new files, and BENCHMARK.json keeps
to the contract's shape."""

import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()


def test_every_workload_finds_its_files():
    for w in BENCH["workloads"]:
        cell = harness.cell(w["name"])
        config = harness.config(w["config"])
        ref = harness.reference(w["config"])
        kind = harness.traffic(w["traffic"])
        for fn in ("setup", "window", "trace", "check"):
            assert callable(getattr(kind, fn))
        for fn in ("build", "flops_per_grad"):
            assert callable(getattr(config, fn))
        for fn in ("potential_and_grad", "constrain", "posterior"):
            assert callable(getattr(ref, fn))
        assert config.NAME == w["config"]


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert callable(harness.metric(m["name"]).read)


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert Path(harness.ROOT, c["file"]).is_file()
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:  # every cell reports setup_s, another e2e and a per-layer metric
        assert any(harness.applies(m, cell) and m["name"] != "setup_s"
                   for m in BENCH["end_to_end"])
        assert any(harness.applies(m, cell) for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_new_cell_config_and_metric_are_only_new_files(tmp_path):
    """A throwaway configuration, cell and metric in a copy of the folder
    load by name beside the ones already there."""
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(harness.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns(".cache"))
    (bench_dir / "configs" / "toy_normal.py").write_text(
        "NAME = 'toy_normal'\nREDUCED = []\n"
        "def build(seed, device):\n    return None\n"
        "def flops_per_grad(chains):\n    return {'bf16': 0.0, 'fp32': 2.0 * chains}\n")
    (bench_dir / "reference" / "toy_normal.py").write_text(
        "def potential_and_grad(data, q, dtype=None):\n    return 0.5 * (q * q).sum(1), q\n"
        "def constrain(q, dtype=None):\n    return q\n"
        "def posterior(data):\n    return 0.0, 1.0\n")
    (bench_dir / "cells" / "toy_normal.nuts.json").write_text(
        json.dumps({"chains": 4}))
    (bench_dir / "metrics" / "toy.count.py").write_text(
        "def read(run):\n    return run.counters.get('toy')\n")
    assert harness.config("toy_normal", bench_dir).flops_per_grad(4)["fp32"] == 8.0
    assert harness.reference("toy_normal", bench_dir).constrain(3) == 3
    assert harness.cell("toy_normal.nuts", bench_dir)["chains"] == 4
    assert harness.traffic("nuts", bench_dir).setup is not None
    run = type("Run", (), {"counters": {"toy": 7}})()
    assert harness.metric("toy.count", bench_dir).read(run) == 7
    with pytest.raises(FileNotFoundError):
        harness.metric("toy.missing", bench_dir)


def test_derived_seeds_take_large_seeds():
    big = 2**33 + 12345
    assert harness.derived_seed(big, 1) == harness.derived_seed(big, 1)
    assert harness.derived_seed(big, 1) != harness.derived_seed(big, 2)
    assert harness.derived_seed(big, 1) != harness.derived_seed(big + 1, 1)
    assert 0 <= harness.derived_seed(big, 3) < 2**31
