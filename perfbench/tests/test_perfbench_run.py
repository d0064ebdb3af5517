"""The command's contract on a machine without the card, and the
whole-name check for JAX and the JAX package."""

import json
import shutil
import subprocess
import sys
import types

from perfbench import harness

CMD = [sys.executable, "perfbench/run.py", "--workload", "eight_schools_nc.hmc",
       "--seed", str(2**33 + 3), "--seconds", "1", "--trace", "0"]


def test_without_a_card_it_prints_no_result():
    import torch

    if torch.cuda.is_available():
        return
    p = subprocess.run(CMD, cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_without_the_program_it_prints_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("jaxtyping", "fugue_tpu_torch.serve", "flaxen", "fugue_tpu_x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == [m for m in harness.forbidden_modules()
                                           if m.split(".")[0] in harness.FORBIDDEN]
    assert not {"jaxtyping", "fugue_tpu_torch.serve", "flaxen", "fugue_tpu_x"} & set(
        harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "fugue_tpu.core", types.ModuleType("fugue_tpu.core"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert {"fugue_tpu.core", "jax.numpy"} <= set(harness.forbidden_modules())


def test_a_whole_run_loads_no_jax_module():
    """Every file of the benchmark loaded and a small cell run on the CPU,
    in a fresh process: no module named jax, jaxlib, flax or fugue_tpu."""
    code = f"""
import json, sys
sys.path.insert(0, {str(harness.ROOT)!r})
from perfbench import harness
b = harness.benchmark()
for w in b["workloads"]:
    c = harness.cell(w["name"])
    harness.config(w["config"]); harness.reference(w["config"]); harness.traffic(w["traffic"])
for m in b["per_layer"]:
    harness.metric(m["name"])
run = harness.new_run("eight_schools_nc.hmc", 5, 0.5, False, device="cpu",
                      overrides={{"chains": 16, "warmup": 10, "call_samples": 2, "n_leapfrog": 4}})
harness.run_cell(run)
print(json.dumps(harness.forbidden_modules()))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
