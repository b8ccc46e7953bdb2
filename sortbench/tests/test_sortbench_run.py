"""Whole runs of every cell on the CPU at a small size: the result line,
the faults planted under the timed path and the control all come out not
correct, and the ways a run must refuse to report."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sortbench import manifest, run
from sortbench.control import control_run

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "sortbench"
CELLS = [w["name"] for w in manifest.load(ROOT)["workloads"]]


def _cell(name):
    return manifest.cell(ROOT, name)


SMALL = 1 << 13
SEED = 2**31 + 12345  # seeds may pass 32 signed bits


# Faults planted under the timed path.  Each wraps an entry's
# ``run(job_input) -> (answer, metrics)`` as `run.run_cell`'s ``wrap`` does:
# the step returns its input as it came; half of the job is left out; the
# exchange between the shards is left out; one key or record of the answer
# is altered where it is produced.


def _halve(kind: str, job_input):
    if kind == "keys":
        return job_input[: len(job_input) // 2]
    keys, payload = job_input
    return keys[: len(keys) // 2], payload[: len(keys) // 2]


def unchanged(run, kind: str):
    from dsort_tpu_torch.utils.metrics import Metrics

    return lambda job_input: (job_input, Metrics())


def half_dropped(run, kind: str):
    return lambda job_input: run(_halve(kind, job_input))


def no_exchange(run, kind: str):
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort

    def go(job_input):
        # Every schedule goes through the padded all-to-all, which then
        # moves nothing: the ring schedules shift with other calls.
        real = VirtualMesh.all_to_all, SampleSort._resolve_exchange
        VirtualMesh.all_to_all = lambda self, send: send.clone()
        SampleSort._resolve_exchange = lambda self, exchange: "alltoall"
        try:
            return run(job_input)
        finally:
            VirtualMesh.all_to_all, SampleSort._resolve_exchange = real

    return go


def altered(run, kind: str):
    def go(job_input):
        answer, metrics = run(job_input)
        if kind == "keys":
            answer = answer.copy()
            answer[len(answer) // 3] ^= 1
        else:
            keys, payload = answer[0], answer[1].copy()
            payload[len(keys) // 3, -1] ^= np.uint8(1)
            answer = (keys, payload)
        return answer, metrics

    return go


FAULTS = {"unchanged": unchanged, "half_dropped": half_dropped,
          "no_exchange": no_exchange, "altered": altered}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_cpu(name, trace):
    cell = _cell(name)
    res = run.run_cell(cell, SEED, 0.3, bool(trace), device="cpu", items=SMALL)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0 for c in res["checks"].values())
    assert res["device"]["platform"] == "cpu" and res["device"]["count"] == cell.chips
    got = set(res["metrics"])
    if trace:
        assert res["attempted"] >= run.CAPTURE_AFTER + run.CAPTURE_JOBS
        # No kernel runs on the CPU, so the roofline finds nothing to read.
        want = {m["name"] for m in cell.per_layer if "roofline" not in m["name"]}
        assert got == want and res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == {m["name"] for m in cell.end_to_end}
    assert run.banned_modules() == []


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault):
    cell = _cell(name)
    res = run.run_cell(cell, SEED + 1, 0.2, False, device="cpu", items=SMALL,
                       wrap=FAULTS[fault])
    assert not res["correct"]
    assert res["checks"][f"mismatched_{cell.entry().KIND}"]["value"] > 0


def secondary_dropped(run, kind: str):
    """The records' secondary key left out: key bytes 8-9 decide nothing."""
    from dsort_tpu_torch.parallel.sample_sort import SampleSort

    def go(job_input):
        real = SampleSort.sort_kv
        SampleSort.sort_kv = lambda self, keys, payload, metrics=None, secondary=None, **kw: real(
            self, keys, payload, metrics, None, **kw)
        try:
            return run(job_input)
        finally:
            SampleSort.sort_kv = real

    return go


SHARED_PREFIXES = [c for c in CELLS if _cell(c).traffic.get("records_per_prefix")]


@pytest.mark.parametrize("name", SHARED_PREFIXES)
def test_a_dropped_secondary_key_is_not_correct_on_shared_prefixes(name):
    res = run.run_cell(_cell(name), SEED + 2, 0.2, False, device="cpu", items=SMALL,
                       wrap=secondary_dropped)
    assert not res["correct"] and res["checks"]["mismatched_records"]["value"] > 0


def test_some_records_cell_judges_the_secondary_key():
    assert SHARED_PREFIXES


#: Job sizes at which keys that round alike in float32 occur on every seed:
#: zipf keys are mostly small, which a float32 holds exactly.
CONTROL_ITEMS = {"keys_uniform": 1 << 16, "terasort_uniform": 1 << 16, "keys_zipf": 1 << 24,
                 "terasort_prefix": 1 << 16}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    for seed in (1, 2, 3):
        out = control_run(_cell(name), seed, "cpu", items=CONTROL_ITEMS[name])
        assert not out["correct"] and out["answers"] >= 1


def test_same_seed_same_inputs_other_seed_other_inputs():
    cell = _cell("terasort_uniform")
    gen = cell.generator()
    a = gen.make_pool(cell.traffic, cell.config, SEED, "cpu", 64)
    b = gen.make_pool(cell.traffic, cell.config, SEED, "cpu", 64)
    c = gen.make_pool(cell.traffic, cell.config, SEED + 1, "cpu", 64)
    assert len(a) == cell.traffic["pool"]
    assert all((x[0] == y[0]).all() and (x[1] == y[1]).all() for x, y in zip(a, b))
    assert not (a[0][0] == c[0][0]).all() and not (a[0][0] == a[1][0]).all()
    assert a[0][1].shape == (64, 92) and a[0][1].flags.c_contiguous


def test_zipf_draws_the_distribution_of_gen_zipf():
    cell = _cell("keys_zipf")
    x = cell.generator().make_pool(cell.traffic, cell.config, 7, "cpu", 1 << 20)[0]
    ref = np.minimum(np.random.default_rng(7).zipf(1.3, size=1 << 20), 2**31 - 1)
    assert x.dtype == np.int32 and x.min() >= 1
    for v in (1, 2, 3, 10):
        assert abs((x == v).mean() - (ref == v).mean()) < 0.003
    for t in (100, 4096, 10**6):
        assert abs((x > t).mean() - (ref > t).mean()) < 0.003
    assert (x == 2**31 - 1).any()


def test_without_a_card_the_run_exits_without_a_result(capsys):
    assert run.main(["--workload", "keys_uniform", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_without_the_program_the_run_exits_without_a_result(tmp_path):
    shutil.copytree(PKG, tmp_path / "sortbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    script = (
        "import sys, torch\n"
        "torch.cuda.is_available = lambda: True\n"
        "torch.cuda.device_count = lambda: 1\n"
        "from sortbench import run\n"
        "sys.exit(run.main(sys.argv[1:]))\n"
    )
    p = subprocess.run(
        [sys.executable, "-c", script, "--workload", "keys_uniform", "--seed", "1",
         "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert p.returncode != 0 and p.stdout == ""
    assert "program is missing" in p.stderr


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("dsort_tpu_torch", "dsort_tpu_torch.cli", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "dsort_tpu.cli", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.banned_modules() == ["dsort_tpu", "jax"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        assert not set(_imports(path)) & set(run.BANNED), path


def test_the_reference_imports_nothing_of_the_program():
    assert set(_imports(PKG / "reference.py")) <= {"__future__", "numpy"}


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run(
        [sys.executable, "-m", "sortbench.run", "--workload", "keys_uniform", "--seed", str(SEED),
         "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["metrics"]["sort_roofline_pct.keys"]["value"] <= 100
