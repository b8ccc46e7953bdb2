"""The port stands alone: no JAX and nothing of ``dsort_tpu`` in its imports,
and no quiet CPU fallback when no GPU is present."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "dsort_tpu_torch"

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "dsort_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, _Block())
import dsort_tpu_torch
names = ["dsort_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(dsort_tpu_torch.__path__, "dsort_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "dsort_tpu"))
assert not bad, bad
print(len(names))
"""


def _modules():
    return sorted(PKG.rglob("*.py"))


def test_every_module_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) == len(_modules())


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", _modules() + [ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT))
)
def test_source_imports_nothing_of_jax_or_dsort_tpu(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "dsort_tpu"}, roots


def test_scan_tells_the_packages_apart(tmp_path):
    """`dsort_tpu_torch` itself must not read as `dsort_tpu`."""
    f = tmp_path / "m.py"
    f.write_text("import dsort_tpu_torch.ops\nfrom dsort_tpu_torch import cli\n")
    assert _imported_roots(f) == {"dsort_tpu_torch"}
    f.write_text("from dsort_tpu.ops import block_sort\n")
    assert _imported_roots(f) == {"dsort_tpu"}


def test_entry_points_without_a_device_raise_instead_of_running_on_cpu(monkeypatch):
    from dsort_tpu_torch import cli
    from dsort_tpu_torch.device import resolve_device
    from dsort_tpu_torch.parallel.mesh import VirtualMesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VirtualMesh(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run", os.devnull])
    # The fleet's agent, in process and as ``cli fleet-agent``.
    from dsort_tpu_torch.fleet import FleetAgent

    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetAgent(num_workers=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["fleet-agent", "--workers", "4"])
    assert VirtualMesh(8, "cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    from dsort_tpu_torch.ops import block_sort as tb

    x = torch.zeros((1, 1024), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tb.bitonic_global_stage(x, 1024, 512)
    # A CPU tensor is an explicit choice: the plain version runs.
    y = torch.from_numpy(np.arange(1024, dtype=np.int32)[::-1].copy()).view(1, -1)
    assert (tb.block_sort(y).numpy() == np.arange(1024)).all()


def test_the_analysis_subtree_is_scanned():
    """The scans above cover the lint engine, its checkers and registries,
    which must import neither jax nor dsort_tpu (nor torch: the layer
    contract `analysis.*` and test_torch_lint.py's blocked run hold that)."""
    names = {str(p.relative_to(ROOT)) for p in _modules()}
    for rel in ("analysis/core.py", "analysis/engine.py", "analysis/checkers/spmd.py",
                "analysis/spmd/registry.py", "analysis/spec/machines.py",
                "analysis/spec/model.py", "utils/tracing.py"):
        assert f"dsort_tpu_torch/{rel}" in names, rel


def test_the_batch_and_multi_process_planes_are_scanned():
    """The scan above covers the multi-process plane and the rank program
    the tests and chip_smoke.py spawn (`tools/mh_proc.py`)."""
    names = {str(p.relative_to(ROOT)) for p in _modules()}
    assert {"dsort_tpu_torch/parallel/distributed.py",
            "dsort_tpu_torch/tools/mh_proc.py"} <= names
    from dsort_tpu_torch.parallel.sample_sort import BatchSampleSort  # noqa: F401


def test_the_introspection_plane_is_scanned():
    """The scan covers the introspection plane: the merger, the analyzer,
    the health plane, ``top`` and the port's own copy of the contracts."""
    names = {str(p.relative_to(ROOT)) for p in _modules()}
    assert {"dsort_tpu_torch/obs/merge.py", "dsort_tpu_torch/obs/analyze.py",
            "dsort_tpu_torch/obs/health.py", "dsort_tpu_torch/obs/top.py",
            "dsort_tpu_torch/analysis/spec/contracts.py"} <= names


def test_the_fleet_plane_is_scanned():
    """The scan covers the fleet plane: the protocol, the controller and
    the agent."""
    names = {str(p.relative_to(ROOT)) for p in _modules()}
    assert {"dsort_tpu_torch/fleet/__init__.py", "dsort_tpu_torch/fleet/proto.py",
            "dsort_tpu_torch/fleet/controller.py", "dsort_tpu_torch/fleet/agent.py"} <= names


_BLOCKED_REPORT = r"""
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "dsort_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, _Block())
from dsort_tpu_torch import cli
rc = cli.main(["report", sys.argv[1], "--analyze", "--conform", "--chrome-trace", sys.argv[2]])
rc2 = cli.main(["top", "http://127.0.0.1:1/metrics"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "dsort_tpu"))
assert not bad, bad
print(rc, rc2)
"""


def test_report_and_top_run_with_jax_blocked(tmp_path):
    """``cli report --analyze --conform`` and ``cli top`` run with JAX and
    the JAX package unimportable."""
    j = tmp_path / "j.jsonl"
    j.write_text("".join(
        f'{{"seq": {i}, "t": {i}.0, "mono": {i}.0, "type": "{t}", "job": 1}}\n'
        for i, t in enumerate(("job_admitted", "job_dequeued", "job_done"))))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_REPORT, str(j), str(tmp_path / "t.json")], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "0 1"
    assert "why-slow verdict" in proc.stdout and "trace conformance" in proc.stdout


_BLOCKED_SPEC = r"""
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "jax", "jaxlib", "dsort_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, _Block())
from dsort_tpu_torch import cli
rc = cli.main(["spec", "check", "--max-states", "2000"])
rc2 = cli.main(["spec", "replay", "--fixture", "tests/data/spec/nonatomic_reserve.json"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "jaxlib", "dsort_tpu"))
assert not bad, bad
print(rc, rc2)
"""


def test_spec_check_and_replay_run_with_torch_and_jax_blocked():
    """``cli spec check`` and ``cli spec replay`` run with torch, JAX and the
    JAX package unimportable: the model checker is control-plane state over
    the port's numpy `ControlPolicy`."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_SPEC], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "0 0"
    assert "OK — no invariant violated" in proc.stdout
    assert "reproduces no_double_run after 7 action(s)" in proc.stdout


_BLOCKED_RUNTIME = r"""
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "dsort_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, _Block())
import dsort_tpu_torch.runtime.worker
assert "torch" not in sys.modules  # a --backend numpy worker never loads torch
import numpy as np
from dsort_tpu_torch.runtime import NativeCoordinator, native
assert native.available()
runs = [np.arange(5, dtype=np.int64), np.arange(3, dtype=np.int64)]
print(native.kway_merge(runs).tolist(), NativeCoordinator.__module__)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "dsort_tpu"))
assert not bad, bad
"""


def test_the_native_runtime_imports_and_runs_with_jax_blocked():
    """``dsort_tpu_torch.runtime`` (the bindings, the coordinator, the worker)
    imports neither JAX nor the JAX package, builds its own copy of the C++
    library, and its worker module loads without torch."""
    from dsort_tpu_torch.runtime import _build

    if _build.compiler() is None:
        pytest.skip("no C++ compiler")
    names = {str(p.relative_to(ROOT)) for p in _modules()}
    assert {"dsort_tpu_torch/runtime/native.py", "dsort_tpu_torch/runtime/coordinator.py",
            "dsort_tpu_torch/runtime/worker.py", "dsort_tpu_torch/runtime/_build.py"} <= names
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUNTIME], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["[0,", "0,", "1,", "1,", "2,", "2,", "3,", "4]",
                                   "dsort_tpu_torch.runtime.coordinator"]
