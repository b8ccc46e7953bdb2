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
    assert VirtualMesh(8, "cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    from dsort_tpu_torch.ops import block_sort as tb

    x = torch.zeros((1, 1024), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tb.bitonic_global_stage(x, 1024, 512)
    # A CPU tensor is an explicit choice: the plain version runs.
    y = torch.from_numpy(np.arange(1024, dtype=np.int32)[::-1].copy()).view(1, -1)
    assert (tb.block_sort(y).numpy() == np.arange(1024)).all()
