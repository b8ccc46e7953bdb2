"""The port's static analysis (`dsort_tpu_torch.analysis`, ``cli lint``).

Held against the JAX package's linter (`dsort_tpu.analysis`): every checker
ported directly gives the same (code, line) lists on the reference's
fixtures (``tests/data/lint/``, read as data), bad fixtures and clean twins
alike; every reference code is in the port's catalog or on its stated skip
list.  Then the gates on the port's own tree: it lints clean with an empty
baseline in a process where torch, jax and ``dsort_tpu`` cannot be
imported, and drift seeded into a copy — a counter, a coordinator event, a
torch import under the fleet controller, a dropped dispatch arm — is
caught.  The SPMD checkers have their own file, test_torch_spmd_lint.py.
"""

import glob
import json
import os
import shutil
import subprocess
import sys
from collections import Counter

import pytest

import dsort_tpu.analysis as jlint
from dsort_tpu.analysis.checkers import all_checkers as ref_checkers
from dsort_tpu.analysis.checkers import checker_catalog as ref_catalog
from dsort_tpu_torch import cli
from dsort_tpu_torch.analysis import (
    CACHE_NAME,
    SKIPPED,
    LintConfig,
    LintStats,
    all_checkers,
    checker_catalog,
    format_sarif,
    lint_paths,
    load_config,
)
from dsort_tpu_torch.analysis.checkers.durability import DurabilityChecker
from dsort_tpu_torch.analysis.checkers.layers import ImportGraph, LayersChecker
from dsort_tpu_torch.analysis.checkers.registry import RegistryChecker
from dsort_tpu_torch.analysis.checkers.spec import SpecChecker
from dsort_tpu_torch.analysis.checkers.tracing import TracingChecker
from dsort_tpu_torch.analysis.core import BASELINE, LAYERS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "lint")

#: The checkers ported directly: same rules, scopes rewritten to the port.
DIRECT = ("registry", "concurrency", "exceptions", "durability", "protocol",
          "lifecycle")

_BLOCKED_LINT = r"""
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "jax", "jaxlib", "dsort_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, _Block())
from dsort_tpu_torch import cli
rc = cli.main(sys.argv[1:])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib", "dsort_tpu"))
sys.exit(3 if bad else rc)
"""


def _blocked_lint(*argv, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-c", _BLOCKED_LINT, "lint", *argv],
        cwd=cwd, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300,
    )


def _pairs(diags, codes=None):
    return [(d.code, d.line) for d in diags if codes is None or d.code in codes]


def _copy(tmp_path, rels):
    for rel in rels:
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(os.path.join(REPO, rel), dst)
    return tmp_path


def _seed(path, old, new):
    text = path.read_text()
    assert old in text, f"seed anchor drifted: {old!r}"
    path.write_text(text.replace(old, new, 1))


# -- the gate on the shipped tree --------------------------------------------


@pytest.fixture(scope="module")
def shipped_lint():
    """One whole-tree ``cli lint`` of ``dsort_tpu_torch/`` (its default
    target), in a process that cannot import torch, jax or dsort_tpu."""
    return _blocked_lint("--root", REPO, "--no-cache", "--format", "json")


def test_shipped_tree_lints_clean_without_torch(shipped_lint):
    assert shipped_lint.returncode == 0, shipped_lint.stdout + shipped_lint.stderr
    assert json.loads(shipped_lint.stdout) == []


def test_shipped_baseline_is_empty():
    with open(os.path.join(REPO, BASELINE), encoding="utf-8") as f:
        assert json.load(f)["entries"] == [], "ship the tree lint-clean, not baselined"


def test_blocked_lint_reports_a_finding(tmp_path):
    """The blocked process really lints: a bad fixture exits 1 there."""
    r = _blocked_lint("--root", REPO, "--no-cache", os.path.join(FIXTURES, "bad_registry.py"))
    assert r.returncode == 1, r.stderr
    assert "DS102" in r.stdout and "DS101" in r.stdout


# -- parity with the JAX package's linter on its fixtures --------------------


def _fixture_cases():
    """(checker, fixture) pairs: every Python fixture for each direct
    checker; the C++ fixtures for the registry checker, the one that reads
    C++."""
    files = sorted(
        os.path.basename(p)
        for p in glob.glob(os.path.join(FIXTURES, "*.py"))
        + glob.glob(os.path.join(FIXTURES, "*.cpp"))
    )
    return [(name, f) for name in DIRECT for f in files
            if f.endswith(".py") or name == "registry"]


@pytest.fixture(scope="module")
def fixture_findings():
    """Each direct checker of each package over every fixture, one lint run
    per checker and package (the registries are parsed once a run):
    ``{checker: (reference's, port's)}``, findings grouped by file."""
    files = [os.path.join(FIXTURES, f) for f in sorted({f for _, f in _fixture_cases()})]
    out = {}
    for name in DIRECT:
        scope = ("*.py", "*.cpp") if name == "registry" else ("*.py",)
        ref = type(next(c for c in ref_checkers() if c.name == name))(scope=scope)
        port = type(next(c for c in all_checkers() if c.name == name))(scope=scope)
        runs = (jlint.lint_paths(files, jlint.LintConfig(root=REPO), checkers=[ref]),
                lint_paths(files, LintConfig(root=REPO), checkers=[port]))
        by_file = ({}, {})
        for diags, sink in zip(runs, by_file):
            for d in diags:
                sink.setdefault(os.path.basename(d.path), []).append(d)
        out[name] = (by_file, set(port.codes))
    return out


@pytest.mark.parametrize("name,fixture", _fixture_cases())
def test_direct_checkers_match_the_reference_on_its_fixtures(fixture_findings, name, fixture):
    (want, got), codes = fixture_findings[name]
    # lifecycle keeps DS903 only (DS901/902 are on the skip list).
    assert _pairs(got.get(fixture, [])) == _pairs(want.get(fixture, []), codes)


@pytest.mark.parametrize("which", ["layers_bad", "layers_good"])
def test_layers_matches_the_reference_on_its_fixtures(which):
    root = os.path.join(FIXTURES, which)
    ref_cfg = jlint.load_config(root)
    want = jlint.lint_paths([os.path.join(root, "pkg")], ref_cfg)
    cfg = LintConfig(root=root, layers=dict(ref_cfg.layers))
    got = lint_paths([os.path.join(root, "pkg")], cfg, checkers=[LayersChecker()])
    assert sorted(_pairs(got)) == sorted(_pairs(want))
    # DS601 anchors at the import; DS602 where the contracts are declared.
    assert [d.path for d in got if d.code == "DS601"] == [
        d.path for d in want if d.code == "DS601"
    ]
    assert all(d.path == "dsort_tpu_torch/analysis/core.py" for d in got if d.code == "DS602")
    assert (which == "layers_bad") == bool(got)


def test_every_reference_code_is_ported_or_stated_skipped():
    ref = {code for codes in ref_catalog().values() for code in codes}
    port = {code for codes in checker_catalog().values() for code in codes}
    assert port.isdisjoint(SKIPPED)
    assert port | set(SKIPPED) == ref
    assert set(SKIPPED) == {"DS302", "DS501", "DS502", "DS901", "DS902", "DS1203"}


def test_skipped_codes_are_explained_where_users_look():
    import dsort_tpu_torch.analysis as pkg

    readme = open(os.path.join(REPO, "README.md"), encoding="utf-8").read()
    port_section = readme[readme.index("python -m dsort_tpu_torch.cli lint"):]
    for code, why in SKIPPED.items():
        assert why.strip()
        assert code in pkg.__doc__, code
        assert code in port_section, code
    assert "compat" not in checker_catalog()


def test_layer_contracts_name_existing_modules():
    graph = ImportGraph(REPO)
    for pattern in LAYERS:
        assert graph.expand(pattern), f"layer contract {pattern!r} matches no module"
    for mod in ("fleet.proto", "fleet.controller", "serve.policy", "serve.admission",
                "serve.fair", "serve.variants", "analysis.*"):
        forbidden = LAYERS[f"dsort_tpu_torch.{mod}"]
        assert {"torch", "jax", "dsort_tpu"} <= set(forbidden)


# -- drift seeded into copies --------------------------------------------------

_REGISTRIES = (
    "dsort_tpu_torch/utils/events.py",
    "dsort_tpu_torch/runtime/native.py",
)


def test_seeded_counter_drift_is_caught(tmp_path):
    _copy(tmp_path, _REGISTRIES)
    seeded = tmp_path / "dsort_tpu_torch" / "_seeded.py"
    seeded.write_text("def f(metrics):\n    metrics.bump('never_registered_counter')\n")
    diags = lint_paths([str(seeded)], load_config(str(tmp_path)), checkers=[RegistryChecker()])
    assert _pairs(diags) == [("DS102", 2)]
    assert "never_registered_counter" in diags[0].message


@pytest.mark.parametrize("name,code", [
    ("franken_event", "DS103"),   # in no registry
    ("agent_register", "DS104"),  # registered, but the drain parser drops it
])
def test_seeded_coordinator_event_drift_is_caught(tmp_path, name, code):
    rel = "dsort_tpu_torch/runtime/native/coordinator.cpp"
    _copy(tmp_path, _REGISTRIES + (rel,))
    cpp = tmp_path / rel
    _seed(cpp, 'log_event_locked("worker_join"', f'log_event_locked("{name}"')
    diags = lint_paths([str(cpp)], load_config(str(tmp_path)), checkers=[RegistryChecker()])
    assert [d.code for d in diags] == [code]
    assert name in diags[0].message


@pytest.fixture
def tree_copy(tmp_path):
    """The port's Python sources, copied (the import graph and the spec
    checker read files on demand from the root)."""
    shutil.copytree(
        os.path.join(REPO, "dsort_tpu_torch"), tmp_path / "dsort_tpu_torch",
        ignore=lambda d, names: [n for n in names
                                 if not (n.endswith(".py") or os.path.isdir(os.path.join(d, n)))
                                 or n in ("__pycache__", "csrc", "native")],
    )
    return tmp_path


def test_seeded_torch_import_under_the_fleet_controller_is_caught(tree_copy):
    fair = tree_copy / "dsort_tpu_torch" / "serve" / "fair.py"
    fair.write_text("import torch\n" + fair.read_text())
    diags = lint_paths([str(fair)], load_config(str(tree_copy)), checkers=[LayersChecker()])
    assert diags and all(d.code == "DS601" and d.path.endswith("serve/fair.py") for d in diags)
    msgs = "\n".join(d.message for d in diags)
    assert "dsort_tpu_torch.fleet.controller ->" in msgs
    assert "dsort_tpu_torch.serve.fair" in msgs


def test_seeded_dropped_dispatch_arm_is_caught(tree_copy):
    agent = tree_copy / "dsort_tpu_torch" / "fleet" / "agent.py"
    cfg = load_config(str(tree_copy))
    assert lint_paths([str(agent)], cfg, checkers=[SpecChecker()]) == []
    _seed(agent, 'elif ftype == "drain":', 'elif ftype == "drained":')
    diags = lint_paths([str(agent)], cfg, checkers=[SpecChecker()])
    assert "DS1003" in {d.code for d in diags}
    assert any("'drain'" in d.message for d in diags)


# -- the port's own readings ---------------------------------------------------

_CAPTURED = '''\
import functools
import time

import torch


@torch.compile
def step(x, metrics):
    metrics.bump("steps")
    return x + 1


@torch.compile(mode="max-autotune")
def helper_caller(x):
    return helper(x)


def helper(x):
    print(x)
    return x


def scripted(x):
    t = time.perf_counter()
    return x * t


def build(x, g, log):
    s = torch.jit.script(scripted)
    f = torch.cuda.make_graphed_callables(lambda y: log.info("y") or y, (x,))
    with torch.cuda.graph(g):
        out = f(x)
        log.warning("captured")
    return s, out


def traced(x):
    return functools.partial(torch.jit.trace, helper)(x)
'''

_CLEAN = '''\
import time

import torch


@torch.compile
def step(x):
    return x + 1


def run(x, metrics, g):
    t0 = time.perf_counter()
    with torch.cuda.graph(g):
        y = step(x)
    metrics.bump("steps")
    print(time.perf_counter() - t0)
    return y
'''


def test_tracing_reads_torch_compile_jit_and_cuda_graphs(tmp_path):
    bad = tmp_path / "captured.py"
    bad.write_text(_CAPTURED)
    diags = lint_paths([str(bad)], LintConfig(root=str(tmp_path)), checkers=[TracingChecker()])
    assert _pairs(diags) == [
        ("DS301", 9), ("DS301", 19), ("DS301", 24), ("DS301", 30), ("DS301", 33)
    ]
    good = tmp_path / "clean.py"
    good.write_text(_CLEAN)
    assert lint_paths([str(good)], LintConfig(root=str(tmp_path)),
                      checkers=[TracingChecker()]) == []


_FENCE = '''\
import os
import threading


class Store:
    def __init__(self):
        self._lock = threading.Lock()

    def flush(self, path, data):
        with self._lock:
            with open(path + ".tmp", "w") as f:
                f.write(data)
                os.fsync(f.fileno())
            os.replace(path + ".tmp", path)

    def kill(self):
        with self._lock:
            pass
'''


def test_a_fence_does_not_make_a_flush_lock_shared(tmp_path):
    """DS703: a ``with lock: pass`` fence (waiting out a write under way,
    `FleetController.kill`) is not a second user of the flush lock; a
    second acquisition that does work is."""
    src = tmp_path / "store.py"
    src.write_text(_FENCE)
    checker = [DurabilityChecker(scope=("*.py",))]
    assert lint_paths([str(src)], LintConfig(root=str(tmp_path)), checkers=checker) == []
    src.write_text(_FENCE.replace("            pass\n", "            self.n = 0\n"))
    diags = lint_paths([str(src)], LintConfig(root=str(tmp_path)), checkers=checker)
    assert Counter(d.code for d in diags) == {"DS703": 3}


# -- the engine and the CLI ------------------------------------------------------


def test_result_cache_hits_and_invalidates(tmp_path):
    rels = _REGISTRIES + (
        "dsort_tpu_torch/fleet/proto.py",
        "dsort_tpu_torch/serve/admission.py",
        "dsort_tpu_torch/serve/fair.py",
        "dsort_tpu_torch/serve/policy.py",
    )
    _copy(tmp_path, rels)
    cache = str(tmp_path / CACHE_NAME)
    jax_cache = tmp_path / ".lint-cache.json"
    jax_cache.write_text("the JAX package's cache")
    cfg = LintConfig(root=str(tmp_path))
    target = [str(tmp_path / "dsort_tpu_torch" / "serve")]
    checkers = [c for c in all_checkers() if not c.project]

    def run():
        stats = LintStats()
        diags = lint_paths(target, cfg, checkers=checkers, cache_path=cache, stats=stats)
        return diags, stats

    cold, s1 = run()
    warm, s2 = run()
    assert s1.files == s2.files == 3 and (s1.cached, s2.cached) == (0, 3)
    assert cold == warm == []
    # A registry source is part of the cache key: editing it invalidates all.
    events = tmp_path / "dsort_tpu_torch" / "utils" / "events.py"
    events.write_text(events.read_text() + "\n")
    _, s3 = run()
    assert s3.cached == 0
    # A changed file misses alone.
    fair = tmp_path / "dsort_tpu_torch" / "serve" / "fair.py"
    fair.write_text(fair.read_text() + "\n")
    _, s4 = run()
    assert s4.cached == 2
    assert jax_cache.read_text() == "the JAX package's cache"
    assert CACHE_NAME != ".lint-cache.json"


def test_cli_lint_formats_stats_and_refusals(tmp_path, capsys):
    bad = os.path.join(FIXTURES, "bad_registry.py")
    assert cli.main(["lint", "--root", REPO, "--no-cache", "--format", "sarif", "--stats",
                     bad]) == 1
    out, err = capsys.readouterr()
    log = json.loads(out)
    assert log["version"] == "2.1.0"
    assert {r["ruleId"] for r in log["runs"][0]["results"]} == {"DS101", "DS102"}
    rules = {r["id"] for r in log["runs"][0]["tool"]["driver"]["rules"]}
    assert rules == {c for codes in checker_catalog().values() for c in codes}
    assert "registry" in err and "checker(s)" in err
    assert json.loads(format_sarif([]))["runs"][0]["results"] == []
    with pytest.raises(SystemExit, match="no such path"):
        cli.main(["lint", "--root", REPO, "definitely/not/a/dir"])
    with pytest.raises(SystemExit, match="exclusive"):
        cli.main(["lint", "--root", REPO, "--changed", bad])
    with pytest.raises(SystemExit, match="exclusive"):
        cli.main(["lint", "--root", REPO, "--changed", "--write-baseline"])


def test_write_baseline_is_idempotent(tmp_path):
    target = tmp_path / "bad.py"
    shutil.copy(os.path.join(FIXTURES, "bad_registry.py"), target)
    base = tmp_path / "base.json"
    argv = ["lint", "--root", REPO, "--no-cache", str(target), "--baseline", str(base)]
    assert cli.main(argv + ["--write-baseline"]) == 0
    first = json.loads(base.read_text())["entries"]
    assert len(first) == 4
    assert cli.main(argv + ["--write-baseline"]) == 0
    assert json.loads(base.read_text())["entries"] == first
    assert cli.main(argv) == 0  # fully tolerated


def test_missing_registry_and_unknown_checker_are_loud(tmp_path):
    src = tmp_path / "x.py"
    src.write_text("def f(m):\n    m.bump('anything')\n")
    cfg = LintConfig(root=str(tmp_path))
    assert "DS105" in {d.code for d in lint_paths([str(src)], cfg)}
    with pytest.raises(ValueError, match="unknown checkers"):
        lint_paths([str(src)], LintConfig(root=str(tmp_path), enable=("registry", "compat")))


def test_cli_lint_changed_scopes_to_the_ports_changed_files(tmp_path, capsys):
    """``--changed``: files under ``dsort_tpu_torch/`` changed against git
    HEAD or untracked; a bad file elsewhere (a fixture) is not linted."""
    root = _copy(tmp_path, _REGISTRIES)
    git = ["git", "-C", str(root), "-c", "user.email=t@t", "-c", "user.name=t"]
    subprocess.run(git + ["init", "-q"], check=True)
    subprocess.run(git + ["add", "-A"], check=True)
    subprocess.run(git + ["commit", "-qm", "base"], check=True)
    argv = ["lint", "--root", str(root), "--changed", "--no-cache"]
    assert cli.main(argv) == 0
    assert "no changed lintable files" in capsys.readouterr().out
    shutil.copy(os.path.join(FIXTURES, "bad_registry.py"), root / "fixture.py")
    assert cli.main(argv) == 0
    capsys.readouterr()
    shutil.copy(os.path.join(FIXTURES, "bad_registry.py"),
                root / "dsort_tpu_torch" / "seeded.py")
    assert cli.main(argv) == 1
    out = capsys.readouterr().out
    assert "dsort_tpu_torch/seeded.py" in out and "fixture.py" not in out
