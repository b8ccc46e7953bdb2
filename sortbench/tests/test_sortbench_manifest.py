"""BENCHMARK.json against the rules its format keeps, and the finding of
every file by name: a new configuration, traffic mix and metric need only
new files and manifest entries."""

import json
import re
import shutil
from pathlib import Path

import pytest

from sortbench import manifest, run
from sortbench.manifest import reader_path

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "sortbench"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\n\t]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return manifest.load(ROOT)


def test_manifest_keys_and_names(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["command"][:3] == ["python3", "-m", "sortbench.run"] and len(man["command"]) <= 32
    assert all(LINE.fullmatch(w) for w in man["command"])
    assert man["paths"] == ["sortbench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in man[k]]
    assert all(NAME.fullmatch(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in man[k]}) == len(man[k])


def test_run_seconds_fits_a_full_check(man):
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_and_cells(man):
    assert 1 <= len(man["configs"]) <= 24 and 1 <= len(man["workloads"]) <= 24
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])
        assert c["file"].startswith("sortbench/configs/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
        assert all(NAME.fullmatch(k) and k in data for k in c["reduced"])
        assert (PKG / "entries" / f"{data['entry']}.py").is_file()
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.fullmatch(w["why"]) and NAME.fullmatch(w["traffic"])
        traffic = json.loads((PKG / "traffic" / f"{w['traffic']}.json").read_text())
        assert (PKG / "traffic" / f"{traffic['generator']}.py").is_file()
    assert sum(w["chips"] == 4 for w in man["workloads"]) <= max(1, len(man["workloads"]) // 4)


def test_metrics(man):
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in {"host_clock", "device_trace"}
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert reader_path(PKG, m["name"]).is_file()
    layers: dict = {}
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and UNIT.fullmatch(m["unit"]) and LINE.fullmatch(m["layer"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
        assert reader_path(PKG, m["name"]).is_file()
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in cells:
        c = manifest.cell(ROOT, w)
        assert "setup_s" in {m["name"] for m in c.end_to_end} and len(c.end_to_end) >= 2
        assert c.per_layer


def test_reader_lookup_prefers_its_own_file(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "a.py").write_text("")
    (tmp_path / "metrics" / "a.keys.py").write_text("")
    assert reader_path(tmp_path, "a.keys").name == "a.keys.py"
    assert reader_path(tmp_path, "a.records").name == "a.py"


def test_new_cell_needs_only_new_files(tmp_path):
    """A throwaway configuration, traffic mix and per-layer metric, added as
    files and manifest entries to a copy, run without an edit."""
    pkg = tmp_path / "sortbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = manifest.load(ROOT)
    conf = json.loads((PKG / "configs" / "keys_int32_1b.json").read_text())
    conf.update(name="keys_int64_small", key_dtype="int64", item_bytes=8)
    (pkg / "configs" / "keys_int64_small.json").write_text(json.dumps(conf))
    traffic = json.loads((PKG / "traffic" / "keys_zipf.json").read_text())
    traffic.update(a=2.0, pool=2)
    (pkg / "traffic" / "keys_zipf2.json").write_text(json.dumps(traffic))
    (pkg / "metrics" / "jobs_done.py").write_text("def read(run):\n    return len(run.done)\n")
    man["configs"].append({"name": "keys_int64_small", "source": "test", "reduced": [],
                           "file": "sortbench/configs/keys_int64_small.json", "why": "test"})
    man["workloads"].append({"name": "new_cell", "config": "keys_int64_small",
                             "traffic": "keys_zipf2", "chips": 1, "why": "test"})
    man["end_to_end"][0]["workloads"].append("new_cell")
    man["per_layer"].append({"name": "jobs_done", "unit": "jobs", "better": "higher",
                             "source": "host_clock", "layer": "harness", "moves": "keys_per_s",
                             "workloads": ["new_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = manifest.cell(tmp_path, "new_cell", pkg=pkg)
    assert [m["name"] for m in cell.per_layer][-1] == "jobs_done"
    traced = run.run_cell(cell, 3, 0.2, True, device="cpu", items=1 << 12)
    assert traced["correct"] and traced["metrics"]["jobs_done"]["value"] >= run.CAPTURE_JOBS
    plain = run.run_cell(cell, 3, 0.2, False, device="cpu", items=1 << 12)
    assert plain["correct"] and set(plain["metrics"]) == {"keys_per_s", "setup_s"}
