"""``bench`` against the JAX package's ``dsort bench``: the plain mode, the
suite, ``--device-resident``, every exclusive pair of mode flags, and the
parsers of every subcommand both CLIs have.

Each mode runs once per module through each CLI's ``main`` in this
process: the JAX package on the conftest's 8-device CPU mesh, the port
with ``--device cpu --workers 8``.  Their JSON lines are held to each
other by `hold_lines`: the same metric names in the same order, the same
keys, equal count and gate fields (every int, bool and str field but the
measured ones, and the floats that are counts' ratios), positive rates.
The helpers here serve the other ``test_torch_bench_*`` files too.
"""

import argparse
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

from dsort_tpu import cli as jcli
from dsort_tpu.data.ingest import gen_terasort as jax_gen_terasort

from dsort_tpu_torch import cli, cli_bench
from dsort_tpu_torch.data import ingest
from dsort_tpu_torch.utils.events import EventLog

#: Fields that are measured (times, memory, the timing-picked arm or
#: phase), never compared between the packages.
MEASURED = {"best_arm", "dominant_phase", "hbm_watermark_bytes"}
#: Float fields that are ratios of counts: equal in both packages.
COUNT_RATIOS = {"dcn_reduction_frac", "premium_ratio", "resume_fraction", "skew_ratio_zipf",
                "skew_ratio_uniform", "cache_hit_rate", "slow_s"}


def run_main(main, argv):
    """``main(argv)`` with stdout captured: ``(exit code, JSON lines)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]


class BenchRuns:
    """Each mode's run through both CLIs, made once and kept: ``get(key)``
    -> ``(jax rc, jax lines, port rc, port lines)``."""

    def __init__(self, modes: dict):
        self.modes, self.done = modes, {}

    def get(self, key):
        if key not in self.done:
            argv = ["bench", *self.modes[key]]
            jrc, jlines = run_main(jcli.main, argv)
            prc, plines = run_main(cli.main, argv + ["--device", "cpu", "--workers", "8"])
            self.done[key] = (jrc, jlines, prc, plines)
        return self.done[key]


def compared_fields(line: dict) -> dict:
    """The count and gate fields of one line."""
    return {k: v for k, v in line.items()
            if k not in MEASURED and (not isinstance(v, float) or k in COUNT_RATIOS)}


def hold_lines(runs: BenchRuns, key: str, aspect: str) -> None:
    jrc, jlines, prc, plines = runs.get(key)
    if aspect == "exit_and_rates":
        assert jrc == 0 and prc == 0
        assert plines and all(ln["value"] > 0 or ln["unit"] == "frac" for ln in plines)
        for ln in plines:
            rates = [v for k, v in ln.items() if k.endswith("_per_sec")]
            assert all(r > 0 for r in rates), ln
    elif aspect == "names":
        assert [ln["metric"] for ln in plines] == [ln["metric"] for ln in jlines]
    elif aspect == "keys":
        assert [list(ln) for ln in plines] == [list(ln) for ln in jlines]
    else:
        assert [compared_fields(ln) for ln in plines] == [compared_fields(ln) for ln in jlines]


ASPECTS = ["exit_and_rates", "names", "keys", "counts_and_gates"]

MODES = {
    "plain_local": ["--n", "20000", "--reps", "1", "--mode", "local"],
    "plain_spmd": ["--n", "20000", "--reps", "1"],
    "device_resident": ["--device-resident", "--n", "50000", "--reps", "1"],
    "suite": ["--suite", "--reps", "1"],
}


@pytest.fixture(scope="module")
def runs():
    return BenchRuns(MODES)


@pytest.mark.parametrize("aspect", ASPECTS)
@pytest.mark.parametrize("mode", list(MODES))
def test_bench_lines_match_reference(runs, mode, aspect):
    hold_lines(runs, mode, aspect)


def test_suite_config1_splits_its_wall(runs):
    """Config 1's wall splits into the program alone and the rest."""
    line = runs.get("suite")[3][0]
    assert line["metric"] == "config1_reference_workload_16384_int32"
    assert line["device_ms"] >= 0 and line["fixed_overhead_ms_per_dispatch"] >= 0


def test_suite_emit_hook_collects_the_ladder(capsys):
    """``args.emit`` receives every line instead of stdout, as a harness
    calling `_bench_suite` directly would use it; config 5 below 4
    workers takes its labelled no-failure branch."""
    got = []
    args = argparse.Namespace(reps=1, emit=got.append, workers=2, device="cpu")
    assert cli_bench._bench_suite(args) == 0
    assert capsys.readouterr().out == ""
    assert [ln["metric"][:7] for ln in got] == [f"config{i}" for i in range(1, 6)]
    assert got[-1]["metric"] == "config5_zipf_1M_no_failure_single_device"


def test_plain_mode_journal_and_memwatch(tmp_path):
    """``--journal`` gets every timed rep's events; ``--memwatch`` adds the
    watermark events."""
    path = tmp_path / "bench.jsonl"
    rc, lines = run_main(cli.main, ["bench", "--n", "4096", "--reps", "2", "--mode", "local",
                                    "--journal", str(path), "--memwatch", "--device", "cpu"])
    assert rc == 0 and lines[0]["metric"] == "sort_throughput_int32_4096_keys_local"
    types = [r["type"] for r in EventLog.read_jsonl(str(path))]
    assert types.count("job_start") == 2 and "hbm_watermark" in types


# -- exclusivity ---------------------------------------------------------------

#: The mode flags in the reference's precedence; each refuses every flag
#: before it.
FLAGS = ["--suite", "--device-resident", "--exchange-ab", "--serve-mixed", "--analyze-smoke",
         "--external-wave", "--fleet-mixed", "--coded-ab", "--autotune-ab", "--hier-ab",
         "--coded-v2-ab"]
PAIRS = [(FLAGS[i], FLAGS[j]) for i in range(1, len(FLAGS)) for j in range(i)]


def _refusal(main, argv) -> str:
    with pytest.raises(SystemExit) as e:
        run_main(main, argv)
    return str(e.value.code)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}+{p[1]}")
def test_exclusive_modes_refuse_with_the_reference_text(pair):
    argv = ["bench", pair[1], pair[0], "--n", "1000", "--reps", "1"]
    want = _refusal(jcli.main, argv)
    assert _refusal(cli.main, argv + ["--device", "cpu"]) == want
    assert want.startswith(pair[0]) or pair == ("--device-resident", "--suite")


@pytest.mark.parametrize("argv", [
    ["--reps", "0"],
    ["--device-resident", "--mode", "local"],
], ids=["reps", "device-resident-mode"])
def test_bench_refusals_match_reference(argv):
    argv = ["bench", "--n", "1000", *argv]
    assert _refusal(cli.main, argv + ["--device", "cpu"]) == _refusal(jcli.main, argv)


def test_bench_without_cuda_raises_through_resolve_device():
    """No quiet fallback: without ``--device cpu`` bench needs the card."""
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_main(cli.main, ["bench", "--n", "1000", "--reps", "1"])


# -- the parsers -----------------------------------------------------------------

#: Flags of the reference the port does not take yet, each with its reason.
UNPORTED: dict = {}
#: Flags only the port takes, each with its reason.
PORT_ONLY = {
    # The port's entry points run on the card unless asked for the CPU.
    **{cmd: {"--device"} for cmd in ("run", "terasort", "external", "worker", "bench",
                                      "fleet-agent")},
    # serve and batch tap every job's memory too.
    "serve": {"--device", "--memwatch"},
    "batch": {"--device", "--memwatch"},
}
# terasort shares the sorting subcommands' knob flags (the local kernel, the
# merge and the coded plane of its sort_kv).
PORT_ONLY["terasort"] |= {"--kernel", "--merge-kernel", "--redundancy", "--redundancy-mode"}


def _subparsers(ap) -> dict:
    for a in ap._actions:
        if isinstance(a, argparse._SubParsersAction):
            return a.choices
    raise AssertionError("no subcommands")


def _options(p) -> set:
    return {s for a in p._actions for s in a.option_strings}


@pytest.fixture(scope="module")
def reference_parser():
    """The JAX CLI's parser, caught at its ``parse_args``."""
    got = {}
    real = argparse.ArgumentParser.parse_args

    def catch(self, args=None, namespace=None):
        got["ap"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = catch
    try:
        with pytest.raises(SystemExit):
            jcli.main(["gen", "1", "-o", "x"])
    finally:
        argparse.ArgumentParser.parse_args = real
    return _subparsers(got["ap"])


PORTED_COMMANDS = ["run", "serve", "batch", "terasort", "external", "coordinator", "worker",
                   "validate", "gen", "report", "top", "bench", "fleet", "fleet-agent", "lint",
                   "spec"]


@pytest.mark.parametrize("cmd", PORTED_COMMANDS)
def test_parser_options_match_reference(reference_parser, cmd):
    port = _subparsers(cli._parser())
    want = (_options(reference_parser[cmd]) - UNPORTED.get(cmd, set())) | PORT_ONLY.get(cmd, set())
    assert _options(port[cmd]) == want


def test_bench_help_lists_the_reference_flags(reference_parser, capsys):
    with pytest.raises(SystemExit):
        cli.main(["bench", "--help"])
    text = capsys.readouterr().out
    for flag in (_options(reference_parser["bench"]) - {"-h"}) | {"--device"}:
        assert flag in text, flag


def _job_fields(job) -> dict:
    return {f: getattr(job, f) for f in (
        "local_kernel", "merge_kernel", "exchange", "hier_hosts", "redundancy",
        "redundancy_mode", "checkpoint_dir", "tenant", "flight_recorder_dir", "autotune",
        "explicit")} | {"key_dtype": np.dtype(job.key_dtype).name}


COORD_FLAGS = ["--kernel", "block", "--merge-kernel", "sort", "--exchange", "ring",
               "--hier-hosts", "2", "--redundancy", "2", "--redundancy-mode", "parity",
               "--mode", "taskpool", "--checkpoint-dir", "ck", "--job-id", "j1",
               "--tenant", "acme", "--flight-dir", "fl", "--no-autotune", "--dtype", "int64"]


@pytest.mark.parametrize("cmd,argv", [
    ("coordinator", COORD_FLAGS),
    ("batch", ["in.txt", "--outdir", "d", "--mode", "local", "--job-id", "j", "-o", "x"]),
])
def test_common_flags_fold_into_the_config_as_the_reference(reference_parser, cmd, argv):
    """The coordinator's twelve common() flags and batch's --job-id / --mode
    / -o parse, and the config they give equals the reference's
    `_load_config` of the same arguments."""
    ours = cli._load_config(cli._parser().parse_args([cmd, *argv]))
    ref_args = reference_parser[cmd].parse_args(argv)
    ref = jcli._load_config(ref_args)
    assert _job_fields(ours.job) == _job_fields(ref.job)


def _tera_file(path, n):
    keys, payload = jax_gen_terasort(n, seed=7)
    ingest.write_terasort_file(path, keys, payload)
    return keys


@pytest.mark.parametrize("conf,flags,want", [
    ("EXCHANGE=ring\nHIER_HOSTS=4\n", [], ("ring", 4)),
    ("EXCHANGE=ring\n", ["--exchange", "alltoall"], ("alltoall", 0)),
    (None, [], ("alltoall", 0)),
], ids=["conf", "flag-wins", "no-conf"])
def test_terasort_conf_reaches_the_job(tmp_path, monkeypatch, conf, flags, want):
    """``terasort --conf``: the conf's EXCHANGE / HIER_HOSTS reach the
    job sort_kv runs under, a flag still wins, and the output is sorted by
    the full key."""
    from dsort_tpu_torch.parallel.sample_sort import SampleSort

    seen = []
    real = SampleSort.sort_kv

    def spy(self, *a, **kw):
        seen.append((self.job.exchange, self.job.hier_hosts))
        return real(self, *a, **kw)

    monkeypatch.setattr(SampleSort, "sort_kv", spy)
    src, dst, cpath = (tmp_path / n for n in ("in.bin", "out.bin", "c.conf"))
    _tera_file(src, 3000)
    argv = ["terasort", str(src), "-o", str(dst), "--device", "cpu", *flags]
    if conf:
        cpath.write_text(conf)
        argv += ["--conf", str(cpath)]
    assert cli.main(argv) == 0
    assert seen == [want]
    k, _ = ingest.read_terasort_file(dst)
    assert np.all(k[:-1] <= k[1:])


def test_external_conf_runs_the_wave_pipeline(tmp_path):
    """``external --conf``: EXTERNAL_MESH / EXTERNAL_WAVE_ELEMS pick the
    wave pipeline and its wave size, a flag still wins, and the file is
    numpy's sort."""
    src, dst, jpath, cpath = (tmp_path / n for n in ("in.bin", "out.bin", "j.jsonl", "c.conf"))
    data = ingest.gen_uniform(5000, seed=3)
    data.tofile(src)
    cpath.write_text("EXTERNAL_MESH=4\nEXTERNAL_WAVE_ELEMS=1000\n")
    assert cli.main(["external", str(src), "-o", str(dst), "--conf", str(cpath),
                     "--journal", str(jpath), "--device", "cpu"]) == 0
    assert np.array_equal(np.fromfile(dst, np.int32), np.sort(data))
    waves = {r.get("wave") for r in EventLog.read_jsonl(str(jpath)) if "wave" in r}
    assert len(waves - {None}) == 5
    assert cli.main(["external", str(src), "-o", str(dst), "--conf", str(cpath),
                     "--wave-elems", "2500", "--journal", str(jpath), "--device", "cpu"]) == 0
    waves = {r.get("wave") for r in EventLog.read_jsonl(str(jpath)) if "wave" in r}
    assert len(waves - {None}) == 2


def test_bench_args_namespace_defaults_match_reference(reference_parser):
    """Every bench flag parses to the reference's default."""
    ours = vars(cli._parser().parse_args(["bench"]))
    ref = vars(reference_parser["bench"].parse_args([]))
    shared = set(ref) - {"fn"}
    assert {k: ours[k] for k in shared} == {k: ref[k] for k in shared}
    assert dataclasses.is_dataclass(cli._load_config(argparse.Namespace(**ours)))
