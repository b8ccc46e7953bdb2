"""The port's model checker of the fleet protocol
(`dsort_tpu_torch.analysis.spec.model`, ``cli spec``), held against the JAX
package's (`dsort_tpu.analysis.spec.model`, ``dsort spec``) on the CPU.

Both explore the same abstract fleet, the port's with the port's
`ControlPolicy` embedded and the reference's with its own: the same counts
at the smoke bound and at an exhausting one, the same invariant and
minimized schedule for each seeded bug (the committed fixtures under
``tests/data/spec/``), the same fixtures dumped, the same states, enabled
actions and invariant verdicts at every step of seeded random walks, and
the same exit codes and lines from both CLIs.
"""

import io
import json
import os
import re

import numpy as np
import pytest

from dsort_tpu import cli as jcli
from dsort_tpu.analysis.spec import model as ref
from dsort_tpu_torch import cli
from dsort_tpu_torch.analysis.spec import model

from test_torch_bench_plain import _subparsers, reference_parser  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "spec")

#: The JAX package's tests' exhausting bound: one agent, one job, no faults.
SMALL = dict(n_agents=1, n_jobs=1, max_duplications=0, max_deaths=0,
             max_reattaches=0, max_crashes=0, max_requeues=1)
#: A wider fleet for the random walks: more agents, jobs and faults.
WIDE = dict(n_agents=3, n_jobs=4, outstanding_cap=1, max_duplications=2,
            max_deaths=2, max_reattaches=2, max_crashes=2, max_requeues=2)


def _counts(res) -> tuple:
    return res.states, res.transitions, res.depth, res.truncated, res.ok


def _fixture(seam: str) -> dict:
    with open(os.path.join(FIXTURES, f"{seam}.json"), encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.parametrize("bound,cfg,max_states", [
    ("smoke", {}, 12_000),
    ("exhausting", SMALL, 100_000),
])
def test_bounds_match_the_reference(bound, cfg, max_states):
    """The smoke bound stops at 12,000 states, 25,030 transitions and depth
    8 with no violation, and the small bound exhausts its space clean: the
    same counts as the reference's checker."""
    got = model.check_model(model.ModelConfig(**cfg), max_states=max_states)
    want = ref.check_model(ref.ModelConfig(**cfg), max_states=max_states)
    assert _counts(got) == _counts(want)
    assert got.ok and got.invariants == want.invariants
    if bound == "smoke":
        assert _counts(got) == (12_000, 25_030, 8, True, True)
    else:
        assert not got.truncated and got.states > 50


@pytest.mark.parametrize("seam", model.SEAMS)
def test_seam_is_caught_as_in_the_reference(seam, tmp_path):
    """Each seeded bug yields the reference's invariant, detail and
    minimized schedule (the committed fixture's), replays twice to the same
    violation, and dumps the same fixture as the reference's."""
    assert model.SEAMS == ref.SEAMS
    got = model.check_model(model.ModelConfig(), seams=(seam,), max_states=20_000)
    want = ref.check_model(ref.ModelConfig(), seams=(seam,), max_states=20_000)
    assert not got.ok
    assert _counts(got) == _counts(want)
    assert got.violation.to_dict() == want.violation.to_dict()
    recorded = _fixture(seam)
    assert got.violation.invariant == recorded["invariant"]
    assert got.violation.schedule == recorded["schedule"]
    once = model.replay_schedule(got.violation.schedule, model.ModelConfig(), (seam,))
    again = model.replay_schedule(got.violation.schedule, model.ModelConfig(), (seam,))
    assert once.invariant == again.invariant == got.violation.invariant
    assert once.detail == again.detail == got.violation.detail
    model.dump_fixture(str(tmp_path / "port.json"), got.violation, model.ModelConfig(), (seam,))
    ref.dump_fixture(str(tmp_path / "ref.json"), want.violation, ref.ModelConfig(), (seam,))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
    assert json.loads((tmp_path / "port.json").read_text()) == recorded


@pytest.mark.parametrize("seam", model.SEAMS)
def test_committed_fixture_replays_on_the_port(seam):
    """A committed fixture loads to its schedule, config and seam, replays
    on the port to its recorded violation, and without the seam is clean
    (or stops at a seam-only action) exactly as on the reference."""
    path = os.path.join(FIXTURES, f"{seam}.json")
    recorded = _fixture(seam)
    schedule, cfg, seams = model.load_fixture(path)
    assert (schedule, cfg.to_dict(), seams) == (
        recorded["schedule"], recorded["config"], (seam,))
    v = model.replay_schedule(schedule, cfg, seams)
    assert v.to_dict() == {k: recorded[k] for k in ("invariant", "detail", "schedule")}

    def unseamed(mod):
        try:
            return mod.replay_schedule(schedule, mod.ModelConfig(**recorded["config"]), ())
        except ValueError as e:
            return str(e)

    got, want = unseamed(model), unseamed(ref)
    assert got is None or isinstance(got, str)  # no violation without the seam
    assert got == want


@pytest.mark.parametrize("seams,cfg", [
    ((), {}),
    (("ack_before_persist",), {}),
    (("nonatomic_reserve",), {}),
    ((), WIDE),
], ids=["real", "ack_before_persist", "nonatomic_reserve", "wide"])
def test_random_walks_agree_step_by_step(seams, cfg):
    """200 seeded walks of up to 40 actions through both models: at every
    step the same canonical state (the port's `ControlPolicy.state_dict`
    equal to the reference's), the same enabled actions in the same order,
    and the same invariant verdict; a seam's walks reach its invariant."""
    rng = np.random.default_rng(24)
    pm = model.FleetModel(model.ModelConfig(**cfg), seams)
    rm = ref.FleetModel(ref.ModelConfig(**cfg), seams)
    steps, hits = 0, set()
    for _ in range(200):
        ps, rs = pm.initial_state(), rm.initial_state()
        for _ in range(40):
            assert pm.canon(ps) == rm.canon(rs)
            bad = pm.check_invariants(ps)
            assert bad == rm.check_invariants(rs)
            if bad is not None:
                hits.add(bad[0])
            acts = pm.enabled_actions(ps)
            assert acts == rm.enabled_actions(rs)
            if not acts:
                break
            action = acts[int(rng.integers(len(acts)))]
            pn, rn = pm.apply(ps, action), rm.apply(rs, action)
            assert (pn is None) == (rn is None), action
            if pn is not None:
                ps, rs = pn, rn
            steps += 1
    assert steps > 200 * 30
    for seam in seams:
        assert {"ack_before_persist": "durable_before_ack",
                "nonatomic_reserve": "no_double_run"}[seam] in hits


#: A schedule of 12 actions, past the smoke bound's depth 8, that both
#: models reach without a seam: a retransmitted submit delivered after the
#: result_ack has emptied the agent's done store runs the job again there.
BEYOND_SMOKE = [
    "submit:j0", "dispatch:a1", "timeout:a1:j0", "deliver_c2a:a1:submit:j0", "run:a1:j0",
    "deliver_a2c:a1:accepted:j0", "dispatch:a1", "deliver_a2c:a1:result:j0",
    "dup:c2a:a1:submit:j0", "deliver_c2a:a1:submit:j0", "deliver_c2a:a1:result_ack:j0",
    "deliver_c2a:a1:submit:j0",
]


def test_both_models_reach_the_same_violation_beyond_the_smoke_bound():
    """Beyond the smoke bound the two models still agree: the same
    violation of the unseamed protocol, and the same schedule is minimal
    in both."""
    got = model.replay_schedule(BEYOND_SMOKE)
    want = ref.replay_schedule(BEYOND_SMOKE)
    assert got.to_dict() == want.to_dict()
    assert (got.invariant, got.detail) == ("no_double_run", "a1/j0 executed 2 times on one agent")
    for mod in (model, ref):
        assert mod.minimize_schedule(mod.FleetModel(), BEYOND_SMOKE, "no_double_run") \
            == BEYOND_SMOKE


def test_the_model_embeds_the_ports_control_policy():
    """The model's queue is the port's `ControlPolicy`, whose state starts
    equal to the reference's; an unknown seam is refused alike."""
    from dsort_tpu_torch.serve.policy import ControlPolicy

    assert type(model._policy()) is ControlPolicy
    assert model.FleetModel().initial_state() == ref.FleetModel().initial_state()
    for mod in (model, ref):
        with pytest.raises(ValueError, match="unknown seam"):
            mod.FleetModel(seams=("no_such_seam",))


def _run(main, argv, capsys) -> tuple:
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, re.sub(r", \d+\.\d\ds \(", ", <elapsed> (", out)


@pytest.mark.parametrize("case", ["check", "seam", "replay", "stale"])
def test_cli_spec_matches_the_reference(case, tmp_path, capsys):
    """``cli spec`` and ``dsort spec``: the same exit codes and output lines
    apart from the elapsed time, and the same dumped fixture."""
    if case == "check":
        argv = [["spec", "check", "--max-states", "2000"]] * 2
        want_rc = 0
    elif case == "seam":
        argv = [["spec", "check", "--seam", "nonatomic_reserve", "--max-states", "20000",
                 "--dump-fixture", str(tmp_path / name)] for name in ("port.json", "ref.json")]
        want_rc = 1
    elif case == "replay":
        argv = [["spec", "replay", "--fixture",
                 os.path.join(FIXTURES, "ack_before_persist.json")]] * 2
        want_rc = 0
    else:  # the seam's schedule on the real protocol: no longer a violation
        stale = dict(_fixture("ack_before_persist"), seams=[])
        (tmp_path / "stale.json").write_text(json.dumps(stale))
        argv = [["spec", "replay", "--fixture", str(tmp_path / "stale.json")]] * 2
        want_rc = 1
    got = _run(cli.main, argv[0], capsys)
    want = _run(jcli.main, argv[1], capsys)
    assert got == want
    assert got[0] == want_rc
    if case == "check":
        assert got[1].splitlines()[-1] == "OK — no invariant violated in the explored space"
    elif case == "seam":
        assert "VIOLATION of no_double_run" in got[1]
        assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
        assert cli.main(["spec", "replay", "--fixture", str(tmp_path / "port.json")]) == 0
        assert "reproduces no_double_run after 7 action(s)" in capsys.readouterr().out
    elif case == "replay":
        assert "reproduces durable_before_ack after 6 action(s)" in got[1]
    else:
        assert got[1].endswith("schedule no longer violates anything\n")


def test_cli_spec_parser_matches_the_reference(reference_parser):
    """Every flag of ``dsort spec`` with its default, type and choices; and
    with ``spec`` the port has every subcommand of the reference."""
    port = _subparsers(cli._parser())

    def flags(p):
        return {a.dest: (a.option_strings, a.default, a.choices, a.type, a.nargs,
                         type(a).__name__)
                for a in p._actions if a.dest != "help"}

    assert flags(port["spec"]) == flags(reference_parser["spec"])
    assert set(port) == set(reference_parser)


def test_lint_cache_key_tracks_the_spec_model(monkeypatch):
    """The lint result cache's key hashes the analysis package's own
    sources, the spec model among them: editing it invalidates the cache,
    as editing the registries ``machines.py`` and ``contracts.py`` does."""
    from dsort_tpu_torch.analysis import all_checkers, engine, load_config

    cfg, checkers = load_config(REPO), all_checkers()
    base = engine.ResultCache._config_key(cfg, checkers)
    real_open = open
    for name in ("model.py", "machines.py", "contracts.py"):
        target = os.path.join(REPO, "dsort_tpu_torch", "analysis", "spec", name)

        def edited(path, *a, _target=target, **k):
            if os.path.abspath(path) == _target:
                return io.BytesIO(b"# edited\n")
            return real_open(path, *a, **k)

        monkeypatch.setattr(engine, "open", edited, raising=False)
        assert engine.ResultCache._config_key(cfg, checkers) != base, name
        monkeypatch.undo()
    assert engine.ResultCache._config_key(cfg, checkers) == base
