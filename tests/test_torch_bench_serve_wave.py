"""``bench --serve-mixed`` and ``--external-wave`` against the JAX
package's, at its own test sizes (`test_torch_bench_plain` holds the
lines)."""

import pytest

from test_torch_bench_plain import ASPECTS, BenchRuns, hold_lines

MODES = {
    "serve_mixed": ["--serve-mixed", "--n", "20000", "--reps", "1"],
    "external_wave": ["--external-wave", "--n", "65536", "--reps", "1"],
}


@pytest.fixture(scope="module")
def runs():
    return BenchRuns(MODES)


@pytest.mark.parametrize("aspect", ASPECTS)
@pytest.mark.parametrize("mode", list(MODES))
def test_bench_lines_match_reference(runs, mode, aspect):
    hold_lines(runs, mode, aspect)


def test_serve_mixed_packs_and_reuses_variants(runs):
    """8 slices, every output numpy's bits, repeat sizes hit the cache."""
    line = runs.get("serve_mixed")[3][0]
    assert line["slices"] == 8 and line["bit_identical"] is True
    assert line["cache_hit_rate"] >= 0.5 and line["jobs"] == 13
    assert line["fairness_p95_ratio"] > 0 and line["speedup_vs_serial"] > 0


def test_external_wave_drill_repairs_one_wave(runs):
    """The mid-wave loss re-sorts one wave's runs, no more."""
    main, drill = runs.get("external_wave")[3]
    assert main["over_hbm_factor"] == main["num_waves"] == 8
    assert drill["runs_resorted"] == 8
    assert drill["resume_fraction"] <= 1 / drill["num_waves"] + 1 / 64
