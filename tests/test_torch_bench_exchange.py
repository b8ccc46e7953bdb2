"""``bench --exchange-ab``, ``--autotune-ab`` and ``--analyze-smoke``
against the JAX package's, at its own test sizes (`test_torch_bench_plain`
holds the lines)."""

import numpy as np
import pytest

from test_torch_bench_plain import ASPECTS, BenchRuns, hold_lines

MODES = {
    "exchange_ab": ["--exchange-ab", "--n", "100000", "--reps", "1"],
    "autotune_ab": ["--autotune-ab", "--n", "65536", "--reps", "1"],
    "analyze_smoke": ["--analyze-smoke", "--n", "200000", "--reps", "2"],
}


@pytest.fixture(scope="module")
def runs():
    return BenchRuns(MODES)


@pytest.mark.parametrize("aspect", ASPECTS)
@pytest.mark.parametrize("mode", list(MODES))
def test_bench_lines_match_reference(runs, mode, aspect):
    hold_lines(runs, mode, aspect)


def test_exchange_ab_fused_arm_is_one_launch(runs):
    """The fused arm's one exchange launch a sort against the ring's P-1
    shifts, with no capacity retry, on every workload."""
    fused = [ln for ln in runs.get("exchange_ab")[3] if "fused_vs_ring" in ln["metric"]]
    assert len(fused) == 3
    for ln in fused:
        assert ln["fused_launches_per_sort"] == ln["dispatches_per_exchange"] == 1
        assert ln["dispatches_per_exchange_ring"] == 7 and ln["capacity_retries"] == 0


def test_autotune_ab_picks_ring_on_the_cpu(runs):
    """On the CPU the planner is told fused is not available: the skewed
    pick is the ring, the uniform pick alltoall."""
    zipf, uni = runs.get("autotune_ab")[3]
    assert (zipf["chosen_exchange"], uni["chosen_exchange"]) == ("ring", "alltoall")
    assert zipf["plan_decisions"] == uni["plan_decisions"] == 1


def test_analyze_smoke_verdict(runs):
    """The analyzer end to end: zipf skew above uniform, the watermark
    read, the dominant phase named."""
    line = runs.get("analyze_smoke")[3][0]
    assert line["introspection_ok"] is True
    assert line["skew_ratio_zipf"] > line["skew_ratio_uniform"] >= 1.0
    assert line["hbm_watermark_bytes"] > 0 and line["dominant_phase"] != "None"


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32,
                                   np.int64, np.uint64])
def test_autotune_probe_matches_reference_for_every_integer_dtype(dtype):
    """The planner's skew probe (run before each autotuned dispatch)
    gives the reference's inputs, hence its decision, for every integer key
    type, skewed or not."""
    from dsort_tpu.obs import plan as jplan

    from dsort_tpu_torch.obs.plan import probe_skew

    info = np.iinfo(dtype)
    rng = np.random.default_rng(3)
    for data in (rng.integers(info.min, info.max, 200_000, dtype=dtype, endpoint=True),
                 (rng.zipf(1.3, 200_000) % 1000).astype(dtype)):
        assert probe_skew(data, 8) == jplan.probe_skew(data, 8)
