"""The port's text ingest and ``cli run --dtype`` against the JAX package's.

``read_ints_file`` of both packages reads the same files (whole-line and
trailing ``#`` comments, ``+`` signs, an empty file, out-of-range values)
into the same arrays, or both raise `OverflowError`; ``cli run --dtype
int64`` of both writes byte-identical output files for the same input.
"""

import numpy as np
import pytest

from dsort_tpu.cli import main as jax_cli_main
from dsort_tpu.data import ingest as jingest

from dsort_tpu_torch import cli
from dsort_tpu_torch.data import ingest

TEXTS = {
    "comment": "# header line\n3\n-1\n2\n",
    "trailing_comment": "3  # three\n-1\n2# two\n\n",
    "plus_sign": "+42\n-7\n+0\n12\n",
    "empty": "",
    "comments_only": "# nothing\n  # here\n",
    "above_2_31": "2147483648\n-2147483649\n5\n",
}


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_read_ints_file_matches_jax(tmp_path, name, dtype):
    """Same file, same array (dtype included); where the values leave the
    dtype, both raise OverflowError."""
    p = tmp_path / "in.txt"
    p.write_text(TEXTS[name])
    if name == "above_2_31" and dtype == np.int32:
        with pytest.raises(OverflowError):
            jingest.read_ints_file(p, dtype)
        with pytest.raises(OverflowError):
            ingest.read_ints_file(p, dtype)
        return
    want = jingest.read_ints_file(p, dtype)
    got = ingest.read_ints_file(p, dtype)
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("text,dtype", [
    ("# c\n5000000000\n", np.int32), ("1 # c\n-1\n", np.uint32),
    ("+9223372036854775808\n", np.int64),
])
def test_read_ints_file_overflow_with_comments_raises(tmp_path, text, dtype):
    """Comments and signs do not open a way around the range check (the
    reference's np.loadtxt fallback wraps such values silently)."""
    p = tmp_path / "in.txt"
    p.write_text(text)
    with pytest.raises(OverflowError):
        ingest.read_ints_file(p, dtype)


def test_cli_run_dtype_int64_matches_jax(tmp_path):
    """``run --dtype int64`` of both packages on one file with keys beyond
    int32, a comment line and a ``+`` sign: byte-identical outputs."""
    rng = np.random.default_rng(61)
    x = rng.integers(-(2**62), 2**62, 3_000, dtype=np.int64)
    x[:3] = [2**31, -(2**31) - 1, 5_000_000_000]
    src = tmp_path / "in.txt"
    src.write_text("# 64-bit keys\n+17\n" + "".join(f"{v}\n" for v in x.tolist()))
    ref, out = tmp_path / "ref.txt", tmp_path / "out.txt"
    assert jax_cli_main(["run", str(src), "-o", str(ref), "--mode", "spmd",
                         "--dtype", "int64"]) == 0
    assert cli.main(["run", str(src), "-o", str(out), "--dtype", "int64",
                     "--device", "cpu"]) == 0
    assert out.read_bytes() == ref.read_bytes()
    want = np.sort(np.append(x, 17))
    assert out.read_bytes() == "".join(f"{v}\n" for v in want.tolist()).encode()


@pytest.mark.parametrize("dtype", ["uint32", "uint64", "float32", "float64"])
def test_cli_run_dtype_round_trips(tmp_path, dtype):
    """Unsigned keys over their full range and floats (NaN, +-inf, -0.0)
    through the key mappings: the file read back equals the sorted keys."""
    rng = np.random.default_rng(62)
    dt = np.dtype(dtype)
    if dt.kind == "u":
        x = rng.integers(0, np.iinfo(dt).max, 2_000, dtype=dt, endpoint=True)
    else:
        x = (rng.standard_normal(2_000) * 1e6).astype(dt)
        x[:5] = [np.nan, np.inf, -np.inf, -0.0, 1e-30]
    src, dst = tmp_path / "in.txt", tmp_path / "out.txt"
    ingest.write_ints_file(src, x)
    np.testing.assert_array_equal(ingest.read_ints_file(src, dt), x)
    assert cli.main(["run", str(src), "-o", str(dst), "--dtype", dtype, "--device", "cpu"]) == 0
    got = ingest.read_ints_file(dst, dt)
    np.testing.assert_array_equal(got, np.sort(x))


# The reader's grammar, pinned (module docstring of data/ingest.py): "_"
# separators are refused by both packages; integral float text reads as the
# integer it names, as the reference reads it; lossy text raises in the port
# where the reference truncates it (3.5 -> 3, nan -> INT_MIN).

@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint32, np.float32])
def test_read_ints_file_refuses_digit_separators(tmp_path, dtype):
    p = tmp_path / "in.txt"
    p.write_text("5\n1_000\n")
    with pytest.raises(ValueError):
        jingest.read_ints_file(p, dtype)
    with pytest.raises(ValueError, match="'_'"):
        ingest.read_ints_file(p, dtype)
    p.write_text("# a_comment_with_underscores\n5\n")
    np.testing.assert_array_equal(ingest.read_ints_file(p, dtype), jingest.read_ints_file(p, dtype))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint32, np.uint64])
def test_read_ints_file_reads_integral_float_text_as_jax(tmp_path, dtype):
    p = tmp_path / "in.txt"
    p.write_text("3.0\n3.\n1e3\n1E3\n+7.0e0\n-0.0\n12\n2.5e1\n")
    want = jingest.read_ints_file(p, dtype)
    got = ingest.read_ints_file(p, dtype)
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [3, 3, 1000, 1000, 7, 0, 12, 25])


@pytest.mark.parametrize("token", ["3.5", "nan", "inf", "-1.25e0", "1e-3", "0x10", "."])
def test_read_ints_file_refuses_lossy_text(tmp_path, token):
    p = tmp_path / "in.txt"
    p.write_text(f"5\n{token}\n")
    with pytest.raises(ValueError):
        ingest.read_ints_file(p, np.int64)


@pytest.mark.parametrize("text,dtype", [("2147483648.0\n", np.int32), ("-3.0\n", np.uint32),
                                        ("1e20\n", np.int64)])
def test_read_ints_file_integral_float_text_out_of_range_raises(tmp_path, text, dtype):
    p = tmp_path / "in.txt"
    p.write_text(text)
    with pytest.raises(OverflowError):
        ingest.read_ints_file(p, dtype)
