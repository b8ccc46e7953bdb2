"""The port's sort-output validation and ``gen`` against the JAX package's.

Every case of ``tests/test_validate.py`` (all but the ``external`` half of
``test_cli_gen_bin_external_validate``, whose out-of-core sort is not
ported) runs through both packages on the same files: reports, checksums,
first violations (also across a streamed chunk boundary, with both modules'
chunk sizes patched alike), the ``validate`` CLI's JSON line and exit code,
and the ``gen`` CLI's files byte for byte.
"""

import json

import numpy as np
import pytest

from dsort_tpu.cli import main as jax_cli_main
from dsort_tpu.data import ingest as jin
from dsort_tpu.models import validate as jv
from dsort_tpu.runtime import native

from dsort_tpu_torch import cli
from dsort_tpu_torch.data import ingest as tin
from dsort_tpu_torch.models import validate as tv


def _report(rep):
    return (rep.records, rep.sorted_ok, rep.first_violation, rep.checksum, rep.ok)


def _both(fn_name, *args, **kw):
    """``fn_name`` of both packages on the same arguments: equal results."""
    got, want = getattr(tv, fn_name)(*args, **kw), getattr(jv, fn_name)(*args, **kw)
    if isinstance(want, jv.ValidationReport):
        got, want = _report(got), _report(want)
    assert got == want, fn_name
    return getattr(tv, fn_name)(*args, **kw)


def test_ints_sorted_and_permutation(tmp_path):
    rng = np.random.default_rng(1)
    data = rng.integers(-(2**31), 2**31 - 1, 10_000).astype(np.int32)
    inp, outp = tmp_path / "in.txt", tmp_path / "out.txt"
    tin.write_ints_file(inp, data)
    tin.write_ints_file(outp, np.sort(data))
    rep = _both("validate_ints_file", outp)
    assert rep.sorted_ok and rep.records == 10_000
    assert _both("checksum_ints_file", inp) == (rep.records, rep.checksum)


def test_ints_detects_unsorted_and_tamper(tmp_path):
    data = np.arange(1000, dtype=np.int32)
    bad = data.copy()
    bad[500], bad[501] = bad[501], bad[500]
    p = tmp_path / "bad.txt"
    tin.write_ints_file(p, bad)
    rep = _both("validate_ints_file", p)
    assert not rep.sorted_ok and rep.first_violation == 501
    q = tmp_path / "tampered.txt"
    t = np.sort(data)
    t[7] += 1
    tin.write_ints_file(q, t)
    assert _both("validate_ints_file", q).checksum != _both("checksum_ints_file", p)[1]


@pytest.mark.parametrize("dtype", ["int64", "uint32", "int8", "uint16"])
def test_ints_dtypes(tmp_path, dtype):
    """Other key widths hash their own bytes, as the reference's do."""
    data = np.random.default_rng(4).integers(
        np.iinfo(dtype).min, np.iinfo(dtype).max, 5_000, endpoint=True).astype(dtype)
    p = tmp_path / "k.txt"
    tin.write_ints_file(p, np.sort(data))
    rep = _both("validate_ints_file", p, dtype=dtype)
    assert rep.sorted_ok and rep.checksum == jv._multiset(data, len(data), data.dtype.itemsize)


def test_terasort_validate_roundtrip(tmp_path):
    inp, outp = tmp_path / "t.bin", tmp_path / "t_out.bin"
    tin.gen_terasort_file(inp, 3_000, seed=2)
    assert cli.main(["terasort", str(inp), "-o", str(outp), "--workers", "8",
                     "--device", "cpu"]) == 0
    rep = _both("validate_terasort_file", outp)
    assert rep.sorted_ok and rep.records == 3_000
    assert not _both("validate_terasort_file", inp).sorted_ok
    assert _both("checksum_terasort_file", inp) == (rep.records, rep.checksum)


def _records(keys10: np.ndarray) -> np.ndarray:
    recs = np.random.default_rng(6).integers(0, 256, (len(keys10), 100), dtype=np.uint8)
    recs[:, :10] = keys10
    return recs


def _order_cases():
    """10-byte keys: a dip at a 4-record chunk's first record (the boundary
    pair), inside a chunk, in bytes 8-9 only, equal keys, sorted."""
    rng = np.random.default_rng(9)
    keys = np.zeros((12, 10), np.uint8)
    keys[:, 0] = np.arange(12)
    boundary = keys.copy()
    boundary[[3, 4]] = boundary[[4, 3]]
    inside = keys.copy()
    inside[[5, 6]] = inside[[6, 5]]
    low = np.zeros((12, 10), np.uint8)
    low[:, 9] = np.arange(12)
    low[9, 9], low[9, 8] = 0, 0
    ties = np.zeros((12, 10), np.uint8)
    rand = rng.integers(0, 4, (12, 10), dtype=np.uint8)
    return {"boundary": boundary, "inside": inside, "bytes 8-9": low, "ties": ties,
            "sorted": keys, "random": rand}


@pytest.mark.parametrize("case", list(_order_cases()))
def test_terasort_order_across_chunks(tmp_path, monkeypatch, case):
    """The first violation, streamed in 4-record chunks (both modules
    patched alike), equals the reference's; the vectorised in-chunk check
    equals a record-by-record compare of the key bytes."""
    monkeypatch.setattr(jv, "_CHUNK_RECORDS", 4)
    monkeypatch.setattr(tv, "_CHUNK_RECORDS", 4)
    recs = _records(_order_cases()[case])
    p = tmp_path / "b.bin"
    recs.tofile(p)
    rep = _both("validate_terasort_file", p)
    keys = [bytes(r[:10]) for r in recs]
    first = next((i for i in range(1, len(keys)) if keys[i] < keys[i - 1]), None)
    assert rep.first_violation == first and rep.sorted_ok == (first is None)
    if case == "boundary":
        assert rep.first_violation == 4
    flat = recs.reshape(-1)
    assert tv._check_order_chunk(flat, len(recs)) == jv._check_order_chunk(flat, len(recs)) == (
        -1 if first is None else first)


def test_empty_and_single(tmp_path):
    p = tmp_path / "e.txt"
    p.write_text("")
    rep = _both("validate_ints_file", p)
    assert rep.ok and rep.records == 0
    p.write_text("42\n")
    rep = _both("validate_ints_file", p)
    assert rep.ok and rep.records == 1


def _cli_both(capsys, argv):
    """``validate`` through both CLIs: (exit code, JSON line), equal."""
    outs = []
    for main in (jax_cli_main, cli.main):
        rc = main(argv)
        line = capsys.readouterr().out.strip().splitlines()[-1]
        outs.append((rc, json.loads(line)))
    assert outs[0] == outs[1]
    return outs[1]


def _files(tmp_path):
    data = np.arange(100, dtype=np.int32)
    files = {}
    for name, arr in (("sorted", data), ("reversed", data[::-1].copy()),
                      ("dropped", data[:-1]), ("tampered", np.r_[data[:-1], 1000]),
                      ("swapped", np.r_[data[:40], data[41], data[40], data[42:]]),
                      ("empty", data[:0]), ("single", data[:1])):
        files[name] = tmp_path / f"{name}.txt"
        tin.write_ints_file(files[name], arr)
    return files


@pytest.mark.parametrize("case,against,want_rc", [
    ("sorted", "reversed", 0), ("reversed", None, 1), ("dropped", "reversed", 1),
    ("tampered", "reversed", 1), ("swapped", "reversed", 1), ("empty", None, 0),
    ("empty", "reversed", 1), ("single", None, 0), ("single", "single", 0),
])
def test_cli_validate_exit_codes(tmp_path, capsys, case, against, want_rc):
    files = _files(tmp_path)
    argv = ["validate", str(files[case])] + (["--against", str(files[against])] if against else [])
    rc, result = _cli_both(capsys, argv)
    assert rc == want_rc
    assert result["records"] == {"empty": 0, "single": 1, "dropped": 99}.get(case, 100)


def test_python_fnv_matches_native():
    """The numpy sweep gives the native library's bits (the reference's
    default where it is built)."""
    if not native.available():
        pytest.skip("the reference's native library is unavailable")
    rng = np.random.default_rng(31)
    buf = rng.integers(0, 256, (500, 100), dtype=np.uint8)
    assert tv._multiset(buf, 500, 100) == native.fnv_multiset(buf, 500, 100)
    ints = rng.integers(-(2**31), 2**31 - 1, 777).astype(np.int32)
    assert tv._fnv_multiset_py(ints, 777, 4) == native.fnv_multiset(ints, 777, 4)
    assert tv._multiset(ints, 777, 4) == jv._fnv_multiset_py(ints, 777, 4)


def test_binary_key_file_validate_roundtrip(tmp_path, monkeypatch):
    """gen --format bin's file, sorted, validated --binary in 4096-key
    chunks (both modules patched alike): order across chunk boundaries
    and the permutation proof."""
    monkeypatch.setattr(jv, "_CHUNK_ELEMS", 4096)
    monkeypatch.setattr(tv, "_CHUNK_ELEMS", 4096)
    src, out = tmp_path / "in.bin", tmp_path / "out.bin"
    tin.gen_uniform_bin_file(src, 100_000, dtype=np.int32, seed=5, chunk=8192)
    data = np.fromfile(src, dtype=np.int32)
    assert len(data) == 100_000
    np.sort(data).tofile(out)
    rep = _both("validate_bin_file", out, dtype=np.int32)
    assert rep.ok and rep.records == 100_000
    n_in, sum_in = _both("checksum_bin_file", src, dtype=np.int32)
    assert (n_in, sum_in) == (rep.records, rep.checksum)
    bad = np.sort(data)
    bad[4096], bad[4095] = bad[4095], bad[4096]
    if bad[4096] == bad[4095]:
        bad[4096] = bad[4095] - 1
    bad.tofile(out)
    rep2 = _both("validate_bin_file", out, dtype=np.int32)
    assert not rep2.ok and rep2.first_violation == 4096
    np.sort(data)[:-1].tofile(out)
    rep3 = _both("validate_bin_file", out, dtype=np.int32)
    assert rep3.ok and rep3.checksum != sum_in


def test_cli_gen_bin_validate(tmp_path, capsys):
    """``gen --format bin`` then ``validate --binary --against`` of its
    sorted keys, through both CLIs (the reference's external sort between
    them is not ported: numpy sorts here)."""
    src = {name: tmp_path / f"{name}.bin" for name in ("jax", "port")}
    assert jax_cli_main(["gen", "50000", "-o", str(src["jax"]), "--format", "bin"]) == 0
    assert cli.main(["gen", "50000", "-o", str(src["port"]), "--format", "bin"]) == 0
    assert src["port"].read_bytes() == src["jax"].read_bytes()
    out = tmp_path / "out.bin"
    np.sort(np.fromfile(src["port"], dtype=np.int32)).tofile(out)
    rc, result = _cli_both(capsys, ["validate", str(out), "--binary", "--against",
                                    str(src["port"])])
    assert rc == 0 and result["permutation_of_input"] and result["records"] == 50000


@pytest.mark.parametrize("argv", [
    ["--dist", "uniform"],
    ["--dist", "uniform", "--dtype", "int64", "--seed", "7"],
    ["--dist", "uniform", "--dtype", "uint16"],
    ["--dist", "zipf"],
    ["--dist", "zipf", "--zipf-a", "1.1", "--dtype", "int64", "--seed", "3"],
    ["--dist", "terasort", "--seed", "4"],
    ["--format", "bin", "--dtype", "uint64", "--seed", "9"],
])
def test_cli_gen_files_equal_the_reference(tmp_path, argv):
    outs = []
    for name, main in (("jax", jax_cli_main), ("port", cli.main)):
        path = tmp_path / name
        assert main(["gen", "3000", "-o", str(path)] + argv) == 0
        outs.append(path.read_bytes())
    assert outs[0] == outs[1] and outs[1]


@pytest.mark.parametrize("argv", [
    ["--dist", "terasort", "--format", "bin"], ["--dist", "zipf", "--format", "bin"],
])
def test_cli_gen_refusals_equal_the_reference(tmp_path, argv):
    errors = []
    for main in (jax_cli_main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(["gen", "10", "-o", str(tmp_path / "x")] + argv)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert not (tmp_path / "x").exists()


def test_gen_functions_equal_the_reference(tmp_path):
    for dtype in (np.int8, np.uint32, np.int64):
        np.testing.assert_array_equal(tin.gen_uniform(2000, dtype, 1), jin.gen_uniform(2000, dtype, 1))
        np.testing.assert_array_equal(tin.gen_zipf(2000, 1.3, dtype, 1), jin.gen_zipf(2000, 1.3, dtype, 1))
    tin.gen_uniform_bin_file(tmp_path / "a", 5000, np.int16, seed=2, chunk=700)
    jin.gen_uniform_bin_file(tmp_path / "b", 5000, np.int16, seed=2, chunk=700)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
