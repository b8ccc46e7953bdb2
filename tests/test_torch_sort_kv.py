"""The port's record sort (``sort_kv``) against the JAX package's.

The same seeded records go through JAX ``SampleSort(mesh8).sort_kv`` on the
CPU mesh (its fused ring under the Pallas interpreter) and the port's on
``VirtualMesh(8, "cpu")``, under every exchange: the sorted keys must be
bit-identical, the per-shard counts identical and the record multiset of
every key equal (equal-key payload order is not specified in the
reference).  Within the port, ``ring`` and ``fused`` give the same payload
bytes.  Also here: the secondary-key path, ``cli terasort``, the TeraSort
file IO and generator, the record local sorts and layouts, all against JAX.
"""

import dataclasses
import functools
import logging

import numpy as np
import pytest
import torch

from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.data import ingest as jingest
from dsort_tpu.data import partition as jpart
from dsort_tpu.ops import local_sort as jls
from dsort_tpu.parallel.mesh import local_device_mesh
from dsort_tpu.parallel.sample_sort import SampleSort as JaxSampleSort

import jax.numpy as jnp

from dsort_tpu_torch import cli
from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.data import ingest, partition
from dsort_tpu_torch.ops import local_sort as ls
from dsort_tpu_torch.parallel import sample_sort as pss
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.parallel.sample_sort import SampleSort

P = 8
EXCHANGES = ["alltoall", "ring", "fused"]


def _case(name):
    if name == "terasort":
        return ingest.gen_terasort(30_000, seed=3)
    rng = np.random.default_rng(12)
    if name == "zipf_dup_sentinel":
        keys = np.minimum(rng.zipf(1.3, 12_000), 2**62).astype(np.int64)
        keys[::50] = np.iinfo(np.int64).max  # real keys equal to the pad sentinel
        vals = np.stack([np.arange(12_000, dtype=np.int64), rng.integers(0, 9, 12_000)], 1)
        return keys, vals
    if name == "float32":
        keys = rng.normal(size=6_000).astype(np.float32)
        keys[::61] = np.nan
        return keys, np.arange(6_000, dtype=np.int32)
    raise KeyError(name)


CASES = ["terasort", "zipf_dup_sentinel", "float32"]


def _jax_job(keys, vals):
    return JaxJobConfig(key_dtype=keys.dtype, payload_bytes=int(vals[0].nbytes))


@functools.lru_cache(maxsize=None)
def _jax_result(name, exchange):
    keys, vals = _case(name)
    ss = JaxSampleSort(local_device_mesh(P), _jax_job(keys, vals))
    out_k, out_v = ss.sort_kv(keys, vals, exchange=exchange)
    # The kv path's splitters are the keys path's (same sorted keys), so the
    # reference's per-shard record counts are its key-range lengths.
    counts = [len(r) for r in ss.sort_ranges(keys)] if keys.dtype.kind != "f" else None
    return out_k, out_v, counts


def _record_multiset(keys, vals):
    """Records ordered by (key, payload bytes): equal per-key multisets
    give equal arrays."""
    rows = np.ascontiguousarray(vals).reshape(len(vals), -1).view(np.uint8)
    order = np.lexsort(tuple(rows.T[::-1]) + (keys.view(f"u{keys.dtype.itemsize}"),))
    return keys[order], rows[order]


def _bits(a):
    return np.asarray(a).view(f"u{np.asarray(a).dtype.itemsize}")


def _port_sort_kv(monkeypatch, ss, keys, vals, **kw):
    """``ss.sort_kv`` plus the per-shard counts its assembly trimmed by."""
    seen = []
    trim = pss._trim_rows

    def spy(rows, c, n, what):
        seen.append([int(v) for v in c])
        return trim(rows, c, n, what)

    monkeypatch.setattr(pss, "_trim_rows", spy)
    out = ss.sort_kv(keys, vals, **kw)
    return out, seen[0]


@pytest.mark.parametrize("kernels", ["from_jax", "block"])
@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("name", CASES)
def test_sort_kv_matches_jax(name, exchange, kernels, monkeypatch):
    keys, vals = _case(name)
    want_k, want_v, want_counts = _jax_result(name, exchange)
    job = JobConfig.from_dict(dataclasses.asdict(_jax_job(keys, vals)))
    if kernels == "block":
        job = dataclasses.replace(job, local_kernel="block", merge_kernel="block_merge")
    ss = SampleSort(VirtualMesh(P, "cpu"), job)
    (out_k, out_v), counts = _port_sort_kv(monkeypatch, ss, keys, vals, exchange=exchange)
    np.testing.assert_array_equal(_bits(out_k), _bits(want_k))
    assert out_v.dtype == want_v.dtype and out_v.shape == want_v.shape
    if want_counts is not None:
        assert counts == want_counts
    if keys.dtype.kind == "f":  # NaN keys: compare the payload multiset alone
        np.testing.assert_array_equal(np.sort(out_v), np.sort(want_v))
    else:
        for a, b in zip(_record_multiset(out_k, out_v), _record_multiset(want_k, want_v)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", CASES)
def test_ring_and_fused_payloads_identical(name):
    """Same plan, same tag plane: the fused exchange gives the ring's exact
    payload permutation, not just the same multisets."""
    keys, vals = _case(name)
    ss = SampleSort(VirtualMesh(P, "cpu"))
    kr, vr = ss.sort_kv(keys, vals, exchange="ring")
    kf, vf = ss.sort_kv(keys, vals, exchange="fused")
    np.testing.assert_array_equal(_bits(kr), _bits(kf))
    np.testing.assert_array_equal(vr, vf)


def test_sentinel_valued_keys_keep_their_payloads():
    keys, vals = _case("zipf_dup_sentinel")
    for exchange in EXCHANGES:
        ks, vs = SampleSort(VirtualMesh(P, "cpu")).sort_kv(keys, vals, exchange=exchange)
        np.testing.assert_array_equal(np.sort(vs[:, 0]), np.arange(len(keys)))
        np.testing.assert_array_equal(keys[vs[:, 0]], ks)


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_secondary_key_orders_like_lexsort(exchange, caplog):
    """TeraSort's full 10-byte order; a secondary keeps the alltoall
    exchange (the ring and fused requests are warned and downgraded)."""
    keys, vals = ingest.gen_terasort(20_000, seed=9)
    keys[::3] = keys[0]  # shared 8-byte prefixes: the secondary decides
    sec = ingest.terasort_secondary(vals)
    port_log = logging.getLogger("dsort_tpu_torch")  # does not propagate to root
    port_log.addHandler(caplog.handler)
    try:
        ks, vs = SampleSort(VirtualMesh(P, "cpu")).sort_kv(
            keys, vals, secondary=sec, exchange=exchange
        )
    finally:
        port_log.removeHandler(caplog.handler)
    order = np.lexsort((sec, keys))
    np.testing.assert_array_equal(ks, keys[order])
    np.testing.assert_array_equal(ingest.terasort_secondary(vs), sec[order])
    assert (exchange == "alltoall") == ("secondary key" not in caplog.text)


def test_cli_terasort_is_byte_identical_to_numpy_order(tmp_path):
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    keys, vals = ingest.gen_terasort(5_000, seed=4)
    ingest.write_terasort_file(src, keys, vals)
    assert cli.main(["terasort", str(src), "-o", str(dst), "--device", "cpu"]) == 0
    raw = np.fromfile(src, np.uint8).reshape(-1, ingest.RECORD_BYTES)
    order = np.lexsort((ingest.terasort_secondary(vals), keys))
    assert dst.read_bytes() == raw[order].tobytes()


def test_terasort_io_and_generator_match_jax(tmp_path):
    keys, vals = ingest.gen_terasort(3_000, seed=11)
    jk, jv = jingest.gen_terasort(3_000, seed=11)
    np.testing.assert_array_equal(keys, jk)
    np.testing.assert_array_equal(vals, jv)
    ingest.write_terasort_file(tmp_path / "a.bin", keys, vals)
    jingest.write_terasort_file(tmp_path / "b.bin", jk, jv)
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    for a, b in zip(ingest.read_terasort_file(tmp_path / "a.bin"),
                    jingest.read_terasort_file(tmp_path / "a.bin")):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ingest.terasort_secondary(vals), jingest.terasort_secondary(jv))
    assert ingest.RECORD_BYTES == jingest.RECORD_BYTES


@pytest.mark.parametrize("trailing", [(), (3,), (2, 5)])
def test_record_layouts_match_jax(trailing):
    rng = np.random.default_rng(13)
    keys = rng.integers(0, 2**63, 1_003, dtype=np.uint64)
    vals = rng.integers(0, 255, (1_003,) + trailing).astype(np.uint8)
    for a, b in zip(partition.pad_kv_to_shards(keys, vals, P), jpart.pad_kv_to_shards(keys, vals, P)):
        np.testing.assert_array_equal(a, b)
    _, _, counts = jpart.pad_kv_to_shards(keys, vals, P)
    sec = rng.integers(0, 2**16, 1_003).astype(np.uint16)
    np.testing.assert_array_equal(partition.pad_to_layout(sec, counts, 128),
                                  jpart.pad_to_layout(sec, counts, 128))


def test_record_local_sorts_match_jax_stable():
    """sort_kv_padded / sort_kv2_padded / sort_kv equal JAX's stable
    lax.sort forms bit for bit (rows, pads, sentinel-valued keys, ties)."""
    rng = np.random.default_rng(14)
    keys = rng.integers(-5, 5, (4, 300)).astype(np.int32)
    keys[:, ::7] = np.iinfo(np.int32).max
    counts = np.array([300, 250, 0, 17], np.int32)
    sec = rng.integers(0, 4, (4, 300)).astype(np.int16)
    vals = rng.integers(0, 255, (4, 300, 6)).astype(np.uint8)
    tk, ts, tv, tc = (torch.from_numpy(a) for a in (keys, sec, vals, counts))
    for row in range(4):
        jk, jv, _ = jls.sort_kv_padded(jnp.asarray(keys[row]), jnp.asarray(vals[row]),
                                       int(counts[row]), stable=True)
        ok, ov, _ = ls.sort_kv_padded(tk[row], tv[row], int(counts[row]))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(ov.numpy(), np.asarray(jv))
        jk, js, jv, _ = jls.sort_kv2_padded(jnp.asarray(keys[row]), jnp.asarray(sec[row]),
                                            jnp.asarray(vals[row]), int(counts[row]), stable=True)
        ok, os_, ov, _ = ls.sort_kv2_padded(tk[row], ts[row], tv[row], int(counts[row]))
        for a, b in ((ok, jk), (os_, js), (ov, jv)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # Batched rows at once give the per-row results.
    ok, ov, _ = ls.sort_kv_padded(tk, tv, tc)
    for row in range(4):
        np.testing.assert_array_equal(ok[row].numpy(),
                                      ls.sort_kv_padded(tk[row], tv[row], int(counts[row]))[0].numpy())
    jk, jv = jls.sort_kv(jnp.asarray(keys[0]), jnp.asarray(vals[0]))
    ok, ov = ls.sort_kv(tk[0], tv[0])
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jv))


def test_empty_and_single_worker_records():
    keys, vals = ingest.gen_terasort(999, seed=2)
    ks, vs = SampleSort(VirtualMesh(1, "cpu")).sort_kv(keys, vals, exchange="fused")
    jk, jv = JaxSampleSort(local_device_mesh(1), _jax_job(keys, vals)).sort_kv(keys, vals)
    np.testing.assert_array_equal(ks, jk)
    np.testing.assert_array_equal(vs, jv)
    ek, ev = SampleSort(VirtualMesh(P, "cpu")).sort_kv(keys[:0], vals[:0], exchange="ring")
    assert ek.shape == (0,) and ev.shape == (0, 92)


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_sort_kv_seven_shards_matches_jax(exchange):
    """A non-power-of-two mesh: the fused merge layout pads with whole
    sentinel slots, the kv tags with ``2 * total + pos``."""
    keys, vals = _case("zipf_dup_sentinel")
    want_k, want_v = JaxSampleSort(local_device_mesh(7), _jax_job(keys, vals)).sort_kv(
        keys, vals, exchange=exchange
    )
    out_k, out_v = SampleSort(VirtualMesh(7, "cpu")).sort_kv(keys, vals, exchange=exchange)
    np.testing.assert_array_equal(out_k, want_k)
    for a, b in zip(_record_multiset(out_k, out_v), _record_multiset(want_k, want_v)):
        np.testing.assert_array_equal(a, b)
