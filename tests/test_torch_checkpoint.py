"""The port's `checkpoint.ShardCheckpoint` against the JAX package's store.

The store is the reference's file for file and key for key, so each case
writes with one package and reads with the other (both directions): the
shard, range, aux and (wave, run) namespaces, the manifest's JSON, the
staleness guard (`sync_manifest`), the sweep of torn tmp files, the
per-writer tmp token, the ``job_id`` path-escape guard and the
``checkpoint_persist`` / ``checkpoint_clear`` journal events.
"""

import json
import os
import time

import numpy as np
import pytest

from dsort_tpu.checkpoint import ShardCheckpoint as JaxShardCheckpoint
from dsort_tpu.utils.events import EventLog as JaxEventLog

from dsort_tpu_torch.checkpoint import ShardCheckpoint, fsync_publish
from dsort_tpu_torch.utils.events import EventLog

STORES = {"jax": JaxShardCheckpoint, "port": ShardCheckpoint}
DIRECTIONS = [("jax", "port"), ("port", "jax")]


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_store_roundtrip_across_packages(tmp_path, writer, reader):
    w = STORES[writer](str(tmp_path), "job1")
    arr = np.arange(10, dtype=np.int64)
    w.save(0, arr)
    w.save(3, arr * 2)
    w.save_range(1, arr[::-1].copy())
    w.save_aux("sec", 2, arr.astype(np.uint16))
    w.save_wave_run(4, 7, arr.astype(np.uint32))
    w.write_manifest(4, np.int64, 40, fingerprint="fp", n_ranges=8)
    r = STORES[reader](str(tmp_path), "job1")
    assert r.completed_shards() == [0, 3] and r.has(3) and not r.has(1)
    np.testing.assert_array_equal(r.load(3), arr * 2)
    assert r.completed_ranges() == [1]
    np.testing.assert_array_equal(r.load_range(1), arr[::-1])
    assert r.completed_aux("sec") == [2]
    assert r.load_aux("sec", 2).dtype == np.uint16
    assert r.completed_wave_runs() == [(4, 7)]
    np.testing.assert_array_equal(r.load_wave_run(4, 7), arr.astype(np.uint32))
    assert r.manifest() == {"num_shards": 4, "dtype": "int64", "total": 40,
                            "fingerprint": "fp", "n_ranges": 8}
    r.clear()
    assert r.completed_shards() == [] and r.manifest() is None


def test_store_files_and_manifest_are_the_references(tmp_path):
    """The same calls leave the same file names and the same manifest bytes
    in both packages' stores."""
    for name, cls in STORES.items():
        ck = cls(str(tmp_path / name), "j")
        ck.save(1, np.arange(3, dtype=np.int32))
        ck.save_range(0, np.arange(3, dtype=np.int32))
        ck.save_aux("rk", 5, np.arange(3, dtype=np.int32))
        ck.save_wave_run(12, 3, np.arange(3, dtype=np.int32))
        ck.write_manifest(8, np.float32, 3, fingerprint="x", kind="wave",
                          splitters=[1, 2, 3], storage_dtype="uint32")
    names = {n: sorted(os.listdir(tmp_path / n / "j")) for n in STORES}
    assert names["port"] == names["jax"] == [
        "aux_rk_00005.npy", "aux_w00012_00003.npy", "manifest.json",
        "range_00000.npy", "shard_00001.npy",
    ]
    manifests = {n: (tmp_path / n / "j" / "manifest.json").read_bytes() for n in STORES}
    assert manifests["port"] == manifests["jax"]
    for f in names["port"]:
        if f.endswith(".npy"):
            assert (tmp_path / "port" / "j" / f).read_bytes() == \
                (tmp_path / "jax" / "j" / f).read_bytes()


def test_namespaces_clear_independently(tmp_path):
    for cls in STORES.values():
        ck = cls(str(tmp_path), f"ns{cls.__module__.split('.')[0]}")
        ck.save(0, np.arange(4, dtype=np.int32))
        ck.save_range(1, np.arange(6, dtype=np.int32))
        ck.save_wave_run(0, 1, np.arange(2, dtype=np.int32))
        ck.save_wave_run(1, 1, np.arange(2, dtype=np.int32))
        ck.clear_shards()
        assert ck.completed_shards() == [] and ck.completed_ranges() == [1]
        ck.save(2, np.arange(3, dtype=np.int32))
        ck.clear_ranges()
        assert ck.completed_ranges() == [] and ck.completed_shards() == [2]
        ck.clear_wave_runs(0)
        assert ck.completed_wave_runs() == [(1, 1)]
        ck.clear_wave_runs()
        assert ck.completed_wave_runs() == [] and ck.completed_shards() == [2]


def test_mmap_reads(tmp_path):
    ck = ShardCheckpoint(str(tmp_path), "jobmm")
    a = np.arange(1000, dtype=np.int64)
    ck.save(0, a)
    ck.save_range(2, a[::-1].copy())
    ck.save_wave_run(1, 0, a)
    for m, want in ((ck.load_mmap(0), a), (ck.load_range_mmap(2), a[::-1]),
                    (ck.load_wave_run_mmap(1, 0), a)):
        assert isinstance(m, np.memmap)
        np.testing.assert_array_equal(np.asarray(m[10:20]), want[10:20])


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_sync_manifest_guard_across_packages(tmp_path, writer, reader):
    """`sync_manifest` trusts a store only for the same (shards, dtype,
    total, fingerprint), keeps a matching manifest's ``n_ranges``, and
    clears orphaned state with no manifest — whichever package wrote it."""
    w = STORES[writer](str(tmp_path), "g")
    assert w.sync_manifest(8, np.int32, 100, "fp") is False
    w.save(0, np.arange(3, dtype=np.int32))
    w.write_manifest(8, np.int32, 100, fingerprint="fp", n_ranges=7)
    r = STORES[reader](str(tmp_path), "g")
    assert r.sync_manifest(8, np.int32, 100, "fp") is False
    assert r.manifest()["n_ranges"] == 7 and r.completed_shards() == [0]
    assert r.sync_manifest(8, np.int32, 100, "other") is True
    assert r.completed_shards() == [] and "n_ranges" not in r.manifest()
    # orphaned state: a range with no manifest is untrusted
    r.save_range(0, np.arange(2, dtype=np.int32))
    os.remove(os.path.join(r.dir, "manifest.json"))
    w2 = STORES[writer](str(tmp_path), "g")
    assert w2.sync_manifest(8, np.int32, 100, "fp") is True
    assert w2.completed_ranges() == []


def test_ignores_and_sweeps_torn_tmp_files(tmp_path):
    """A crash between the save and the rename leaves ``*.tmp*`` files: they
    are never listed, and a new handle sweeps the STALE ones only (a fresh
    one may belong to a live writer sharing the job dir)."""
    ckpt = ShardCheckpoint(str(tmp_path), "torn")
    ckpt.save(0, np.arange(4, dtype=np.int32))
    ckpt.save_range(0, np.arange(4, dtype=np.int32))
    torn = ("shard_00001.npy.tmp.npy", "range_00001.npy.tmp.npy", "manifest.json.tmp",
            "aux_w00000_00001.npy.tmp.npy")
    for name in torn + ("fresh_inflight.npy.tmp.npy",):
        with open(os.path.join(ckpt.dir, name), "wb") as f:
            f.write(b"torn")
    old = time.time() - ShardCheckpoint.TMP_SWEEP_AGE_S - 5
    for name in torn:
        os.utime(os.path.join(ckpt.dir, name), (old, old))
    assert ckpt.completed_shards() == [0] and ckpt.completed_ranges() == [0]
    assert ckpt.completed_wave_runs() == []
    ckpt2 = ShardCheckpoint(str(tmp_path), "torn")
    assert [n for n in os.listdir(ckpt2.dir) if ".tmp" in n] == ["fresh_inflight.npy.tmp.npy"]
    assert ckpt2.completed_shards() == [0]


def test_tmp_names_unique_per_writer(tmp_path):
    a = ShardCheckpoint(str(tmp_path), "dup")
    b = ShardCheckpoint(str(tmp_path), "dup")
    assert a._token != b._token
    a.save(0, np.arange(8, dtype=np.int32))
    b.save(0, np.arange(8, dtype=np.int32)[::-1].copy())
    np.testing.assert_array_equal(a.load(0), np.arange(8, dtype=np.int32)[::-1])


@pytest.mark.parametrize("bad", ["", ".", "..", "...", "a/b", "a\\b"])
def test_job_id_path_escape_refused(tmp_path, bad):
    """Both packages refuse the same ids: ``..`` plus the stale clear would
    rmtree the checkpoint root's parent."""
    for cls in STORES.values():
        with pytest.raises(ValueError, match="invalid job_id"):
            cls(str(tmp_path / "ck"), bad)


def test_fsync_publish_replaces_atomically(tmp_path):
    tmp, path = tmp_path / "x.tmp", tmp_path / "x"
    path.write_text("old")
    tmp.write_text("new")
    fsync_publish(str(tmp), str(path))
    assert path.read_text() == "new" and not tmp.exists()


def test_persist_and_clear_events_match_jax(tmp_path):
    """With a journal attached, every persist is a ``checkpoint_persist``
    and a clear a ``checkpoint_clear``, with the reference's fields."""
    got = {}
    for name, (cls, log_cls) in {"jax": (JaxShardCheckpoint, JaxEventLog),
                                 "port": (ShardCheckpoint, EventLog)}.items():
        ck = cls(str(tmp_path / name), "ev")
        ck.journal = log_cls()
        ck.save(2, np.arange(5, dtype=np.int32))
        ck.save_range(1, np.arange(3, dtype=np.int32))
        ck.save_aux("sec", 0, np.arange(4, dtype=np.int32))
        ck.save_wave_run(3, 6, np.arange(7, dtype=np.int32))
        ck.clear()
        got[name] = [(e.type, e.fields) for e in ck.journal.events()]
    assert got["port"] == got["jax"]
    assert [t for t, _ in got["port"]] == ["checkpoint_persist"] * 4 + ["checkpoint_clear"]
    assert got["port"][3][1] == {"kind": "wave_run", "wave": 3, "id": 6, "n": 7}


def test_manifest_is_json_with_reference_keys(tmp_path):
    ck = ShardCheckpoint(str(tmp_path), "m")
    ck.write_manifest(3, np.uint64, 9, run_elems=4, fingerprint="f", storage_dtype="uint64")
    with open(os.path.join(ck.dir, "manifest.json"), encoding="utf-8") as f:
        assert json.load(f) == {"num_shards": 3, "dtype": "uint64", "total": 9,
                                "run_elems": 4, "fingerprint": "f",
                                "storage_dtype": "uint64"}
