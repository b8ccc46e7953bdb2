"""Sorted-shard, range and run checkpoints for partial recovery.

Counterpart of ``dsort_tpu/checkpoint.py``, host numpy only and the same
store, file for file and key for key, so a store that either package wrote
resumes in the other: one ``.npy`` per entry under ``<dir>/<job_id>/`` in
four namespaces (``shard_NNNNN`` local-sort shards and ``range_NNNNN``
shuffle ranges of `scheduler.SpmdScheduler` / `scheduler.Scheduler`,
``aux_<tag>_NNNNN`` companion arrays, ``aux_wWWWWW_RRRRR`` runs of the
wave pipeline) plus ``manifest.json`` (shard count, ``dtype``, ``total``,
``fingerprint`` and whatever a pipeline adds: ``n_ranges``, ``run_elems``,
``storage_dtype``, the wave layout and its ``splitters``).

Every write is tmp + fsync + rename (`fsync_publish`); tmp names carry a
per-writer token, stale torn tmp files are swept when a store opens, a
``job_id`` that could escape the root is refused, and with a ``journal``
attached every persist is a ``checkpoint_persist`` event.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid

import numpy as np


def fsync_publish(tmp: str, path: str) -> None:
    """The durability half of write-then-rename: fsync ``tmp``'s bytes,
    THEN ``os.replace`` it into place.  Every resume path in this module
    trusts a listed-complete file to hold its data — without the fsync the
    rename can land while the payload is still only in the page cache, so
    an OS/host loss could leave a whole-looking but empty checkpoint
    ."""
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)


class ShardCheckpoint:
    """Per-job shard result store keyed by (checkpoint_dir, job_id)."""

    #: Torn tmp files younger than this survive the constructor sweep: a
    #: fresh tmp may belong to a LIVE concurrent writer sharing this
    #: (root, job_id) (serve loop + second process, taskpool threads racing
    #: a new scheduler) and deleting it would break that writer's
    #: ``os.replace``.  A crashed writer's leftovers are, by the
    #: time anyone resumes the job, comfortably older.
    TMP_SWEEP_AGE_S = 60.0

    #: Optional `utils.events.EventLog`: schedulers attach their job's
    #: journal here (``ckpt.journal = metrics.journal``) so every persist is
    #: a ``checkpoint_persist`` event on the fault timeline.  Class default
    #: None keeps the store dependency-free and journal-optional.
    journal = None

    def __init__(self, root: str, job_id: str):
        # Defense in depth against path escape: a job_id like '..' would
        # resolve outside `root`, and clear() rmtrees self.dir — refuse
        # anything that is not a plain directory-name-safe token.
        if (
            not job_id
            or not job_id.strip(".")
            or any(s in job_id for s in ("/", "\\", os.sep))
        ):
            raise ValueError(f"invalid job_id {job_id!r}")
        self.dir = os.path.join(root, job_id)
        os.makedirs(self.dir, exist_ok=True)
        self._manifest_path = os.path.join(self.dir, "manifest.json")
        # Tmp names carry a per-writer token so two instances sharing
        # (root, job_id) can never write the same tmp path.
        self._token = f"{os.getpid():x}-{uuid.uuid4().hex[:6]}"
        # A crash between np.save and os.replace leaves a '*.tmp*' file
        # behind; sweep STALE ones here so a torn write can never break
        # listing/resume for this job_id.  Fresh tmp files are
        # left alone — they may belong to a live concurrent writer.
        now = time.time()
        for name in os.listdir(self.dir):
            if ".tmp" in name:
                p = os.path.join(self.dir, name)
                try:
                    if now - os.path.getmtime(p) > self.TMP_SWEEP_AGE_S:
                        os.remove(p)
                except OSError:
                    pass

    def _shard_path(self, shard_id: int) -> str:
        return os.path.join(self.dir, f"shard_{shard_id:05d}.npy")

    def write_manifest(self, num_shards: int, dtype, total: int, **extra) -> None:
        # The manifest is THE staleness guard: it must be durable before
        # any shard it blesses can be trusted (tmp+fsync+rename).
        tmp = f"{self._manifest_path}.{self._token}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(
                {"num_shards": num_shards, "dtype": str(np.dtype(dtype)),
                 "total": total, **extra},
                f,
            )
        fsync_publish(tmp, self._manifest_path)

    def sync_manifest(
        self, num_shards: int, dtype, total: int, fingerprint: str
    ) -> bool:
        """THE scheduler-side staleness guard: trust persisted state only if
        it came from this exact (data, layout); clear otherwise.

        Compares the stored manifest against ``(num_shards, dtype, total,
        fingerprint)``; on mismatch — or orphaned state with no manifest at
        all — everything under this job is cleared.  Either way the manifest
        is (re)written, preserving a matching manifest's ``n_ranges`` record
        so the shuffle-restore path survives.  Returns True iff stale state
        was cleared.  Both schedulers call this (one canonical guard — a
        reused job_id with different same-length data must never serve stale
        shards).
        """
        m = self.manifest()
        have_state = bool(self.completed_shards() or self.completed_ranges())
        stale = (m is None and have_state) or (
            m is not None
            and (
                m.get("num_shards") != num_shards
                or m.get("dtype") != str(np.dtype(dtype))
                or m.get("total") != total
                or m.get("fingerprint") != fingerprint
            )
        )
        if stale:
            self.clear()
        extra = {}
        if not stale and m is not None and "n_ranges" in m:
            extra["n_ranges"] = m["n_ranges"]
        self.write_manifest(
            num_shards, dtype, total, fingerprint=fingerprint, **extra
        )
        return stale

    def manifest(self) -> dict | None:
        try:
            with open(self._manifest_path, encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def has(self, shard_id: int) -> bool:
        return os.path.exists(self._shard_path(shard_id))

    def save(self, shard_id: int, arr: np.ndarray) -> None:
        # Write-then-rename so a crash mid-save never yields a torn shard.
        # The `.npy` suffix keeps np.save from appending its own.
        path = self._shard_path(shard_id)
        tmp = f"{path}.{self._token}.tmp.npy"
        np.save(tmp, np.asarray(arr))
        fsync_publish(tmp, path)
        if self.journal is not None:
            self.journal.emit(
                "checkpoint_persist", kind="shard", id=shard_id, n=len(arr)
            )

    def load(self, shard_id: int) -> np.ndarray:
        return np.load(self._shard_path(shard_id))

    def load_mmap(self, shard_id: int) -> np.ndarray:
        """Memory-mapped read — out-of-core merge inputs never load fully."""
        return np.load(self._shard_path(shard_id), mmap_mode="r")

    def completed_shards(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if (name.startswith("shard_") and name.endswith(".npy")
                    and ".tmp" not in name):
                out.append(int(name[len("shard_"):-len(".npy")]))
        return sorted(out)

    def clear_shards(self) -> None:
        """Drop the shard namespace only (ranges + manifest survive)."""
        for i in self.completed_shards():
            try:
                os.remove(self._shard_path(i))
            except OSError:
                pass

    # -- shuffle-output ranges (the SPMD shuffle-phase checkpoint) --
    # Separate namespace from "shard_": shards are *local-sort* outputs keyed
    # by input position; ranges are *shuffle* outputs keyed by key interval.

    def _range_path(self, range_id: int) -> str:
        return os.path.join(self.dir, f"range_{range_id:05d}.npy")

    def has_range(self, range_id: int) -> bool:
        return os.path.exists(self._range_path(range_id))

    def save_range(self, range_id: int, arr: np.ndarray) -> None:
        path = self._range_path(range_id)
        tmp = f"{path}.{self._token}.tmp.npy"
        np.save(tmp, np.asarray(arr))
        fsync_publish(tmp, path)
        if self.journal is not None:
            self.journal.emit(
                "checkpoint_persist", kind="range", id=range_id, n=len(arr)
            )

    def load_range(self, range_id: int) -> np.ndarray:
        return np.load(self._range_path(range_id))

    def load_range_mmap(self, range_id: int) -> np.ndarray:
        """Memory-mapped read — restores can slice without loading fully."""
        return np.load(self._range_path(range_id), mmap_mode="r")

    def completed_ranges(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if (name.startswith("range_") and name.endswith(".npy")
                    and ".tmp" not in name):
                out.append(int(name[len("range_"):-len(".npy")]))
        return sorted(out)

    def clear_ranges(self) -> None:
        """Drop the shuffle-phase ranges only (local-sort shards survive)."""
        for i in self.completed_ranges():
            try:
                os.remove(self._range_path(i))
            except OSError:
                pass

    # -- auxiliary channels (tagged companion arrays) ------------------------
    # A third namespace next to "shard_"/"range_": companion data a recovery
    # path needs alongside a persisted range — the multi-host kv path's
    # sorted secondary keys ("sec"), its resume scratch ("rk"/"rv"/"rs"),
    # and the wave pipeline's (wave, run) store below all live here.

    def _aux_path(self, tag: str, idx: int) -> str:
        return os.path.join(self.dir, f"aux_{tag}_{idx:05d}.npy")

    def has_aux(self, tag: str, idx: int) -> bool:
        return os.path.exists(self._aux_path(tag, idx))

    def save_aux(self, tag: str, idx: int, arr: np.ndarray) -> None:
        path = self._aux_path(tag, idx)
        tmp = f"{path}.{self._token}.tmp.npy"
        np.save(tmp, np.asarray(arr))
        fsync_publish(tmp, path)
        if self.journal is not None:
            self.journal.emit(
                "checkpoint_persist", kind=f"aux_{tag}", id=idx, n=len(arr)
            )

    def load_aux(self, tag: str, idx: int) -> np.ndarray:
        return np.load(self._aux_path(tag, idx))

    def load_aux_mmap(self, tag: str, idx: int) -> np.ndarray:
        return np.load(self._aux_path(tag, idx), mmap_mode="r")

    def completed_aux(self, tag: str) -> list[int]:
        pre = f"aux_{tag}_"
        out = []
        for name in os.listdir(self.dir):
            if name.startswith(pre) and name.endswith(".npy") and ".tmp" not in name:
                out.append(int(name[len(pre):-len(".npy")]))
        return sorted(out)

    def clear_aux(self, tag: str) -> None:
        for i in self.completed_aux(tag):
            try:
                os.remove(self._aux_path(tag, i))
            except OSError:
                pass

    # -- wave runs: the (wave, run) granularity of the out-of-core wave
    # pipeline (`models.wave_sort`).  Run ``r`` of wave
    # ``w`` is device/range ``r``'s sorted slice of input wave ``w``; files
    # are ``aux_wWWWWW_RRRRR.npy`` so an interrupted wave resumes by
    # re-sorting ONLY its missing runs, never the job.

    @staticmethod
    def _wave_tag(wave: int) -> str:
        return f"w{wave:05d}"

    def has_wave_run(self, wave: int, run: int) -> bool:
        return self.has_aux(self._wave_tag(wave), run)

    def save_wave_run(self, wave: int, run: int, arr: np.ndarray) -> None:
        path = self._aux_path(self._wave_tag(wave), run)
        tmp = f"{path}.{self._token}.tmp.npy"
        np.save(tmp, np.asarray(arr))
        # The (wave, run) resume contract is a DURABILITY contract: a run
        # listed complete must survive an OS/host loss, not just a process
        # kill (the wave pipeline hides the fsync wait behind the next
        # wave's device exchange).
        fsync_publish(tmp, path)
        if self.journal is not None:
            self.journal.emit(
                "checkpoint_persist", kind="wave_run", wave=wave, id=run,
                n=len(arr),
            )

    def load_wave_run(self, wave: int, run: int) -> np.ndarray:
        return self.load_aux(self._wave_tag(wave), run)

    def load_wave_run_mmap(self, wave: int, run: int) -> np.ndarray:
        return self.load_aux_mmap(self._wave_tag(wave), run)

    def completed_wave_runs(self) -> list[tuple[int, int]]:
        """All persisted ``(wave, run)`` pairs, sorted."""
        out = []
        for name in os.listdir(self.dir):
            if (name.startswith("aux_w") and name.endswith(".npy")
                    and ".tmp" not in name):
                body = name[len("aux_w"):-len(".npy")]
                w, _, r = body.partition("_")
                if w.isdigit() and r.isdigit():
                    out.append((int(w), int(r)))
        return sorted(out)

    def clear_wave_runs(self, wave: int | None = None) -> None:
        """Drop wave runs — one wave's, or all of them."""
        for w, r in self.completed_wave_runs():
            if wave is None or w == wave:
                try:
                    os.remove(self._aux_path(self._wave_tag(w), r))
                except OSError:
                    pass

    def clear(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
        os.makedirs(self.dir, exist_ok=True)
        if self.journal is not None:
            self.journal.emit("checkpoint_clear", reason="stale state")
