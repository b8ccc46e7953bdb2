"""Typed configuration: `JobConfig`, `ServeConfig`, `ExternalConfig`,
`MeshConfig` and the conf-file loader.

Counterpart of ``dsort_tpu/config.py``.  `load_conf_file` parses the
reference's ``KEY=value`` files (``server.conf`` / ``client.conf``) and
`SortConfig.from_mapping` builds the whole tree from one flat mapping
under the reference's keys, so a conf file read by both packages gives the
same values.  `JobConfig.from_dict` carries a ``dsort_tpu`` ``JobConfig``
(``dataclasses.asdict``) across, ``autotune`` (the planner, `obs.plan`)
included.  Not ported yet: the fleet plane (``FleetConfig``); a
``FLEET_*`` key raises a "not yet ported" `ConfigError`.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Mapping

import numpy as np

# Every value the JAX package accepts; all of them are ported.
_LOCAL_KERNELS = ("auto", "lax", "block", "bitonic", "pallas", "radix")
_MERGE_KERNELS = ("auto", "sort", "bitonic", "block_merge")
_EXCHANGES = ("alltoall", "ring", "fused", "hier")
_REDUNDANCY_MODES = ("replicate", "parity")


class ConfigError(ValueError):
    """Raised for invalid or inconsistent configuration."""


def load_conf_file(path: str | os.PathLike) -> dict[str, str]:
    """Parse a ``KEY=value`` conf file (the reference's ``read_conf_file``).

    Any key set is accepted; blank lines and ``#`` comments are skipped,
    whitespace is stripped, and a missing file or a line without ``=``
    raises a clear `ConfigError` (the reference calls ``fclose(NULL)``).
    """
    out: dict[str, str] = {}
    try:
        with open(path, "r", encoding="utf-8") as f:
            for lineno, raw in enumerate(f, 1):
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                if "=" not in line:
                    raise ConfigError(f"{path}:{lineno}: expected KEY=value, got {line!r}")
                key, _, value = line.partition("=")
                out[key.strip()] = value.strip()
    except FileNotFoundError as e:
        raise ConfigError(f"conf file not found: {path}") from e
    return out


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The worker mesh: ``num_workers`` virtual workers (None = the
    command's default of 8) times a ``dp`` batch axis (`BatchSampleSort`'s
    job slots), the reference's device-mesh spec without its axis names
    (a `VirtualMesh` has one axis)."""

    num_workers: int | None = None
    dp: int = 1

    def __post_init__(self) -> None:
        if self.num_workers is not None and self.num_workers < 1:
            raise ConfigError(f"num_workers must be >= 1, got {self.num_workers}")
        if self.dp < 1:
            raise ConfigError(f"dp must be >= 1, got {self.dp}")


def _check_choice(name: str, value, known: tuple) -> None:
    if value not in known:
        raise ConfigError(f"{name} must be one of {known}, got {value!r}")


@dataclasses.dataclass(frozen=True)
class JobConfig:
    """Per-job sort parameters.

    - ``local_kernel``: per-shard sort; ``lax`` is ``torch.sort`` here,
      ``block`` the block-bitonic CUDA kernels, ``bitonic`` the plain
      PyTorch bitonic network (`ops.bitonic`), ``pallas`` the tile-sort CUDA
      kernel plus the bitonic merge tree (`ops.pallas_sort`); ``auto`` picks
      ``block`` for integer keys of at least 2^16 on a CUDA tensor
      (`ops.local_sort`), never ``bitonic``, ``pallas`` or ``radix``;
      ``radix`` is the LSD counting sort (`ops.radix`, plain PyTorch);
    - ``merge_kernel``: post-exchange combine; ``block_merge`` enters the
      bitonic network at the run level, ``bitonic`` merges the received runs
      with the bitonic merge tree, ``sort`` re-sorts flat through the local
      kernel, ``auto`` picks ``block_merge`` wherever the block kernel
      applies and ``sort`` elsewhere;
    - ``oversample``: splitter candidates per shard;
    - ``capacity_factor``: per-(src, dst) bucket headroom over n/P;
    - ``max_capacity_retries``: measured-capacity retries after an overflow;
    - ``exchange``: the bucket exchange: ``alltoall`` (one padded
      transpose with the measured-capacity retry), ``ring`` (P-1 shifts
      sized from the measured histogram, merged as they land),
      ``fused`` (the same schedule as one exchange kernel plus one merge,
      `ops.ring_kernel`) or ``hier`` (the two-level schedule: intra-host
      aggregation, one transfer per (src-host, dst-host) pair, a local
      scatter; `parallel.exchange`);
    - ``hier_hosts``: the host count ``hier`` groups the workers into; 0 is
      auto (the world size of an initialised ``torch.distributed`` group,
      else 2 simulated hosts); a value that does not divide the workers
      resolves to the nearest divisor below it
      (`parallel.exchange.resolve_hier_hosts`);
    - ``redundancy``: the coded exchange (`parallel.coded`): 1 is off; r > 1
      forces the ``ring`` schedule and ships every bucket's redundancy to
      its destination's ring successors, so losses within the budget
      recover by a local merge of a survivor's slots instead of a re-run;
    - ``redundancy_mode``: ``replicate`` (r - 1 full bucket copies) or
      ``parity`` (XOR at r = 2, GF(256) P+Q at r >= 3);
    - ``checkpoint_dir``: where resumable jobs persist their progress
      (`checkpoint.ShardCheckpoint`): with a ``job_id``, `scheduler.
      SpmdScheduler.sort` keeps its local-sort shards and shuffle ranges
      there and `scheduler.Scheduler.run_job` its sorted shards, and a
      re-run of the same job restores what is on disk instead of sorting
      it again; None (the default) persists nothing;
    - the fault plane (`scheduler.SpmdScheduler`, the fused route's
      bounded wait in ``cli run``), with the reference's
      defaults: ``settle_delay_s`` between a failure and the re-run;
      ``heartbeat_timeout_s`` bounds a liveness probe; a whole attempt's
      wait is bounded by ``heartbeat_timeout_s + exec_allowance_floor_s +
      n_keys / exec_allowance_keys_per_s``, plus ``compile_grace_s`` while
      its (mesh, size bucket) has not completed once (the first launch
      builds the kernels); ``max_transient_retries`` bounds the re-runs
      after a lapsed wait or a runtime error with every probe healthy.
      The task pool (`scheduler.Scheduler`) waits ``heartbeat_timeout_s``
      for a shard's attempt, plus ``compile_grace_s`` (in windows of 1x, 2x
      and 4x) while the (worker, shape) has not completed once, and retries
      a transient error on the same worker ``max_transient_retries`` times;
    - ``key_dtype``: the dtype ``cli`` reads keys as and the serving
      prewarm compiles for (its numpy name; a sort itself takes the input
      array's dtype);
    - ``tenant``: the label on every ``job_start`` and on the per-tenant
      SLO histograms (`obs.slo`), ``[A-Za-z0-9._-]+``;
    - ``flight_recorder_dir`` / ``flight_ring_size``: where the schedulers'
      and the service's `obs.flight.FlightRecorder` dump a postmortem
      bundle whenever a recovery path fires, and how many recent events
      it keeps;
    - ``autotune``: the planner (`obs.plan`) fills the knobs the user left
      unset from measured signals (the exchange per dispatch, the wave
      size, the prewarm set, the slice width), journaled as
      ``plan_decision``; off by default, on for the CLI unless
      ``--no-autotune``;
    - ``explicit``: the knobs the user set (a flag given, a conf key
      present); the planner never overrides them and journals a
      ``plan_override`` instead.
    """

    local_kernel: str = "auto"
    merge_kernel: str = "auto"
    exchange: str = "alltoall"
    hier_hosts: int = 0
    redundancy: int = 1
    redundancy_mode: str = "replicate"
    oversample: int = 32
    capacity_factor: float = 1.3
    max_capacity_retries: int = 3
    settle_delay_s: float = 0.1
    heartbeat_timeout_s: float = 10.0
    compile_grace_s: float = 240.0
    max_transient_retries: int = 2
    exec_allowance_floor_s: float = 30.0
    exec_allowance_keys_per_s: float = 1e6
    checkpoint_dir: str | None = None
    key_dtype: str = "int32"
    tenant: str = "default"
    flight_recorder_dir: str | None = None
    flight_ring_size: int = 256
    autotune: bool = False
    explicit: tuple = ()

    def is_explicit(self, knob: str) -> bool:
        """True when the user set ``knob`` (a flag given, a conf key
        present): the planner must not override it."""
        return knob in self.explicit

    def __post_init__(self) -> None:
        try:
            object.__setattr__(self, "key_dtype", np.dtype(self.key_dtype).name)
        except TypeError as e:
            raise ConfigError(f"key_dtype {self.key_dtype!r} is not a dtype") from e
        _check_choice("local_kernel", self.local_kernel, _LOCAL_KERNELS)
        _check_choice("merge_kernel", self.merge_kernel, _MERGE_KERNELS)
        _check_choice("exchange", self.exchange, _EXCHANGES)
        if not isinstance(self.hier_hosts, int) or self.hier_hosts < 0:
            raise ConfigError(
                f"hier_hosts must be an integer >= 0, got {self.hier_hosts!r}"
            )
        if not isinstance(self.redundancy, int) or self.redundancy < 1:
            raise ConfigError(
                f"redundancy must be an integer >= 1, got {self.redundancy!r}"
            )
        _check_choice("redundancy_mode", self.redundancy_mode, _REDUNDANCY_MODES)
        if self.oversample < 1:
            raise ConfigError(f"oversample must be >= 1, got {self.oversample}")
        if self.capacity_factor < 1.0:
            raise ConfigError(
                f"capacity_factor must be >= 1.0, got {self.capacity_factor}"
            )
        if self.max_capacity_retries < 0:
            raise ConfigError(
                "max_capacity_retries must be >= 0, got "
                f"{self.max_capacity_retries}"
            )
        if self.max_transient_retries < 0:
            raise ConfigError(
                f"max_transient_retries must be >= 0, got {self.max_transient_retries}"
            )
        if self.exec_allowance_floor_s < 0:
            raise ConfigError(
                f"exec_allowance_floor_s must be >= 0, got {self.exec_allowance_floor_s}"
            )
        if self.exec_allowance_keys_per_s <= 0:
            raise ConfigError(
                "exec_allowance_keys_per_s must be > 0, got "
                f"{self.exec_allowance_keys_per_s}"
            )
        if not re.fullmatch(r"[A-Za-z0-9._-]+", self.tenant or ""):
            raise ConfigError(
                "tenant must match [A-Za-z0-9._-]+ (it becomes a metrics "
                f"label), got {self.tenant!r}"
            )
        if self.flight_ring_size < 1:
            raise ConfigError(f"flight_ring_size must be >= 1, got {self.flight_ring_size}")
        if not isinstance(self.explicit, tuple):
            object.__setattr__(self, "explicit", tuple(self.explicit))
        for knob in self.explicit:
            if not isinstance(knob, str) or not knob:
                raise ConfigError(f"explicit must name knobs as strings, got {knob!r}")

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "JobConfig":
        """Build this package's config from ``dataclasses.asdict`` of a
        ``dsort_tpu`` ``JobConfig`` — how both packages run one sort with
        identical settings.

        Read: every field of this class (``key_dtype`` as its numpy name).

        Ignored (not read by the ported path): ``payload_bytes`` (the
        payload array's row decides) and ``max_reassign_attempts`` (the
        task pool reassigns while a worker lives, as its default does).
        """
        names = [f.name for f in dataclasses.fields(cls)]
        kw = {k: d[k] for k in names if k in d}
        if "key_dtype" in kw:
            kw["key_dtype"] = np.dtype(kw["key_dtype"]).name
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the serving layer (`serve.SortService`), with the
    reference's defaults and checks: the admission bounds, the fair
    scheduler's quantum and weights, the slice width, the variant cache's
    bound and the prewarm range (key counts, expanded to the capacity
    ladder's rungs), and SLO shedding (``slo_shed_ms``; None = off).
    ``small_job_max`` None is `models.pipelines.FUSED_SMALL_JOB_MAX`."""

    max_queue_depth: int = 64
    max_tenant_inflight: int = 16
    slice_devices: int = 1
    small_job_max: int | None = None
    drr_quantum_keys: int = 1 << 14
    tenant_weights: Mapping[str, float] = dataclasses.field(default_factory=dict)
    variant_cache_entries: int = 64
    prewarm: bool = False
    prewarm_policy: str = "auto"
    prewarm_min_keys: int = 1 << 14
    prewarm_max_keys: int = 1 << 16
    slo_shed_ms: float | None = None

    def __post_init__(self) -> None:
        for name in ("max_queue_depth", "max_tenant_inflight", "slice_devices",
                     "drr_quantum_keys", "variant_cache_entries"):
            if getattr(self, name) < 1:
                raise ConfigError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.small_job_max is not None and self.small_job_max < 1:
            raise ConfigError(f"small_job_max must be >= 1, got {self.small_job_max}")
        for t, w in dict(self.tenant_weights).items():
            if not (isinstance(w, (int, float)) and w > 0):
                raise ConfigError(f"tenant weight for {t!r} must be > 0, got {w!r}")
        _check_choice("prewarm_policy", self.prewarm_policy, ("auto", "all"))
        if not (0 < self.prewarm_min_keys <= self.prewarm_max_keys):
            raise ConfigError(
                "prewarm range must satisfy 0 < min <= max, got "
                f"[{self.prewarm_min_keys}, {self.prewarm_max_keys}]"
            )
        if self.slo_shed_ms is not None and self.slo_shed_ms <= 0:
            raise ConfigError(f"slo_shed_ms must be > 0, got {self.slo_shed_ms}")


@dataclasses.dataclass(frozen=True)
class ExternalConfig:
    """Out-of-core sort knobs (``cli external`` / ``cli terasort
    --external``), with the reference's defaults and checks.

    ``run_elems`` sizes the single-device spill runs
    (`models.external_sort`); ``wave_elems`` sizes the per-wave device
    budget of the wave pipeline (`models.wave_sort`); ``mesh`` is the wave
    pipeline's worker count (None = the single-device external sort).
    """

    run_elems: int = 1 << 22
    wave_elems: int = 1 << 22
    mesh: int | None = None

    def __post_init__(self) -> None:
        if self.run_elems < 2:
            raise ConfigError(f"run_elems must be >= 2, got {self.run_elems}")
        if self.wave_elems < 2:
            raise ConfigError(f"wave_elems must be >= 2, got {self.wave_elems}")
        if self.mesh is not None and self.mesh < 1:
            raise ConfigError(f"mesh must be >= 1, got {self.mesh}")


# Conf keys whose presence makes the knob explicit: the planner never
# overrides it (it journals a plan_override instead).
_EXPLICIT_KEYS = {
    "EXCHANGE": "exchange",
    "REDUNDANCY": "redundancy",
    "REDUNDANCY_MODE": "redundancy_mode",
    "EXTERNAL_WAVE_ELEMS": "wave_elems",
    "SERVE_PREWARM": "prewarm",
    "SERVE_SLICE_DEVICES": "slice_devices",
}


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """The whole tree: mesh + job + serve + external, and the reference's
    control-plane endpoint and output path."""

    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    job: JobConfig = dataclasses.field(default_factory=JobConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    external: ExternalConfig = dataclasses.field(default_factory=ExternalConfig)
    server_ip: str = "127.0.0.1"
    server_port: int = 9008
    output_path: str = "output.txt"

    @classmethod
    def from_mapping(cls, m: Mapping[str, str]) -> "SortConfig":
        """Build from a flat ``KEY=value`` mapping under the reference's
        keys: ``SERVER_IP``, ``SERVER_PORT``, ``OUTPUT_PATH``; ``NUM_WORKERS``,
        ``DP``; ``KEY_DTYPE``, ``LOCAL_KERNEL``, ``MERGE_KERNEL``,
        ``EXCHANGE``, ``HIER_HOSTS``, ``REDUNDANCY``, ``REDUNDANCY_MODE``,
        ``OVERSAMPLE``, ``CAPACITY_FACTOR``, ``HEARTBEAT_TIMEOUT_S``,
        ``CHECKPOINT_DIR``, ``TENANT``, ``FLIGHT_DIR``, ``AUTOTUNE``;
        ``SERVE_QUEUE_DEPTH``, ``SERVE_TENANT_INFLIGHT``,
        ``SERVE_SLICE_DEVICES``, ``SERVE_SMALL_JOB_MAX``, ``SERVE_WEIGHTS``
        (``tenant=weight,...``), ``SERVE_PREWARM`` (``1`` or ``all``),
        ``SERVE_SLO_SHED_MS``; ``EXTERNAL_RUN_ELEMS``,
        ``EXTERNAL_WAVE_ELEMS``, ``EXTERNAL_MESH``.  ``PAYLOAD_BYTES`` is
        read by the reference's config only; a ``FLEET_*`` key raises (the
        fleet plane is not ported yet).  A knob key present in the mapping
        joins ``JobConfig.explicit``.
        """
        fleet = sorted(k for k in m if k.startswith("FLEET_"))
        if fleet:
            raise ConfigError(
                f"conf keys {fleet}: the fleet plane is not yet ported to dsort_tpu_torch"
            )

        def geti(key: str, default: int | None) -> int | None:
            return int(m[key]) if key in m else default

        from dsort_tpu_torch.serve.fair import parse_weights

        mesh = MeshConfig(num_workers=geti("NUM_WORKERS", None), dp=geti("DP", 1))
        explicit = tuple(sorted(knob for key, knob in _EXPLICIT_KEYS.items() if key in m))
        job = JobConfig(
            key_dtype=m.get("KEY_DTYPE", "int32"),
            local_kernel=m.get("LOCAL_KERNEL", JobConfig.local_kernel),
            merge_kernel=m.get("MERGE_KERNEL", JobConfig.merge_kernel),
            exchange=m.get("EXCHANGE", JobConfig.exchange),
            hier_hosts=geti("HIER_HOSTS", JobConfig.hier_hosts),
            redundancy=geti("REDUNDANCY", JobConfig.redundancy),
            redundancy_mode=m.get("REDUNDANCY_MODE", JobConfig.redundancy_mode),
            oversample=geti("OVERSAMPLE", JobConfig.oversample),
            capacity_factor=float(m.get("CAPACITY_FACTOR", JobConfig.capacity_factor)),
            heartbeat_timeout_s=float(
                m.get("HEARTBEAT_TIMEOUT_S", JobConfig.heartbeat_timeout_s)
            ),
            checkpoint_dir=m.get("CHECKPOINT_DIR") or None,
            tenant=m.get("TENANT", JobConfig.tenant),
            flight_recorder_dir=m.get("FLIGHT_DIR") or None,
            autotune=m.get("AUTOTUNE", "0").strip().lower() in ("1", "true", "yes"),
            explicit=explicit,
        )
        prewarm = m.get("SERVE_PREWARM", "").strip().lower()
        serve = ServeConfig(
            max_queue_depth=geti("SERVE_QUEUE_DEPTH", ServeConfig.max_queue_depth),
            max_tenant_inflight=geti("SERVE_TENANT_INFLIGHT", ServeConfig.max_tenant_inflight),
            slice_devices=geti("SERVE_SLICE_DEVICES", ServeConfig.slice_devices),
            small_job_max=geti("SERVE_SMALL_JOB_MAX", None),
            tenant_weights=parse_weights(m.get("SERVE_WEIGHTS")),
            prewarm=prewarm in ("1", "true", "yes", "all"),
            prewarm_policy="all" if prewarm == "all" else "auto",
            slo_shed_ms=float(m["SERVE_SLO_SHED_MS"]) if "SERVE_SLO_SHED_MS" in m else None,
        )
        external = ExternalConfig(
            run_elems=geti("EXTERNAL_RUN_ELEMS", ExternalConfig.run_elems),
            wave_elems=geti("EXTERNAL_WAVE_ELEMS", ExternalConfig.wave_elems),
            mesh=geti("EXTERNAL_MESH", None),
        )
        return cls(
            mesh=mesh, job=job, serve=serve, external=external,
            server_ip=m.get("SERVER_IP", "127.0.0.1"),
            server_port=int(m.get("SERVER_PORT", 9008)),
            output_path=m.get("OUTPUT_PATH", "output.txt"),
        )

    @classmethod
    def from_conf_file(cls, path: str | os.PathLike) -> "SortConfig":
        return cls.from_mapping(load_conf_file(path))
