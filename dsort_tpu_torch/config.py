"""Typed job configuration: the `JobConfig` fields the sample sort and the
scheduler read.

Counterpart of ``dsort_tpu/config.py``'s ``JobConfig``, cut to what the
ported path reads.  `JobConfig.from_dict` refuses the reference's settings
this package has not ported yet with a clear "not yet ported"
`ConfigError` instead of running something else.  `ExternalConfig` holds
the out-of-core knobs of ``cli external`` / ``cli terasort --external``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

# Every value the JAX package accepts; all of them are ported.
_LOCAL_KERNELS = ("auto", "lax", "block", "bitonic", "pallas", "radix")
_MERGE_KERNELS = ("auto", "sort", "bitonic", "block_merge")
_EXCHANGES = ("alltoall", "ring", "fused", "hier")
_REDUNDANCY_MODES = ("replicate", "parity")


class ConfigError(ValueError):
    """Raised for invalid or inconsistent configuration."""


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
      a transient error on the same worker ``max_transient_retries`` times.
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

    def __post_init__(self) -> None:
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

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "JobConfig":
        """Build this package's config from ``dataclasses.asdict`` of a
        ``dsort_tpu`` ``JobConfig`` — how both packages run one sort with
        identical settings.

        Read: ``local_kernel``, ``merge_kernel``, ``exchange``,
        ``hier_hosts``, ``redundancy``, ``redundancy_mode``,
        ``oversample``, ``capacity_factor``,
        ``max_capacity_retries``, ``settle_delay_s``,
        ``heartbeat_timeout_s``, ``compile_grace_s``,
        ``max_transient_retries``, ``exec_allowance_floor_s``,
        ``exec_allowance_keys_per_s``, ``checkpoint_dir``.

        Ignored (not read by the ported path yet): ``key_dtype`` (the input
        array's dtype decides), ``payload_bytes`` (the payload array's row
        decides), ``max_reassign_attempts`` (the task-pool scheduler's), ``tenant``,
        ``flight_recorder_dir``, ``flight_ring_size``, ``explicit``.

        Refused, as not yet ported (it would change the reference's
        schedule): ``autotune`` (the planner).
        """
        if d.get("autotune", False):
            raise ConfigError(
                "autotune (the exchange planner) is not yet ported to "
                "dsort_tpu_torch"
            )
        names = [f.name for f in dataclasses.fields(cls)]
        return cls(**{k: d[k] for k in names if k in d})


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
