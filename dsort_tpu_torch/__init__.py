"""dsort_tpu_torch — the PyTorch/CUDA port of ``dsort_tpu``.

The JAX package ``dsort_tpu`` is the reference: this package mirrors its
module paths and public names so each counterpart is easy to find, and its
tests hold every ported function against the JAX one on the same numpy
input.  It imports ``torch`` and ``numpy`` only — nothing of JAX and
nothing of ``dsort_tpu``.

Ported (``dsort run`` in its three modes — the SPMD scheduler with
the fused small-job route, the task pool, local — and ``--device-resident``;
``dsort serve``; ``dsort batch``; ``dsort terasort`` and ``dsort external``;
``dsort validate`` and ``dsort gen``; ``dsort coordinator`` and ``dsort
worker``; ``dsort fleet`` and ``dsort fleet-agent``; ``dsort bench``;
``dsort lint`` and ``dsort run --profile-dir``; ``dsort spec``):

  device.py            device resolution (``cuda`` unless ``cpu`` is asked for)
  config.py            ``JobConfig``, ``ServeConfig``, ``SortConfig`` and the
                       reference's ``KEY=value`` conf files
  data/                ``partition`` / ``pad_to_shards``; int and TeraSort IO,
                       the seeded generators
  ops/float_order.py   order-preserving float <-> signed-int bijection
  ops/local_sort.py    ``sort_keys`` (torch.sort), kernel dispatch, padding,
                       the key+payload sorts
  ops/block_sort.py    block-bitonic sort and run merge over the CUDA kernels
                       in ``csrc/block_sort.cu`` (plain PyTorch on the CPU)
  ops/bitonic.py       the bitonic network and merge tree (plain PyTorch)
  ops/pallas_sort.py   tile sort, stable key+index tile sort and radix
                       histogram over ``csrc/tile_sort.cu``; ``pallas_sort``
  ops/ring_kernel.py   the fused ring exchange over ``csrc/ring_exchange.cu``
  ops/merge.py         the host k-way merges and the on-device shard merge
  ops/errors.py        ``KernelLaunchError`` and the CUDA status names
  parallel/mesh.py     ``VirtualMesh``: P shards as rows of one tensor
  parallel/exchange.py the ring schedule: measured caps, shifts, merge tower
  parallel/sample_sort.py  ``SampleSort`` (splitters, buckets, exchange, merge;
                       ``keep_on_device``)
  parallel/device_result.py  ``DeviceSortResult``: sorted keys left on the
                       device (``to_host``, ``consume``, ``validate_on_device``)
  models/pipelines.py  ``fused_sort_small`` (the small-job route),
                       ``GatherMergeSort``, ``local_pipeline``, ``pad_rung``
  models/validate.py   order + FNV-1a multiset checksum: the file validators
                       and the on-device one
  scheduler/           ``SpmdScheduler`` (bounded waits, probes, re-form over
                       the survivors, device-resident handles invalidated on
                       re-form), the task-pool ``Scheduler`` and
                       ``DeviceExecutor``, ``FaultInjector``, ``WorkerTable``,
                       the CUDA error classifier
  serve/               ``SortService``: admission, weighted DRR, slices of the
                       mesh on CUDA streams, the variant cache and prewarm
  obs/                 telemetry and its metrics endpoint, SLO histograms,
                       the flight recorder, the first-call ledger, the
                       planner (``autotune``)
  fleet/               the fleet plane: the framed-JSON protocol, the torch-free
                       ``FleetController`` (routing, restart-safe state) and
                       ``FleetAgent`` (a ``SortService`` behind a TCP port)
  utils/events.py      ``EventLog``: the JSONL event journal
  utils/tracing.py     ``profile_trace`` / ``annotate``: torch.profiler hooks
                       (``run --profile-dir``)
  analysis/            ``cli lint``: the stdlib-only static analysis of this
                       tree (registries, locks, layers, durability, the
                       fleet protocol spec, the exchanges' closed forms);
                       ``cli spec``: the fleet protocol's model checker
                       (``analysis/spec/model.py``)
  runtime/             the native C++ runtime (k-way merges, text IO, record
                       hashes, worker table, TCP coordinator; built with g++
                       at first use), ``NativeCoordinator`` and the worker
                       process (``SortWorker``, sorting on the card)
  cli.py               ``python -m dsort_tpu_torch.cli {run,serve,batch,terasort,
                       external,coordinator,worker,fleet,fleet-agent,bench,lint,
                       spec} ...``
                       (``run --mode spmd|taskpool|local``, ``run --device-resident``),
                       ``validate``, ``gen``, ``report``, ``top``
"""

__all__ = ["ConfigError", "JobConfig", "resolve_device"]


def __getattr__(name):
    # torch loads with the first device use, not with the package: a
    # ``--backend numpy`` worker process never needs it.  numpy loads with
    # the config: importing a subpackage (the stdlib-only ``analysis``)
    # executes this module first and must not pull it in.
    if name == "resolve_device":
        from dsort_tpu_torch.device import resolve_device

        return resolve_device
    if name in ("ConfigError", "JobConfig"):
        from dsort_tpu_torch import config

        return getattr(config, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
