"""dsort_tpu_torch — the PyTorch/CUDA port of ``dsort_tpu``.

The JAX package ``dsort_tpu`` is the reference: this package mirrors its
module paths and public names so each counterpart is easy to find, and its
tests hold every ported function against the JAX one on the same numpy
input.  It imports ``torch`` and ``numpy`` only — nothing of JAX and
nothing of ``dsort_tpu``.

Ported so far (``dsort run`` in its three modes — the SPMD scheduler with
the fused small-job route, the task pool, local — and ``--device-resident``;
the in-core ``dsort terasort``; ``dsort validate`` and ``dsort gen``):

  device.py            device resolution (``cuda`` unless ``cpu`` is asked for)
  config.py            ``JobConfig`` (the fields the sample sort reads)
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
  utils/events.py      ``EventLog``: the JSONL event journal
  cli.py               ``python -m dsort_tpu_torch.cli {run,terasort} IN -o OUT``
                       (``run --mode spmd|taskpool|local``, ``run
                       --device-resident``), ``validate``, ``gen``
"""

from dsort_tpu_torch.config import ConfigError, JobConfig
from dsort_tpu_torch.device import resolve_device

__all__ = ["ConfigError", "JobConfig", "resolve_device"]
