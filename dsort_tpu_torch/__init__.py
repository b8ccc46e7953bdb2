"""dsort_tpu_torch — the PyTorch/CUDA port of ``dsort_tpu``.

The JAX package ``dsort_tpu`` is the reference: this package mirrors its
module paths and public names so each counterpart is easy to find, and its
tests hold every ported function against the JAX one on the same numpy
input.  It imports ``torch`` and ``numpy`` only — nothing of JAX and
nothing of ``dsort_tpu``.

Ported so far (the main path of ``dsort run``, all_to_all exchange):

  device.py            device resolution (``cuda`` unless ``cpu`` is asked for)
  config.py            ``JobConfig`` (the fields the sample sort reads)
  data/                ``partition`` / ``pad_to_shards``; one-int-per-line IO
  ops/float_order.py   order-preserving float <-> signed-int bijection
  ops/local_sort.py    ``sort_keys`` (torch.sort), kernel resolution, padding
  ops/block_sort.py    block-bitonic sort and run merge over the CUDA kernels
                       in ``csrc/block_sort.cu`` (plain PyTorch on the CPU)
  parallel/mesh.py     ``VirtualMesh``: P shards as rows of one tensor
  parallel/sample_sort.py  ``SampleSort`` (splitters, buckets, exchange, merge)
  cli.py               ``python -m dsort_tpu_torch.cli run IN -o OUT``
"""

from dsort_tpu_torch.config import ConfigError, JobConfig
from dsort_tpu_torch.device import resolve_device

__all__ = ["ConfigError", "JobConfig", "resolve_device"]
