"""Per-shard kernels: torch.sort wrappers, the block-bitonic CUDA kernels,
the tile and ring kernels, the merges and the radix sort.

The flagship kernels live in `dsort_tpu_torch.ops.block_sort` and are
imported from the submodule directly: re-exporting ``block_sort`` here would
shadow the submodule attribute with the function of the same name.
"""

from dsort_tpu_torch.ops.local_sort import (  # noqa: F401
    sentinel_for,
    sort_keys,
    sort_kv,
    sort_padded,
)
from dsort_tpu_torch.ops.radix import radix_sort, radix_sort_kv  # noqa: F401
