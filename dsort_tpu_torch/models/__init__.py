"""Sort pipelines (the fused small-job route, the gather-merge sort),
sort-output validation, and the out-of-core sorts.

Counterpart of ``dsort_tpu/models``: ``pipelines``, ``validate``,
``external_sort`` (`ExternalSort`, `ExternalTeraSort`) and ``wave_sort``
(`ExternalWaveSort`, `ExternalWaveTeraSort`) are ported.
"""

from dsort_tpu_torch.models.pipelines import (  # noqa: F401
    FUSED_SMALL_JOB_MAX,
    GatherMergeSort,
    fused_sort_small,
    local_pipeline,
    pad_rung,
)
