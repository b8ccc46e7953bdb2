"""Sort pipelines (the fused small-job route, the gather-merge sort) and
sort-output validation.

Counterpart of ``dsort_tpu/models``: ``pipelines`` and ``validate`` are
ported; the external sort and the wave pipeline are not yet.
"""

from dsort_tpu_torch.models.pipelines import (  # noqa: F401
    FUSED_SMALL_JOB_MAX,
    GatherMergeSort,
    fused_sort_small,
    local_pipeline,
    pad_rung,
)
