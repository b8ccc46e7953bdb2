"""Sort pipelines: the fused small-job route and the gather-merge sort.

Counterpart of ``dsort_tpu/models``: ``pipelines`` is ported; the external
sort, the wave pipeline and ``validate`` are not yet.
"""

from dsort_tpu_torch.models.pipelines import (  # noqa: F401
    FUSED_SMALL_JOB_MAX,
    GatherMergeSort,
    fused_sort_small,
    local_pipeline,
    pad_rung,
)
