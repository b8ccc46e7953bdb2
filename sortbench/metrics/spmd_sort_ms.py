"""Host ms a job in the program's ``spmd_sort`` phase: the shard programs,
ending on the stats copy, so the device work is inside it."""


def read(run):
    return run.phase_ms("spmd_sort")
