"""Host ms a job in the program's ``partition`` phase (padding, uploads)."""


def read(run):
    return run.phase_ms("partition")
