"""Host ms a job in the program's ``assemble`` phase (trim, downloads)."""


def read(run):
    return run.phase_ms("assemble")
