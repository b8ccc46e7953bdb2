"""The least time the card could take to sort a job (each input byte read
once and written once, at the card's published bandwidth) as a share of
the device time of every kernel per job (memcpy and memset excluded)."""


def read(run):
    least, kernels = run.least_job_s(), run.device_s_per_job(("kernel",))
    if least is None or not kernels:
        return None
    return 100.0 * least / kernels
