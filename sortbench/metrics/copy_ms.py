"""Device ms a job of host-to-device and device-to-host copies."""

from sortbench.trace import COPY_DIRECTIONS


def read(run):
    s = run.device_s_per_job(("gpu_memcpy",), COPY_DIRECTIONS)
    return None if s is None else 1e3 * s
