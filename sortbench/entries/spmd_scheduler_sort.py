"""Keys through ``SpmdScheduler.sort``: what ``cli run --mode spmd`` runs
for a job of 2^20 keys and more (``cli._make_sorter``), on the
configuration's workers and ``JobConfig``."""

KIND = "keys"


def build(config: dict, device: str):
    """``run(keys) -> (sorted keys, the job's Metrics)`` over one scheduler
    that lives as long as ``run``."""
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.scheduler import SpmdScheduler
    from dsort_tpu_torch.utils.metrics import Metrics

    sched = SpmdScheduler(int(config["workers"]), device, JobConfig(**config["job"]))

    def run(keys):
        metrics = Metrics()
        return sched.sort(keys, metrics), metrics

    return run
