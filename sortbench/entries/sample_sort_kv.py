"""Records through ``SampleSort.sort_kv`` as ``cli terasort`` runs them:
the packed 8-byte key, the payload, and key bytes 8-9 as the secondary
key (``data.ingest.terasort_secondary``), on the configuration's workers
and ``JobConfig``."""

KIND = "records"


def build(config: dict, device: str):
    """``run((keys, payload)) -> ((keys, payload) sorted, the job's Metrics)``."""
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.data.ingest import terasort_secondary
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort
    from dsort_tpu_torch.utils.metrics import Metrics

    ss = SampleSort(VirtualMesh(int(config["workers"]), device), JobConfig(**config["job"]))

    def run(records):
        keys, payload = records
        metrics = Metrics()
        out = ss.sort_kv(keys, payload, metrics=metrics, secondary=terasort_secondary(payload))
        return out, metrics

    return run
