"""The virtual mesh, the SPMD sample sort over it, and device-resident results."""

from dsort_tpu_torch.parallel.device_result import DeviceSortResult
from dsort_tpu_torch.parallel.mesh import VirtualMesh

__all__ = ["DeviceSortResult", "VirtualMesh"]
