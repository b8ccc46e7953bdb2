"""The virtual mesh and the SPMD sample sort over it."""

from dsort_tpu_torch.parallel.mesh import VirtualMesh

__all__ = ["VirtualMesh"]
