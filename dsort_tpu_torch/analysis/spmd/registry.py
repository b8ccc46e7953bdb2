"""THE SPMD-verifier declaration registry (pure literals, parsed not run).

Counterpart of ``dsort_tpu/analysis/spmd/registry.py``, naming the port's
files.  Two things live here, both read by PARSING this file
(`ast.literal_eval`), never by importing it:

1. **Bounded verification domains.**  The symbolic proofs are exhaustive
   over these concrete grids: mesh sizes ``P``, local-shard size samples,
   and caps tuples for the slot-layout checks.  The grids are part of the
   lint cache key, so editing them invalidates cached verdicts.

2. **Required declarations.**  Each module in `SPMD_REQUIRED` must carry a
   top-level pure-literal ``SPMD_CONTRACT``; the per-file minima below pin
   what that contract must at least declare.  Deleting a contract (or one
   entry of it) to silence a proof is itself a DS1200/DS1300 finding.

The lint `ResultCache` hashes this file AND every source it names into the
config key (`engine.ResultCache._config_key`): editing a closed form in
``exchange.py`` invalidates every cached verdict in the tree.
"""

#: Mesh sizes ``P`` the permutation/layout proofs instantiate: the
#: degenerate 1-worker mesh, primes (no host grouping), and the composite
#: sizes the hierarchical plane groups (H x D).
MESH_SIZES = (1, 2, 3, 4, 6, 8)

#: Local-shard sizes ``n_local`` the capacity proofs sweep measured maxes
#: over.
SIZE_SAMPLES = (8, 64, 100, 1000, 4096, 100000)

#: Caps tuples driving the slot-offset/cumsum layout proofs.  Mixed rungs,
#: a zero-length slot, and a single-slot degenerate all participate.
CAPS_SAMPLES = (
    (8,),
    (8, 16),
    (8, 0, 16),
    (8, 16, 8, 24),
    (16, 8, 8, 32, 8, 40, 8, 8),
)

#: Modules that MUST declare a top-level ``SPMD_CONTRACT``: the reference's
#: five, and the process-group plane (its collectives block a gloo group).
SPMD_REQUIRED = (
    "dsort_tpu_torch/parallel/exchange.py",
    "dsort_tpu_torch/parallel/distributed.py",
    "dsort_tpu_torch/parallel/coded.py",
    "dsort_tpu_torch/ops/ring_kernel.py",
    "dsort_tpu_torch/models/pipelines.py",
    "dsort_tpu_torch/obs/plan.py",
)

#: Per-file minimum ``perms`` declarations (DS1201): the closed-form
#: ``mesh.ppermute`` tables that must stay declared and proven.
SPMD_REQUIRED_PERMS = {
    "dsort_tpu_torch/parallel/exchange.py": (
        "_hier_perm_intra",
        "_hier_perm_leg",
    ),
}

#: Per-file minimum ``rolls`` declarations (DS1201): the functions whose
#: ``torch.roll`` along the shard axis is the ring's ``ppermute``, each
#: held to its declared destination form.
SPMD_REQUIRED_ROLLS = {
    "dsort_tpu_torch/parallel/exchange.py": (
        "_roll_jobs",
        "_ring_exchange_kv_shard",
    ),
}

#: Per-file minimum ``layouts`` declarations (DS1204): the functions whose
#: per-step slot writes must stay provably disjoint and inside their
#: buffers.  `ring_exchange_plain` is the layout the CUDA exchange kernel
#: writes (chip_smoke.py holds the kernel to it bit for bit).
SPMD_REQUIRED_LAYOUTS = {
    "dsort_tpu_torch/ops/ring_kernel.py": ("ring_exchange_plain",),
}

#: Per-file minimum ``caps`` declarations (DS13xx).
SPMD_REQUIRED_CAPS = {
    "dsort_tpu_torch/parallel/exchange.py": (
        "ring_step_quantum",
        "_quantize_cap",
        "ladder_rungs",
        "parity_slots",
        "resolve_redundancy",
    ),
    "dsort_tpu_torch/ops/ring_kernel.py": ("_step_offsets",),
    "dsort_tpu_torch/models/pipelines.py": ("pad_rung",),
}

#: Per-file minimum ``stores`` declarations (DS1302): receive-canvas writes
#: that must keep their declared re-pack hop.
SPMD_REQUIRED_STORES = {
    "dsort_tpu_torch/parallel/exchange.py": ("_hier_exchange_shard",),
}

#: Per-file minimum ``consts`` declarations (DS1303 clamp chains).
SPMD_REQUIRED_CONSTS = {
    "dsort_tpu_torch/obs/plan.py": ("WAVE_MIN_ELEMS", "WAVE_MAX_ELEMS"),
}
