"""Sharding layer: the partition-spec rules (``rules``), the activation
context (``ctx``) and the serving mesh's helpers that split the slot
pool's batch axis over the mesh's data axis."""
from repro_torch.sharding.rules import (  # noqa: F401
    P, batch_specs, cache_specs, mesh_signature, paged_state_specs,
    param_specs, place, serve_param_specs, spec_for_path,
)
