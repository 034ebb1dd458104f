"""apex_tpu_torch.lint: so far only the mesh model that
``parallel.hierarchy.plan_comm`` plans over (:mod:`.mesh_model`). The
JAX package's graph passes are ROADMAP.md queue A, item 12."""

from apex_tpu_torch.lint.mesh_model import (  # noqa: F401
    LINK_CLASSES, MeshAxis, MeshModel, parse_mesh_spec,
)
