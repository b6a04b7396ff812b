"""The ("data", "model") process mesh and the Megatron sharding of the port.

Counterpart of :mod:`lmms_owc_tpu.parallel`: ``mesh`` builds the mesh over the
``torch.distributed`` ranks, ``sharding`` splits a built model's weights
over a model group (imported on its own: it imports the model stack), and
``dryrun`` is the multi-rank dry run on the CPU.
"""

from lmms_owc_tpu_torch.parallel.mesh import MeshConfig, ModelGroup, create_mesh, local_mesh

__all__ = ["MeshConfig", "ModelGroup", "create_mesh", "local_mesh"]
