"""The ("data", "model") process mesh of the port.

Counterpart of :mod:`lmms_owc_tpu.parallel.mesh`. In JAX each process owns a
mesh over its local chips; in torch each rank is one process on one device. So
``model_parallel = tp`` groups ``tp`` consecutive ranks into one model group
(the ranks that hold one model's shards and run it together), and
``WORLD_SIZE / tp`` data groups shard the requests: rank ``r`` sits at data
coordinate ``r // tp`` and model coordinate ``r % tp``.

:class:`ModelGroup` is what the sharded modules hold: the model group's
process group, this rank's place in it, and the two collectives tensor
parallelism needs (``all_reduce`` with SUM or MAX). Both are the collectives
gloo also runs on CUDA tensors, so a model group of two processes on one card
runs over gloo.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lmms_owc_tpu_torch.utils import get_logger

log = get_logger(__name__)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "MeshConfig", "ModelGroup", "create_mesh", "local_mesh", "model_group"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. ``data * model`` must equal the rank count; -1 infers."""

    data: int = -1
    model: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        data, model = self.data, self.model
        if data == -1 and model == -1:
            raise ValueError("at most one mesh axis may be -1")
        if model == -1:
            model = n_devices // data
        if data == -1:
            data = n_devices // model
        if data * model != n_devices:
            raise ValueError(f"mesh {data}x{model} does not match device count {n_devices}")
        return data, model


def _world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def create_mesh(config: MeshConfig | None = None, device_type: str = "cpu"):
    """A 2D ``("data", "model")`` ``DeviceMesh`` over every rank of the default
    process group, model coordinates varying fastest. Every rank must call it.
    Raises ``ValueError`` when the shape does not match the rank count (a
    single process without a process group counts as one rank)."""
    from torch.distributed.device_mesh import init_device_mesh

    config = config or MeshConfig()
    world = _world_size()
    data, model = config.resolve(world)
    if world == 1:
        raise ValueError("a mesh needs an initialised process group of more than one rank")
    log.info("created mesh: data=%d model=%d over %d ranks", data, model, world)
    return init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def local_mesh(model_parallel: int = 1, device_type: str = "cpu"):
    """The mesh of an adapter's ``model_parallel`` / ``use_mesh``: ``model_parallel``
    ranks per model group and the rest on "data". None for a single process at
    ``model_parallel`` 1 (nothing to split); ``model_parallel`` > 1 with no
    process group, or with a rank count it does not divide, raises ``ValueError``
    as :meth:`MeshConfig.resolve` does, and never runs unsharded quietly."""
    config = MeshConfig(data=-1, model=int(model_parallel))
    if _world_size() == 1:
        config.resolve(1)
        return None
    return create_mesh(config, device_type)


@dataclass(frozen=True)
class ModelGroup:
    """The ranks that hold one model's shards: ``group`` (a process group, None
    for the default one), this rank's index ``rank`` in it and its ``size``."""

    group: object
    rank: int
    size: int

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place all-reduce of a contiguous tensor over the model group (SUM or MAX)."""
        dist = torch.distributed
        reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(t, op=reduce_op, group=self.group)
        return t


def model_group(mesh) -> ModelGroup | None:
    """The :class:`ModelGroup` of this rank on ``mesh`` (None without a mesh or at
    one rank per model)."""
    if mesh is None or mesh.size(1) == 1:
        return None
    return ModelGroup(mesh.get_group(MODEL_AXIS), mesh.get_local_rank(MODEL_AXIS), mesh.size(1))
