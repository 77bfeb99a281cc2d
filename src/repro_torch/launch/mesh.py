"""Device meshes of the port: ``torch.distributed`` ``DeviceMesh`` objects
in place of the JAX package's ``jax.make_mesh`` meshes (``launch/mesh.py``
there).

A function, not a module-level constant: importing this module touches no
device and no process group. Each function builds its mesh over the
default process group, which the caller initializes first, one process per
rank (``torch.distributed.init_process_group``: ``nccl`` for CUDA ranks,
``gloo`` for CPU ranks, with an explicit ``init_method``, ``rank`` and
``world_size``); the mesh's size must equal the world size. Meshes are on
``cuda`` unless the caller asks for ``device_type="cpu"``.

``fake_world`` is the exception: one process plays one rank of a world
of any size over PyTorch's ``"fake"`` process group, whose collectives
move nothing (the dry run, ``launch/dryrun.py``); the production layout
comes through it (``production_shape``).
"""

from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.dist.ring import RING_DIMS


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """The reference's production layout as ``(shape, names)``: ``("data",
    "model")`` of 16 x 16 = 256 ranks, or ``("pod", "data", "model")`` of
    2 x 16 x 16 = 512 with ``multi_pod``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production layout (``production_shape``) over the process group,
    which has its 256 or 512 ranks (``fake_world`` plays one of them)."""
    shape, names = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


@contextlib.contextmanager
def fake_world(shape, names, rank: int = 0):
    """This process as rank ``rank`` of a ``"fake"`` process group of
    prod(``shape``) ranks (``torch.testing._internal.distributed.fake_pg``:
    collectives return at once and move nothing), and a ``DeviceMesh`` of
    ``shape`` with dimensions ``names`` over it (``cpu``: the mesh's device
    type only names its groups' backend). Refuses to start where a process
    group exists already; destroys the group on exit, so none outlives
    the block."""
    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a process group")
    from torch.testing._internal.distributed import fake_pg  # registers "fake"

    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


def make_local_mesh(data: int = 1, model: int = 1, *, device_type: str = "cuda"):
    """A ``("data", "model")`` mesh over the ranks of the process group
    (tests and examples)."""
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def make_ring_mesh(pods: int = 1, ring: int = 1, model: int = 1, *,
                   device_type: str = "cuda"):
    """The 3-dim ``("pod", "ring", "model")`` mesh of the two-level
    messaging ring (``dist.ring_order``): P pods of R intra-pod shards,
    samples over ``model``. ``pods=1`` is the flat ring with a degenerate
    pod dimension; ``dist.sharding.make_rules`` and
    ``dist.ring.ring_find_root_jit`` both take the mesh without flattening
    its pod level away."""
    return init_device_mesh(device_type, (pods, ring, model), mesh_dim_names=RING_DIMS)
