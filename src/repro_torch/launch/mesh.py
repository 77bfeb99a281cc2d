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
"""

from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh

from repro_torch.dist.ring import RING_DIMS


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production layout: a ``("data", "model")`` mesh of
    16 x 16 = 256 ranks, or ``("pod", "data", "model")`` of 2 x 16 x 16 =
    512 with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


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
