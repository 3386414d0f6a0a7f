"""Device meshes over ``torch.distributed`` for the sharded modes.

Counterpart of parlayann_tpu/parallel/mesh.py. The JAX package drives a
``jax.sharding.Mesh`` from one controller; the port runs one process per
device (SPMD). Every rank runs the same host loop on the same numpy
inputs and keeps its own shard; the mesh's axes are process sub-groups:

  ``d``  dataset shards: the ranks that share this rank's ``q`` coordinate;
  ``q``  query shards: the ranks that share its ``d`` coordinate.

Rank i sits at (d, q) = (i // Q, i % Q), the place of device i in JAX's
``devs.reshape(d, n // d)``. The JAX collectives map one to one onto the
helpers below: ``all_gather(tiled)`` -> :func:`all_gather`
(``all_gather_into_tensor``), ``psum_scatter(tiled)`` ->
:func:`psum_scatter` (``reduce_scatter_tensor``), ``psum`` / ``pmin`` /
``pmax`` -> :func:`psum` / :func:`pmin` / :func:`pmax` (``all_reduce``),
``axis_index`` -> ``mesh.index(axis)``.

Launching is the caller's: ``torchrun``, a spawner, or a world of one
process. The mesh runs on the current CUDA device (``torch.cuda.set_device``
picks it) unless ``device="cpu"`` is given. The device names the
backend of the mesh's sub-groups: gloo on the CPU, NCCL on CUDA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from parlayann_tpu_torch.utils.device import resolve

BACKENDS = {"cpu": "gloo", "cuda": "nccl"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh: the axes' sizes, its coordinates, the
    sub-group of each axis and the device its shards live on."""

    shape: dict  # axis name -> size
    coords: dict  # axis name -> this rank's coordinate
    groups: dict  # axis name -> process group of the ranks along the axis
    device: torch.device
    backend: str

    def index(self, axis: str = "d") -> int:
        return self.coords[axis]


def _resolve(device):
    """The mesh's device and the backend it implies (gloo on the CPU, NCCL
    on CUDA)."""
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = BACKENDS.get(dev.type)
    if backend is None:
        raise ValueError(f"no collective backend for device {dev}")
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "init_process_group first")
    return dev, backend


def _groups(rows, backend):
    """One sub-group per row of ranks, created by every rank in the same
    order (``new_group`` is collective) -> the group of the row holding
    this rank."""
    me, mine = dist.get_rank(), None
    for row in rows:
        g = dist.new_group([int(r) for r in row], backend=backend)
        if me in row:
            mine = g
    return mine


def make_mesh(n_devices: int | None = None, data_axis: int | None = None, *,
              device=None) -> Mesh:
    """A (d, q) mesh over the initialised world: ``d`` dataset shards times
    ``n_devices // d`` query shards (default: every rank on ``d``).
    ``n_devices`` must be the world size."""
    dev, backend = _resolve(device)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} ranks, got {world}")
    D = n if data_axis is None else data_axis
    if n % D:
        raise ValueError(f"{n} devices not divisible by data axis {D}")
    Q = n // D
    grid = np.arange(n).reshape(D, Q)
    rank = dist.get_rank()
    return Mesh(shape={"d": D, "q": Q}, coords={"d": rank // Q, "q": rank % Q},
                groups={"d": _groups(grid.T, backend), "q": _groups(grid, backend)},
                device=dev, backend=backend)


def make_mesh_1d(n_devices: int | None = None, *, device=None) -> Mesh:
    """A mesh with the one axis ``d`` over the whole world (JAX
    global_build.py:61)."""
    dev, backend = _resolve(device)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} ranks, got {world}")
    return Mesh(shape={"d": n}, coords={"d": dist.get_rank()},
                groups={"d": _groups([range(n)], backend)}, device=dev,
                backend=backend)


# ---------------------------------------------------------------------------
# collectives along one axis (every rank of the axis calls each, in order)
# ---------------------------------------------------------------------------


def all_gather(mesh: Mesh, x: torch.Tensor, axis: str = "d") -> torch.Tensor:
    """(b, ...) on each rank -> (size * b, ...), the ranks' blocks in
    coordinate order (JAX ``all_gather(..., tiled=True)``)."""
    x = x.contiguous()
    out = torch.empty((mesh.shape[axis] * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.groups[axis])
    return out


def psum_scatter(mesh: Mesh, x: torch.Tensor, axis: str = "d") -> torch.Tensor:
    """(size * b, ...) on each rank -> (b, ...): the sum over ranks of the
    block at this rank's coordinate (JAX ``psum_scatter(..., tiled=True)``)."""
    x = x.contiguous()
    out = torch.empty((x.shape[0] // mesh.shape[axis],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=mesh.groups[axis])
    return out


def _all_reduce(mesh, x, axis, op):
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=op, group=mesh.groups[axis])
    return x


def psum(mesh: Mesh, x: torch.Tensor, axis: str = "d") -> torch.Tensor:
    return _all_reduce(mesh, x, axis, dist.ReduceOp.SUM)


def pmin(mesh: Mesh, x: torch.Tensor, axis: str = "d") -> torch.Tensor:
    return _all_reduce(mesh, x, axis, dist.ReduceOp.MIN)


def pmax(mesh: Mesh, x: torch.Tensor, axis: str = "d") -> torch.Tensor:
    return _all_reduce(mesh, x, axis, dist.ReduceOp.MAX)


def any_rank(mesh: Mesh, flag: torch.Tensor, axis: str = "d") -> bool:
    """Whether ``flag`` (a bool tensor) holds anywhere on any rank of the
    axis: one all-reduce, so every rank takes the same branch after it."""
    return bool(psum(mesh, flag.any().to(torch.int32).reshape(1), axis)[0] > 0)


def gather_shards(mesh: Mesh, x: torch.Tensor, axis: str = "d") -> np.ndarray:
    """This rank's (nl, ...) shard -> the (size, nl, ...) array of every
    shard along the axis, as numpy on every rank of it."""
    full = all_gather(mesh, x, axis)
    return full.reshape((mesh.shape[axis],) + tuple(x.shape)).cpu().numpy()


def to_mesh(index, mesh: Mesh):
    """A sharded index (a dataclass with a ``mesh`` field) on another mesh
    of the same shape: the same shard with its tensors on ``mesh.device``."""
    moved = {f.name: getattr(index, f.name).to(mesh.device)
             for f in dataclasses.fields(index)
             if isinstance(getattr(index, f.name), torch.Tensor)}
    return dataclasses.replace(index, mesh=mesh, **moved)
