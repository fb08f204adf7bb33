"""Meshes of devices across processes, and the process group.

The PyTorch counterpart of ``slb2d_tpu/parallel/mesh.py``.  A mesh is an
array of *slots* with axis names: the "sweep" axis spreads the points of
a parameter sweep, the "space" axis cuts one phi_y grid (SURVEY.md §2.2).
A slot is one (process rank, torch.device) pair; its array holds the
slots in rank order, each process's own devices in their order, as
``jax.devices()`` orders a JAX mesh's devices.

The devices a process contributes (``local_devices``): its CUDA cards from
``device=`` on, or, under torchrun with several processes on a host, the
card of its local rank; on the CPU the one CPU.  An explicit ``devices=``
may repeat a device, which is how several slots share one card (the
smoke run's ``[cuda:0] * S``) or the CPU (the tests' ``[cpu] * 8``, the
counterpart of the 8 virtual CPU devices XLA gives the JAX tests); the
CLIs pass ``local_devices`` and so never repeat one.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

# the JAX package's launcher variables (examples/multihost_sweep.py)
ENV_COORD, ENV_NPROCS, ENV_PROC_ID = ("SLB2D_COORD", "SLB2D_NPROCS",
                                      "SLB2D_PROC_ID")


@dataclasses.dataclass(frozen=True)
class Slot:
    rank: int
    device: torch.device


class Mesh:
    """An array of Slots with axis names (``shape``: axis -> size, as a JAX
    mesh's ``.shape``)."""

    def __init__(self, slots: np.ndarray, axis_names):
        if slots.ndim != len(axis_names):
            raise ValueError(f"mesh of {slots.ndim} dims named {axis_names}")
        self.slots = slots
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, slots.shape))

    @property
    def size(self) -> int:
        return int(self.slots.size)

    def axis_slots(self, axis: str) -> list:
        """The slots along `axis` (the other axes of size 1), in order."""
        others = [n for n, k in self.shape.items() if n != axis and k != 1]
        if others:
            raise ValueError(f"mesh {self.shape}: axes {others} besides "
                             f"{axis!r} have more than one slot (a "
                             f"combined layout takes Mesh.grid)")
        return list(self.slots.reshape(-1))

    def grid(self, axis: str, space_axis: str) -> list:
        """For each index along `axis`, its row of slots along
        `space_axis` (the other axes of size 1): the combined sweep x space
        layout's blocks, each a row of slots that cut one point's grid."""
        names = self.axis_names
        others = [n for n, k in self.shape.items()
                  if n not in (axis, space_axis) and k != 1]
        if axis == space_axis or others:
            raise ValueError(f"mesh {self.shape}: no grid of {axis!r} by "
                             f"{space_axis!r}")
        order = [names.index(axis), names.index(space_axis)] + [
            i for i, n in enumerate(names) if n not in (axis, space_axis)]
        rows = np.transpose(self.slots, order).reshape(
            self.shape[axis], self.shape[space_axis])
        return [list(row) for row in rows]

    def __repr__(self):
        slots = [(s.rank, str(s.device)) for s in self.slots.reshape(-1)]
        return f"Mesh({self.shape}, {slots})"


def process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def local_devices(cfg=None, device=None):
    """The devices this process contributes to a mesh by default: the CPU
    (`device`, else cfg.device == "cpu"); on a card one per process under
    torchrun with several local processes (its LOCAL_RANK), else every
    card from the first (`device`, else cfg.device) on."""
    if device is None and cfg is not None:
        device = "cpu" if cfg.device == "cpu" else f"cuda:{cfg.device}"
    device = torch.device("cuda:0" if device is None else device)
    if device.type == "cpu":
        return [device]
    if not torch.cuda.is_available():
        return []
    first = device.index or 0
    if int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > 1:
        return [torch.device(f"cuda:{first + int(os.environ['LOCAL_RANK'])}")]
    return [torch.device(f"cuda:{i}")
            for i in range(first, torch.cuda.device_count())]


def make_mesh(shape=None, axis_names=("sweep", "space"), devices=None,
              cfg=None) -> Mesh:
    """A mesh over the slots of every process.

    devices: this process's devices (default local_devices(cfg)); under
    torch.distributed each process contributes its own and the ranks
    exchange their lists, slots in rank order.  shape: a tuple matching
    axis_names; None puts every slot on the first axis.  The first
    prod(shape) slots are taken; fewer raise as the JAX package does.
    Every process must hold at least one slot of the mesh."""
    devs = [torch.device(d) for d in (local_devices(cfg) if devices is None
                                      else devices)]
    rank, nprocs = process_index(), process_count()
    if nprocs > 1:
        from .collectives import all_gather_object
        per_rank = all_gather_object([str(d) for d in devs])
        slots = [Slot(r, torch.device(d)) for r, ds in enumerate(per_rank)
                 for d in ds]
    else:
        slots = [Slot(0, d) for d in devs]
    n = len(slots)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    need = int(np.prod(shape))
    if need > n:
        raise ValueError(f"mesh shape {tuple(shape)} needs {need} devices, "
                         f"have {n}")
    arr = np.empty(need, dtype=object)
    arr[:] = slots[:need]
    if not any(s.rank == rank for s in arr):
        raise ValueError(f"mesh shape {tuple(shape)}: process {rank} holds "
                         f"no slot of it ({n} slots over {nprocs} processes)")
    return Mesh(arr.reshape(shape), axis_names)


def default_split(n: int) -> tuple[int, int]:
    """Factor n into (sweep, space) with space <= sweep, space in {1,2,4}."""
    for space in (4, 2, 1):
        if n % space == 0 and n // space >= space:
            return (n // space, space)
    return (n, 1)


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None, device=None) -> bool:
    """Join a torch.distributed process group for a run across processes;
    False (and nothing done) when no launcher set one up, as the JAX
    package's returns False on one host.

    The group comes from the arguments, else from SLB2D_COORD ("host:port"),
    SLB2D_NPROCS and SLB2D_PROC_ID (examples/multihost_sweep.py's), else
    from torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK.  The
    backend is chosen here and printed to stderr: `backend` when given,
    else NCCL where CUDA is available and every process of a host has its
    own card (LOCAL_WORLD_SIZE, 1 without torchrun, at most the card
    count), else Gloo.  NCCL refuses two ranks on one card, so two
    processes on one card use Gloo.  A failure to initialise raises;
    nothing falls back to another backend.  Under NCCL the process's
    current card becomes `device` (default its first local device)."""
    import torch.distributed as dist
    env = os.environ
    coord = coordinator_address or env.get(ENV_COORD)
    nprocs = num_processes or env.get(ENV_NPROCS)
    pid = process_id if process_id is not None else env.get(ENV_PROC_ID)
    if coord is None and "MASTER_ADDR" in env and "WORLD_SIZE" in env:
        coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        nprocs = nprocs or env["WORLD_SIZE"]
        pid = pid if pid is not None else env.get("RANK")
    if coord is None or nprocs is None or pid is None:
        return False
    nprocs, pid = int(nprocs), int(pid)
    local = int(env.get("LOCAL_WORLD_SIZE", "1"))
    if backend is None:
        own_cards = (torch.cuda.is_available()
                     and local <= torch.cuda.device_count())
        backend = "nccl" if own_cards else "gloo"
        why = ("every process has its own card" if own_cards else
               "no card, or more processes than cards on a host")
    else:
        why = "asked for"
    if backend == "nccl":
        dev = torch.device(device if device is not None
                           else f"cuda:{int(env.get('LOCAL_RANK', '0'))}")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend, init_method=f"tcp://{coord}",
                            world_size=nprocs, rank=pid)
    print(f"# distributed: process {pid} of {nprocs}, backend {backend} "
          f"({why})", file=sys.stderr, flush=True)
    return True
