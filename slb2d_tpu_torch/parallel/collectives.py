"""What the JAX package's shard_map bodies do with ``ppermute`` and
``psum`` (slb2d_tpu/parallel/spatial.py: _halo_shift_factory,
_sum_m_factory), between the slots of a mesh: point-to-point copies, the
slot-order sum's gather, and broadcasts from process 0.

Within a process a transfer is a tensor copy (a peer copy between cards);
across processes it is torch.distributed point-to-point
(``batch_isend_irecv``) and collectives.  Under Gloo a CUDA tensor is
never handed to the backend: it is staged through a pinned host buffer
on the way out and copied back to its card on the way in.  Every process
must reach each of these calls with the same arguments' shapes in the
same order: they are collectives.
"""

from __future__ import annotations

import torch

from .mesh import process_count, process_index


def _gloo() -> bool:
    import torch.distributed as dist
    return dist.get_backend() == "gloo"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """t as the backend takes it: contiguous, and on the host (pinned)
    for a CUDA tensor under Gloo."""
    t = t.contiguous()
    if t.is_cuda and _gloo():
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t


def _wire_empty(like: torch.Tensor) -> torch.Tensor:
    if like.is_cuda and _gloo():
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


def exchange(transfers, slot_ranks):
    """Point-to-point copies between slots.  transfers: (src_slot,
    dst_slot, src, dst) in one order on every process, src the tensor to
    send where src_slot is this process's (else None), dst the tensor
    (a view may be) that receives it where dst_slot is (else None).
    slot_ranks[i] is slot i's process rank.  Copies between this process's
    slots are tensor copies; the others go through one batch_isend_irecv,
    tagged by their place in the list."""
    rank = process_index()
    ops, pending = [], []
    for tag, (s, d, src, dst) in enumerate(transfers):
        rs, rd = slot_ranks[s], slot_ranks[d]
        if rs == rank and rd == rank:
            dst.copy_(src)
        elif rs == rank:
            import torch.distributed as dist
            ops.append(dist.P2POp(dist.isend, _wire(src), rd, tag=tag))
        elif rd == rank:
            import torch.distributed as dist
            buf = _wire_empty(dst)
            ops.append(dist.P2POp(dist.irecv, buf, rs, tag=tag))
            pending.append((buf, dst))
    if ops:
        import torch.distributed as dist
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for buf, dst in pending:
        dst.copy_(buf)


def gather_slots(local, n_per_rank, group=None):
    """The per-slot tensors of every process, in slot order, on the device
    of `local`'s first tensor.  local: this process's slots' tensors (one
    shape and dtype for all); n_per_rank: slots of each process that holds
    some, in rank order (processes hold contiguous runs of slots); group:
    the process group of those processes (None: every process)."""
    home = local[0].device
    mine = torch.stack([t.to(home) for t in local])
    if len(n_per_rank) == 1:
        return list(mine.unbind(0))
    import torch.distributed as dist
    most = max(n_per_rank)
    pad = torch.zeros((most,) + tuple(mine.shape[1:]), dtype=mine.dtype,
                      device=mine.device)
    pad[:mine.shape[0]] = mine
    wire = _wire(pad)
    outs = [_wire_empty(wire) for _ in n_per_rank]
    dist.all_gather(outs, wire, group=group)
    return [t.to(home) for out, n in zip(outs, n_per_rank)
            for t in out[:n].unbind(0)]


def all_gather_object(obj) -> list:
    """obj of every process, in rank order (the one-process list without a
    process group)."""
    if process_count() == 1:
        return [obj]
    import torch.distributed as dist
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj):
    """Process 0's obj on every process."""
    if process_count() == 1:
        return obj
    import torch.distributed as dist
    box = [obj if process_index() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]
