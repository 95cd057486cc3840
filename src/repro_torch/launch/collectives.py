"""The collectives the reference's GSPMD inserts implicitly, made explicit.

Every cross-rank transfer of the port goes through this module, so one
counter sees all of it: each call adds its payload bytes (the size of the
whole buffer the collective operates on, see below) to :data:`BYTES`, the
bytes one rank sends on a ring of the call's ``p`` ranks to :data:`SENT`
(``2 (p - 1) / p`` of an all-reduce's payload, ``(p - 1) / p`` of the
others') and one to :data:`CALLS`, each under its kind, keyed by
``hlo_stats.COLLECTIVES``.  :func:`stats` reads the payloads as a
``hlo_stats.CollectiveStats``; :func:`reset` zeroes all three.

Payloads: ``all-reduce`` the buffer; ``all-gather`` the gathered result;
``reduce-scatter`` the unreduced input; ``all-to-all`` the send buffer;
``collective-permute`` (:func:`shift`) the tensor a rank sends, counted on
each rank that sends, payload and sent alike (the reference's 1 x
|operand|, no ring factor).

Two layers:

* plain functions on a process group (:func:`all_reduce_`,
  :func:`all_gather_into`, :func:`all_to_all_single`), for code that runs
  without autograd (serving, the grid backend, the optimizer);
* ``torch.autograd.Function`` s over one axis of a ``launch.mesh.Mesh``, for
  the training forward (Megatron's ``f`` and ``g``):

  - :func:`copy_to` — identity forward, ``all_reduce`` backward: where a
    tensor every rank of the axis holds enters a rank-local computation (the
    input of a column-parallel product);
  - :func:`reduce_from` — ``all_reduce`` forward, identity backward: where
    the ranks' partial results add up (the output of a row-parallel product);
  - :func:`gather` — ``all_gather`` forward along one dimension; backward
    ``reduce_scatter`` when the ranks of the axis computed on different rows
    (FSDP over ``data``), else the rank's own slice of the (then identical)
    gradient;
  - :func:`all_to_all` — ``all_to_all_single`` both ways (expert parallelism);
  - :func:`shift` — the reference's ``ppermute`` by one position along an
    axis (a pipeline's stage hand-off): send to the next position, receive
    from the previous one; backward the reverse permute.

With no process group, a local mesh or an axis of size 1 each is the
identity and counts nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.hlo_stats import COLLECTIVES, CollectiveStats

__all__ = ["BYTES", "SENT", "CALLS", "reset", "stats", "axis_group",
           "barrier", "all_reduce_", "all_gather_into", "all_to_all_single",
           "copy_to", "reduce_from", "gather", "all_to_all", "shift",
           "max_over"]

#: payload bytes, ring bytes a rank sends, and calls, by kind, since the
#: last :func:`reset`
BYTES: dict[str, int] = {c: 0 for c in COLLECTIVES}
SENT: dict[str, float] = {c: 0.0 for c in COLLECTIVES}
CALLS: dict[str, int] = {c: 0 for c in COLLECTIVES}


def reset() -> None:
    for c in COLLECTIVES:
        BYTES[c] = 0
        SENT[c] = 0.0
        CALLS[c] = 0


def stats() -> CollectiveStats:
    """The counters as the roofline's collective term takes them."""
    return CollectiveStats(total_bytes=float(sum(BYTES.values())),
                           by_op={c: float(BYTES[c]) for c in COLLECTIVES},
                           counts=dict(CALLS))


def _count(kind: str, t: torch.Tensor, group) -> None:
    nbytes = t.numel() * t.element_size()
    p = _size(group)
    BYTES[kind] += nbytes
    SENT[kind] += nbytes * (p - 1) / p * (2 if kind == "all-reduce" else 1)
    CALLS[kind] += 1


def _count_permute(t: torch.Tensor) -> None:
    nbytes = t.numel() * t.element_size()
    BYTES["collective-permute"] += nbytes
    SENT["collective-permute"] += nbytes
    CALLS["collective-permute"] += 1


def _size(group) -> int:
    return dist.get_world_size(group)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``, or None when
    there is nothing to exchange (no mesh, a local mesh, no such axis, or
    an axis of size 1)."""
    if (mesh is None or not mesh.distributed or axis not in mesh.axes
            or mesh.axis_size(axis) == 1):
        return None
    return mesh.axis_group(axis)


def barrier(mesh) -> None:
    """Every rank of a distributed ``mesh`` waits for all the others (no
    payload, nothing counted)."""
    if mesh is not None and mesh.distributed:
        dist.barrier()


# ---------------------------------------------------------------------------
# plain collectives on a process group
# ---------------------------------------------------------------------------

def all_reduce_(t: torch.Tensor, group=None, op=None) -> torch.Tensor:
    """``dist.all_reduce`` in place (SUM unless ``op``) over ``group`` (the
    world when None); a group of one rank is skipped."""
    if _size(group) == 1:
        return t
    _count("all-reduce", t, group)
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return t


def all_gather_into(out: torch.Tensor, t: torch.Tensor,
                    group=None) -> torch.Tensor:
    """``dist.all_gather_into_tensor`` (rank blocks along dim 0 of
    ``out``)."""
    if _size(group) == 1:
        out.copy_(t)
        return out
    _count("all-gather", out, group)
    _ALL_GATHER(out, t.contiguous(), group=group)
    return out


def all_to_all_single(out: torch.Tensor, t: torch.Tensor,
                      group=None) -> torch.Tensor:
    """``dist.all_to_all_single`` with even splits along dim 0."""
    if _size(group) == 1:
        out.copy_(t)
        return out
    _count("all-to-all", t, group)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def _permute(t: torch.Tensor, group, index: int, step: int) -> torch.Tensor:
    """One ``batch_isend_irecv`` on ``group``: send ``t`` to the position
    ``index + step`` of the group and receive from ``index - step``.  A
    position past either end is no one: nothing goes there, and what comes
    from there is zeros.  Peers are translated to global ranks.  Waiting on
    the work orders the current stream after it (no host sync under NCCL)."""
    t = t.contiguous()
    out = torch.zeros_like(t)
    size = _size(group)
    ops = []
    if 0 <= index + step < size:
        _count_permute(t)
        ops.append(dist.P2POp(dist.isend, t,
                              dist.get_global_rank(group, index + step), group))
    if 0 <= index - step < size:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, index - step), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


#: ``all_gather_single`` where this torch has it (it deprecates the other)
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


def _reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = _size(group)
    moved = t.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // n, *moved.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _count("reduce-scatter", moved, group)
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def _gather_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = _size(group)
    moved = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * moved.shape[0], *moved.shape[1:]),
                      dtype=t.dtype, device=t.device)
    all_gather_into(out, moved, group)
    return out.movedim(0, dim)


def max_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``all_reduce(MAX)`` of a copy of ``t`` over each of ``axes`` in turn
    (no gradient)."""
    t = t.detach().clone()
    for axis in (axes,) if isinstance(axes, str) else axes:
        group = axis_group(mesh, axis)
        if group is not None:
            all_reduce_(t, group, dist.ReduceOp.MAX)
    return t


# ---------------------------------------------------------------------------
# autograd collectives over one mesh axis
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, reduce_grad, index):
        ctx.group, ctx.dim, ctx.reduce_grad = group, dim, reduce_grad
        ctx.index, ctx.size = index, x.shape[dim]
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            out = _reduce_scatter(g, ctx.group, ctx.dim)
        else:
            out = g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size).contiguous()
        return out, None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_single(torch.empty_like(x), x, group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return all_to_all_single(torch.empty_like(g), g, ctx.group), None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index):
        ctx.group, ctx.index = group, index
        return _permute(x, group, index, +1)

    @staticmethod
    def backward(ctx, g):
        # the gradient of what this rank received goes back to its sender;
        # the gradient of what it sent comes from its receiver
        return _permute(g, ctx.group, ctx.index, -1), None, None


def copy_to(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Identity forward, ``all_reduce`` of the gradient over ``axis``."""
    group = axis_group(mesh, axis)
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """``all_reduce(SUM)`` over ``axis`` forward, identity backward."""
    group = axis_group(mesh, axis)
    if group is None:
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        return all_reduce_(x.contiguous().clone(), group)
    return _ReduceFrom.apply(x, group)


def gather(x: torch.Tensor, mesh, axis: str, dim: int,
           reduce_grad: bool) -> torch.Tensor:
    """The ranks' slices of ``axis`` concatenated along ``dim``.  Backward:
    ``reduce_scatter`` (``reduce_grad``: the ranks' gradients are partial
    sums) or the rank's own slice (they are the same whole gradient)."""
    group = axis_group(mesh, axis)
    if group is None:
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        return _gather_dim(x, group, dim)
    return _Gather.apply(x, group, dim, reduce_grad, mesh.axis_index(axis))


def all_to_all(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """``all_to_all_single`` with even splits along dim 0, both ways."""
    group = axis_group(mesh, axis)
    if group is None:
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        return all_to_all_single(torch.empty_like(x), x, group)
    return _AllToAll.apply(x, group)


def shift(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The reference's ``lax.ppermute`` of ``x`` by one position along
    ``axis``: each rank sends ``x`` to position ``i + 1`` of its line and
    returns what position ``i - 1`` sent (zeros at position 0).  The
    reference's wrap from the last position to the first is left out: a
    pipeline never uses what it carries, so the last rank sends nothing
    forward and the first receives nothing.  Backward is the reverse
    permute: the gradient of the received tensor goes to ``i - 1``, that of
    the sent one comes from ``i + 1`` (zeros at the last position).  Every
    rank of the line must call it, in the same order, in both passes."""
    group = axis_group(mesh, axis)
    if group is None:
        return x
    index = mesh.axis_index(axis)
    if not torch.is_grad_enabled() or not x.requires_grad:
        return _permute(x, group, index, +1)
    return _Shift.apply(x, group, index)
