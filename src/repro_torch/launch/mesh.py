"""The meshes of the distributed pipeline and of the sharded LM, over
``torch.distributed``.

The JAX package runs one controller over a ``shard_map`` mesh.  Here each
device of the mesh is a rank of a process group (SPMD): every rank calls
the same entry point, computes its own block (``runtime/sharding.py``),
and the collectives the JAX stages use become the :class:`DataMesh`
methods: ``ppermute`` one step along the ring is
:meth:`DataMesh.ring_shift`, ``all_gather(tiled=True)`` is
:meth:`DataMesh.all_gather`, ``psum`` is :meth:`DataMesh.all_reduce_sum`
(added in rank order), ``all_to_all(tiled=True)`` is
:meth:`DataMesh.all_to_all`.  Each takes the mesh axis it runs along:
``"data"``, ``"model"``, or None for the whole mesh.

A mesh is ``(data, model)``, JAX's ``make_mesh((D, M), ("data",
"model"))``: mesh rank r is device ``(r // M, r % M)``, row-major, and
the mesh is the first D·M ranks of the world.  Each rank belongs to one
process group a ``"model"`` row (the M ranks of its data index) and one a
``"data"`` column (the D ranks of its model index).  The pipeline's meshes
are ``(P, 1)``: their ``size`` and ``rank`` are the data axis's.

The training step differentiates through its collectives
(:func:`model_sum`, whose backward is the identity; :func:`model_copy`,
the identity whose backward is the ``"model"`` sum; :func:`gather_data`,
the tiled gather over ``"data"`` whose backward is the rank-order
reduce-scatter, :meth:`DataMesh.reduce_scatter_sum`; :func:`model_gather`,
the same along ``"model"``; :func:`model_unshard`, the same gather for
work replicated on every rank after it, whose backward takes the rank's
block, and its dual :func:`model_shard`; :func:`model_halves`, the
re-blocking of two tensors cut over ``"model"`` as one, an exchange of
pieces (:meth:`DataMesh.exchange`) whose backward is the inverse
exchange),
each adding in rank order as :meth:`DataMesh.all_reduce_sum` does, and
times them by kind while a caller has set :attr:`DataMesh.clock`.

The transport follows the group's backend.  NCCL moves the tensors on
the card.  Gloo moves host tensors: a tensor on the card is copied to the
host, moved, and copied back (processes that share one card can only
talk through gloo, since NCCL takes one rank a GPU).  A failing
collective raises; nothing retries it another way.

The ranks outside a mesh smaller than the world have ``rank == -1`` and
receive the mesh's result by :func:`broadcast_from_mesh`.  With no
process group, :func:`make_data_mesh` makes a world of one: NCCL on the
card, gloo when the caller asked for the CPU.  On a host with several
cards, ``torchrun --nproc_per_node=P`` starts the ranks; each takes the
card of its ``LOCAL_RANK``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time

import torch
import torch.distributed as dist

_SUBGROUPS: dict = {}       # (world group id, ranks) -> their subgroup


def mark(dev):
    """A point in time: a CUDA event recorded on the current stream (read
    later, without draining the card), or the host clock off the card."""
    if dev.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def elapsed_ms(a, b) -> float:
    """ms from mark ``a`` to mark ``b`` (waits for ``b`` on the card)."""
    if isinstance(a, float):
        return (b - a) * 1e3
    b.synchronize()
    return a.elapsed_time(b)


@dataclasses.dataclass
class DataMesh:
    """One rank's view of a ``(data, model)`` mesh."""
    group: object           # the mesh's process group (None outside it)
    rank: int               # this rank's mesh index d * M + m, -1 outside
    size: int               # the mesh's ranks D * M
    device: torch.device    # where this rank's stages run
    backend: str            # "nccl" or "gloo"
    world_rank: int
    world_size: int
    model: int = 1          # the "model" axis M
    # {"data": (group, global ranks), "model": (...)}: this rank's column
    # and row, for a mesh with both axes above 1
    axes: dict = dataclasses.field(default_factory=dict)
    # {kind: [(start mark, end mark), ...]} while a caller times the
    # collectives (:meth:`timed`), else None
    clock: dict = None

    @property
    def in_mesh(self) -> bool:
        return self.rank >= 0

    @property
    def shape(self) -> dict:
        """The axis sizes, JAX's ``mesh.shape``: ``{"data": D, "model":
        M}`` (the partition rules of ``runtime/sharding.py`` read it)."""
        return {"data": self.size // self.model, "model": self.model}

    def axis_size(self, axis=None) -> int:
        """The ranks along ``axis`` ("data", "model"; None: the mesh)."""
        return self.size if axis is None else self.shape[axis]

    def axis_index(self, axis=None) -> int:
        """This rank's index along ``axis``."""
        if axis is None:
            return self.rank
        return self.rank // self.model if axis == "data" else \
            self.rank % self.model

    def _group(self, axis):
        """(the process group along ``axis``, its global ranks)."""
        if axis is None or self.axis_size(axis) == self.size:
            return self.group, list(range(self.size))
        return self.axes[axis]

    @contextlib.contextmanager
    def timed(self, kind: str):
        """Record the time of the block under ``kind`` in :attr:`clock`
        (nothing when the clock is off)."""
        if self.clock is None:
            yield
            return
        a = mark(self.device)
        yield
        self.clock.setdefault(kind, []).append((a, mark(self.device)))

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend moves it: on the card for NCCL, a host
        copy for gloo."""
        t = t.contiguous()
        return t if self.backend == "nccl" else t.cpu()

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """The ``t`` of the previous rank along the ring (this rank's goes
        to the next one): one ``ppermute`` step, ``(s, s + 1 mod P)``."""
        if self.size == 1:
            return t
        send = self._wire(t)
        recv = torch.empty_like(send)
        nxt, prv = (self.rank + 1) % self.size, (self.rank - 1) % self.size
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, nxt, self.group),
            dist.P2POp(dist.irecv, recv, prv, self.group)])
        for r in reqs:
            r.wait()
        return recv.to(self.device)

    def all_gather_list(self, t: torch.Tensor, axis=None) -> list:
        """Every rank's ``t`` along ``axis``, in rank order (equal
        shapes)."""
        n = self.axis_size(axis)
        if n == 1:
            return [t]
        w = self._wire(t)
        out = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(out, w, group=self._group(axis)[0])
        return [o.to(self.device) for o in out]

    def all_gather(self, t: torch.Tensor, axis=None,
                   dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` along ``axis`` concatenated along ``dim`` in
        rank order (JAX's ``all_gather(tiled=True)``)."""
        if self.axis_size(axis) == 1:
            return t
        return torch.cat(self.all_gather_list(t, axis), dim=dim)

    def all_reduce_sum(self, t: torch.Tensor, axis=None) -> torch.Tensor:
        """The sum of every rank's ``t`` along ``axis``, added in rank
        order.

        The backend's own reduction adds in an order of its choosing, so
        this one is spelled out: ``t`` is cut into P blocks, an all-to-all
        hands rank r block r of every rank, rank r adds them in rank
        order, and an all-gather returns the sums.  Every rank holds the
        same bits, two runs agree, and the bits do not depend on the
        backend (an add rounds alike on the host and the card).  A rank
        moves about 2 (P-1)/P times ``t``'s bytes, as in a ring
        all-reduce, and holds three copies of ``t`` at most."""
        P = self.axis_size(axis)
        if P == 1:
            return t
        group = self._group(axis)[0]
        flat = t.reshape(-1)
        n = flat.numel()
        blk = -(-n // P)
        w = self._wire(torch.nn.functional.pad(flat, (0, blk * P - n)))
        parts = torch.empty_like(w)
        dist.all_to_all_single(parts, w, group=group)
        parts = parts.view(P, blk)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        out = torch.empty_like(w)
        dist.all_gather(list(out.view(P, blk).unbind(0)), acc, group=group)
        return out[:n].view(t.shape).to(self.device)

    def reduce_scatter_sum(self, t: torch.Tensor, axis) -> torch.Tensor:
        """Block r of the rank-order sum over ``axis`` on rank r of it:
        ``t`` is (P, n), row r this rank's term of block r.  Rank r adds
        the rows it receives in rank order: the bits that
        :meth:`all_reduce_sum` gives block r."""
        P = self.axis_size(axis)
        if P == 1:
            return t[0]
        w = self._wire(t)
        parts = torch.empty_like(w)
        dist.all_to_all_single(parts, w, group=self._group(axis)[0])
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc.to(self.device)

    def all_to_all(self, t: torch.Tensor, axis, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """JAX's ``all_to_all(t, axis, split_axis, concat_axis,
        tiled=True)``: ``t`` cut into P equal chunks along ``split_axis``,
        chunk i sent to rank i of ``axis``, and the chunks received
        concatenated along ``concat_axis`` in the senders' rank order."""
        P = self.axis_size(axis)
        if P == 1:
            return t
        if t.shape[split_axis] % P:
            raise ValueError(f"all_to_all: dimension {split_axis} of "
                             f"{tuple(t.shape)} does not split over {P}")
        send = self._wire(torch.stack(t.chunk(P, dim=split_axis)))
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self._group(axis)[0])
        return torch.cat(recv.to(self.device).unbind(0), dim=concat_axis)

    def exchange(self, sends: list, recvs: list, axis) -> list:
        """Point-to-point blocks along ``axis`` in one all-to-all: each
        ``(peer, tensor)`` of ``sends`` goes to that peer (an index along
        the axis, this rank's own included), and the tensors of ``recvs``
        (``(peer, shape)`` pairs; the dtype of ``sends``) come back from
        theirs, in that order.  A rank sends and receives at most one
        tensor a peer; every rank of the axis calls it."""
        P = self.axis_size(axis)
        out_n, in_n = [0] * P, [0] * P
        for peer, t in sends:
            in_n[peer] = t.numel()
        for peer, shape in recvs:
            out_n[peer] = math.prod(shape)
        flat = torch.cat([t.reshape(-1) for _, t in
                          sorted(sends, key=lambda s: s[0])])
        send = self._wire(flat)
        recv = send.new_empty(sum(out_n))
        dist.all_to_all_single(recv, send, out_n, in_n,
                               group=self._group(axis)[0])
        recv = recv.to(self.device)
        off = [sum(out_n[:p]) for p in range(P)]
        return [recv[off[peer]:off[peer] + out_n[peer]].view(shape)
                for peer, shape in recvs]

    def broadcast(self, t: torch.Tensor, src: int = 0,
                  axis=None) -> torch.Tensor:
        """Rank ``src``'s ``t`` (an index along ``axis``) on every rank
        of that axis (``t`` itself is left as it is)."""
        if self.axis_size(axis) == 1:
            return t
        group, ranks = self._group(axis)
        w = self._wire(t)
        if w is t:
            w = w.clone()
        dist.broadcast(w, ranks[src], group=group)
        return w.to(self.device)

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


# ---------------------------------------------------------------------------
# Collectives that autograd differentiates (the training step's)
# ---------------------------------------------------------------------------

class _ModelSum(torch.autograd.Function):
    """The rank-order sum over ``"model"``; its backward is the identity
    (every rank of the axis holds the sum's gradient)."""

    @staticmethod
    def forward(ctx, mesh, t):
        with mesh.timed("model_sum"):
            return mesh.all_reduce_sum(t, "model")

    @staticmethod
    def backward(ctx, g):
        return None, g


class _ModelCopy(torch.autograd.Function):
    """The identity on a tensor every rank of ``"model"`` holds alike and
    uses for its own slice of the work (the input of a column-parallel
    product); its backward is the rank-order sum of the ranks'
    gradients."""

    @staticmethod
    def forward(ctx, mesh, t):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        with ctx.mesh.timed("model_sum"):
            return None, ctx.mesh.all_reduce_sum(g.contiguous(), "model")


def model_split(mesh) -> bool:
    """Whether ``mesh`` has a ``"model"`` axis above 1, on which a block
    runs on the rank's slice of its heads or inner dimension."""
    return mesh is not None and mesh.shape["model"] > 1


def model_sum(mesh, t: torch.Tensor) -> torch.Tensor:
    """:meth:`DataMesh.all_reduce_sum` over ``"model"`` under autograd
    (the same bits forward)."""
    if mesh.shape["model"] == 1:
        return t
    return _ModelSum.apply(mesh, t)


def model_copy(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is, its gradient summed over ``"model"`` in rank
    order."""
    if mesh.shape["model"] == 1:
        return t
    return _ModelCopy.apply(mesh, t)


class _ModelGather(torch.autograd.Function):
    """The rank's blocks along ``"model"`` concatenated along ``dim`` in
    rank order (the tiled all-gather); its backward hands rank m block m
    of the rank-order sum of the ranks' gradients (the reduce-scatter),
    since each rank uses the whole tensor for its own slice of the
    work."""

    @staticmethod
    def forward(ctx, mesh, t, dim):
        ctx.mesh, ctx.dim = mesh, dim
        with mesh.timed("model_exchange"):
            return mesh.all_gather(t, "model", dim=dim)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        M = mesh.shape["model"]
        parts = g.chunk(M, dim=ctx.dim)
        with mesh.timed("model_exchange"):
            mine = mesh.reduce_scatter_sum(torch.stack(
                [p.reshape(-1) for p in parts]), "model")
        return None, mine.view(parts[0].shape), None


def model_gather(mesh, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The whole tensor of the rank's blocks of ``t`` along ``"model"``
    (tiled along ``dim``), under autograd (:class:`_ModelGather`)."""
    if mesh.shape["model"] == 1:
        return t
    return _ModelGather.apply(mesh, t, dim % t.dim())


class _ModelUnshard(torch.autograd.Function):
    """The rank's blocks along ``"model"`` concatenated along ``dim`` in
    rank order, for work that every rank then does alike on the whole
    tensor; its backward takes the rank's block of the gradient, which
    every rank holds alike, and sums nothing (a sum would count the same
    gradient M times)."""

    @staticmethod
    def forward(ctx, mesh, t, dim):
        ctx.mesh, ctx.dim = mesh, dim
        with mesh.timed("model_exchange"):
            return mesh.all_gather(t, "model", dim=dim)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        block = g.shape[ctx.dim] // mesh.shape["model"]
        return None, g.narrow(ctx.dim, mesh.axis_index("model") * block,
                              block), None


class _ModelShard(torch.autograd.Function):
    """The rank's block along ``dim`` of a tensor every rank of
    ``"model"`` holds alike (the dual of :class:`_ModelUnshard`); its
    backward gathers the ranks' gradient blocks, so that the work before
    it gets the whole gradient alike on every rank."""

    @staticmethod
    def forward(ctx, mesh, t, dim):
        ctx.mesh, ctx.dim = mesh, dim
        block = t.shape[dim] // mesh.shape["model"]
        return t.narrow(dim, mesh.axis_index("model") * block, block)

    @staticmethod
    def backward(ctx, g):
        with ctx.mesh.timed("model_exchange"):
            return None, ctx.mesh.all_gather(g.contiguous(), "model",
                                             dim=ctx.dim), None


def model_unshard(mesh, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The whole tensor of the rank's blocks of ``t`` along ``"model"``,
    for a computation replicated on every rank after it (the mLSTM's and
    sLSTM's heads that do not divide the axis): forward the tiled gather,
    backward the rank's block of the gradient (:class:`_ModelUnshard`)."""
    if mesh.shape["model"] == 1:
        return t
    return _ModelUnshard.apply(mesh, t, dim % t.dim())


def model_shard(mesh, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The rank's block along ``dim`` of ``t``, which every rank of
    ``"model"`` holds alike; its backward gathers the blocks' gradients
    whole (:class:`_ModelShard`)."""
    if mesh.shape["model"] == 1:
        return t
    return _ModelShard.apply(mesh, t, dim % t.dim())


def _halves_plan(M: int, m: int):
    """Rank ``m``'s part in re-blocking ``[a | b]``, two tensors of width
    n side by side and cut over ``"model"`` as one (rank r holds columns
    ``[2rn/M, 2(r+1)n/M)``), into each one's block (rank m: columns ``[mn/M,
    (m+1)n/M)`` of a and of b).  In pieces of n/M columns, piece s of the
    2M is a's block s for s < M and b's block s - M after it, owned by
    rank s mod M; rank m holds pieces 2m and 2m + 1.  Returns (the ranks
    its two pieces go to, the ranks its a and b blocks come from)."""
    return ((2 * m) % M, (2 * m + 1) % M), (m // 2, (M + m) // 2)


class _Halves(torch.autograd.Function):
    """:func:`model_halves` forward; its backward sends the gradients
    back the way the pieces came (the inverse exchange)."""

    @staticmethod
    def forward(ctx, mesh, t):
        ctx.mesh = mesh
        M, m = mesh.shape["model"], mesh.axis_index("model")
        dst, src = _halves_plan(M, m)
        pieces = t.chunk(2, dim=-1)
        shape = pieces[0].shape
        with mesh.timed("model_exchange"):
            a, b = mesh.exchange(
                [(dst[0], pieces[0].contiguous()),
                 (dst[1], pieces[1].contiguous())],
                [(src[0], shape), (src[1], shape)], "model")
        return torch.cat([a, b], dim=-1)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        M, m = mesh.shape["model"], mesh.axis_index("model")
        dst, src = _halves_plan(M, m)
        ga, gb = g.chunk(2, dim=-1)
        shape = ga.shape
        with mesh.timed("model_exchange"):
            p0, p1 = mesh.exchange(
                [(src[0], ga.contiguous()), (src[1], gb.contiguous())],
                [(dst[0], shape), (dst[1], shape)], "model")
        return None, torch.cat([p0, p1], dim=-1)


def model_halves(mesh, t: torch.Tensor) -> torch.Tensor:
    """The rank's block of ``[a | b]`` (its last dimension the rank's
    ``2n/M`` columns of the two tensors side by side, cut over
    ``"model"`` as one) re-blocked as ``[a_m | b_m]``, rank m's n/M
    columns of each: one exchange of two pieces a rank along
    ``"model"`` (:func:`_halves_plan`), under autograd.  ``t`` itself at
    ``model`` = 1."""
    if mesh.shape["model"] == 1:
        return t
    return _Halves.apply(mesh, t)


class _DataGather(torch.autograd.Function):
    """Whole tensors from the ranks' blocks along ``"data"`` (FSDP's
    gather), several leaves in one collective.  A block with a dimension
    (``dims``) is gathered tiled along it; its backward is the rank-order
    reduce-scatter of the whole gradient, which hands rank r block r of
    the sum.  A tensor with None every rank holds whole: forward the
    identity, backward the rank-order all-reduce."""

    @staticmethod
    def forward(ctx, mesh, dims, *blocks):
        ctx.mesh, ctx.dims = mesh, dims
        ctx.shapes = [b.shape for b in blocks]
        ctx.dtypes = [b.dtype for b in blocks]
        cut = [b for b, d in zip(blocks, dims) if d is not None]
        out = [b.view_as(b) for b in blocks]
        if not cut:
            return tuple(out)
        with mesh.timed("data_gather"):
            parts = mesh.all_gather_list(
                torch.cat([b.reshape(-1) for b in cut]), "data")
        off = 0
        for i, (b, d) in enumerate(zip(blocks, dims)):
            if d is None:
                continue
            n = b.numel()
            out[i] = torch.cat([p[off:off + n].view(b.shape)
                                for p in parts], dim=d)
            off += n
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        mesh, dims = ctx.mesh, ctx.dims
        D = mesh.shape["data"]
        grads = [torch.zeros(s if d is None else _whole(s, d, D),
                             dtype=t, device=mesh.device) if g is None
                 else g for g, s, t, d in zip(grads, ctx.shapes, ctx.dtypes,
                                              dims)]
        out = [None] * len(grads)
        cut = [i for i, d in enumerate(dims) if d is not None]
        kept = [i for i, d in enumerate(dims) if d is None]
        if cut:
            rows = [torch.cat([grads[i].chunk(D, dim=dims[i])[r].reshape(-1)
                               for i in cut]) for r in range(D)]
            with mesh.timed("grad_reduce_scatter"):
                mine = mesh.reduce_scatter_sum(torch.stack(rows), "data")
            off = 0
            for i in cut:
                n = ctx.shapes[i].numel()
                out[i] = mine[off:off + n].view(ctx.shapes[i])
                off += n
        if kept:
            with mesh.timed("grad_all_reduce"):
                flat = mesh.all_reduce_sum(
                    torch.cat([grads[i].reshape(-1) for i in kept]), "data")
            off = 0
            for i in kept:
                n = ctx.shapes[i].numel()
                out[i] = flat[off:off + n].view(ctx.shapes[i])
                off += n
        return (None, None) + tuple(out)


def _whole(shape, d: int, n: int) -> tuple:
    return tuple(s * n if i == d else s for i, s in enumerate(shape))


def gather_data(mesh, blocks: list, dims: list) -> list:
    """The whole tensors of the rank's ``blocks`` over ``"data"``, each
    gathered along its dimension in ``dims`` (None: held whole), in one
    collective, under autograd (:class:`_DataGather`); the blocks
    themselves on a data axis of one."""
    if mesh.shape["data"] == 1:
        return list(blocks)
    return list(_DataGather.apply(mesh, tuple(dims), *blocks))


def _local_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_data_mesh(data: int = 0, *, device="cuda") -> DataMesh:
    """The data mesh over the first ``data`` ranks of the world (0 = all).

    Without a process group, a world of one is made here: NCCL for a
    ``cuda`` device, gloo for the CPU.  Every rank of the world must call
    this with the same ``data`` (a smaller mesh is a subgroup, which the
    whole world creates together)."""
    dev = torch.device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    backend = str(dist.get_backend())
    world, wrank = dist.get_world_size(), dist.get_rank()
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL process group moves tensors on the card: "
                         f"device {dev} needs a gloo group")
    dev = _local_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    P = world if data <= 0 else min(int(data), world)
    group = dist.group.WORLD if P == world else \
        _subgroup(backend, list(range(P)))
    inside = wrank < P
    return DataMesh(group=group if inside else None,
                    rank=wrank if inside else -1, size=P, device=dev,
                    backend=backend, world_rank=wrank, world_size=world)


def _subgroup(backend: str, ranks: list):
    """The process group of the world ranks ``ranks``, made once (every
    rank of the world must take part in making it)."""
    key = (id(dist.distributed_c10d._get_default_group()), tuple(ranks))
    if key not in _SUBGROUPS:
        _SUBGROUPS[key] = dist.new_group(list(ranks), backend=backend)
    return _SUBGROUPS[key]


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device="cuda") -> DataMesh:
    """The JAX package's ``make_host_mesh``: ``data`` clamped to the
    world, then ``model`` to ``world // data``, the mesh the first
    ``data * model`` ranks in JAX's row-major order (mesh rank ``d * M +
    m``).  ``model = 1`` is :func:`make_data_mesh`'s 1-D mesh.  Every rank
    of the world must call this with the same arguments."""
    if not dist.is_initialized():
        make_data_mesh(1, device=device)        # a world of one
    world = dist.get_world_size()
    D = max(1, min(int(data), world))
    M = max(1, min(int(model), world // D))
    mesh = make_data_mesh(D * M, device=device)
    if M == 1:
        return mesh
    mesh.model = M
    rows = [list(range(d * M, (d + 1) * M)) for d in range(D)]
    cols = [list(range(m, D * M, M)) for m in range(M)]
    for axis, groups in (("model", rows), ("data", cols)):
        if len(groups[0]) in (1, D * M):     # no group, or the mesh's
            continue
        for ranks in groups:
            g = _subgroup(mesh.backend, ranks)
            if mesh.world_rank in ranks:
                mesh.axes[axis] = (g, ranks)
    return mesh


def broadcast_from_mesh(mesh: DataMesh, tensors: list, obj=None):
    """Hand the mesh's result to the ranks outside it: rank 0's
    ``tensors`` (each allocated with its shape and dtype on every rank)
    and the picklable ``obj`` go to every rank of the world.  A no-op when
    the mesh is the whole world.  Returns ``(tensors, obj)``."""
    if mesh.size == mesh.world_size:
        return tensors, obj
    out = []
    for t in tensors:
        w = t.contiguous() if mesh.backend == "nccl" else t.cpu().contiguous()
        dist.broadcast(w, 0)
        out.append(w.to(mesh.device))
    box = [obj]
    dist.broadcast_object_list(box, 0,
                               device=mesh.device if mesh.backend == "nccl"
                               else None)
    return out, box[0]


# ---------------------------------------------------------------------------
# The production mesh of the dry run: a recording mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecordingMesh(DataMesh):
    """One rank's view of a ``(data, model)`` mesh with no processes
    behind it, for the dry run (``launch/dryrun.py``): the axis sizes, this
    rank's index, and :class:`DataMesh`'s collectives, each returning
    tensors of the right shapes and dtypes on :attr:`device` and logging
    ``(kind, axis, bytes)`` in :attr:`log`, ``bytes`` the tensors the rank
    hands the collective.  On the meta device the results hold no values.
    On the card they hold stand-in values: a gather tiles the rank's own
    block, a sum returns the rank's own term, an all-to-all the rank's own
    chunk in every slot, an exchange the rank's own pieces; nothing moves
    between processes, so neither a collective's time nor its values are
    those of a real mesh."""
    log: list = dataclasses.field(default_factory=list)

    @property
    def _meta(self) -> bool:
        return self.device.type == "meta"

    def _note(self, kind: str, axis, *ts) -> None:
        n = sum(t.numel() * t.element_size() for t in ts)
        self.log.append((kind, axis or "mesh", int(n)))

    def _same(self, t):
        """A tensor like ``t``: no values on the meta device, ``t``'s own
        values (a copy) on the card."""
        return torch.empty_like(t, device="meta") if self._meta else \
            t.clone()

    def ring_shift(self, t):
        if self.size > 1:
            self._note("ring_shift", None, t)
        return self._same(t)

    def all_gather_list(self, t, axis=None) -> list:
        if self.axis_size(axis) > 1:
            self._note("all_gather", axis, t)
        return [self._same(t) for _ in range(self.axis_size(axis))]

    def all_gather(self, t, axis=None, dim: int = 0):
        n = self.axis_size(axis)
        if n == 1:
            return t
        self._note("all_gather", axis, t)
        if not self._meta:
            return torch.cat([t] * n, dim=dim)
        shape = list(t.shape)
        shape[dim] *= n
        return t.new_empty(shape, device="meta")

    def all_reduce_sum(self, t, axis=None):
        if self.axis_size(axis) == 1:
            return t
        self._note("all_reduce", axis, t)
        return self._same(t)

    def reduce_scatter_sum(self, t, axis):
        if self.axis_size(axis) == 1:
            return t[0]
        self._note("reduce_scatter", axis, t)
        return self._same(t[self.axis_index(axis)])

    def all_to_all(self, t, axis, split_axis: int, concat_axis: int):
        P = self.axis_size(axis)
        if P == 1:
            return t
        if t.shape[split_axis] % P:
            raise ValueError(f"all_to_all: dimension {split_axis} of "
                             f"{tuple(t.shape)} does not split over {P}")
        self._note("all_to_all", axis, t)
        if not self._meta:
            own = t.chunk(P, dim=split_axis)[self.axis_index(axis)]
            return torch.cat([own] * P, dim=concat_axis)
        shape = list(t.shape)
        shape[split_axis] //= P
        shape[concat_axis] *= P
        return t.new_empty(shape, device="meta")

    def exchange(self, sends: list, recvs: list, axis) -> list:
        self._note("exchange", axis, *(t for _, t in sends))
        dtype = sends[0][1].dtype
        if self._meta:
            return [torch.empty(shape, dtype=dtype, device="meta")
                    for _, shape in recvs]
        return [sends[i % len(sends)][1].reshape(shape).clone()
                for i, (_, shape) in enumerate(recvs)]

    def broadcast(self, t, src: int = 0, axis=None):
        if self.axis_size(axis) > 1:
            self._note("broadcast", axis, t)
        return self._same(t)

    def barrier(self) -> None:
        pass

    def collectives(self) -> dict:
        """{kind:axis: {"calls": n, "bytes": total}} of the log."""
        out: dict = {}
        for kind, axis, n in self.log:
            rec = out.setdefault(f"{kind}:{axis}", {"calls": 0, "bytes": 0})
            rec["calls"] += 1
            rec["bytes"] += n
        return out


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0,
                         device="meta") -> RecordingMesh:
    """The JAX package's production mesh, as a :class:`RecordingMesh` of
    mesh rank ``rank``: ``(data 16, model 16)``, or with ``multi_pod``
    JAX's ``(pod 2, data 16, model 16)`` with ``"pod"`` folded into
    ``"data"`` as 32 (JAX's DP axes are ``("pod", "data")``, and every
    rule that cuts over ``"data"`` cuts over both, so each rank's blocks
    are the same).  Nothing runs across processes: the dry run builds one
    rank's step on ``device`` (the meta device, or the card with stand-in
    collectives) and records the collectives it would make."""
    D, M = (32, 16) if multi_pod else (16, 16)
    return RecordingMesh(group=None, rank=rank, size=D * M,
                         device=torch.device(device), backend="record",
                         world_rank=rank, world_size=D * M, model=M)
