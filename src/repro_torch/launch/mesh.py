"""The 1-D "data" mesh of the distributed pipeline, over ``torch.distributed``.

The JAX package runs one controller over a ``shard_map`` mesh.  Here each
shard is a rank of a process group (SPMD): every rank calls the same
entry point with the same inputs, computes its own row block
(``runtime/sharding.py``), and the collectives the JAX stages use become
the :class:`DataMesh` methods: ``ppermute`` one step along the ring is
:meth:`DataMesh.ring_shift`, ``all_gather(tiled=True)`` is
:meth:`DataMesh.all_gather`, ``psum`` is :meth:`DataMesh.all_reduce_sum`
(added in rank order).

The transport follows the group's backend.  NCCL moves the tensors on
the card.  Gloo moves host tensors: a tensor on the card is copied to the
host, moved, and copied back (two processes that share one card can only
talk through gloo, since NCCL takes one rank a GPU).  A failing
collective raises; nothing retries it another way.

The mesh is the first ``data`` ranks of the world (0 means all of them),
as a subgroup when it is smaller than the world; the other ranks are
outside it (``rank == -1``) and receive the mesh's result by
:func:`broadcast_from_mesh`.  With no process group, :func:`make_data_mesh`
makes a world of one: NCCL on the card, gloo when the caller asked for
the CPU.  On a host with several cards, ``torchrun --nproc_per_node=P``
starts the ranks; each takes the card of its ``LOCAL_RANK``.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

_SUBGROUPS: dict = {}       # (world group id, P) -> the subgroup of P ranks


@dataclasses.dataclass
class DataMesh:
    """One rank's view of the data mesh."""
    group: object           # the mesh's process group (None outside it)
    rank: int               # this rank's shard index, -1 outside the mesh
    size: int               # shards P
    device: torch.device    # where this rank's stages run
    backend: str            # "nccl" or "gloo"
    world_rank: int
    world_size: int

    @property
    def in_mesh(self) -> bool:
        return self.rank >= 0

    @property
    def shape(self) -> dict:
        """The axis sizes, JAX's ``mesh.shape``: ``{"data": P, "model":
        1}`` (the partition rules of ``runtime/sharding.py`` read it)."""
        return {"data": self.size, "model": 1}

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

    def all_gather_list(self, t: torch.Tensor) -> list:
        """Every rank's ``t``, in rank order (equal shapes)."""
        if self.size == 1:
            return [t]
        w = self._wire(t)
        out = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(out, w, group=self.group)
        return [o.to(self.device) for o in out]

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated along axis 0 in rank order."""
        if self.size == 1:
            return t
        return torch.cat(self.all_gather_list(t))

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, added in rank order.

        The backend's own reduction adds in an order of its choosing, so
        this one is spelled out: ``t`` is cut into P blocks, an all-to-all
        hands rank r block r of every rank, rank r adds them in rank
        order, and an all-gather returns the sums.  Every rank holds the
        same bits, two runs agree, and the bits do not depend on the
        backend (an f32 add rounds alike on the host and the card).  A
        rank moves about 2 (P-1)/P times ``t``'s bytes, as in a ring
        all-reduce, and holds three copies of ``t`` at most."""
        P = self.size
        if P == 1:
            return t
        flat = t.reshape(-1)
        n = flat.numel()
        blk = -(-n // P)
        w = self._wire(torch.nn.functional.pad(flat, (0, blk * P - n)))
        parts = torch.empty_like(w)
        dist.all_to_all_single(parts, w, group=self.group)
        parts = parts.view(P, blk)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        out = torch.empty_like(w)
        dist.all_gather(list(out.view(P, blk).unbind(0)), acc,
                        group=self.group)
        return out[:n].view(t.shape).to(self.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Mesh rank ``src``'s ``t`` on every rank of the mesh."""
        if self.size == 1:
            return t
        w = self._wire(t)
        dist.broadcast(w, src, group=self.group)
        return w.to(self.device)

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


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
    if P == world:
        group = dist.group.WORLD
    else:
        key = (id(dist.distributed_c10d._get_default_group()), P)
        if key not in _SUBGROUPS:
            _SUBGROUPS[key] = dist.new_group(list(range(P)), backend=backend)
        group = _SUBGROUPS[key]
    inside = wrank < P
    return DataMesh(group=group if inside else None,
                    rank=wrank if inside else -1, size=P, device=dev,
                    backend=backend, world_rank=wrank, world_size=world)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device="cuda") -> DataMesh:
    """The JAX package's ``make_host_mesh``: the data mesh over
    ``min(data, world)`` ranks, as JAX clamps ``data`` to the devices.
    ``model > 1`` raises: tensor parallelism over ``"model"`` is ROADMAP
    Queue 1 item 7 step 8."""
    if model > 1:
        raise ValueError(f"make_host_mesh: model={model}: tensor "
                         "parallelism over 'model' is ROADMAP Queue 1 item "
                         "7 step 8; the port's meshes have model = 1")
    return make_data_mesh(max(1, int(data)), device=device)


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
