"""Shards within a rank, ranks within a process group: the layout and
the collectives of the slab domain decomposition and of the
replicated-node element sharding.

Port of ``exaconstit_tpu.parallel.sharding`` and of the multi-process
start of ``exaconstit_tpu.cli``.  The JAX package spreads a run over a
device mesh that may span processes; here a run is spread over ``S``
shards, ``S_local = S / world_size`` consecutive shards on each rank's
one device, stacked along a leading shard axis.  One process with ``S``
shards is the counterpart of the JAX tests' ``S`` virtual devices (and
how one card runs the slab); one shard per rank is the usual PyTorch
layout, one process per GPU.

The collectives are the JAX package's: ``psum`` and ``pmax`` become a
local reduction over the shard axis followed by ``dist.all_reduce``,
``process_allgather`` becomes ``allgather_blocks`` and ``ppermute``
becomes ``exchange`` (a shift along the shard axis within a rank, one
``batch_isend_irecv`` pair per neighbouring rank).  Whenever a process
group is initialised they go through it, at world size 1 too; without
one a run is a single rank.  ``init_distributed`` starts the group from
a launcher's environment: NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")
# the process group's backend for each device type
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def pad_elements(n_elems: int, n_shards: int) -> int:
    """Padded element count (next multiple of n_shards)."""
    return ((n_elems + n_shards - 1) // n_shards) * n_shards


def process_group_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_rank() -> int:
    """This process's rank (0 without a process group): only rank 0
    writes files."""
    return dist.get_rank() if process_group_active() else 0


def world_size() -> int:
    return dist.get_world_size() if process_group_active() else 1


def init_distributed(device="cuda") -> torch.device:
    """Start the process group when a launcher asks for one, and return
    the device this rank runs on.

    A launch is ``torchrun`` (it sets ``TORCHELASTIC_RUN_ID``) or any
    launcher that sets ``EXACONSTIT_TPU_DIST=1``; either provides
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``.  On ``cuda`` each rank takes the card
    ``cuda:LOCAL_RANK`` over NCCL; on ``cpu`` the ranks talk over gloo.
    Without a launch ``device`` is returned as given.  A missing
    variable, a rank without a card of its own (NCCL runs one rank per
    card), or a group that fails its first reduction stops the run."""
    env = os.environ
    device = torch.device(device)
    if env.get("EXACONSTIT_TPU_DIST") != "1" and \
            "TORCHELASTIC_RUN_ID" not in env:
        return device
    missing = [k for k in _LAUNCH_VARS if k not in env]
    if missing:
        raise RuntimeError(f"a distributed launch needs {missing} in the "
                           "environment")
    rank, world, local = (int(env[k]) for k in _LAUNCH_VARS[:3])
    if device.type not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but torch finds no CUDA "
                "device; pass --device cpu to run the ranks on the CPU")
        cards = torch.cuda.device_count()
        if local >= cards:
            raise RuntimeError(
                f"rank {rank} is local rank {local} but {cards} card(s) "
                "are visible: NCCL runs one rank per card (put several "
                "shards on one card with --shards instead)")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    dist.init_process_group(
        _BACKENDS[device.type],
        init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        rank=rank, world_size=world,
        device_id=device if device.type == "cuda" else None)
    one = torch.ones(1, device=device)
    dist.all_reduce(one)
    if int(one.item()) != world:
        raise RuntimeError(f"the process group's first reduction gave "
                           f"{one.item()}, not its world size {world}")
    return device


def shutdown_distributed():
    if process_group_active():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """``n_shards`` shards over the ranks of the process group (or one
    rank without one): this rank holds shards ``first`` to
    ``first + s_local - 1`` on ``device``."""

    n_shards: int
    world_size: int
    rank: int
    device: torch.device
    distributed: bool  # a process group carries the collectives

    @classmethod
    def create(cls, n_shards: int, device) -> "ShardLayout":
        device = torch.device(device)
        active = process_group_active()
        world, rank = world_size(), process_rank()
        if active and _BACKENDS.get(device.type) != dist.get_backend():
            raise ValueError(
                f"a {device.type} run needs the "
                f"{_BACKENDS.get(device.type)} backend, the process group "
                f"has {dist.get_backend()}")
        if n_shards < 1 or n_shards % world:
            raise ValueError(f"{n_shards} shards do not divide over "
                             f"{world} ranks")
        return cls(n_shards, world, rank, device, active)

    @property
    def s_local(self) -> int:
        return self.n_shards // self.world_size

    @property
    def first(self) -> int:
        return self.rank * self.s_local

    def allreduce_sum(self, t):
        """Sum of ``t`` over the ranks (a fresh tensor: reduced in
        place)."""
        return self._allreduce(t, dist.ReduceOp.SUM)

    def allreduce_max(self, t):
        return self._allreduce(t, dist.ReduceOp.MAX)

    def _allreduce(self, t, op):
        t = t.contiguous()
        if self.distributed:
            dist.all_reduce(t.view(-1), op=op)
        return t

    def sum_shards(self, x, axis, keep=0):
        """The sum of ``x`` over all its axes but the first ``keep`` ones,
        and over every rank's shards: axis ``axis`` of ``x`` is this
        rank's.  Every rank reduces the same (n_shards, ...) stack of
        shard blocks (zero blocks for the other ranks' shards), so each
        shard's sum rounds alike whatever the ranks; the sums are added in
        shard order after a reduction that adds only zeros to them, as
        the reference's ``psum`` of per-device sums.  One rank holds every
        shard: it adds them before the reduction, which then moves one
        sum."""
        blocks = x.movedim(axis, 0)
        if self.world_size == 1:
            stack = blocks.contiguous()
        else:
            stack = x.new_zeros((self.n_shards,) + blocks.shape[1:])
            stack[self.first:self.first + self.s_local] = blocks
        dims = tuple(range(1 + keep, stack.ndim))
        parts = stack.sum(dim=dims) if dims else stack  # () sums all
        if self.world_size == 1:
            return self.allreduce_sum(parts.sum(dim=0))
        return self.allreduce_sum(parts).sum(dim=0)

    def allgather_blocks(self, t):
        """(world_size, *t.shape): every rank's ``t``, in rank order."""
        t = t.contiguous()
        if not self.distributed:
            return t[None]
        out = t.new_empty((self.world_size * t.numel(),))
        dist.all_gather_into_tensor(out, t.reshape(-1))
        return out.reshape(self.world_size, *t.shape)

    def exchange(self, up, dn):
        """The halo exchange of partial sums along the shard axis (axis
        1 of ``up`` and ``dn``, each (c, s_local, m)): ``up[:, s]`` holds
        shard s's partials for the nodes it shares with shard s + 1,
        ``dn[:, s]`` those for shard s - 1.  Returns (from_below,
        from_above): what shard s receives from shard s - 1 and from
        s + 1, zero at the ends of the global shard axis."""
        from_below = torch.zeros_like(up)
        from_above = torch.zeros_like(dn)
        from_below[:, 1:] = up[:, :-1]
        from_above[:, :-1] = dn[:, 1:]
        if not self.distributed or self.world_size == 1:
            return from_below, from_above
        ops, fills = [], []
        for peer, send, into in (
                (self.rank + 1, up[:, -1], from_above[:, -1]),
                (self.rank - 1, dn[:, 0], from_below[:, 0])):
            if not 0 <= peer < self.world_size:
                continue
            buf = torch.empty_like(into)
            ops += [dist.P2POp(dist.isend, send.contiguous(), peer),
                    dist.P2POp(dist.irecv, buf, peer)]
            fills.append((into, buf))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for into, buf in fills:
            into.copy_(buf)
        return from_below, from_above
