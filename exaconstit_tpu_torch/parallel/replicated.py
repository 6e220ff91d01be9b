"""Replicated-node element sharding: the elements spread over shards and
``torch.distributed`` ranks, every nodal vector whole on every rank.

Port of the ``device_mesh`` branch of ``exaconstit_tpu.driver.
MechSystem`` (and of ``exaconstit_tpu.parallel.sharding``'s padding):
the reference's fallback for what the slab does not cover (a UMAT,
MINRES and GMRES, a mesh whose element order shares nodes between
blocks that are not neighbours).  The element list is padded to the
next multiple of the shard count with copies of element 0, appended at
the end, and cut into contiguous blocks of ``ne_pad / S`` elements in
the mesh's own order; a rank holds ``S_local`` consecutive blocks
stacked on its device (``sharding.ShardLayout``).  The E->T scatter-add
is each shard's partial sum over all the nodes, then their sum over the
shards in shard order (``ShardLayout.sum_shards``: one all-reduce of a
nodal vector when one rank holds every shard); Krylov's dots and norms
run on the replicated vectors with no collective.

``ReplicatedMap`` is the device side, with the interface of
``fem/space``'s maps and ``parallel/slab.SlabMap`` (``gather``,
``scatter_add``, ``ne``, ``real``, ``layout``): nodal vectors are flat
(3 * nn,) planes [vx | vy | vz] and element vectors (3, nen, S_local *
ne_per).  Handed to ``MechSystem(emap=...)`` it makes the system the
reference's on a device mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.space import IndexMap
from .sharding import ShardLayout, pad_elements


class ReplicatedMap:
    """The E <-> T maps of one rank's shards of the padded element list.

    Each shard's scatter-add is an ``IndexMap`` incidence table of its
    block over all ``nn`` nodes (the pad elements left out, so their
    force, operator and diagonal never reach a node, as the reference's
    ``elem_mask`` does), summed slot by slot with no atomics; every
    shard's table has the longest valence of all shards, so the tables
    are alike however the shards are spread over the ranks."""

    def __init__(self, conn, num_nodes: int, layout: ShardLayout):
        conn = np.asarray(conn, dtype=np.int64)
        ne, nen = conn.shape
        S, sl = layout.n_shards, layout.s_local
        self.layout = layout
        self.nn = int(num_nodes)
        self.ne_pad = pad_elements(ne, S)
        self.ne_per = self.ne_pad // S
        self.ne = sl * self.ne_per  # the rank's elements, pads included
        device = layout.device
        perm = np.arange(self.ne_pad)
        perm[ne:] = 0  # pad with copies of element 0
        real = np.arange(self.ne_pad) < ne
        mine = slice(layout.first * self.ne_per,
                     (layout.first + sl) * self.ne_per)
        self.conn_t = torch.as_tensor(
            np.ascontiguousarray(conn[perm][mine].T), device=device)
        self.real = torch.as_tensor(real[mine], device=device)
        # each shard's block with its pads on a node past the last one
        # (dropped below), so no table lists them
        blocks = np.where(real[:, None], conn[perm], self.nn).reshape(
            S, self.ne_per, nen)
        valence = max(int(np.bincount(b[b < self.nn].reshape(-1)).max(
            initial=0)) for b in blocks)
        slot = nen * self.ne_per + 1  # a block's element slots and a zero
        valence = max(valence, 1)
        tables = np.full((valence, sl, self.nn), slot - 1, dtype=np.int64)
        for s in range(sl):
            # past its real nodes' valence a table lists only the zero
            t = IndexMap(blocks[layout.first + s], self.nn + 1).table.numpy()
            tables[:min(valence, t.shape[0]), s] = t[:valence, :self.nn]
            tables[:, s] += s * slot
        self.table = torch.as_tensor(tables, device=device)

    def gather(self, tvec):
        """Flat (3*nn,) nodal field -> (3, nen, S_local * ne_per)."""
        return tvec.reshape(3, self.nn)[:, self.conn_t]

    def scatter_add(self, evec):
        """(3, nen, S_local * ne_per) element vectors -> flat (3*nn,)
        sums over every rank's real elements, the same on every rank."""
        sl = self.layout.s_local
        nen = evec.shape[1]
        ev = evec.reshape(3, nen, sl, self.ne_per).transpose(1, 2).reshape(
            3, sl, nen * self.ne_per)
        ev = torch.cat([ev, ev.new_zeros((3, sl, 1))], dim=2).reshape(3, -1)
        parts = ev[:, self.table]  # (3, valence, S_local, nn)
        out = parts[:, 0]
        for k in range(1, parts.shape[1]):
            out = out + parts[:, k]
        return self.layout.sum_shards(out, axis=1, keep=2).reshape(-1)
