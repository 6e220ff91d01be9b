"""Block-partitioned (slab) domain decomposition with halo exchange.

Port of ``exaconstit_tpu.parallel.slab``.  Elements are split into
contiguous blocks, one per shard; every shard owns the nodes its
elements touch (the boundary node planes are shared with the
neighbouring block), and the E->T scatter-add becomes a local
scatter-add plus a neighbour-only halo exchange: per matvec two node
planes of 3-vectors cross each shard boundary, not the whole nodal
vector.  Reductions (dots, norms, volume averages) mask the node copies
a shard does not own and sum over all shards.

The partition comes from the connectivity alone, so it serves voxel and
mesh-file meshes alike, as long as node sharing is neighbour-local in
the element order (lexicographic voxel bricks and meshes ordered along
one axis; a brick's blocks must be whole z-layers).

``build_slab_partition`` and the host conversions are the reference's
numpy.  ``SlabMap`` is the device side for one rank's stacked shards,
component-major like ``fem/space``'s maps: nodal vectors are flat
(3 * S_local * (n_loc + 1),) planes [vx | vy | vz], each plane the
rank's shards one after another with a trash row at the end of each,
and element vectors are (3, nen, S_local * ne_per).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fem.space import IndexMap
from .sharding import ShardLayout, pad_elements


@dataclasses.dataclass(frozen=True)
class SlabPartition:
    """Static partition data (numpy, stacked over the shard axis)."""

    n_shards: int
    ne_per: int            # elements per shard (padded)
    n_loc: int             # local node slots per shard (max, padded)
    m_halo: int            # halo exchange slots (max, padded)
    glob_nodes: np.ndarray  # (S, n_loc) global node id per local slot (-1 pad)
    conn_local: np.ndarray  # (S, ne_per, nen) local node indices
    elem_mask: np.ndarray   # (S, ne_per) 1.0 for real elements
    owner_mask: np.ndarray  # (S, n_loc + 1) 1.0 where this shard owns node
    send_up: np.ndarray     # (S, m_halo) local idx shared with shard s+1
    recv_dn: np.ndarray     # (S, m_halo) local idx for data from shard s-1
    send_dn: np.ndarray     # (S, m_halo) local idx shared with shard s-1
    recv_up: np.ndarray     # (S, m_halo) local idx for data from shard s+1
    elem_perm: np.ndarray   # (S * ne_per,) original element index (padded)

    @property
    def trash(self):
        """Dead local row used for halo/scatter padding."""
        return self.n_loc


def build_slab_partition(conn: np.ndarray, num_nodes: int,
                         n_shards: int) -> SlabPartition:
    """Partition elements into contiguous blocks; derive local numbering,
    ownership, and neighbor halo exchange lists.

    Raises ValueError if any node is shared between non-adjacent blocks
    (the caller should fall back to the replicated-node path).
    """
    ne = conn.shape[0]
    nen = conn.shape[1]
    ne_pad = pad_elements(ne, n_shards)
    ne_per = ne_pad // n_shards
    perm = np.arange(ne_pad)
    perm[ne:] = 0  # pad with copies of element 0 (masked)
    conn_pad = conn[perm]  # (ne_pad, nen)
    elem_mask = (perm_mask := np.zeros(ne_pad))
    perm_mask[:ne] = 1.0
    blocks = conn_pad.reshape(n_shards, ne_per, nen)
    mask_blk = elem_mask.reshape(n_shards, ne_per)

    glob, conn_local, owner, shared_up = [], [], [], []
    node_owner = np.full(num_nodes, -1, dtype=np.int64)
    for s in range(n_shards):
        nodes = np.unique(blocks[s])
        glob.append(nodes)
        lut = np.full(num_nodes, -1, dtype=np.int64)
        lut[nodes] = np.arange(nodes.size)
        conn_local.append(lut[blocks[s]])
        first = node_owner[nodes] == -1
        node_owner[nodes[first]] = s
        owner.append(node_owner[nodes] == s)

    # neighbor sharing (and check nothing is shared farther than +-1)
    seen_by = {}
    for s in range(n_shards):
        for nd in glob[s]:
            seen_by.setdefault(int(nd), []).append(s)
    for nd, ss in seen_by.items():
        if ss[-1] - ss[0] > 1:
            raise ValueError(
                f"node {nd} shared by non-adjacent blocks {ss}; "
                "slab partition needs axis-ordered elements")

    for s in range(n_shards):
        if s + 1 < n_shards:
            sh = np.intersect1d(glob[s], glob[s + 1])
        else:
            sh = np.zeros(0, dtype=np.int64)
        shared_up.append(sh)

    n_loc = max(g.size for g in glob)
    m_halo = max(1, max(sh.size for sh in shared_up))
    trash = n_loc

    S = n_shards
    glob_nodes = np.full((S, n_loc), -1, dtype=np.int64)
    conn_l = np.zeros((S, ne_per, nen), dtype=np.int32)
    owner_mask = np.zeros((S, n_loc + 1))
    send_up = np.full((S, m_halo), trash, dtype=np.int32)
    recv_dn = np.full((S, m_halo), trash, dtype=np.int32)
    send_dn = np.full((S, m_halo), trash, dtype=np.int32)
    recv_up = np.full((S, m_halo), trash, dtype=np.int32)
    for s in range(S):
        g = glob[s]
        glob_nodes[s, :g.size] = g
        conn_l[s] = conn_local[s]
        owner_mask[s, :g.size] = owner[s].astype(float)
        lut = np.full(num_nodes, trash, dtype=np.int64)
        lut[g] = np.arange(g.size)
        if s + 1 < S:
            sh = shared_up[s]
            send_up[s, :sh.size] = lut[sh]
            # shard s+1's local indices of the same (sorted) globals
            lut1 = np.full(num_nodes, trash, dtype=np.int64)
            lut1[glob[s + 1]] = np.arange(glob[s + 1].size)
            recv_dn[s + 1, :sh.size] = lut1[sh]
            send_dn[s + 1, :sh.size] = lut1[sh]
            recv_up[s, :sh.size] = lut[sh]

    return SlabPartition(
        n_shards=S, ne_per=ne_per, n_loc=n_loc, m_halo=m_halo,
        glob_nodes=glob_nodes, conn_local=conn_l, elem_mask=mask_blk,
        owner_mask=owner_mask, send_up=send_up, recv_dn=recv_dn,
        send_dn=send_dn, recv_up=recv_up, elem_perm=perm)


# ---- conversions (host side) ----------------------------------------------

def to_local(part: SlabPartition, tvec_global: np.ndarray) -> np.ndarray:
    """(num_nodes, c) -> (S, n_loc + 1, c) with zero trash row."""
    out = np.zeros((part.n_shards, part.n_loc + 1) + tvec_global.shape[1:],
                   dtype=tvec_global.dtype)
    for s in range(part.n_shards):
        g = part.glob_nodes[s]
        real = g >= 0
        out[s, :real.sum()] = tvec_global[g[real]]
    return out


def to_global(part: SlabPartition, tvec_local: np.ndarray,
              num_nodes: int) -> np.ndarray:
    """(S, n_loc + 1, c) -> (num_nodes, c), owner rows win."""
    out = np.zeros((num_nodes,) + tvec_local.shape[2:],
                   dtype=tvec_local.dtype)
    for s in range(part.n_shards):
        g = part.glob_nodes[s]
        own = (part.owner_mask[s, :part.n_loc] > 0) & (g >= 0)
        out[g[own]] = tvec_local[s, :part.n_loc][own]
    return out


# ---- device side: one rank's stacked shards --------------------------------

class SlabMap:
    """The E <-> T maps of one rank's shards (``layout``), with the same
    interface as ``fem/space.StructuredMap`` and ``IndexMap`` (``gather``,
    ``scatter_add``) plus the owner-masked ``dot``.

    The local scatter is an ``IndexMap`` over the rank's
    ``S_local * (n_loc + 1)`` node slots (each shard's connectivity
    offset by its first slot): gathers and slot-by-slot adds, no
    atomics.  It skips the pad elements (copies of element 0), zeroes
    the trash rows, and adds the partial sums the neighbouring shards
    hold for the shared nodes: both directions send the partials taken
    before either add."""

    # the reference's slab runs every assembly warm-started: MechSystem
    # keeps no point-major half on this map
    warm_everywhere = True

    def __init__(self, part: SlabPartition, layout: ShardLayout):
        self.part, self.layout = part, layout
        sl, nl1 = layout.s_local, part.n_loc + 1
        mine = slice(layout.first, layout.first + sl)
        self.ntot = sl * nl1
        self.ne = sl * part.ne_per  # the rank's elements, pads included
        off = np.arange(sl) * nl1
        conn = part.conn_local[mine] + off[:, None, None]
        device = layout.device
        self.index = IndexMap(conn.reshape(-1, conn.shape[-1]), self.ntot,
                              device=device)

        def rows(a):  # (sl, m) local indices -> slots of the stack
            return torch.as_tensor(a[mine] + off[:, None], device=device)

        self.send_up, self.recv_dn = rows(part.send_up), rows(part.recv_dn)
        self.send_dn, self.recv_up = rows(part.send_dn), rows(part.recv_up)
        self.trash = torch.as_tensor(off + part.trash, device=device)
        self.real = torch.as_tensor(part.elem_mask[mine].reshape(-1) > 0,
                                    device=device)  # (S_local * ne_per,)
        self.owned = torch.as_tensor(np.tile(
            part.owner_mask[mine].reshape(-1) > 0, 3), device=device)
        # the slots that hold no node: each shard's trash row and the
        # slots past a shard's last node when it has fewer than n_loc
        dead = np.ones((sl, nl1), dtype=bool)
        dead[:, :part.n_loc] = part.glob_nodes[mine] < 0
        self.dead_dofs = torch.as_tensor(np.tile(dead.reshape(-1), 3),
                                         device=device)

    def gather(self, tvec):
        """Flat nodal field -> (3, nen, S_local * ne_per)."""
        return self.index.gather(tvec)

    def scatter_add(self, evec):
        """(3, nen, S_local * ne_per) element vectors -> flat nodal sums,
        complete on every copy of a shared node."""
        local = self.index.scatter_add(torch.where(self.real, evec, 0.0))
        return self.exchange_add(local.reshape(3, self.ntot)).reshape(-1)

    def exchange_add(self, y):
        """(3, ntot) local partial sums -> the same with the neighbours'
        partials added at the shared nodes (in place)."""
        y[:, self.trash] = 0.0
        from_below, from_above = self.layout.exchange(y[:, self.send_up],
                                                      y[:, self.send_dn])
        y[:, self.recv_dn] += from_below
        y[:, self.recv_up] += from_above
        y[:, self.trash] = 0.0
        return y

    def halo_bytes(self, dtype):
        """Bytes that one exchange moves across each shard boundary: the
        shared node plane's 3-vectors, in both directions."""
        return 2 * self.part.m_halo * 3 * torch.finfo(dtype).bits // 8

    def dot(self, a, b):
        """Owner-masked global dot product of two flat nodal vectors, in
        their dtype (an f32 recurrence stays f32): ``ShardLayout.
        sum_shards`` of the per-shard sums."""
        prod = torch.where(self.owned, a * b, 0.0)
        return self.layout.sum_shards(prod.view(3, self.layout.s_local, -1),
                                      axis=1)
