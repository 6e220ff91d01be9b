"""Slab-partitioned MechSystem: the halo-exchange system over shards and
``torch.distributed`` ranks.

Port of ``exaconstit_tpu.parallel.slab_system``.  The node space is
block-partitioned with the elements (``parallel/slab.py``): the E->T
scatter-add is a local scatter-add plus a neighbour-only halo exchange,
and every reduction (dots, norms, volume averages, the largest
deformation rate) is owner- or element-masked and summed over all
shards.  Per Krylov iteration two node planes cross each shard
boundary.

Layouts, component-major on each rank's device (``S_local`` stacked
shards, see ``parallel/sharding.py``):

* nodal vectors: flat (3 * S_local * (n_loc + 1),), each component
  plane the rank's shards' local nodes and a trash row per shard;
* point fields: (k, nq * S_local * ne_per) in partition order, pad
  elements (copies of element 0) included.

The host side still speaks the reference's global point-major shapes:
``to_node`` / ``from_node``, ``to_state`` / ``from_state`` and
``from_elem`` convert, and the ``from_*`` gather over all ranks, so
every rank must reach them.  ``MechSystem``'s Newton, line search,
SolveInit, ``make_step``, its setup, residual, operator and Krylov
code and its pad-masked volume averages and largest deformation rate
run unchanged on these layouts: the element map is the slab's
``SlabMap``, and the inner products and norms go through the
owner-masked ``dot``.

The numbers are the reference slab's, which differ from the
single-device system's: the operator is built in the run's dtype (no
f32 EA build), the only preconditioner is Jacobi, the point solve is
warm-started on every assembly (PA and B-bar too), the solver must be
PCG, and the slots that hold no node get a unit diagonal.  The point
solve runs once per rank over all of its stacked points, pad elements
included: on the card that is one launch of the dogleg kernel per setup
per rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.options import KrylovSolver
from ..driver import MechSystem, resolve_device
from .sharding import ShardLayout
from .slab import SlabMap, build_slab_partition, to_global, to_local


class SlabMechSystem(MechSystem):
    """``MechSystem`` over ``n_shards`` slab shards of the mesh, spread
    over the ranks of the process group (one rank without one)."""

    def __init__(self, opt, mesh, model, n_shards, device="cuda",
                 warm_start=None):
        if opt.solver != KrylovSolver.PCG:
            raise ValueError("slab mode supports the PCG Krylov path; "
                             "set Solvers.Krylov.solver = 'PCG'")
        layout = ShardLayout.create(n_shards, resolve_device(device))
        self.part = build_slab_partition(np.asarray(mesh.conn),
                                         mesh.num_nodes, n_shards)
        # the slab's map makes the system the reference's slab: warm
        # point solves everywhere (unless ``warm_start`` is off), Jacobi
        # only, the f64 EA build and storage, one setup chunk
        super().__init__(opt, mesh, model, device=device, ea_asm_f32=False,
                         emap=SlabMap(self.part, layout), ea_f32=False,
                         warm_start=warm_start)

    # -- per-iteration compute ----------------------------------------------

    def setup(self, *args):
        """``MechSystem.setup`` with a unit diagonal on the slots that
        hold no node, so Jacobi stays finite there (their residual and
        dot contributions are zero)."""
        r, k_data, diag, *rest = super().setup(*args)
        return (r, k_data, torch.where(self.emap.dead_dofs, 1.0, diag),
                *rest)

    def dot(self, a, b):
        return self.emap.dot(a, b)

    def norm(self, r):
        return torch.sqrt(self.dot(r, r))

    # -- layout adapters (host global point-major <-> device slab) ----------

    def _mine(self, stacked):
        """This rank's shards of a host array stacked over all of them."""
        lay = self.layout
        return stacked[lay.first:lay.first + lay.s_local]

    def to_node(self, arr):
        """Host (nn, c) nodal field -> flat (c * S_local * (n_loc+1),)."""
        loc = self._mine(to_local(self.part, np.asarray(arr)))
        return torch.as_tensor(
            np.moveaxis(loc, -1, 0).reshape(-1),
            dtype=self.dtype if loc.dtype != bool else torch.bool,
            device=self.device)

    def from_node(self, dev):
        """Flat slab nodal vector -> host (nn, 3), gathered over the
        ranks (owner rows win)."""
        p, lay = self.part, self.layout
        a = lay.allgather_blocks(dev).cpu().numpy().reshape(
            lay.world_size, 3, lay.s_local, p.n_loc + 1)
        loc = a.transpose(0, 2, 3, 1).reshape(p.n_shards, p.n_loc + 1, 3)
        return to_global(p, loc, self.nn)

    def to_ess(self, mask):
        return self.to_node(np.asarray(mask, dtype=bool))

    def permute_elems(self, arr_global):
        """Host (ne, ...) element array -> this rank's (S_local * ne_per,
        ...) in partition order."""
        return self._mine(arr_global[self.part.elem_perm].reshape(
            self.part.n_shards, self.part.ne_per, *arr_global.shape[1:])
        ).reshape(self.ne, *arr_global.shape[1:])

    def unpermute_elems(self, blocks):
        """(world_size, S_local * ne_per, ...) host blocks in partition
        order -> (ne, ...) in the original element order."""
        a = blocks.reshape(-1, *blocks.shape[2:])
        out = np.empty((self.fes.num_elems,) + a.shape[1:], dtype=a.dtype)
        real = self.part.elem_mask.reshape(-1) > 0
        out[self.part.elem_perm[real]] = a[real]
        return out

    def to_state(self, pm):
        """Host (ne, nq, k) point field -> (k, nq * S_local * ne_per)."""
        a = self.permute_elems(np.asarray(pm)[:self.fes.num_elems])
        return torch.as_tensor(a.transpose(2, 1, 0).reshape(a.shape[2], -1),
                               dtype=self.dtype, device=self.device)

    def from_state(self, dev):
        """(k, nq * S_local * ne_per) -> host (ne, nq, k), gathered over
        the ranks."""
        a = self.layout.allgather_blocks(dev).cpu().numpy()
        a = a.reshape(a.shape[0], a.shape[1], self.nq, self.ne)
        return self.unpermute_elems(a.transpose(0, 3, 2, 1))

    to_stress = to_state
    from_stress = from_state

    def from_elem(self, dev):
        """(k, S_local * ne_per) per-element field -> host (ne, k),
        gathered over the ranks."""
        a = self.layout.allgather_blocks(dev).cpu().numpy()
        return self.unpermute_elems(a.transpose(0, 2, 1))
