"""Geometric multigrid preconditioner on the structured voxel hierarchy.

Port of ``exaconstit_tpu.solvers.gmg``: halve the element grid while
every dimension stays even, Galerkin-coarsen the EA element blocks
through the fixed trilinear embedding (RAP), and run a
Chebyshev(Jacobi)-smoothed V(1,1) cycle as the PCG preconditioner, with
a dense Cholesky solve on the coarsest level.  The hierarchy is rebuilt
from the current EA blocks every Newton iteration (the mesh moves).

Conventions: nodal fields flat (3*nn,) component planes, reshapeable to
(3, npz, npy, npx); EA blocks (24, 24, ne) with dof = a*3 + i; element
e = i + nx*(j + ny*k).  Coarse-level E <-> T maps are the strided
structured maps (``fem.space.StructuredMap``), so every level sums in a
fixed order.  The coarsest matrix is factored once per hierarchy rather
than once per cycle: the same numbers, less work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.space import StructuredMap

# dense-direct threshold for the coarsest level (3*nn dofs)
_COARSE_DOFS = 3000


def _grid_conn(nx, ny, nz):
    """Order-1 hex connectivity on an (nx, ny, nz) voxel grid."""
    npx, npy = nx + 1, ny + 1
    k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                          indexing="ij")
    base = (i + npx * (j + npy * k)).reshape(-1)
    loc = np.array([li + npx * (lj + npy * lk) for lk in (0, 1)
                    for lj in (0, 1) for li in (0, 1)])
    return (base[:, None] + loc[None, :]).astype(np.int64)


def _octant_weights():
    """W[o, a, b]: trilinear weight of coarse local node b at fine local
    node a of octant o; local node order x-fastest, a = px + 2py + 4pz."""
    W = np.zeros((8, 8, 8))
    for o in range(8):
        ox, oy, oz = o & 1, (o >> 1) & 1, (o >> 2) & 1
        for a in range(8):
            xi = ((ox + (a & 1)) / 2.0, (oy + ((a >> 1) & 1)) / 2.0,
                  (oz + ((a >> 2) & 1)) / 2.0)
            for b in range(8):
                bits = (b & 1, (b >> 1) & 1, (b >> 2) & 1)
                W[o, a, b] = np.prod([x if bit else 1 - x
                                      for x, bit in zip(xi, bits)])
    return W


def _dof_weights():
    """(8, 24, 24) octant weights expanded to dof level (kron with I3)."""
    W = _octant_weights()
    return np.stack([np.kron(W[o], np.eye(3)) for o in range(8)])


class GMGMeta:
    """Static per-mesh hierarchy metadata (host numpy)."""

    def __init__(self, structure):
        nx, ny, nz = (int(v) for v in structure)
        self.grids = [(nx, ny, nz)]
        while (nx % 2 == 0 and ny % 2 == 0 and nz % 2 == 0
               and 3 * (nx + 1) * (ny + 1) * (nz + 1) > _COARSE_DOFS):
            nx, ny, nz = nx // 2, ny // 2, nz // 2
            self.grids.append((nx, ny, nz))
        gx, gy, gz = self.grids[-1]
        # dense direct solve only when the coarsest level is small; an
        # odd-dimension early stop smooths heavily there instead
        self.coarse_dense = (3 * (gx + 1) * (gy + 1) * (gz + 1)
                             <= _COARSE_DOFS)
        self.nlevels = len(self.grids)
        self.maps = [StructuredMap(g) for g in self.grids]
        self.wd = _dof_weights()

    @property
    def usable(self):
        return self.nlevels >= 2


def _mask_blocks(k_cm, ess_el):
    """Zero rows/cols of element blocks (24, 24, ne) at essential dofs
    ess_el (24, ne)."""
    keep = 1.0 - ess_el.to(k_cm.dtype)
    return k_cm * keep[:, None, :] * keep[None, :, :]


def _rap(k_f, grid_f, wd):
    """Galerkin-coarsen (24, 24, ne_f) blocks to the half grid."""
    nx, ny, nz = grid_f
    kg = k_f.reshape(24, 24, nz, ny, nx)
    out = None
    for o in range(8):
        ox, oy, oz = o & 1, (o >> 1) & 1, (o >> 2) & 1
        ko = kg[:, :, oz::2, oy::2, ox::2]
        w = torch.as_tensor(wd[o], dtype=k_f.dtype, device=k_f.device)
        t = torch.einsum("ab,bcKJI->acKJI", w.T, ko)  # W^T K W per element
        t = torch.einsum("acKJI,cd->adKJI", t, w)
        out = t if out is None else out + t
    return out.reshape(24, 24, (nz // 2) * (ny // 2) * (nx // 2))


def _coarsen_field(a3, grid_f):
    """Node field (3, nn_f) -> (3, nn_c) by injection at even nodes."""
    nx, ny, nz = grid_f
    return a3.reshape(3, nz + 1, ny + 1, nx + 1)[:, ::2, ::2, ::2] \
        .reshape(3, -1)


def _prolong(c3, grid_f):
    """Coarse (3, nn_c) -> fine (3, nn_f) trilinear interpolation."""
    nx, ny, nz = grid_f
    g = c3.reshape(3, nz // 2 + 1, ny // 2 + 1, nx // 2 + 1)
    for axis, n_f in ((1, nz + 1), (2, ny + 1), (3, nx + 1)):
        pre = (slice(None),) * axis
        shape = list(g.shape)
        shape[axis] = n_f
        out = g.new_zeros(shape)
        out[pre + (slice(0, None, 2),)] = g
        n_c = g.shape[axis]
        out[pre + (slice(1, None, 2),)] = 0.5 * (g.narrow(axis, 0, n_c - 1)
                                                 + g.narrow(axis, 1, n_c - 1))
        g = out
    return g.reshape(3, -1)


def _restrict(r3, grid_f):
    """Adjoint of _prolong: fine (3, nn_f) -> coarse (3, nn_c)."""
    nx, ny, nz = grid_f
    g = r3.reshape(3, nz + 1, ny + 1, nx + 1)
    for axis in (1, 2, 3):
        pre = (slice(None),) * axis
        even = g[pre + (slice(0, None, 2),)]
        odd = 0.5 * g[pre + (slice(1, None, 2),)]
        n_c = even.shape[axis]
        out = even.clone()
        out.narrow(axis, 0, n_c - 1).add_(odd)
        out.narrow(axis, 1, n_c - 1).add_(odd)
        g = out
    return g.reshape(3, -1)


def _ea_matvec(k_cm, smap, x, ess1):
    """Masked EA matvec on a coarse level (flat component-major field)."""
    x = torch.where(ess1, 0.0, x)
    el_u = smap.gather(x)  # (3, 8, ne)
    u = el_u.transpose(0, 1).reshape(24, -1)
    y = torch.einsum("abe,be->ae", k_cm, u).reshape(8, 3, -1)
    out = smap.scatter_add(y.transpose(0, 1))
    return torch.where(ess1, x, out)


def _power_start(n, dtype, device):
    """Seeded start vector of the lambda_max power iteration."""
    v = np.random.default_rng(0).standard_normal(n)
    return torch.as_tensor(v, dtype=dtype, device=device)


def _power_lmax(matvec, dinv, n, dtype, iters=8):
    """Upper bound on lambda_max(D^-1 A) by power iteration (+10%)."""
    v = _power_start(n, dtype, dinv.device)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = dinv * matvec(v)
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    w = dinv * matvec(v)
    lam = torch.dot(v, w) / torch.clamp(torch.dot(v, v), min=1e-30)
    return 1.1 * lam


def _chebyshev(matvec, dinv, b, x, lmax, degree=3):
    """Chebyshev(Jacobi) smoothing on [0.3*lmax, 1.1*lmax]."""
    lmin = 0.3 * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = b - matvec(x)
    d = (dinv * r) / theta
    for _ in range(degree):
        x = x + d
        r = r - matvec(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (dinv * r)
        rho = rho_new
    return x


def _dense_factor(k, conn, ess, nn):
    """Cholesky factor of the assembled coarsest-level matrix.

    Assembled by 64 local-node-pair adds; within one pair every target
    entry is hit once, so the sums are order-independent."""
    n3 = 3 * nn
    idx = torch.as_tensor(conn[:, :, None] + nn * np.arange(3)[None, None],
                          device=k.device).reshape(-1, 24)  # (ne, 24)
    kb = k.permute(2, 0, 1)  # (ne, 24, 24)
    A = k.new_zeros((n3, n3))
    for a in range(8):
        rows = idx[:, 3 * a:3 * a + 3, None].expand(-1, 3, 3)
        for b in range(8):
            cols = idx[:, None, 3 * b:3 * b + 3].expand(-1, 3, 3)
            A.index_put_((rows, cols), kb[:, 3 * a:3 * a + 3, 3 * b:3 * b + 3],
                         accumulate=True)
    keep = 1.0 - ess.to(k.dtype)
    A = A * keep[:, None] * keep[None, :] + torch.diag(ess.to(k.dtype))
    eye = torch.eye(n3, dtype=k.dtype, device=k.device)
    # as jnp.linalg.cholesky: a matrix that is not positive definite gives
    # a NaN factor, not an exception, so the V-cycle returns NaN, PCG
    # stops on breakdown and the Newton step fails and is retried
    L, info = torch.linalg.cholesky_ex(A + 1e-12 * eye)
    return torch.where(info == 0, L, torch.nan)


def _dense_solve(level, b):
    L = level["chol"]
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]


def build_hierarchy(meta: GMGMeta, k_fine, ess_fine, fine_matvec,
                    fine_diag):
    """Level operators from the current fine EA blocks.

    k_fine (24, 24, ne); ess_fine flat (3*nn,) bool; fine_matvec and
    fine_diag are the production masked matvec and assembled diagonal
    of level 0.  Returns a list of per-level dicts (0 = finest)."""
    dtype = k_fine.dtype
    nn0 = ess_fine.numel() // 3
    dinv0 = 1.0 / fine_diag
    levels = [dict(matvec=fine_matvec, dinv=dinv0,
                   lmax=_power_lmax(fine_matvec, dinv0, ess_fine.numel(),
                                    dtype),
                   ess=ess_fine, grid=meta.grids[0], nn=nn0)]
    # eliminate fine essential dofs from the blocks once; RAP keeps it
    el_ess = meta.maps[0].gather(ess_fine.to(dtype))  # (3, 8, ne)
    k_cur = _mask_blocks(k_fine, el_ess.transpose(0, 1).reshape(24, -1)
                         > 0.5)
    ess3 = ess_fine.reshape(3, nn0)
    for lev in range(1, meta.nlevels):
        grid_f = meta.grids[lev - 1]
        k_cur = _rap(k_cur, grid_f, meta.wd)
        ess3 = _coarsen_field(ess3, grid_f)
        ess1 = ess3.reshape(-1)
        nn = ess1.numel() // 3
        smap = meta.maps[lev]
        dloc = torch.diagonal(k_cur, dim1=0, dim2=1).T.reshape(8, 3, -1)
        diag = torch.where(ess1, 1.0, smap.scatter_add(dloc.transpose(0, 1)))
        diag = torch.where(torch.abs(diag) > 1e-30, diag, 1.0)

        def mv(x, k_lev=k_cur, smap=smap, ess_lev=ess1):
            return _ea_matvec(k_lev, smap, x, ess_lev)

        dinv = 1.0 / diag
        level = dict(matvec=mv, dinv=dinv,
                     lmax=_power_lmax(mv, dinv, 3 * nn, dtype), ess=ess1,
                     grid=meta.grids[lev], nn=nn)
        if lev == meta.nlevels - 1 and meta.coarse_dense:
            level["chol"] = _dense_factor(k_cur, _grid_conn(*meta.grids[lev]),
                                          ess1, nn)
        levels.append(level)
    return levels


def v_cycle(levels, r, degree=3, coarse_dense=True):
    """One V(1,1) cycle; returns z ~= A^-1 r (symmetric in the A inner
    product, so a valid PCG preconditioner)."""

    def cycle(lev, b):
        L = levels[lev]
        if lev == len(levels) - 1:
            if coarse_dense:
                return _dense_solve(L, b)
            return _chebyshev(L["matvec"], L["dinv"], b, torch.zeros_like(b),
                              L["lmax"], 24)
        x = _chebyshev(L["matvec"], L["dinv"], b, torch.zeros_like(b),
                       L["lmax"], degree)
        r = torch.where(L["ess"], 0.0, b - L["matvec"](x))
        rc = _restrict(r.reshape(3, L["nn"]), L["grid"]).reshape(-1)
        rc = torch.where(levels[lev + 1]["ess"], 0.0, rc)
        zc = cycle(lev + 1, rc)
        zf = _prolong(zc.reshape(3, levels[lev + 1]["nn"]),
                      L["grid"]).reshape(-1)
        x = x + torch.where(L["ess"], 0.0, zf)
        return _chebyshev(L["matvec"], L["dinv"], b, x, L["lmax"], degree)

    return cycle(0, r)
