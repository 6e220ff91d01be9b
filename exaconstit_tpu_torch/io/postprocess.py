"""Element-averaged fields for visualization, and the dump itself.

Port of ``exaconstit_tpu.io.postprocess``: every quadrature field is
volume-averaged per element; the ExaCMech state fields come out of the
``qf_mapping`` offsets; quaternions are re-normalized; ``light_up`` adds
the element centroid and the full elastic strain in the crystal frame
(for lattice-strain post-processing).  A UMAT state gives its
deformation gradient and its user state variables instead (the JAX
package's dump knows only the ExaCMech names).  The averages are computed on the
simulation's device from its component-major fields and leave it in one
transfer per dump.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..fem import operators as ops
from ..models.evptn_cm import vecd_to_svec_cm
from .hdf5_dc import write_hdf5_step
from .vtk import write_pvd, write_vtu


def element_average(qf, wts):
    """(k, nq, ne) quadrature field, (nq, ne) point volumes -> (k, ne)."""
    return torch.einsum("qe,kqe->ke", wts, qf) / torch.sum(wts, dim=0)


def compute_element_fields(sim, light_up=False):
    """All visualization fields as {name: (ne,) or (ne, k) numpy array}."""
    sysm = sim.system
    nq = sysm.nq
    qmap = sim.model.qf_mapping
    el_x = sysm.emap.gather(sim.x_cur)  # (3, nen, ne)
    wts = ops.quad_point_volumes_cm(el_x, sysm.dshape, sysm.qwts)

    s = element_average(sim.stress.reshape(6, nq, -1), wts)
    t4 = s[3] ** 2 + s[4] ** 2 + s[5] ** 2
    von_mises = torch.sqrt(0.5 * ((s[0] - s[1]) ** 2 + (s[1] - s[2]) ** 2
                                  + (s[2] - s[0]) ** 2 + 6.0 * t4))
    state = element_average(
        sim.state.reshape(sim.state.shape[0], nq, -1), wts)

    def part(name):
        off, n = qmap[name]
        return state[off:off + n]

    fields = {
        "Stress": s,
        "VonMisesStress": von_mises[None],
        "HydrostaticStress": s[:3].mean(dim=0, keepdim=True),
        "ElementVolume": torch.sum(wts, dim=0, keepdim=True),
    }
    if "def_grad" in qmap:  # a UMAT state
        fields["DeformationGradient"] = part("def_grad")
        if qmap["statev"][1]:
            fields["StateVariables"] = part("statev")
        light_up = False  # the lattice-strain fields are ExaCMech's
    else:
        q = part("quats")
        fields.update({
            "DpEff": part("shrateEff"),
            "EffPlasticStrain": part("shrEff"),
            "Hardness": part("hardness"),
            "ShearRate": part("gdot"),
            "LatticeOrientation": q / torch.linalg.vector_norm(q, dim=0),
        })
    if light_up:
        # element centroids on the current configuration
        shape = torch.as_tensor(sysm.fes.ref.shape, dtype=el_x.dtype,
                                device=el_x.device)  # (nq, nen)
        fields["ElemCentroid"] = element_average(
            torch.einsum("qn,kne->kqe", shape, el_x), wts)
        # full elastic strain in the crystal frame: the deviatoric
        # 5-vector as an svec plus log(rel vol) on the diagonal
        svec = vecd_to_svec_cm(part("elas_strain"))
        vol = torch.log(part("rel_vol"))
        fields["XtalElasticStrain"] = torch.cat([svec[:3] + vol, svec[3:]])

    # one transfer for all fields, then split on the host
    flat = torch.cat(list(fields.values())).cpu().numpy()
    out, row = {}, 0
    for name, f in fields.items():
        k = f.shape[0]
        block = flat[row:row + k].T
        # scalar fields are (ne,), except the hardness vector of length 1
        out[name] = block if k > 1 or name == "Hardness" else block[:, 0]
        row += k
        if name == "ElementVolume":
            out["GrainId"] = sim.mesh.elem_attr.astype(float)
    return out


def write_vis_step(sim, ti, t, entries):
    """Write one visualization dump: paraview/visit -> VTU + PVD time
    series; conduit/adios2 -> the HDF5 data collection (io/hdf5_dc.py)."""
    opt = sim.opt
    base = opt.basename
    fields = compute_element_fields(sim, light_up=opt.light_up)
    sysm = sim.system
    x_cur = sysm.from_node(sim.x_cur)
    points = {"Displacement": x_cur - sysm.from_node(sim.x_ref),
              "Velocity": sysm.from_node(sim.v)}
    conn = np.asarray(sim.mesh.conn)
    if opt.paraview or opt.visit:
        vtu_name = f"step_{ti:06d}.vtu"
        write_vtu(os.path.join(sim.workdir, base, vtu_name), x_cur, conn,
                  sim.mesh.order, cell_fields=fields, point_fields=points)
        entries.append((t, os.path.join(base, vtu_name)))
        write_pvd(os.path.join(sim.workdir, base + ".pvd"), entries)
    if opt.conduit or opt.adios2:
        write_hdf5_step(os.path.join(sim.workdir, base + ".h5"), ti, t,
                        x_cur, conn, fields, points)
