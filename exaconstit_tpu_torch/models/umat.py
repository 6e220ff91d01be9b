"""Abaqus-convention UMAT material interface, evaluated on the host.

Port of ``exaconstit_tpu.models.umat``: user materials compiled to a
shared library with the standard UMAT signature (the reference's
AbaqusUmatModel + userumat ABI) are called through ctypes, one point at
a time, on the host; the reference likewise restricts UMATs to the CPU.
The JAX package reaches the host through ``jax.pure_callback``; here
``model_setup_cm`` moves the velocity gradient and the state to the host
once, evaluates them with the same numpy and ctypes code, and moves the
stress, state and tangent back once.  The rest of the step stays on the
caller's device.

Kinematics follow the reference's incremental treatment: the state
carries the beginning-step deformation gradient per point; the
incremental deformation gradient comes from the velocity gradient
(Pade approximant of expm(L dt)), with Eulerian log strains, their
increment, the incremental rotation (polar decomposition), and the
conversions between the svec order [11,22,33,23,13,12] and Abaqus'
[11,22,33,12,13,23].
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

# svec [11,22,33,23,13,12] <-> Abaqus [11,22,33,12,13,23]
_SVEC_TO_ABQ = np.array([0, 1, 2, 5, 4, 3])
_ABQ_TO_SVEC = np.array([0, 1, 2, 5, 4, 3])


def _polar_rotation(F):
    """Rotation factors of F (batched numpy, via SVD)."""
    U, _, Vt = np.linalg.svd(F)
    det = np.linalg.det(U @ Vt)
    U[det < 0, :, -1] *= -1.0  # guard reflections
    return U @ Vt


def _log_strain(F):
    """Eulerian log strain ln(V) from F (batched numpy, eigendecomp)."""
    B = F @ np.swapaxes(F, -1, -2)
    w, v = np.linalg.eigh(B)
    lw = 0.5 * np.log(np.maximum(w, 1e-300))
    return np.einsum("...ij,...j,...kj->...ik", v, lw, v)


def _to_abq(t):
    """(..., 3, 3) strain tensor -> Abaqus 6-vector, engineering shear."""
    return np.stack([t[..., 0, 0], t[..., 1, 1], t[..., 2, 2],
                     2 * t[..., 0, 1], 2 * t[..., 0, 2], 2 * t[..., 1, 2]],
                    axis=-1)


class UmatLibrary:
    """ctypes binding of a shared library exporting ``umat_`` or ``umat``
    (the Fortran UMAT argument list, all by reference)."""

    def __init__(self, path: str):
        self.lib = ctypes.CDLL(path)
        for name in ("umat_", "umat"):
            if hasattr(self.lib, name):
                self.fn = getattr(self.lib, name)
                break
        else:
            raise ValueError(f"{path} exports no umat symbol")
        self.fn.restype = None

    def call_batch(self, stress_abq, statev, stran, dstran, drot, dfgrd0,
                   dfgrd1, props, dtime, temp, char_len):
        """One call per point, in place on ``stress_abq`` and ``statev``.
        Returns (stress, statev, ddsdde (n, 6, 6) row-major)."""
        n = stress_abq.shape[0]
        nsv = statev.shape[1]
        npr = props.shape[0]
        ddsdde = np.zeros((n, 6, 6))
        c_d, c_i = ctypes.c_double, ctypes.c_int
        zero = np.zeros(1)
        time2 = np.zeros(2)

        def ptr(a):
            return a.ctypes.data_as(ctypes.POINTER(c_d))

        for i in range(n):
            sse, spd, scd, rpl = c_d(0.0), c_d(0.0), c_d(0.0), c_d(0.0)
            drpldt, pnewdt = c_d(0.0), c_d(10.0)
            dt_c, temp_c, dtemp = c_d(dtime), c_d(temp), c_d(0.0)
            ndi, nshr, ntens = c_i(3), c_i(3), c_i(6)
            nsv_c, npr_c = c_i(nsv), c_i(npr)
            noel, npt, layer, kspt = c_i(i + 1), c_i(1), c_i(0), c_i(0)
            kstep, kinc = c_i(1), c_i(1)
            celent = c_d(char_len[i])
            dd = np.zeros((6, 6), order="F")
            coords, predef, dpred = np.zeros(3), np.zeros(1), np.zeros(1)
            cmname = ctypes.create_string_buffer(b"umat", 80)
            self.fn(
                ptr(stress_abq[i]), ptr(statev[i]), ptr(dd),
                ctypes.byref(sse), ctypes.byref(spd), ctypes.byref(scd),
                ctypes.byref(rpl), ptr(zero), ptr(zero),
                ctypes.byref(drpldt), ptr(stran[i]), ptr(dstran[i]),
                ptr(time2), ctypes.byref(dt_c), ctypes.byref(temp_c),
                ctypes.byref(dtemp), ptr(predef), ptr(dpred), cmname,
                ctypes.byref(ndi), ctypes.byref(nshr), ctypes.byref(ntens),
                ctypes.byref(nsv_c), ptr(props), ctypes.byref(npr_c),
                ptr(coords), ptr(np.asfortranarray(drot[i])),
                ctypes.byref(pnewdt), ctypes.byref(celent),
                ptr(np.asfortranarray(dfgrd0[i])),
                ptr(np.asfortranarray(dfgrd1[i])),
                ctypes.byref(noel), ctypes.byref(npt), ctypes.byref(layer),
                ctypes.byref(kspt), ctypes.byref(kstep), ctypes.byref(kinc),
            )
            ddsdde[i] = dd.T  # Fortran column-major -> row-major
        return stress_abq, statev, ddsdde


@dataclasses.dataclass(frozen=True)
class UmatModel:
    """UMAT-backed material.  State per point: [F (9, column-major), the
    stress svec (6), the user state variables (num_user_state)], so that
    the driver's interface is that of the crystal models."""

    lib: UmatLibrary
    props: np.ndarray
    num_user_state: int
    temp_k: float = 298.0

    IND_F = 0
    # the reference runs UMATs on its point-major path; the driver keeps
    # that path's rules (f64 operator build)
    point_major = True

    @property
    def num_state(self):
        return 9 + 6 + self.num_user_state

    @property
    def qf_mapping(self):
        return {"def_grad": (0, 9), "stress": (9, 6),
                "statev": (15, self.num_user_state)}

    def init_state(self, quats_unused=None, npts=None):
        s = np.zeros((npts, self.num_state))
        s[:, 0] = s[:, 4] = s[:, 8] = 1.0  # F = I (column-major)
        return s

    def substep_counts(self, dt):
        """UMATs handle their own sub-increments."""
        return None

    def model_setup(self, dt, vgrad, state_beg, compute_tangent=True,
                    nsub=None):
        """Point-major host evaluation: vgrad (N, 3, 3), state_beg
        (N, num_state) numpy -> (stress (N, 6), state_end, tangent
        (N, 6, 6)) numpy, f64.  The tangent is always computed."""
        vgrad = np.asarray(vgrad, dtype=np.float64)
        state = np.asarray(state_beg, dtype=np.float64)
        npts = vgrad.shape[0]
        dt = float(dt)
        F0 = state[:, :9].reshape(npts, 3, 3).transpose(0, 2, 1)
        eye = np.eye(3)
        A = vgrad * dt
        Fhat = np.linalg.solve((eye - 0.5 * A).reshape(npts, 3, 3),
                               (eye + 0.5 * A).reshape(npts, 3, 3))
        F1 = Fhat @ F0
        eps0 = _log_strain(F0)
        deps = _log_strain(F1) - eps0
        stress_abq = state[:, 9:15][:, _SVEC_TO_ABQ].copy()
        statev = np.ascontiguousarray(state[:, 15:])
        if statev.shape[1] == 0:
            statev = np.zeros((npts, 1))
        char_len = np.cbrt(np.abs(np.linalg.det(F1)))
        s_out, sv_out, dd = self.lib.call_batch(
            stress_abq, statev, _to_abq(eps0), _to_abq(deps),
            _polar_rotation(Fhat), F0, F1,
            np.asarray(self.props, dtype=np.float64), dt, self.temp_k,
            char_len)
        stress_new = s_out[:, _ABQ_TO_SVEC]
        dd = dd[:, _ABQ_TO_SVEC][:, :, _ABQ_TO_SVEC]
        state_new = np.concatenate(
            [F1.transpose(0, 2, 1).reshape(npts, 9), stress_new,
             sv_out[:, :self.num_user_state]], axis=1)
        return stress_new, state_new, dd

    def model_setup_cm(self, dt, vgrad_cm, state_beg_cm,
                       compute_tangent=True, nsub=None, x_warm=None,
                       warm_ok=False, with_solution=False):
        """Component-major adapter for the driver: vgrad_cm (3, 3, N) and
        state_beg_cm (num_state, N) on any device go to the host in one
        transfer each, and stress (6, N), state_end (num_state, N) and
        tangent (6, 6, N) come back in one.  There is no point-solve
        solution to carry, so ``with_solution`` appends None."""
        host = torch.cat([vgrad_cm.reshape(9, -1), state_beg_cm]).cpu()
        host = host.numpy()
        vgrad = np.ascontiguousarray(host[:9].reshape(3, 3, -1)
                                     .transpose(2, 0, 1))
        stress, state_end, dd = self.model_setup(
            dt, vgrad, np.ascontiguousarray(host[9:].T))
        back = np.concatenate([stress.T, state_end.T,
                               dd.transpose(1, 2, 0).reshape(36, -1)])
        back = torch.as_tensor(back, dtype=vgrad_cm.dtype,
                               device=vgrad_cm.device)
        stress = back[:6]
        state_end = back[6:6 + self.num_state]
        tangent = back[6 + self.num_state:].reshape(6, 6, -1)
        out = (stress, state_end, tangent if compute_tangent else None)
        return out + (None,) if with_solution else out
