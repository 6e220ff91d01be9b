"""Slip-system geometry (numpy tables); FCC for this slice.

Port of ``exaconstit_tpu.models.slip_geom``: each slip system s has a
symmetric Schmid tensor ``P_s`` stored as a vecd 5-vector and a skew
part ``Q_s`` stored as a wvec 3-vector, both in the crystal frame.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..utils.tensors import BASIS_DEV


@dataclasses.dataclass(frozen=True)
class SlipGeom:
    name: str
    P: np.ndarray  # (nslip, 5) symmetric Schmid, vecd components
    Q: np.ndarray  # (nslip, 3) skew Schmid, wvec components [W32, W13, W21]

    @property
    def nslip(self):
        return self.P.shape[0]


def _build(name, m_list, n_list):
    m = np.asarray(m_list, dtype=float)
    n = np.asarray(n_list, dtype=float)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    if np.max(np.abs(np.sum(m * n, axis=1))) >= 1e-12:
        raise ValueError("slip directions must lie in their planes")
    T = np.einsum("si,sj->sij", m, n)
    sym = 0.5 * (T + np.swapaxes(T, 1, 2))
    skw = 0.5 * (T - np.swapaxes(T, 1, 2))
    P = np.einsum("kij,sij->sk", BASIS_DEV, sym)
    Q = np.stack([skw[:, 2, 1], skw[:, 0, 2], skw[:, 1, 0]], axis=-1)
    return SlipGeom(name=name, P=P, Q=Q)


@functools.lru_cache(maxsize=None)
def fcc12() -> SlipGeom:
    """FCC {111}<110>, 12 systems, in the reference's order."""
    planes = [(1, 1, 1), (-1, 1, 1), (1, -1, 1), (1, 1, -1)]
    m_list, n_list = [], []
    for n in planes:
        na = np.array(n, dtype=float)
        dirs = []
        for d in [(0, 1, -1), (1, 0, -1), (1, -1, 0),
                  (0, 1, 1), (1, 0, 1), (1, 1, 0)]:
            da = np.array(d, dtype=float)
            if abs(np.dot(da, na)) < 1e-12:
                dirs.append(da)
                if len(dirs) == 3:
                    break
        for d in dirs:
            m_list.append(d)
            n_list.append(na)
    return _build("fcc12", m_list, n_list)


def get_slip_geom(xtal_type: str) -> SlipGeom:
    if xtal_type.lower() == "fcc":
        return fcc12()
    raise NotImplementedError(
        f"slip geometry {xtal_type!r} is not ported yet (FCC only)")
