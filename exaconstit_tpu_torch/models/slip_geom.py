"""Slip-system geometry (numpy tables) for FCC, BCC and HCP crystals.

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


@functools.lru_cache(maxsize=None)
def bcc12() -> SlipGeom:
    """BCC {110}<111>, 12 systems, in the reference's order."""
    planes = [(0, 1, 1), (0, 1, -1), (1, 0, 1), (1, 0, -1),
              (1, 1, 0), (1, -1, 0)]
    m_list, n_list = [], []
    for n in planes:
        na = np.array(n, dtype=float)
        for d in [(1, 1, 1), (-1, 1, 1), (1, -1, 1), (1, 1, -1)]:
            da = np.array(d, dtype=float)
            if abs(np.dot(da, na)) < 1e-12:
                m_list.append(da)
                n_list.append(na)
    return _build("bcc12", m_list, n_list)


@functools.lru_cache(maxsize=None)
def hcp24(c_over_a: float = 1.587) -> SlipGeom:
    """HCP, 24 systems: 3 basal, 3 prismatic, 6 pyramidal <a> and 12
    pyramidal <c+a>, in the reference's order.  Miller-Bravais indices
    to Cartesian with x along a1 and z along c."""
    r = float(c_over_a)

    def mb_dir(u, v, t, w):
        return np.array([1.5 * u, (u + 2.0 * v) * np.sqrt(3.0) / 2.0, w * r])

    def mb_plane(h, k, i, l):
        return np.array([h, (h + 2.0 * k) / np.sqrt(3.0), l / r])

    a_dirs = [(2, -1, -1, 0), (-1, 2, -1, 0), (-1, -1, 2, 0)]
    basal = [((0, 0, 0, 1), d) for d in a_dirs]
    pris = [((0, 1, -1, 0), (2, -1, -1, 0)),
            ((-1, 0, 1, 0), (-1, 2, -1, 0)),
            ((1, -1, 0, 0), (-1, -1, 2, 0))]
    pyr_a = [((0, 1, -1, 1), (2, -1, -1, 0)),
             ((-1, 0, 1, 1), (-1, 2, -1, 0)),
             ((1, -1, 0, 1), (-1, -1, 2, 0)),
             ((0, -1, 1, 1), (2, -1, -1, 0)),
             ((1, 0, -1, 1), (-1, 2, -1, 0)),
             ((-1, 1, 0, 1), (-1, -1, 2, 0))]
    m_list = [mb_dir(*d) for _, d in basal + pris + pyr_a]
    n_list = [mb_plane(*pl) for pl, _ in basal + pris + pyr_a]
    # pyramidal <c+a> {10-11}<11-23>: the two <c+a> directions lying in
    # each of the six planes
    pyr_ca_planes = [(1, 0, -1, 1), (0, 1, -1, 1), (-1, 1, 0, 1),
                     (-1, 0, 1, 1), (0, -1, 1, 1), (1, -1, 0, 1)]
    ca_dirs = [(-2, 1, 1, 3), (-1, -1, 2, 3), (1, -2, 1, 3),
               (2, -1, -1, 3), (1, 1, -2, 3), (-1, 2, -1, 3)]
    for pl in pyr_ca_planes:
        npl = mb_plane(*pl)
        for d in ca_dirs:
            dd = mb_dir(*d)
            if abs(np.dot(dd, npl)) < 1e-9 * np.linalg.norm(dd) \
                    * np.linalg.norm(npl):
                m_list.append(dd)
                n_list.append(npl)
    if len(m_list) != 24:
        raise ValueError(f"hcp24 found {len(m_list)} slip systems")
    return _build("hcp24", m_list, n_list)


def get_slip_geom(xtal_type: str, c_over_a: float = 1.587) -> SlipGeom:
    xt = xtal_type.lower()
    if xt == "fcc":
        return fcc12()
    if xt == "bcc":
        return bcc12()
    if xt == "hcp":
        return hcp24(c_over_a)
    raise ValueError(f"unknown xtal type {xtal_type}")
