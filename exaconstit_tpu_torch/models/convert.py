"""Carry a model and a state across from the JAX package's numpy arrays.

The JAX package is not imported here: a caller that has both packages
(a test, a migration script) flattens the reference model into the plain
dict of numpy arrays and scalars that ``ecmech_from_reference`` reads:

* ``elast.C_dev`` (5, 5), ``elast.bulk``;
* ``slip.P`` (S, 5), ``slip.Q`` (S, 3), ``slip.name``;
* ``kin.class`` (``"VocePL"``, ``"KMBalD"`` or ``"SplineG"``) and
  ``kin.<field>`` for every field of that class (``KMBalD``'s ``c1``,
  ``go`` and ``s`` as floats or per-slip (S,) arrays);
* ``eos.<field>`` for every ``EosConst`` field;
* ``solver_tol``, ``fast_tol``, ``refine_iters``, ``solver_max_iter``,
  ``substep_cap``, ``max_substeps``, ``h_gd_blend``,
  ``mixed_precision``, ``temp_k``.

A UMAT model flattens to ``umat.library`` (the shared library's path),
``umat.props``, ``umat.num_user_state`` and ``temp_k``, which
``umat_from_reference`` reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ecmech import ECMechModel
from .elasticity import Elasticity
from .eos import EosConst
from .evptn import EvptnModel
from . import kinetics
from .slip_geom import SlipGeom
from .umat import UmatLibrary, UmatModel

_INT_FIELDS = ("refine_iters", "solver_max_iter", "max_substeps")
_FLOAT_FIELDS = ("solver_tol", "fast_tol", "substep_cap", "h_gd_blend")


def _fields(cls, prefix, arrays):
    return {f.name: arrays[f"{prefix}.{f.name}"]
            for f in dataclasses.fields(cls)}


_SCALARS = _INT_FIELDS + _FLOAT_FIELDS + ("mixed_precision",)
_KINETICS = {c.__name__: c for c in (kinetics.VocePL, kinetics.KMBalD,
                                     kinetics.SplineG)}


def arrays_from_model(model) -> dict:
    """Flatten a model of either package into that dict.  Reads
    attributes only, so the caller's model object brings its own package
    with it and none is imported here."""
    if hasattr(model, "lib"):  # a UMAT: its library's ctypes handle
        return {"umat.library": model.lib.lib._name,
                "umat.props": np.asarray(model.props, dtype=np.float64),
                "umat.num_user_state": int(model.num_user_state),
                "temp_k": float(model.temp_k)}
    ev = model.evptn
    kin_cls = _KINETICS[type(ev.kinetics).__name__]
    arrays = {"elast.C_dev": ev.elast.C_dev, "elast.bulk": ev.elast.bulk,
              "slip.P": ev.slip.P, "slip.Q": ev.slip.Q,
              "slip.name": ev.slip.name, "kin.class": kin_cls.__name__,
              "temp_k": model.temp_k}
    for f in dataclasses.fields(kin_cls):
        arrays[f"kin.{f.name}"] = getattr(ev.kinetics, f.name)
    for f in dataclasses.fields(EosConst):
        arrays[f"eos.{f.name}"] = getattr(ev.eos, f.name)
    for k in _SCALARS:
        arrays[k] = getattr(ev, k)
    return arrays


def ecmech_from_reference(arrays: dict) -> ECMechModel:
    """Build the port's model from the reference model's arrays."""
    slip = SlipGeom(name=str(arrays["slip.name"]),
                    P=np.asarray(arrays["slip.P"], float),
                    Q=np.asarray(arrays["slip.Q"], float))
    elast = Elasticity(C_dev=np.asarray(arrays["elast.C_dev"], float),
                       bulk=arrays["elast.bulk"])
    kin_cls = _KINETICS[arrays["kin.class"]]
    kin = kin_cls(**_fields(kin_cls, "kin", arrays))
    eos = EosConst(**_fields(EosConst, "eos", arrays))
    extra = {k: int(arrays[k]) for k in _INT_FIELDS}
    extra.update({k: float(arrays[k]) for k in _FLOAT_FIELDS})
    evptn = EvptnModel(slip=slip, elast=elast, kinetics=kin, eos=eos,
                       mixed_precision=bool(arrays["mixed_precision"]),
                       **extra)
    return ECMechModel(evptn=evptn, temp_k=float(arrays["temp_k"]),
                       nslip=slip.nslip, n_h=kin.n_h)


def umat_from_reference(arrays: dict) -> UmatModel:
    """Build the port's UMAT model on the same shared library."""
    return UmatModel(lib=UmatLibrary(str(arrays["umat.library"])),
                     props=np.asarray(arrays["umat.props"], float),
                     num_user_state=int(arrays["umat.num_user_state"]),
                     temp_k=float(arrays["temp_k"]))


def state_from_reference(state_cm, device) -> torch.Tensor:
    """A component-major (nsv, npts) reference state as an f64 tensor on
    the caller's ``device``."""
    return torch.as_tensor(np.asarray(state_cm, dtype=np.float64),
                           device=device)
