"""Numerics guards (debug mode).

Port of ``exaconstit_tpu.utils.guards``.  The reference threads
``checkify`` NaN checks through its jitted setup under
``EXACONSTIT_CHECK_NUMERICS=1``; eager PyTorch needs no functionalised
assertion, so the port checks what each layer of the setup returns with
``torch.isfinite`` and raises on the first tensor that is not finite,
naming the layer.

Off by default: a check reads the device (one synchronisation per
tensor), and the production kinetics are NaN-safe by construction.  Off,
``MechSystem`` makes no check and touches no tensor.
"""

from __future__ import annotations

import os

import torch


class NonFiniteError(FloatingPointError):
    """A layer returned a tensor with a NaN or an infinity."""


def numerics_checks_enabled() -> bool:
    return os.environ.get("EXACONSTIT_CHECK_NUMERICS", "0") not in ("", "0")


def check_finite(layer, **tensors):
    """Raise ``NonFiniteError`` naming ``layer`` and the tensor if any of
    ``tensors`` (None entries skipped) holds a nan or an inf."""
    for name, t in tensors.items():
        if t is None:
            continue
        bad = ~torch.isfinite(t)
        if bool(bad.any()):
            raise NonFiniteError(
                f"non-finite values (nan/inf) out of the {layer} layer: "
                f"{name} has {int(bad.sum())} of {t.numel()} "
                f"(first at flat index {int(bad.flatten().nonzero()[0])})")



class FiniteTally:
    """The non-finite entries of each layer's tensors, summed over the
    element chunks of one setup and read once by ``check``: it names the
    first layer (in the order the layers were added) that is not finite,
    whatever the chunk count.  Off, it touches no tensor."""

    def __init__(self, on):
        self.on = on
        self.counts = {}  # layer -> {name: [non-finite count, size]}

    def add(self, layer, **tensors):
        if not self.on:
            return
        names = self.counts.setdefault(layer, {})
        for name, t in tensors.items():
            if t is None:
                continue
            bad = (~torch.isfinite(t)).sum()
            if name in names:
                names[name][0] = names[name][0] + bad
                names[name][1] += t.numel()
            else:
                names[name] = [bad, t.numel()]

    def check(self):
        """Raise ``NonFiniteError`` for the first layer holding a nan or
        an inf (one device read per tensor)."""
        for layer, names in self.counts.items():
            for name, (bad, size) in names.items():
                if int(bad):
                    raise NonFiniteError(
                        f"non-finite values (nan/inf) out of the {layer} "
                        f"layer: {name} has {int(bad)} of {size}")
