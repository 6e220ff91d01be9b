"""PyTorch port against the JAX package: ``model_setup`` for every knob
variant on the BCC MTSDD model (``KMBalD`` kinetics, athermal strength), pure f64 (see
``test_torch_point_variants.check_model_setup_variant``; one file per
family keeps each file near a minute and a half on one worker, most of
it the reference compiling each variant)."""

import pytest
import torch

from test_torch_point_variants import (check_model_setup_variant,
                                       variant_knobs)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("knob", variant_knobs("kmbald"))
def test_model_setup_variants_kmbald(knob):
    check_model_setup_variant("kmbald", knob)
