"""Every model name of the port at full width against the flax model's
variables: leaves and shapes, flax traced abstractly (nothing computed).
The zoo's numbers are held in test_torch_port_zoo.py."""

import jax
import jax.numpy as jnp
import pytest
import torch

from mulactseg_tpu.models import get_model as jax_get_model
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.models.factory import MODEL_NAMES, get_model
from tests.test_torch_port_model import _flat

torch.set_num_threads(1)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_full_width_names_and_shapes_match_flax(name):
    """Every model name at full width (20 outputs, OS16, separable asked
    for, so the V3+ heads take it and the others ignore it): the port's
    seeded numpy init has exactly the flax model's leaves and shapes
    (flax traced abstractly, nothing computed)."""
    port = get_model(name, 20, 16, separable_conv=True, device="cpu")
    got = _flat(convert.random_variables(port, 0), lambda a: a.shape)
    ref = jax_get_model(name, 20, 16, separable_conv=True)
    shapes = jax.eval_shape(
        lambda: ref.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                         train=False))
    want = _flat({"params": shapes["params"],
                  "batch_stats": shapes["batch_stats"]},
                 lambda s: tuple(s.shape))
    assert got == want
    separable = any("depthwise" in k and "classifier" in k for k in got)
    assert separable == ("plus" in name)
