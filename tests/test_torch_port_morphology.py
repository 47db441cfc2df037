"""The port's superpixel morphology (mulactseg_tpu_torch/ops/morphology.py)
against the JAX package's ops/morphology.py, on the CPU: boundary_mask,
binary_dilation3x3, neighbor_ids_map and segment_adjacency exactly, on
irregular and grid superpixel maps, a one-segment map, maps of one row or
column, ids at the invalid bucket, and ids past float32's exact integers
(the integer path of boundary_mask)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mulactseg_tpu.ops import morphology as jax_morph
from mulactseg_tpu_torch.data.synthetic import (
    grid_superpixels,
    irregular_superpixels,
)
from mulactseg_tpu_torch.ops import morphology

torch.set_num_threads(1)


def _maps():
    rng = np.random.RandomState(0)
    return {
        "irregular": irregular_superpixels(23, 31, 12, rng),
        "grid": grid_superpixels(16, 20, 9).astype(np.int32),
        "one_segment": np.zeros((7, 5), np.int32),
        "one_row": rng.randint(0, 4, (1, 17)).astype(np.int32),
        "one_column": rng.randint(0, 4, (13, 1)).astype(np.int32),
        "invalid_bucket": np.where(rng.rand(12, 14) < 0.2, 9,
                                   rng.randint(0, 9, (12, 14))
                                   ).astype(np.int32),
    }


@pytest.mark.parametrize("name", sorted(_maps()))
def test_boundary_mask_and_neighbours_match_jax(name):
    spx = _maps()[name]
    got = morphology.boundary_mask(torch.from_numpy(spx))
    want = np.asarray(jax_morph.boundary_mask(jnp.asarray(spx)))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    for k in (3, 5):
        np.testing.assert_array_equal(
            morphology.neighbor_ids_map(torch.from_numpy(spx), k).numpy(),
            np.asarray(jax_morph.neighbor_ids_map(jnp.asarray(spx), k)))


@pytest.mark.parametrize("name", sorted(_maps()))
def test_segment_adjacency_matches_jax(name):
    spx = _maps()[name]
    S = 9 if name == "invalid_bucket" else int(spx.max()) + 1
    for k in (3, 5):
        got = morphology.segment_adjacency(torch.from_numpy(spx), S, k)
        want = np.asarray(jax_morph.segment_adjacency(jnp.asarray(spx), S,
                                                      k))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_binary_dilation_matches_jax(iterations):
    rng = np.random.RandomState(iterations)
    for shape, p in (((19, 23), 0.05), ((1, 9), 0.2), ((6, 6), 0.0)):
        mask = rng.rand(*shape) < p
        mask[0, 0] = p > 0
        got = morphology.binary_dilation3x3(torch.from_numpy(mask),
                                            iterations)
        want = jax_morph.binary_dilation3x3(jnp.asarray(mask), iterations)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_boundary_mask_takes_the_integer_path_past_float32():
    """Ids 2**24 and 2**24 + 1 are one float32 value: compared as
    integers they still show their boundary, as JAX's int32 max/min
    does."""
    spx = np.full((6, 8), 1 << 24, np.int64)
    spx[:, 4:] += 1
    got = morphology.boundary_mask(torch.from_numpy(spx))
    want = np.asarray(jax_morph.boundary_mask(jnp.asarray(spx, jnp.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:, 3:5].all() and not got[:, :3].any()
