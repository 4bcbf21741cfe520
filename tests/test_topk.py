"""ops/topk.py: exact top-k as a stable sort, held to lax.top_k's contract
(largest first, ties to the lower index) and to a NumPy stable argsort."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navtech_radar_slam_tpu.ops.topk import top_k


@pytest.mark.parametrize("shape,k", [((1000,), 10), ((7, 50), 5),
                                     ((400 * 3456,), 1024)])
def test_top_k_matches_lax_and_stable_argsort(shape, k):
    rng = np.random.default_rng(k)
    x = np.round(rng.random(shape), 2).astype(np.float32)   # many ties
    x[..., ::7] = -np.inf
    vals, idx = jax.device_get(top_k(jnp.asarray(x), k))
    ref_vals, ref_idx = jax.device_get(jax.lax.top_k(jnp.asarray(x), k))
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(vals, ref_vals)
    order = np.argsort(-x, axis=-1, kind="stable")[..., :k]
    np.testing.assert_array_equal(idx, order)
