"""Exact top-k as a stable sort.

``top_k(x, k)`` keeps the contract of ``jax.lax.top_k``: the k largest
entries along the last axis, largest first, ties to the lower index.  It
is written as a stable key/index sort because XLA's GPU compiler, handed
``lax.top_k`` at this repository's sizes (k = 1024 of a 1.38 M-pixel score
map), grows its host memory without bound (tens of GB, no result), while
the sort compiles in seconds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def top_k(x: jnp.ndarray, k: int):
    """(values, indices) of the k largest entries along the last axis."""
    axis = x.ndim - 1
    idx = jax.lax.broadcasted_iota(jnp.int32, x.shape, axis)
    neg, idx = jax.lax.sort((-x, idx), dimension=axis, num_keys=1,
                            is_stable=True)
    return -neg[..., :k], idx[..., :k]
