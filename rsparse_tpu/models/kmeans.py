"""k-means (internal helper, reference R/kmeans.R:2-25 over
src/kmeans.cpp:10-17's ``arma::kmeans`` wrapper).

Lloyd's algorithm as a jitted lax loop of matrix products: the assignment
step is one dense distance matmul per iteration.  Seed modes mirror arma's:
``static_subset``/``random_subset`` (centroids from data rows) and
``static_spread``/``random_spread`` (k-means++-style spread).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("n_iter",))
def _lloyd(x: jax.Array, cent0: jax.Array, n_iter: int):
    k = cent0.shape[0]

    def step(cent, _):
        # squared distances via the expansion ||x||^2 - 2 x.c + ||c||^2
        xc = x @ cent.T
        d = (jnp.sum(x * x, 1, keepdims=True) - 2 * xc
             + jnp.sum(cent * cent, 1)[None, :])
        assign = jnp.argmin(d, axis=1)
        onehot = jax.nn.one_hot(assign, k, dtype=x.dtype)
        counts = onehot.sum(0)
        sums = onehot.T @ x
        new = jnp.where(counts[:, None] > 0, sums / counts[:, None], cent)
        return new, None

    cent, _ = jax.lax.scan(step, cent0, None, length=n_iter)
    xc = x @ cent.T
    d = (jnp.sum(x * x, 1, keepdims=True) - 2 * xc
         + jnp.sum(cent * cent, 1)[None, :])
    return cent, jnp.argmin(d, axis=1)


def kmeans(
    x,
    k: int,
    n_iter: int = 10,
    seed_mode: str = "random_subset",
    seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster rows of ``x`` into ``k`` groups; returns (centroids,
    assignments)."""
    x = jnp.asarray(np.asarray(x, np.float32))
    n = x.shape[0]
    if k > n:
        raise ValueError(f"k={k} > n_rows={n}")
    rng = np.random.default_rng(
        0 if "static" in seed_mode else seed)
    if seed_mode in ("static_subset", "random_subset"):
        rows = rng.choice(n, size=k, replace=False)
        cent0 = x[jnp.asarray(rows)]
    elif seed_mode in ("static_spread", "random_spread"):
        # k-means++-style: greedily pick far points
        xn = np.asarray(x)
        chosen = [int(rng.integers(n))]
        d2 = np.sum((xn - xn[chosen[0]]) ** 2, axis=1)
        for _ in range(k - 1):
            p = d2 / max(d2.sum(), 1e-30)
            nxt = int(rng.choice(n, p=p))
            chosen.append(nxt)
            d2 = np.minimum(d2, np.sum((xn - xn[nxt]) ** 2, axis=1))
        cent0 = x[jnp.asarray(chosen)]
    else:
        raise ValueError(f"unknown seed_mode {seed_mode!r}")
    cent, assign = _lloyd(x, cent0, n_iter)
    return np.asarray(cent), np.asarray(assign)
