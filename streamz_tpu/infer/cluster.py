"""On-device cosine k-means over speaker embeddings.

Rebuild of ``cluster_embeddings`` (``streamz-rs/src/lib.rs:1668-1713``):
random init by sampling k distinct embeddings, assignment by maximum cosine
similarity, centers recomputed as the normalized mean of their members, empty
clusters reseeded with a random embedding.  The assignment step is one
[N x D] @ [D x k] matmul per iteration inside a ``lax.fori_loop``; serves
the ``--cluster-embeddings`` CLI flag (documented at README.md:76 but never
wired to the CLI in the reference — implemented for real here).
"""

from __future__ import annotations

from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from streamz_tpu.precision import MATMUL


@partial(jax.jit, static_argnames=("k", "iterations"))
def _kmeans(embeds: jax.Array, key: jax.Array, *, k: int, iterations: int):
    n, d = embeds.shape
    norms = jnp.linalg.norm(embeds, axis=1, keepdims=True)
    unit = embeds / jnp.maximum(norms, 1e-12)

    init_idx = jax.random.permutation(key, n)[:k]
    centers = embeds[init_idx]

    def body(i, carry):
        centers, _ = carry
        cnorm = jnp.linalg.norm(centers, axis=1, keepdims=True)
        cunit = centers / jnp.maximum(cnorm, 1e-12)
        sims = jnp.matmul(unit, cunit.T, precision=MATMUL)  # [n, k]
        # zero-norm rows/centers → cosine 0 (src/lib.rs:1536-1539)
        sims = jnp.where((norms > 0) & (cnorm.T > 0), sims, 0.0)
        assign = jnp.argmax(sims, axis=1)

        one_hot = jax.nn.one_hot(assign, k, dtype=embeds.dtype)  # [n, k]
        counts = one_hot.sum(axis=0)  # [k]
        sums = jnp.matmul(one_hot.T, embeds, precision=MATMUL)  # [k, d]
        means = sums / jnp.maximum(counts[:, None], 1.0)
        mnorm = jnp.linalg.norm(means, axis=1, keepdims=True)
        means = jnp.where(mnorm > 1e-6, means / jnp.maximum(mnorm, 1e-12), means)

        # Reseed empty clusters with a random embedding.
        rk = jax.random.fold_in(key, i)
        rand_idx = jax.random.randint(rk, (k,), 0, n)
        new_centers = jnp.where((counts > 0)[:, None], means, embeds[rand_idx])
        return new_centers, assign

    centers, assign = jax.lax.fori_loop(
        0, max(iterations, 1), body, (centers, jnp.zeros((n,), jnp.int32))
    )
    return assign


def cluster_embeddings(
    embeds, k: int, iterations: int, *, seed: int = 0
) -> List[int]:
    """Cluster embeddings into k groups; returns per-embedding cluster ids."""
    embeds = np.asarray(embeds, np.float32)
    if k < 0:
        raise ValueError(f"k must be non-negative, got {k}")
    if len(embeds) == 0 or k == 0:
        return []
    k = min(k, len(embeds))
    assign = _kmeans(
        jnp.asarray(embeds), jax.random.PRNGKey(seed), k=int(k),
        iterations=int(iterations),
    )
    return [int(a) for a in np.asarray(assign)]
