"""Shared model API.

Mirrors the reference's mlapi conventions (README.md:92-94): every model has
``fit_transform(x)`` / ``transform(x)``; recommenders add
``predict(x, k, not_recommend, items_exclude)`` and ``get_similar_items``
from the ``MatrixFactorizationRecommender`` base
(reference R/MatrixFactorizationRecommender.R:4-121).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import scipy.sparse as sp


class TopK(NamedTuple):
    """Result of ``predict``: top-k item indices (0-based), scores, and — when
    the training matrix carried column names — the item identifiers (the
    ``ids`` attribute of the reference's prediction matrix,
    R/MatrixFactorizationRecommender.R:71-77)."""

    indices: np.ndarray             # (n_users, k) int32
    scores: np.ndarray              # (n_users, k) float32
    ids: Optional[np.ndarray]       # (n_users, k) object or None
    user_ids: Optional[Sequence]    # row names of the query matrix

    @property
    def shape(self):
        return self.indices.shape


def get_names(x, axis: int):
    """Row/col names attached by the RData loader (or None)."""
    return getattr(x, "row_names" if axis == 0 else "col_names", None)


class MatrixFactorizationRecommender:
    """Base recommender: holds item embeddings (``components``) and retrieval.

    ``components`` is (R, n_items), matching the reference's rank-by-items
    layout (R/model_WRMF.R:399).
    """

    def __init__(self):
        self.components: Optional[np.ndarray] = None
        self.global_bias: float = 0.0
        self.item_ids: Optional[Sequence] = None
        self._components_l2: Optional[np.ndarray] = None

    # subclasses implement transform(x) -> (n_users, R)

    def predict(
        self,
        x: sp.spmatrix,
        k: int,
        not_recommend: Union[sp.spmatrix, None, str] = "x",
        items_exclude: Sequence = (),
    ) -> TopK:
        """Recommend top-k items for each row of ``x``.

        ``not_recommend`` defaults to ``x`` itself (don't recommend already
        seen items, reference R/MatrixFactorizationRecommender.R:24).
        ``items_exclude`` may be integer indices or item identifiers.
        """
        from ..ops.topk import top_product

        if isinstance(not_recommend, str) and not_recommend == "x":
            not_recommend = x
        from ..sparse.splr import SparsePlusLowRank
        if isinstance(not_recommend, SparsePlusLowRank):
            # mask the OBSERVED interactions of a sparse-plus-low-rank
            # input: its sparse part (the low-rank term is a dense offset,
            # not an interaction record)
            not_recommend = not_recommend.x
        items_exclude = list(dict.fromkeys(items_exclude))
        excl_idx = None
        if items_exclude:
            if all(isinstance(i, (int, np.integer)) for i in items_exclude):
                excl_idx = np.asarray(items_exclude, np.int64)
            else:
                if self.item_ids is None:
                    raise ValueError("model doesn't contain item ids")
                lookup = {v: i for i, v in enumerate(self.item_ids)}
                excl_idx = np.asarray(
                    [lookup[i] for i in items_exclude if i in lookup], np.int64)

        user_emb = self.transform(x)
        # pass device embeddings straight through (top_product keeps jax
        # arrays on-device; components go through its content-addressed
        # staging cache)
        if isinstance(user_emb, np.ndarray):
            user_emb = np.asarray(user_emb, np.float32)
        mesh = getattr(self, "mesh", None)
        if mesh is not None and "data" in getattr(mesh, "axis_names", ()):
            # mesh-fitted model: item axis sharded over the mesh, packed
            # bitmasks sharded by item range, O(k) candidate merge
            # (parallel/topk_sharded.py).  Any mesh routes sharded (the
            # crossover against the single-device kernel is not measured
            # on the H100).  Very large k can exceed the per-shard
            # candidate budget — fall back to the single-device kernel
            # there rather than failing a recall@k evaluation.
            import jax
            n_dev = mesh.shape["data"]
            n_items_ = np.asarray(self.components).shape[1]
            shard_cap = (-(-n_items_ // (256 * n_dev)) * 256)
            if jax.process_count() == 1 and k <= shard_cap:
                from ..parallel.topk_sharded import sharded_top_product
                idx, scores = sharded_top_product(
                    mesh, user_emb,
                    np.asarray(self.components, np.float32), k,
                    not_recommend=not_recommend, exclude=excl_idx,
                    glob_mean=self.global_bias)
                ids = None
                if self.item_ids is not None:
                    ids = np.asarray(self.item_ids, object)[idx]
                return TopK(idx, scores, ids, get_names(x, 0))
        idx, scores = top_product(
            user_emb,
            np.asarray(self.components, np.float32),
            k,
            not_recommend=not_recommend,
            exclude=excl_idx,
            glob_mean=self.global_bias,
        )
        ids = None
        if self.item_ids is not None:
            ids = np.asarray(self.item_ids, object)[idx]
        return TopK(idx, scores, ids, get_names(x, 0))

    # below this, a host dot+argsort beats the device dispatch round-trip
    _SIMILAR_DEVICE_MIN_ELEMS = 1 << 22

    def get_similar_items(self, item_id, k: Optional[int] = None,
                          device: Optional[bool] = None) -> TopK:
        """Cosine-similar items to ``item_id``
        (reference R/MatrixFactorizationRecommender.R:79-107).

        Large item catalogs ride the device ``top_product`` kernel against
        the L2-normalized components (the normalized table is staged once
        through its content-addressed cache); small ones use a host dot.
        ``device``: force the path (None = pick by catalog size).
        """
        comps = np.asarray(self.components, np.float32)
        n_items = comps.shape[1]
        # the query item is always excluded, so at most n_items - 1 results
        # (both paths — the width must not depend on the path taken)
        k = n_items - 1 if k is None else min(k, n_items - 1)
        if self.item_ids is not None and not isinstance(item_id, (int, np.integer)):
            matches = np.flatnonzero(
                np.asarray(self.item_ids, object) == item_id)
            if len(matches) == 0:
                raise ValueError(f"no item with id {item_id!r} in the model")
            i = int(matches[0])
        else:
            i = int(item_id)
        if self._components_l2 is None:
            norms = np.sqrt((comps ** 2).sum(axis=0))
            self._components_l2 = comps / np.maximum(norms, 1e-12)
        if device is None:
            device = comps.size >= self._SIMILAR_DEVICE_MIN_ELEMS
        if device:
            from ..ops.topk import top_product
            idx, scores = top_product(
                self._components_l2[:, i][None, :], self._components_l2,
                k, exclude=np.asarray([i], np.int64))
            order, scr = idx[0], scores[0]
        else:
            q = self._components_l2[:, i]
            scores = q @ self._components_l2
            scores[i] = -np.inf  # remove similarity with itself
            order = np.argsort(-scores)[:k]
            scr = scores[order]
        ids = None
        if self.item_ids is not None:
            ids = np.asarray(self.item_ids, object)[order][None, :]
        return TopK(order[None, :].astype(np.int32),
                    scr[None, :].astype(np.float32), ids, None)
