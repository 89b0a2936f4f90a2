"""Model checkpointing with warm-start semantics.

The reference's persistence story is per-model: FTRL ``dump()/load()``
(R/model_FTRL.R:142-158), warm-start ``init`` everywhere (WRMF components
R/model_WRMF.R:245-249, GloVe tensors R/model_GloVe.R:35-60, soft_als padded
SVD triples R/SoftALS.R:137-143), otherwise R object serialization.

Here: one generic checkpointer for every model class — JSON-serializable
hyperparameters go to a sidecar; arrays go to either

- an ``.npz`` (host gather; the always-works single-host store), or
- an **orbax** checkpoint (``store="orbax"``, or automatically whenever a
  device array is committed to more than one device and orbax can be
  imported; orbax is an optional dependency): every device writes
  its own shards — factor tables sharded over a mesh are saved WITHOUT a
  host gather, and ``load(..., sharding=...)`` restores them directly into
  the requested sharding (multi-host restore).

``load`` rebuilds the model and re-places arrays on device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Type

import jax
import jax.numpy as jnp
import numpy as np

_SKIP = ("_rng", "_key", "preprocess", "_init", "_train_ui")


def _is_array(v) -> bool:
    return isinstance(v, (jax.Array, np.ndarray))


def _is_jsonable(v) -> bool:
    return isinstance(v, (int, float, str, bool, type(None), list, tuple))


def _is_multidevice(v) -> bool:
    return (isinstance(v, jax.Array)
            and getattr(v, "sharding", None) is not None
            and len(v.sharding.device_set) > 1)


def _fit_sharding(sharding, shape):
    """``sharding`` if it tiles ``shape`` evenly, else a replicated sharding
    on the same mesh (XLA rejects uneven tilings), else None."""
    if sharding is None:
        return None
    try:
        sharding.shard_shape(tuple(shape))
        return sharding
    except Exception:  # noqa: BLE001 - non-divisible or rank mismatch
        from jax.sharding import NamedSharding, PartitionSpec
        if isinstance(sharding, NamedSharding):
            return NamedSharding(sharding.mesh, PartitionSpec())
        return None


def _have_orbax() -> bool:
    try:
        import orbax.checkpoint  # noqa: F401
    except ImportError:
        return False
    return True


def _orbax():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "store='orbax' needs the optional package orbax-checkpoint "
            "(import orbax.checkpoint failed)") from e
    return ocp


def save(model: Any, path: str, store: str = "auto") -> None:
    """Save a fitted model to ``path`` (a directory).

    ``store``: "npz" | "orbax" | "auto" (orbax when any array is sharded
    across devices and orbax is installed, else npz)."""
    os.makedirs(path, exist_ok=True)
    arrays: Dict[str, Any] = {}
    str_arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {"__class__": type(model).__name__}
    dtypes: Dict[str, str] = {}
    any_sharded = False
    for k, v in vars(model).items():
        if k in _SKIP or callable(v):
            continue
        if _is_array(v):
            if getattr(v, "dtype", None) is not None and v.dtype.kind in "OUS":
                str_arrays[k] = np.asarray(v)
                continue
            any_sharded |= _is_multidevice(v)
            arrays[k] = v
        elif hasattr(v, "nnz"):  # scipy matrices (e.g. RankMF features)
            import scipy.sparse as sp
            coo = sp.coo_matrix(v)
            arrays[f"__sp__{k}__row"] = coo.row
            arrays[f"__sp__{k}__col"] = coo.col
            arrays[f"__sp__{k}__val"] = coo.data
            meta.setdefault("__sparse__", {})[k] = list(coo.shape)
        elif _is_jsonable(v):
            meta[k] = v
    if store == "auto":
        store = "orbax" if any_sharded and _have_orbax() else "npz"
    # string / object arrays: npz stores unicode natively; object arrays and
    # the orbax store degrade to JSON lists (restored back to ndarrays),
    # which is only faithful for 1-D arrays
    for k, v in str_arrays.items():
        if store == "npz" and v.dtype.kind in "US":
            arrays[k] = v
        elif v.ndim == 1:
            meta[k] = [str(s) for s in v.tolist()]
            meta.setdefault("__strarr__", []).append(k)
        else:
            raise ValueError(
                f"cannot checkpoint {v.ndim}-D string/object array {k!r} "
                f"(dtype {v.dtype}) in the {store} store")
    if store == "orbax":
        ocp = _orbax()
        meta["__store__"] = "orbax"
        meta["__orbax_arrays__"] = {
            k: [list(np.shape(v)), str(v.dtype)] for k, v in arrays.items()}
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(os.path.abspath(os.path.join(path, "arrays_orbax")),
                   arrays, force=True)
        ckptr.wait_until_finished()
    elif store == "npz":
        np_arrays: Dict[str, np.ndarray] = {}
        for k, v in arrays.items():
            a = np.asarray(v)
            if a.dtype == jnp.bfloat16:
                dtypes[k] = "bfloat16"
                a = a.astype(np.float32)
            np_arrays[k] = a
        np.savez_compressed(os.path.join(path, "arrays.npz"), **np_arrays)
    else:
        raise ValueError(f"unknown store {store!r}")
    meta["__bf16__"] = dtypes
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1, default=str)


def load(path: str, cls: Optional[Type] = None, sharding=None) -> Any:
    """Restore a model saved by :func:`save`.

    ``cls`` may be omitted — the class is looked up in rsparse_tpu's model
    registry by the recorded name.  ``sharding`` optionally re-places factor
    arrays with a jax sharding (for multi-host restore).
    """
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if cls is None:
        import rsparse_tpu
        cls = getattr(rsparse_tpu, meta["__class__"])
    model = cls.__new__(cls)
    bf16 = meta.pop("__bf16__", {})
    sparse_shapes = meta.pop("__sparse__", {})
    store = meta.pop("__store__", "npz")
    orbax_specs = meta.pop("__orbax_arrays__", {})
    strarr = meta.pop("__strarr__", [])
    meta.pop("__class__", None)
    for k, v in meta.items():
        setattr(model, k, np.asarray(v) if k in strarr else v)

    if store == "orbax":
        ckptr = _orbax().StandardCheckpointer()
        p = os.path.abspath(os.path.join(path, "arrays_orbax"))
        # always restore against a concrete target tree built from the saved
        # specs: restoring with no target is topology-dependent (orbax warns
        # UNSAFE, and a checkpoint written on an N-device mesh then has no
        # valid restore on a different device count).  With ``sharding``,
        # float factor arrays land directly in the requested sharding (no
        # host round-trip); everything else restores as host numpy.
        abstract = {}
        for k, (shape, dt) in orbax_specs.items():
            dtype = jnp.bfloat16 if dt == "bfloat16" else np.dtype(dt)
            shardable = (np.issubdtype(np.dtype(dt), np.floating)
                         if dt != "bfloat16" else True)
            shardable = (shardable and not k.startswith("__sp__")
                         and k != "components" and len(shape) > 0)
            sh_k = (_fit_sharding(sharding, shape)
                    if (shardable and sharding is not None) else None)
            if sh_k is not None:
                abstract[k] = jax.ShapeDtypeStruct(
                    tuple(shape), dtype, sharding=sh_k)
            else:
                # numpy template -> restored as a host numpy array
                abstract[k] = np.empty(tuple(shape), dtype)
        restored = ckptr.restore(p, abstract)
        files = {k: restored[k] for k in restored}
    else:
        npz = np.load(os.path.join(path, "arrays.npz"))
        files = {k: npz[k] for k in npz.files}

    sparse_parts: Dict[str, Dict[str, np.ndarray]] = {}
    for k, a in files.items():
        if k.startswith("__sp__"):
            name, part = k[len("__sp__"):].rsplit("__", 1)
            sparse_parts.setdefault(name, {})[part] = np.asarray(a)
            continue
        if store == "orbax" and isinstance(a, jax.Array) and sharding is not None:
            # already restored into the target sharding
            if a.dtype == jnp.bfloat16 or jnp.issubdtype(a.dtype, jnp.floating):
                setattr(model, k, a)
                continue
        a = np.asarray(a)
        if k in bf16 or (store == "orbax"
                         and orbax_specs.get(k, [None, None])[1] == "bfloat16"):
            arr = jnp.asarray(a, jnp.bfloat16)
        elif k in ("components",) or not np.issubdtype(a.dtype, np.floating):
            setattr(model, k, a)
            continue
        else:
            arr = jnp.asarray(a)
        sh_k = _fit_sharding(sharding, arr.shape)
        if sh_k is not None:
            arr = jax.device_put(arr, sh_k)
        setattr(model, k, arr)
    import scipy.sparse as sp
    for name, parts in sparse_parts.items():
        shape = tuple(sparse_shapes[name])
        setattr(model, name, sp.csr_matrix(
            (parts["val"], (parts["row"], parts["col"])), shape=shape))
    # non-serialized runtime state: fresh RNGs, identity preprocess,
    # dtype re-derived from the precision name
    model._rng = np.random.default_rng(0)
    model._key = jax.random.PRNGKey(0)
    if "preprocess" not in vars(model):
        model.preprocess = lambda m: m
    if getattr(model, "precision", None) is not None:
        from ..config import resolve_dtype
        model.dtype = resolve_dtype(model.precision)
    return model
