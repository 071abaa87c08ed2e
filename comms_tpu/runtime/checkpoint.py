"""Pipeline-state checkpoint / resume.

The reference keeps all stream state (FIR tails, phases, LFSR
registers) locked inside per-node structs with no way to save it
(SURVEY.md section 5: "checkpoint/resume: absent").  Here state is an
explicit pytree, so snapshotting a whole pipeline mid-stream is a
pytree device_get + np.savez, and resume is exact: the restored
stream continues bit-identically.

Complex leaves are encoded as float32 pairs on the way out (the
f32-pair boundary API, runtime/boundary.py) and re-encoded
on restore using the pipeline's own init_state as the structure/dtype
template.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

import jax
import jax.numpy as jnp

from comms_tpu.runtime import boundary

__all__ = ["save_state", "load_state"]

_COMPLEX_TAG = "__complex_pairs__"


def _path_fingerprint(tree) -> list[str]:
    """JAX-version-stable structure fingerprint: the keystr of every
    leaf path.  ``str(PyTreeDef)`` formatting changes across JAX
    releases, but key paths ("[0][1]", ".field", "['k']") are the
    documented tree_util surface — comparing them catches a reordered
    or re-nested template even when the writer ran a different JAX."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [jax.tree_util.keystr(path) for path, _ in flat]


def _norm_path(path) -> str:
    """np.savez appends .npz when missing; normalize up front so the
    array file and the json sidecar always share one basename."""
    p = str(path)
    return p if p.endswith(".npz") else p + ".npz"


def save_state(path, state: Any, meta: dict | None = None) -> None:
    """Snapshot a state pytree to an .npz (+ json metadata)."""
    path = _norm_path(path)
    leaves, treedef = jax.tree_util.tree_flatten(state)
    arrays = {}
    tags = []
    for i, leaf in enumerate(leaves):
        arr = jnp.asarray(leaf)
        if jnp.issubdtype(arr.dtype, jnp.complexfloating):
            arr = boundary.complex_to_pairs(arr)
            tags.append(_COMPLEX_TAG)
        else:
            tags.append("")
        arrays[f"leaf_{i}"] = np.asarray(jax.device_get(arr))
    np.savez(path, **arrays)
    sidecar = {
        "num_leaves": len(leaves),
        "tags": tags,
        "treedef": str(treedef),
        # str(PyTreeDef) formatting is not stable across JAX releases;
        # record the writer's version so load_state only enforces the
        # string comparison within the same version.  "paths" is the
        # version-stable fingerprint checked in every case.
        "paths": _path_fingerprint(state),
        "jax_version": jax.__version__,
        "meta": meta or {},
    }
    with open(str(path) + ".json", "w") as f:
        json.dump(sidecar, f)


def load_state(path, like: Any):
    """Restore a pytree saved by :func:`save_state`.

    ``like``: a template pytree with the target structure and dtypes
    (e.g. ``pipeline.init_state()``).
    """
    path = _norm_path(path)
    data = np.load(path)
    with open(path + ".json") as f:
        sidecar = json.load(f)
    like_leaves, treedef = jax.tree_util.tree_flatten(like)
    if len(like_leaves) != sidecar["num_leaves"]:
        raise ValueError(
            f"checkpoint has {sidecar['num_leaves']} leaves, template "
            f"has {len(like_leaves)}"
        )
    same_jax = sidecar.get("jax_version", jax.__version__) == jax.__version__
    if same_jax and sidecar.get("treedef", str(treedef)) != str(treedef):
        raise ValueError(
            "checkpoint structure mismatch: saved treedef "
            f"{sidecar['treedef']!r} != template {str(treedef)!r}"
        )
    paths = _path_fingerprint(like)
    saved_paths = sidecar.get("paths", paths)  # absent in old checkpoints
    if saved_paths != paths:
        raise ValueError(
            "checkpoint structure mismatch: saved leaf paths "
            f"{saved_paths} != template {paths}"
        )
    out = []
    for i, (tag, tmpl) in enumerate(zip(sidecar["tags"], like_leaves)):
        arr = jnp.asarray(data[f"leaf_{i}"])
        if tag == _COMPLEX_TAG:
            arr = boundary.pairs_to_complex(arr).astype(
                jnp.asarray(tmpl).dtype)
        else:
            arr = arr.astype(jnp.asarray(tmpl).dtype)
        out.append(arr)
    return jax.tree_util.tree_unflatten(treedef, out)
