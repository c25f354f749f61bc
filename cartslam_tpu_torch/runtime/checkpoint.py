"""Checkpoint/resume of the pipeline state (the port's counterpart of
cartslam_tpu/runtime/checkpoint.py, with the same file layout).

One ``.npz`` holds everything that persists across frames: ``__meta__``, a
JSON object with ``frame_id``, ``treedef`` and ``host_state`` (the modules'
running histograms and plane ranges), then ``leaf_0``, ``leaf_1``, ... the
state tree's arrays in JAX's flatten order (dict keys sorted).  ``treedef``
is written as ``str(treedef)`` of JAX's flatten of the same tree, so the
two packages resume each other's checkpoints; loading checks the saved
structure, and each leaf's shape and dtype, against the port's own state.
"""

from __future__ import annotations

import json

import numpy as np

from .state import state_to_numpy


def _flatten(tree) -> tuple[list[np.ndarray], str]:
    """(leaves in sorted-key order, the tree's structure as JAX prints its
    treedef: dicts with sorted keys, a leaf as '*')."""
    if isinstance(tree, dict):
        leaves, parts = [], []
        for k in sorted(tree):
            sub, text = _flatten(tree[k])
            leaves += sub
            parts.append(f"{k!r}: {text}")
        return leaves, "{" + ", ".join(parts) + "}"
    return [np.asarray(tree)], "*"


def treedef_str(tree) -> str:
    return f"PyTreeDef({_flatten(tree)[1]})"


def _unflatten(example, leaves: list):
    if isinstance(example, dict):
        return {k: _unflatten(example[k], leaves) for k in sorted(example)}
    return leaves.pop(0)


def _jsonable(x):
    if isinstance(x, np.ndarray):
        return {"__nd__": x.tolist(), "dtype": str(x.dtype)}
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    raise TypeError(type(x))


def _unjson(x):
    if isinstance(x, dict) and "__nd__" in x:
        return np.array(x["__nd__"], dtype=x["dtype"])
    if isinstance(x, dict):
        return {k: _unjson(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_unjson(v) for v in x]
    return x


def save_checkpoint(path: str, state, frame_id: int, host_state: dict | None = None) -> None:
    """state: the pipeline's state tree (tensors or arrays)."""
    leaves, text = _flatten(state_to_numpy(state))
    meta = {"frame_id": int(frame_id), "treedef": f"PyTreeDef({text})",
            "host_state": host_state or {}}
    arrays = {f"leaf_{i}": v for i, v in enumerate(leaves)}
    np.savez_compressed(path, __meta__=json.dumps(meta, default=_jsonable), **arrays)


def load_checkpoint(path: str, example_state):
    """Restores the saved leaves into the structure of `example_state`
    (tensors or arrays).  Returns (state as numpy arrays, frame_id,
    host_state).  Raises ValueError when the structure, the leaf count or
    a leaf's shape or dtype differs from the example's."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    example = state_to_numpy(example_state)
    want, text = _flatten(example)
    saved = meta.get("treedef")
    if saved and saved != f"PyTreeDef({text})":
        raise ValueError(
            f"checkpoint '{path}' was saved by a pipeline with a different state "
            f"structure:\n  saved:   {saved}\n  current: PyTreeDef({text})")
    n = len(data.files) - 1
    if n != len(want):
        raise ValueError(f"checkpoint '{path}' holds {n} state leaves, the pipeline "
                         f"{len(want)}")
    leaves = [data[f"leaf_{i}"] for i in range(n)]
    for i, (got, ref) in enumerate(zip(leaves, want)):
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise ValueError(f"checkpoint '{path}' leaf {i}: {got.shape} {got.dtype}, the "
                             f"pipeline's state has {ref.shape} {ref.dtype}")
    return _unflatten(example, leaves), meta["frame_id"], _unjson(meta["host_state"])
