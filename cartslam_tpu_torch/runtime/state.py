"""State carried across packages.

The JAX pipeline's state is a tree ``{"modules": {name: {key: array}},
"history": {key: array}}`` of numpy-convertible arrays, and its host params
are ``{name: {key: array}}``.  These two functions map such trees to the
port's tensors and back, keys, shapes and dtypes unchanged, so both packages
can start from the same state.  This system has no weights: its state (the
superpixel labels, the flow's previous gray frame, the temporal vote's
carried ``warp_votes``, the history rings, the provider ranges) takes their
place.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def host_to_device(arr: Any, device) -> torch.Tensor:
    """An array (numpy or array-like) as a tensor of its own on `device`.
    To a card it goes through pinned memory with a non-blocking copy, which
    does not wait for the stream (PyTorch's pinned-memory cache keeps the
    staging block until the copy is done)."""
    device = torch.device(device)
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def state_from_reference(tree: Any, device) -> Any:
    """Nested dict of arrays (numpy or array-likes) -> tensors on `device`."""
    if isinstance(tree, dict):
        return {k: state_from_reference(v, device) for k, v in tree.items()}
    return host_to_device(tree, device)


def state_to_numpy(tree: Any) -> Any:
    """Nested dict of tensors -> numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def map_tree(fn, tree: Any) -> Any:
    """Nested dict with `fn` applied to each leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_trees(trees: list) -> Any:
    """Trees of the same structure -> one tree of their leaves stacked on a
    new leading axis (the multi-sequence batch)."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)
