"""Parameter trees in and out of the port, without JAX.

- ``params_from_numpy(tree)``: a nested dict/list of numpy arrays (the
  reference's ``init_tft`` tree after ``np.asarray`` on every leaf) becomes
  the same nesting of float32 tensors.
- ``tree_to(tree, device)``: a tree of tensors as float32 on ``device``.
- ``load_checkpoint(directory)``: reads a reference ``Checkpointer``
  checkpoint (``step_<n>/arrays.npz`` whose keys are tree paths joined with
  ``"::"``, ``repro/train/checkpoint.py:29-37``) into such a tree.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

SEP = "::"  # the reference checkpoint's path separator


def params_from_numpy(tree: Any, *, device=None) -> Any:
    """Nested dicts/lists/tuples of array-likes -> same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device=device) for v in tree]
    arr = np.asarray(tree)
    if np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def tree_to(tree: Any, device: torch.device) -> Any:
    """The same nesting with every tensor as float32 on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.to(device=device, dtype=torch.float32)


def _nest(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = root
        *parents, leaf = key.split(SEP)
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr

    def listify(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        kids = {k: listify(v) for k, v in node.items()}
        if kids and all(k.isdigit() for k in kids):
            return [kids[str(i)] for i in range(len(kids))]
        return kids

    return listify(root)


def load_checkpoint(directory: str, *, step: Optional[int] = None, device=None) -> Any:
    """The tree saved by a reference ``Checkpointer`` (latest step by default).

    Integer path segments become list indices, as the reference's
    ``SequenceKey`` wrote them. Empty subtrees (such as a ReLU's ``{}``)
    hold no arrays and are absent from the result.

    Raises:
        FileNotFoundError: the directory holds no checkpoint.
    """
    if step is None:
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(directory) if n.startswith("step_"))
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        step = steps[-1]
    path = os.path.join(directory, f"step_{step:012d}", "arrays.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return params_from_numpy(_nest(flat), device=device)
