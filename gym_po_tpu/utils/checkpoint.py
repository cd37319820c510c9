"""Checkpoint / resume (SURVEY.md §5).

The reference never persists anything (env state is a few ints per instance).
Here everything — env state pytrees, PPO TrainState, PRNG keys — is a pytree
of arrays, so a checkpoint is the pytree's leaves in one ``numpy.savez``
file per step; resume is exact because the PRNG is counter-based keys
stored in the state itself.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import jax
import numpy as np

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

MAX_TO_KEEP = 3
_NAME = re.compile(r"^step_(\d+)\.npz$")


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m
    )


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}.npz")


def _to_host(leaf):
    if jax.dtypes.issubdtype(getattr(leaf, "dtype", None), jax.dtypes.prng_key):
        leaf = jax.random.key_data(leaf)
    return np.asarray(jax.device_get(leaf))


def save_checkpoint(directory: str, step: int, pytree: Any) -> None:
    """Save a pytree (env state, TrainState, ...) at ``step``; keeps the
    newest ``MAX_TO_KEEP`` steps."""
    os.makedirs(directory, exist_ok=True)
    leaves = jax.tree.leaves(pytree)
    tmp = _path(directory, step) + ".tmp.npz"
    np.savez(tmp, *[_to_host(x) for x in leaves])
    os.replace(tmp, _path(directory, step))
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        os.remove(_path(directory, old))


def restore_checkpoint(
    directory: str, template: Any, step: Optional[int] = None
) -> Any:
    """Restore the pytree saved at ``step`` (default: latest).

    ``template`` is a pytree with the right structure/shapes/dtypes (e.g. a
    freshly-initialized TrainState); restored arrays adopt its sharding.
    """
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    leaves, treedef = jax.tree.flatten(template)
    with np.load(_path(directory, step)) as data:
        saved = [data[f"arr_{i}"] for i in range(len(data.files))]
    if len(saved) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(saved)} leaves, template has {len(leaves)}"
        )
    out = []
    for t, x in zip(leaves, saved):
        if jax.dtypes.issubdtype(getattr(t, "dtype", None), jax.dtypes.prng_key):
            x = jax.random.wrap_key_data(x, impl=jax.random.key_impl(t))
        sharding = getattr(t, "sharding", None)
        out.append(jax.device_put(x, sharding) if sharding is not None
                   else jax.numpy.asarray(x))
    return jax.tree.unflatten(treedef, out)


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None
