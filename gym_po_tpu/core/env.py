"""Core functional environment protocol.

Design (accelerator-first, contrast with the reference's stateful gymnasium classes,
e.g. reference ``gym_po/envs/extended_taxi.py:149-287``):

* An :class:`Environment` instance holds only *static, host-compiled* data
  (lookup tables, spaces).  All mutable episode state lives in an immutable
  ``EnvState`` pytree threaded through pure functions.
* ``reset(key) -> (obs, state)`` and
  ``step(key, state, action) -> (obs, state, reward, done, trunc, info)``
  are single-instance pure functions: jit-, vmap-, scan- and shard_map-safe.
* ``step`` performs **in-graph autoreset** with the reference's
  reset-before-obs semantics (reference ``extended_taxi.py:286-287``): for
  environments that finished, the returned obs belongs to the *new* episode.
  ``info["terminal_state"]`` exposes the pre-reset state for wrappers that
  need the final observation.
* Every environment additionally factors its dynamics into deterministic
  stages (``transition``-style pure functions taking randomness as explicit
  inputs).  The jitted ``step`` composes them with ``jax.random`` draws; the
  NumPy-parity harness (:mod:`gym_po_tpu.compat.parity`) composes the *same*
  stages with draws mirrored from the reference's ``np.random.Generator``
  consumption order, giving bit-exact trajectory equality under a fixed seed.
"""

from __future__ import annotations

from typing import Any, Dict, Generic, Tuple, TypeVar

import jax

from .pytree import PyTreeNode
from .spaces import Space

__all__ = ["EnvState", "Environment", "PyTreeNode", "StepOut"]


class EnvState(PyTreeNode):
    """Base class for per-instance environment state pytrees.

    ``elapsed`` mirrors the reference's per-env step counter
    (reference ``extended_taxi.py:189``).
    """

    elapsed: jax.Array


TState = TypeVar("TState", bound=EnvState)

# (obs, state, reward, done, truncated, info)
StepOut = Tuple[jax.Array, TState, jax.Array, jax.Array, jax.Array, Dict[str, Any]]


class Environment(Generic[TState]):
    """Single-instance pure-functional environment.

    Subclasses precompute all lookup tables on the host in ``__init__`` and
    implement ``reset_env`` / ``step_env``.  Batch execution is obtained with
    ``jax.vmap`` (see :mod:`gym_po_tpu.vector`), multi-device execution with
    ``shard_map`` over a device mesh (see :mod:`gym_po_tpu.parallel`).
    """

    #: human-readable name, mirrors reference ``metadata['name']``
    name: str = "Environment"

    # ---------------------------------------------------------------- spaces
    @property
    def observation_space(self) -> Space:
        raise NotImplementedError

    @property
    def action_space(self) -> Space:
        raise NotImplementedError

    # ------------------------------------------------------------- protocol
    def reset(self, key: jax.Array) -> Tuple[jax.Array, TState]:
        """Start a fresh episode."""
        return self.reset_env(key)

    def step(self, key: jax.Array, state: TState, action: jax.Array) -> StepOut:
        """Advance one step with in-graph autoreset (reset-before-obs)."""
        return self.step_env(key, state, action)

    # ------------------------------------------------------ implementations
    def reset_env(self, key: jax.Array) -> Tuple[jax.Array, TState]:
        raise NotImplementedError

    def step_env(self, key: jax.Array, state: TState, action: jax.Array) -> StepOut:
        raise NotImplementedError

    # ------------------------------------------------------ batched fast path
    # Splitting one key per env per step costs a threefry block per env on
    # top of every actual draw — measured ~2.5x slower than drawing [B]-shaped
    # randomness from ONE key on the previous accelerator.  The
    # defaults below are correct for any env; each env overrides them with a
    # batched-draw version.  Distributions are identical; only the key->draw
    # mapping differs, so perf-mode trajectories differ from vmap(step) for
    # the same key (parity mode is unaffected — it feeds explicit draws).
    def reset_vec(self, key: jax.Array, num_envs: int) -> Tuple[jax.Array, TState]:
        """Reset a batch of ``num_envs`` instances."""
        return jax.vmap(self.reset)(jax.random.split(key, num_envs))

    def step_vec(self, key: jax.Array, state: TState, action: jax.Array) -> StepOut:
        """Step a batch (leading axis inferred from ``state``)."""
        num = jax.tree_util.tree_leaves(state)[0].shape[0]
        return jax.vmap(self.step)(jax.random.split(key, num), state, action)

    # --------------------------------------------------------------- extras
    def observe(self, state: TState) -> jax.Array:
        """Observation as a pure function of state."""
        raise NotImplementedError

    def observe_vec(self, state: TState) -> jax.Array:
        """Batched :meth:`observe` (leading axis on every state leaf).

        Used by learners to observe ``info["terminal_state"]`` — the
        pre-reset state — so truncated episodes can bootstrap their value
        targets through the time limit.
        """
        return jax.vmap(self.observe)(state)

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}({self.name})"
