"""Action tables and stochastic action-failure machinery.

Re-derived from reference ``gym_po/envs/rooms/action_utils.py``:

* ordinal/cardinal displacement tables (``:16-35``)
* row-stochastic failure matrix: ``1-p`` on the diagonal, ``p/(A-1)``
  elsewhere (``:38-48``)
* cumsum-threshold sampler: executed = #(cumsum(P[a]) < u) (``:73-90``)

The deterministic part (cumsum comparison) is a shared jittable stage;
only the uniform draw ``u`` differs between perf mode (``jax.random``) and the
NumPy-parity harness (host ``Generator.random`` in float64, compared on host
to avoid f32 boundary flips).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "ACTIONS_ORDINAL",
    "ACTIONS_CARDINAL",
    "ACTIONS_ORDINAL_Z",
    "ACTIONS_CARDINAL_Z",
    "ACTION_NAMES_ORDINAL",
    "ACTION_NAMES_CARDINAL",
    "failure_matrix",
    "failure_cumsum",
    "exec_action_np",
    "make_exec_action",
]

# N, NE, E, SE, S, SW, W, NW — (dy, dx)
ACTIONS_ORDINAL = np.array(
    [[-1, 0], [-1, 1], [0, 1], [1, 1], [1, 0], [1, -1], [0, -1], [-1, -1]],
    dtype=np.int64,
)
ACTIONS_CARDINAL = ACTIONS_ORDINAL[::2]  # N, E, S, W
ACTIONS_ORDINAL_Z = np.concatenate(
    (np.zeros((8, 1), dtype=np.int64), ACTIONS_ORDINAL), -1
)
ACTIONS_CARDINAL_Z = ACTIONS_ORDINAL_Z[::2]
ACTION_NAMES_ORDINAL = ["N", "NE", "E", "SE", "S", "SW", "W", "NW"]
ACTION_NAMES_CARDINAL = ACTION_NAMES_ORDINAL[::2]


def failure_matrix(action_n: int, p: float) -> np.ndarray:
    """[A, A] row-stochastic matrix, 1-p diagonal, p/(A-1) off-diagonal."""
    m = np.full((action_n, action_n), p / (action_n - 1), dtype=np.float64)
    np.fill_diagonal(m, 1.0 - p)
    return m


def failure_cumsum(action_n: int, p: float) -> np.ndarray:
    """Row-wise cumsum of :func:`failure_matrix` (float64, host-exact)."""
    return failure_matrix(action_n, p).cumsum(axis=1)


def exec_action_np(cum: np.ndarray, actions: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Host-exact executed-action sampler (reference action_utils.py:73-90)."""
    return (cum[actions] < u[:, None]).sum(axis=1)


def make_exec_action(cum: np.ndarray):
    """Jittable executed-action stage: (action, u) -> action'.

    Shape-polymorphic (scalar or [B] leading axis); the failure-matrix row
    lookup is a small-table gather.
    """
    cum_j = jnp.asarray(cum, jnp.float32)

    def exec_action(action: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        rows = cum_j[action]  # [..., A]
        return (rows < u[..., None]).sum(-1).astype(jnp.int32)

    return exec_action
