"""Shared observation-model registry for the rooms family.

The reference keeps three near-copies of an obs-factory
(``rooms.py:15-68``, ``crooms.py:16-88``, ``msrooms.py:192-254``); here one
registry builds single-instance jittable observation functions (vmap for the
batch axis).  Observation semantics re-derived from reference
``gym_po/envs/rooms/observations.py``:

* discrete state grid: ``((grid>=0).cumsum()-1).reshape(...)`` (``:16-29``)
* room-abstract count: #unique room ids (``:32-41``)
* Hansen scalar: neighbor wall/empty bits · 2^i, × (goal_dir+1) (``:44-71``)
* n×n grid window, out-of-bounds redirected to wall cell (0,0) (``:74-103``)
* Hansen vector: per-neighbor {0 wall, 1 empty, 2 goal} (``:106-131``)

Keyword-flag parsing of ``obs_type`` (substring matching on 'vector', 'goal',
'room', 'mdp', 'hansen'/'hansen8', 'grid') mirrors reference ``rooms.py:19-67``.
Continuous variants pre-discretize coordinates by ``cell_size``
(reference ``crooms.py:16-88``; ``coord_to_grid`` in ``rooms/utils.py:15-20``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.spaces import Box, Discrete, Space
from ..utils.actions import ACTIONS_CARDINAL, ACTIONS_ORDINAL

__all__ = [
    "n_discrete_states",
    "state_grid",
    "n_room_states",
    "make_rooms_obs",
]


def n_discrete_states(grid: np.ndarray) -> int:
    return int((grid >= 0).sum())


def state_grid(grid: np.ndarray) -> np.ndarray:
    """Dense walkable-cell id per cell (reference observations.py:16-29)."""
    return ((grid >= 0).cumsum() - 1).reshape(grid.shape)


def n_room_states(grid: np.ndarray) -> int:
    """#rooms, ignoring walls (reference observations.py:32-41)."""
    return len(np.unique(grid)) - 1


def make_rooms_obs(
    obs_type: str,
    grid: np.ndarray,
    obs_n: int = 3,
    cell_size: Optional[float] = None,
) -> Tuple[Space, Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]]:
    """Build (space, obs_fn(agent, goal) -> obs) for a rooms-family grid.

    ``cell_size=None`` -> discrete coordinates (int cells);
    otherwise continuous coordinates pre-discretized by ``cell_size``.
    """
    continuous = cell_size is not None
    is_vector = "vector" in obs_type
    has_goal = "goal" in obs_type
    # flat grid: one gather per lookup
    grid_flat = jnp.asarray(grid.reshape(-1), jnp.int32)
    _W = grid.shape[-1]

    def grid_at(yx):
        """grid[yx[..., 0], yx[..., 1]] from the flat grid."""
        return grid_flat[yx[..., 0] * _W + yx[..., 1]]

    if continuous:
        def to_cell(x):
            return jnp.floor(x / cell_size).astype(jnp.int32)
        a_max = np.asarray(grid.shape, np.float64) - 1 - 1e-6
        mdp_vec_dtype = jnp.float32
        mdp_low = 1.0
    else:
        def to_cell(x):
            return x.astype(jnp.int32)
        a_max = np.asarray(grid.shape, np.int64) - 2
        mdp_vec_dtype = jnp.int32
        mdp_low = 1

    def cell_val(x):
        return grid_at(to_cell(x))

    if "room" in obs_type:
        n = n_room_states(grid)
        if has_goal:
            space = Discrete(int(n**2))
            def obs(agent, goal):
                return cell_val(agent) + n * cell_val(goal)
        else:
            space = Discrete(int(n))
            def obs(agent, goal):
                return cell_val(agent)
    elif "mdp" in obs_type:
        if is_vector:
            if has_goal:
                space = Box(mdp_low, np.tile(a_max, 2), (4,), dtype=mdp_vec_dtype)
                def obs(agent, goal):
                    return jnp.concatenate((agent, goal), -1)
            else:
                space = Box(mdp_low, a_max, (2,), dtype=mdp_vec_dtype)
                def obs(agent, goal):
                    return agent
        else:
            n = n_discrete_states(grid)
            sg_flat = jnp.asarray(state_grid(grid).reshape(-1), jnp.int32)

            def sg_at(yx):
                return sg_flat[yx[..., 0] * _W + yx[..., 1]]

            if has_goal:
                space = Discrete(int(n**2))
                def obs(agent, goal):
                    return sg_at(to_cell(agent)) + n * sg_at(to_cell(goal))
            else:
                space = Discrete(int(n))
                def obs(agent, goal):
                    return sg_at(to_cell(agent))
    elif "hansen" in obs_type:
        base_n = 8 if "8" in obs_type else 4
        offs = jnp.asarray(
            ACTIONS_CARDINAL if base_n == 4 else ACTIONS_ORDINAL, jnp.int32
        )

        def neighbor_vals(agent, goal):
            a, g = to_cell(agent), to_cell(goal)
            nb = a[None, :] + offs  # [k, 2]
            vals = grid_at(nb)  # [k]
            empty = (vals >= 0).astype(jnp.int32)
            is_goal = (nb == g[None, :]).all(-1)  # [k]
            return empty, is_goal

        if is_vector:
            if has_goal:
                space = Box(0, 2, (base_n,), dtype=jnp.int32)
                def obs(agent, goal):
                    empty, is_goal = neighbor_vals(agent, goal)
                    return jnp.where(is_goal, 2, empty)
            else:
                space = Box(0, 1, (base_n,), dtype=jnp.int32)
                def obs(agent, goal):
                    empty, _ = neighbor_vals(agent, goal)
                    return empty
        else:
            space = Discrete(int(2**base_n * (base_n + 1)))
            mult = jnp.asarray([2**i for i in range(base_n)], jnp.int32)
            def obs(agent, goal):
                empty, is_goal = neighbor_vals(agent, goal)
                code = (empty * mult).sum()
                goal_mult = jnp.where(
                    is_goal.any(), jnp.argmax(is_goal).astype(jnp.int32) + 1, 1
                )
                return code * goal_mult
    elif "grid" in obs_type:
        space = Box(0, 2, (obs_n, obs_n), dtype=jnp.int32)
        off = obs_n // 2
        mg = np.mgrid[:obs_n, :obs_n] - off  # [2, n, n]
        mg_j = jnp.asarray(mg.reshape(2, -1).T, jnp.int32)  # [n*n, 2]
        H, W = grid.shape

        def obs(agent, goal):
            a, g = to_cell(agent), to_cell(goal)
            coords = a[None, :] + mg_j  # [n*n, 2]
            oob = (
                (coords[:, 0] < 0)
                | (coords[:, 1] < 0)
                | (coords[:, 0] >= H)
                | (coords[:, 1] >= W)
            )
            # invalid coords redirect to wall cell (0,0): reference :92-98
            coords = jnp.where(oob[:, None], 0, coords)
            is_goal = (coords == g[None, :]).all(-1)
            vals = grid_at(coords)
            sq = jnp.where(is_goal, 2, (vals >= 0).astype(jnp.int32))
            return sq.reshape(obs_n, obs_n)
    elif "lidar" in obs_type:
        # The reference DECLARES this obs type but never implements it
        # (reference crooms.py:139 docstring: "TODO: 'lidar': [bins+2,]
        # vector of range to nearest wall, then 2D for relative xy position
        # of goal").  Implemented here for the continuous envs: fixed-angle
        # DDA ray-march against the wall grid, fixed iteration count
        # (jit-safe), plus the relative goal offset.
        if not continuous:
            raise NotImplementedError("lidar obs requires a continuous env")
        bins = obs_n if obs_n > 2 else 8
        H, Wg = grid.shape
        max_range = float(np.hypot(H, Wg)) * (cell_size or 1.0)
        step_len = 0.5 * (cell_size or 1.0)
        n_march = int(np.ceil(max_range / step_len))
        angles = np.linspace(0.0, 2 * np.pi, bins, endpoint=False)
        dirs = jnp.asarray(
            np.stack([np.sin(angles), np.cos(angles)], -1), jnp.float32
        )  # [bins, 2] (dy, dx)
        space = Box(
            np.concatenate([np.zeros(bins), -np.asarray(a_max, np.float64)]),
            np.concatenate([np.full(bins, max_range), np.asarray(a_max, np.float64)]),
            (bins + 2,),
            dtype=jnp.float32,
        )

        def ray_ranges(agent):
            pos = agent.astype(jnp.float32)  # [2]

            def march(carry, t):
                hit_t = carry
                probe = pos[None, :] + dirs * t  # [bins, 2]
                cy = jnp.clip(
                    jnp.floor(probe[:, 0] / (cell_size or 1.0)), 0, H - 1
                ).astype(jnp.int32)
                cx = jnp.clip(
                    jnp.floor(probe[:, 1] / (cell_size or 1.0)), 0, Wg - 1
                ).astype(jnp.int32)
                inside = (
                    (probe[:, 0] >= 0)
                    & (probe[:, 0] < H * (cell_size or 1.0))
                    & (probe[:, 1] >= 0)
                    & (probe[:, 1] < Wg * (cell_size or 1.0))
                )
                wall = (grid_flat[cy * _W + cx] < 0) | ~inside
                hit_t = jnp.where(wall & (t < hit_t), t, hit_t)
                return hit_t, None

            ts = jnp.arange(1, n_march + 1, dtype=jnp.float32) * step_len
            hit_t, _ = jax.lax.scan(
                march, jnp.full((bins,), max_range, jnp.float32), ts
            )
            return hit_t

        def obs(agent, goal):
            ranges = ray_ranges(agent)
            rel = (goal - agent).astype(jnp.float32)
            return jnp.concatenate([ranges, rel])
    else:
        raise NotImplementedError(f"Observation type {obs_type!r} not recognized")

    return space, obs
