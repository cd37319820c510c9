"""Vectorizable JAX C-ROOMS (continuous rooms).

Re-expresses the reference ``CRoomsEnv`` (reference
``gym_po/envs/rooms/crooms.py:91-338``) as a pure-functional JAX environment:
continuous (y, x) coordinates over the same 12 layouts, optional velocity
dynamics, wall hits resolved by resampling within the current cell.

Dynamics are factored into deterministic stages taking all randomness as
explicit inputs, shared between perf mode (``jax.random``) and the bit-exact
NumPy-parity harness (``gym_po_tpu/compat/parity.py``).

Replicated reference quirks (documented, numerics preserved):

* ``self.rng`` is a private stream seeded only through ``seed()`` — distinct
  from gymnasium ``np_random`` (reference crooms.py:168,246-249).
* Random spawns and the fixed *goal* spawn convert cell -> coordinate with the
  default ``cell_size=1.0`` even when the env's ``cell_size`` differs; only the
  fixed *agent* spawn passes ``cell_size`` (reference crooms.py:222-244).
* Wall-hit resample noise has fixed scale 0.5 regardless of ``cell_size``
  (reference crooms.py:324).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import Box, Discrete, Environment, EnvState
from ..maps.layouts import LAYOUT_NAMES, layout_end, layout_grid, layout_start
from ..obs.observations import make_rooms_obs
from ..utils.actions import (
    ACTIONS_CARDINAL,
    ACTIONS_ORDINAL,
    failure_cumsum,
    make_exec_action,
)

__all__ = ["CRooms", "CRoomsState"]

MAX_VELOCITY = 5.0  # reference crooms.py:169


def grid_to_coord_np(cell_yx: np.ndarray, cell_size: float = 1.0) -> np.ndarray:
    """Cell index -> cell-center coordinate (reference rooms/utils.py:7-12)."""
    return (cell_yx * cell_size) + (cell_size / 2)


class CRoomsState(EnvState):
    agent_yx: jax.Array  # float [2]
    goal_yx: jax.Array  # float [2]
    vel_yx: jax.Array  # float [2]


class CRooms(Environment[CRoomsState]):
    """Continuous ROOMS domain.

    Args mirror the reference constructor (reference crooms.py:104-153) minus
    ``num_envs``/``render_mode``.  Defaults preserved: layout '4', 500-step
    limit, no velocity, cell_size 1.0, 'mdp' obs, 0.2 action failure, 'yx'
    continuous actions, action noise std 0.2, power 1.0, fixed goal at the
    layout end, random agent, rewards (0, 0, 1), goal threshold 0.5.
    """

    def __init__(
        self,
        layout: str = "4",
        time_limit: int = 500,
        use_velocity: bool = False,
        cell_size: float = 1.0,
        obs_type: str = "mdp",
        obs_m: int = 3,
        action_failure_probability: float = 0.2,
        action_type: str = "yx",
        action_std: float = 0.2,
        action_power: float = 1.0,
        agent_xy: Optional[Sequence[int]] = None,
        goal_xy: Optional[Sequence[int]] = (0, 0),
        step_reward: float = 0.0,
        wall_reward: float = 0.0,
        goal_reward: float = 1.0,
        goal_threshold: float = 0.5,
        **kwargs,
    ):
        assert layout in LAYOUT_NAMES
        self.name = f"CRooms__{layout}__{action_type}__{obs_type}"
        self.layout = layout
        grid = layout_grid(layout)
        self.grid_np = grid
        self.gridshape = np.asarray(grid.shape, np.int64)
        self.time_limit = int(time_limit)
        self.use_velocity = bool(use_velocity)
        self.cell_size = float(cell_size)
        self.action_type = action_type
        self.action_std = float(action_std)
        self.action_power = float(action_power)
        self.step_reward = float(step_reward)
        self.wall_reward = float(wall_reward)
        self.goal_reward = float(goal_reward)
        self.goal_threshold = float(goal_threshold)

        self._grid = jnp.asarray(grid, jnp.int32)
        self._grid_flat = jnp.asarray(grid.reshape(-1), jnp.int32)
        self._W = grid.shape[1]
        # position clip ceiling (reference crooms.py:312-314), f64 on host
        self._pos_hi = self.gridshape.astype(np.float64) - 1 - 1e-6

        if action_type == "yx":
            self._action_space = Box(-1.0, 1.0, (2,), dtype=jnp.float32)
            self.num_actions = None
            self._disp = None
            self._cum = None
            self._exec = None
        else:
            actions = (
                ACTIONS_CARDINAL if action_type == "cardinal" else ACTIONS_ORDINAL
            )
            self.num_actions = actions.shape[0]
            self._disp = jnp.asarray(actions, jnp.float32)
            self._disp_np = np.asarray(actions, np.int64)
            self._cum = failure_cumsum(self.num_actions, action_failure_probability)
            self._exec = make_exec_action(self._cum)
            self._action_space = Discrete(self.num_actions)

        # param is named ``obs_m`` to mirror the reference exactly
        # (reference crooms.py:112 uses obs_m; rooms.py:90/msrooms.py:273 use obs_n)
        # 'vel' in obs_type appends the velocity to any VECTOR obs — the
        # reference declares this but never implements it (reference
        # crooms.py:131: "TODO: Velocity as part of observation")
        self.obs_includes_velocity = "vel" in obs_type.replace("velocity", "vel")
        base_obs_type = obs_type.replace("velocity", "").replace("vel", "")
        base_obs_type = base_obs_type.strip("_") or "mdp"
        self._observation_space, self._obs_fn = make_rooms_obs(
            base_obs_type, grid, obs_m, cell_size=self.cell_size
        )
        if self.obs_includes_velocity:
            from ..core import Box as _Box

            sp = self._observation_space
            if not hasattr(sp, "low_arr") or len(sp.shape) != 1:
                raise NotImplementedError(
                    "'vel' obs flag requires a 1-D vector obs_type"
                )
            self._observation_space = _Box(
                np.concatenate([sp.low_arr, [-MAX_VELOCITY, -MAX_VELOCITY]]),
                np.concatenate([sp.high_arr, [MAX_VELOCITY, MAX_VELOCITY]]),
                (sp.shape[0] + 2,),
                dtype=sp.dtype,
            )

        self.valid_states = np.flatnonzero(grid >= 0)
        valid_yx = np.stack(np.unravel_index(self.valid_states, grid.shape), -1)
        # random spawn: cell center with implicit cell_size=1.0 (quirk above)
        self._valid_coord = jnp.asarray(grid_to_coord_np(valid_yx, 1.0))

        # fixed spawns (reference crooms.py:216-244)
        self.fixed_goal_coord: Optional[np.ndarray] = None
        if goal_xy is not None:
            yx = tuple(reversed(goal_xy))
            if grid[yx] < 0:
                yx = tuple(reversed(layout_end(layout)))
            self.fixed_goal_coord = grid_to_coord_np(np.asarray(yx, np.int64), 1.0)
        self.fixed_agent_coord: Optional[np.ndarray] = None
        if agent_xy is not None:
            yx = tuple(reversed(agent_xy))
            if grid[yx] < 0:
                yx = tuple(reversed(layout_start(layout)))
            self.fixed_agent_coord = grid_to_coord_np(
                np.asarray(yx, np.int64), self.cell_size
            )

    # ---------------------------------------------------------------- spaces
    @property
    def action_space(self):
        return self._action_space

    @property
    def observation_space(self):
        return self._observation_space

    # ------------------------------------------------- deterministic stages
    def _cell(self, coord: jax.Array) -> jax.Array:
        """coord -> cell index (reference rooms/utils.py:15-20)."""
        return jnp.floor(coord / self.cell_size).astype(jnp.int32)

    def _wall_at(self, coord: jax.Array) -> jax.Array:
        c = self._cell(coord)
        return self._grid_flat[c[..., 0] * self._W + c[..., 1]] == -1

    def displacement(self, executed: jax.Array) -> jax.Array:
        """Discrete executed action -> float displacement."""
        return self._disp[executed]

    def propose(
        self, state: CRoomsState, a_eff: jax.Array
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Stage A: proposed position from the effective action.

        Velocity integration + grid clip + wall test
        (reference crooms.py:300-315).  Returns (proposed, vel_new, oob).
        """
        dt = state.agent_yx.dtype
        if self.use_velocity:
            vel = jnp.clip(state.vel_yx + a_eff, -MAX_VELOCITY, MAX_VELOCITY)
            proposed = state.agent_yx + vel
        else:
            vel = state.vel_yx
            proposed = state.agent_yx + a_eff
        proposed = jnp.clip(proposed, 0, jnp.asarray(self._pos_hi, dt))
        return proposed, vel, self._wall_at(proposed)

    def resolve(
        self,
        state: CRoomsState,
        proposed: jax.Array,
        vel_new: jax.Array,
        oob: jax.Array,
        cell_noise: jax.Array,
    ) -> Tuple[CRoomsState, jax.Array, jax.Array, jax.Array]:
        """Stage B: commit movement, wall resample, rewards.

        ``cell_noise`` is the N(0, 0.5) draw used only when ``oob``
        (reference crooms.py:316-330).  Returns (mid_state, rew, done, trunc).
        """
        dt = state.agent_yx.dtype
        elapsed = state.elapsed + 1
        cs = self.cell_size
        center = (self._cell(state.agent_yx) * cs + cs / 2).astype(dt)
        # upper bound: reference uses boundary - 1e-8 (crooms.py:327).  In f32
        # perf mode that margin underflows (cell+1-1e-8 rounds to cell+1), so
        # additionally clamp one ULP below the boundary; in f64 parity mode
        # nextafter(boundary) > boundary-1e-8 and the minimum is a no-op.
        boundary = center + cs / 2
        hi = jnp.minimum(
            boundary - 1e-8, jnp.nextafter(boundary, jnp.zeros_like(boundary))
        )
        resampled = jnp.clip(center + cell_noise, center - cs / 2, hi)
        agent = jnp.where(oob, resampled, proposed)
        vel = jnp.where(oob, jnp.zeros_like(vel_new), vel_new)
        diff = agent - state.goal_yx
        done = jnp.sqrt((diff * diff).sum(-1)) <= self.goal_threshold
        rew = jnp.where(
            done,
            jnp.float32(self.goal_reward),
            jnp.where(
                oob, jnp.float32(self.wall_reward), jnp.float32(self.step_reward)
            ),
        )
        trunc = elapsed > self.time_limit
        mid = state.replace(agent_yx=agent, vel_yx=vel, elapsed=elapsed)
        return mid, rew, done, trunc

    def apply_reset(
        self,
        state: CRoomsState,
        mask: jax.Array,
        goal_new: jax.Array,
        agent_new: jax.Array,
    ) -> CRoomsState:
        """Masked partial reset, zero velocity (reference crooms.py:268-274)."""
        return state.replace(
            agent_yx=jnp.where(mask, agent_new, state.agent_yx),
            goal_yx=jnp.where(mask, goal_new, state.goal_yx),
            vel_yx=jnp.where(mask, jnp.zeros_like(state.vel_yx), state.vel_yx),
            elapsed=jnp.where(mask, 0, state.elapsed),
        )

    def observe(self, state: CRoomsState) -> jax.Array:
        base = self._obs_fn(state.agent_yx, state.goal_yx)
        if self.obs_includes_velocity:
            return jnp.concatenate(
                [base.astype(jnp.float32), state.vel_yx.astype(jnp.float32)], -1
            )
        return base

    # ------------------------------------------------------- random sampling
    def sample_goal(self, key: jax.Array, dtype=jnp.float32) -> jax.Array:
        if self.fixed_goal_coord is not None:
            return jnp.asarray(self.fixed_goal_coord, dtype)
        idx = jax.random.randint(key, (), 0, self._valid_coord.shape[0])
        return self._valid_coord[idx].astype(dtype)

    def sample_agent(self, key: jax.Array, dtype=jnp.float32) -> jax.Array:
        if self.fixed_agent_coord is not None:
            return jnp.asarray(self.fixed_agent_coord, dtype)
        idx = jax.random.randint(key, (), 0, self._valid_coord.shape[0])
        return self._valid_coord[idx].astype(dtype)

    def sample_effective_action(self, key: jax.Array, action: jax.Array) -> jax.Array:
        """Perf-mode action randomization (reference crooms.py:171-198)."""
        if self.action_type == "yx":
            noise = jax.random.normal(key, (2,), action.dtype) * self.action_std
            return (action + noise) * self.action_power
        ku, kn = jax.random.split(key)
        u = jax.random.uniform(ku, ())
        executed = self._exec(action, u)
        disp = self.displacement(executed)
        if self.action_std:
            disp = disp + jax.random.normal(kn, (2,), disp.dtype) * self.action_std
        return disp * self.action_power

    # -------------------------------------------------------------- protocol
    def reset_env(self, key: jax.Array) -> Tuple[jax.Array, CRoomsState]:
        kg, ka = jax.random.split(key)
        state = CRoomsState(
            elapsed=jnp.zeros((), jnp.int32),
            agent_yx=self.sample_agent(ka),
            goal_yx=self.sample_goal(kg),
            vel_yx=jnp.zeros(2, jnp.float32),
        )
        return self.observe(state), state

    def step_env(
        self, key: jax.Array, state: CRoomsState, action: jax.Array
    ) -> Tuple[jax.Array, CRoomsState, jax.Array, jax.Array, jax.Array, Dict[str, Any]]:
        ka, kc, kg, kag = jax.random.split(key, 4)
        a_eff = self.sample_effective_action(ka, action)
        proposed, vel_new, oob = self.propose(state, a_eff)
        dt = state.agent_yx.dtype
        cell_noise = jax.random.normal(kc, (2,), dt) * jnp.asarray(0.5, dt)
        mid, rew, done, trunc = self.resolve(state, proposed, vel_new, oob, cell_noise)
        reset_mask = done | trunc
        new_state = self.apply_reset(
            mid, reset_mask, self.sample_goal(kg, dt), self.sample_agent(kag, dt)
        )
        obs = self.observe(new_state)
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return obs, new_state, rew, done, trunc, info

    # ------------------------------------------------------ batched fast path
    def _sample_spawn_vec(self, key, num: int, fixed, dtype) -> jax.Array:
        if fixed is not None:
            return jnp.broadcast_to(jnp.asarray(fixed, dtype), (num, 2))
        idx = jax.random.randint(key, (num,), 0, self._valid_coord.shape[0])
        return self._valid_coord[idx].astype(dtype)

    def _sample_effective_vec(self, key, action: jax.Array) -> jax.Array:
        B = action.shape[0]
        if self.action_type == "yx":
            noise = jax.random.normal(key, (B, 2), action.dtype) * self.action_std
            return (action + noise) * self.action_power
        ku, kn = jax.random.split(key)
        u = jax.random.uniform(ku, (B,))
        executed = self._exec(action, u)  # polymorphic
        disp = self._disp[executed]
        if self.action_std:
            disp = disp + jax.random.normal(kn, (B, 2), disp.dtype) * self.action_std
        return disp * self.action_power

    def reset_vec(self, key: jax.Array, num_envs: int):
        kg, ka = jax.random.split(key)
        state = CRoomsState(
            elapsed=jnp.zeros(num_envs, jnp.int32),
            agent_yx=self._sample_spawn_vec(
                ka, num_envs, self.fixed_agent_coord, jnp.float32
            ),
            goal_yx=self._sample_spawn_vec(
                kg, num_envs, self.fixed_goal_coord, jnp.float32
            ),
            vel_yx=jnp.zeros((num_envs, 2), jnp.float32),
        )
        return jax.vmap(self.observe)(state), state

    def step_vec(self, key: jax.Array, state: CRoomsState, action: jax.Array):
        B = action.shape[0]
        ka, kc, kg, kag = jax.random.split(key, 4)
        a_eff = self._sample_effective_vec(ka, action)
        proposed, vel_new, oob = jax.vmap(self.propose)(state, a_eff)
        dt = state.agent_yx.dtype
        cell_noise = jax.random.normal(kc, (B, 2), dt) * jnp.asarray(0.5, dt)
        mid, rew, done, trunc = jax.vmap(self.resolve)(
            state, proposed, vel_new, oob, cell_noise
        )
        reset_mask = done | trunc
        new_state = jax.vmap(self.apply_reset)(
            mid,
            reset_mask,
            self._sample_spawn_vec(kg, B, self.fixed_goal_coord, dt),
            self._sample_spawn_vec(kag, B, self.fixed_agent_coord, dt),
        )
        obs = jax.vmap(self.observe)(new_state)
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return obs, new_state, rew, done, trunc, info
