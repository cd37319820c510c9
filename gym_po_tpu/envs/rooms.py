"""Vectorizable JAX ROOMS (discrete).

Re-expresses the reference ``RoomsEnv`` (reference
``gym_po/envs/rooms/rooms.py:71-227``) as a pure-functional JAX environment:
grid lookups for collision, cumsum-threshold action failure, masked in-graph
autoreset.  Dynamics are factored into deterministic stages shared with the
NumPy-parity harness (``gym_po_tpu/compat/parity.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import Discrete, Environment, EnvState
from ..maps.layouts import LAYOUT_NAMES, layout_end, layout_grid, layout_start
from ..obs.observations import make_rooms_obs
from ..utils.actions import (
    ACTIONS_CARDINAL,
    ACTIONS_ORDINAL,
    failure_cumsum,
    make_exec_action,
)

__all__ = ["Rooms", "RoomsState"]


class RoomsState(EnvState):
    agent_yx: jax.Array  # int32 [2]
    goal_yx: jax.Array  # int32 [2]


class Rooms(Environment[RoomsState]):
    """Discrete ROOMS domain (12 layouts, 1–32 rooms).

    Args mirror the reference constructor (reference rooms.py:84-118) minus
    ``num_envs``/``render_mode``.  Defaults preserved: layout '4', 500-step
    time limit, 'mdp' obs, 0.2 action failure, ordinal actions, fixed goal at
    the layout end, random agent spawn, rewards (0, 0, 1).
    """

    def __init__(
        self,
        layout: str = "4",
        time_limit: int = 500,
        obs_type: str = "mdp",
        obs_n: int = 3,
        action_failure_probability: float = 0.2,
        action_type: str = "ordinal",
        agent_xy: Optional[Sequence[int]] = None,
        goal_xy: Optional[Sequence[int]] = (0, 0),
        step_reward: float = 0.0,
        wall_reward: float = 0.0,
        goal_reward: float = 1.0,
        **kwargs,
    ):
        assert layout in LAYOUT_NAMES
        self.name = f"Rooms__{layout}__{action_type}__{obs_type}"
        self.layout = layout
        grid = layout_grid(layout)
        self.grid_np = grid
        self.time_limit = int(time_limit)
        self.step_reward = float(step_reward)
        self.wall_reward = float(wall_reward)
        self.goal_reward = float(goal_reward)

        self._grid = jnp.asarray(grid, jnp.int32)
        self._grid_flat = jnp.asarray(grid.reshape(-1), jnp.int32)
        self._W = grid.shape[1]
        actions = ACTIONS_CARDINAL if action_type == "cardinal" else ACTIONS_ORDINAL
        self._actions = jnp.asarray(actions, jnp.int32)
        self.num_actions = actions.shape[0]
        self._cum = failure_cumsum(self.num_actions, action_failure_probability)
        self._exec = make_exec_action(self._cum)

        self._observation_space, self._obs_fn = make_rooms_obs(obs_type, grid, obs_n)
        self._action_space = Discrete(self.num_actions)

        # Spawn cells: flat indices of walkable cells (reference rooms.py:130-132)
        self.valid_states = np.flatnonzero(grid >= 0)
        valid_yx = np.stack(np.unravel_index(self.valid_states, grid.shape), -1)
        self._valid_yx = jnp.asarray(valid_yx, jnp.int32)

        # Fixed-vs-random spawn resolution (reference rooms.py:152-172):
        # an invalid fixed coordinate falls back to the layout default.
        # STARTS/ENDS are (x, y) and get reversed (reference rooms.py:156,167).
        self.fixed_goal_yx = self._resolve_fixed(
            goal_xy, tuple(reversed(layout_end(layout)))
        )
        self.fixed_agent_yx = self._resolve_fixed(
            agent_xy, tuple(reversed(layout_start(layout)))
        )

    def _resolve_fixed(self, xy, default_yx) -> Optional[np.ndarray]:
        if xy is None:
            return None
        yx = tuple(reversed(xy))
        if self.grid_np[yx] < 0:
            yx = default_yx
        return np.asarray(yx, np.int64)

    # ---------------------------------------------------------------- spaces
    @property
    def action_space(self) -> Discrete:
        return self._action_space

    @property
    def observation_space(self):
        return self._observation_space

    # ------------------------------------------------- deterministic stages
    def exec_action(self, action: jax.Array, u: jax.Array) -> jax.Array:
        """Stochastic action failure given uniform u (reference rooms.py:210)."""
        return self._exec(action, u)

    def advance(
        self, state: RoomsState, executed: jax.Array
    ) -> Tuple[RoomsState, jax.Array, jax.Array, jax.Array]:
        """Deterministic move + reward (reference rooms.py:208-220)."""
        elapsed = state.elapsed + 1
        proposed = state.agent_yx + self._actions[executed]
        oob = self._grid_flat[proposed[..., 0] * self._W + proposed[..., 1]] == -1
        agent = jnp.where(oob, state.agent_yx, proposed)
        done = (agent == state.goal_yx).all(-1)
        rew = jnp.where(
            done,
            jnp.float32(self.goal_reward),
            jnp.where(oob, jnp.float32(self.wall_reward), jnp.float32(self.step_reward)),
        )
        trunc = elapsed > self.time_limit
        return state.replace(agent_yx=agent, elapsed=elapsed), rew, done, trunc

    def apply_reset(
        self,
        state: RoomsState,
        mask: jax.Array,
        goal_new: jax.Array,
        agent_new: jax.Array,
    ) -> RoomsState:
        """Masked partial reset (reference rooms.py:191-196)."""
        return state.replace(
            agent_yx=jnp.where(mask, agent_new, state.agent_yx),
            goal_yx=jnp.where(mask, goal_new, state.goal_yx),
            elapsed=jnp.where(mask, 0, state.elapsed),
        )

    def observe(self, state: RoomsState) -> jax.Array:
        return self._obs_fn(state.agent_yx, state.goal_yx)

    # ------------------------------------------------------- random sampling
    def sample_goal(self, key: jax.Array) -> jax.Array:
        if self.fixed_goal_yx is not None:
            return jnp.asarray(self.fixed_goal_yx, jnp.int32)
        idx = jax.random.randint(key, (), 0, self._valid_yx.shape[0])
        return self._valid_yx[idx]

    def sample_agent(self, key: jax.Array) -> jax.Array:
        if self.fixed_agent_yx is not None:
            return jnp.asarray(self.fixed_agent_yx, jnp.int32)
        idx = jax.random.randint(key, (), 0, self._valid_yx.shape[0])
        return self._valid_yx[idx]

    # -------------------------------------------------------------- protocol
    def reset_env(self, key: jax.Array) -> Tuple[jax.Array, RoomsState]:
        kg, ka = jax.random.split(key)
        state = RoomsState(
            elapsed=jnp.zeros((), jnp.int32),
            agent_yx=self.sample_agent(ka),
            goal_yx=self.sample_goal(kg),
        )
        return self.observe(state), state

    def step_env(
        self, key: jax.Array, state: RoomsState, action: jax.Array
    ) -> Tuple[jax.Array, RoomsState, jax.Array, jax.Array, jax.Array, Dict[str, Any]]:
        ku, kg, ka = jax.random.split(key, 3)
        u = jax.random.uniform(ku, ())
        executed = self.exec_action(action, u)
        mid, rew, done, trunc, = self.advance(state, executed)
        reset_mask = done | trunc
        new_state = self.apply_reset(
            mid, reset_mask, self.sample_goal(kg), self.sample_agent(ka)
        )
        obs = self.observe(new_state)
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return obs, new_state, rew, done, trunc, info

    # ------------------------------------------------------ batched fast path
    def _sample_spawn_vec(self, key: jax.Array, num: int, fixed) -> jax.Array:
        if fixed is not None:
            return jnp.broadcast_to(jnp.asarray(fixed, jnp.int32), (num, 2))
        idx = jax.random.randint(key, (num,), 0, self._valid_yx.shape[0])
        return self._valid_yx[idx]

    def reset_vec(self, key: jax.Array, num_envs: int):
        kg, ka = jax.random.split(key)
        state = RoomsState(
            elapsed=jnp.zeros(num_envs, jnp.int32),
            agent_yx=self._sample_spawn_vec(ka, num_envs, self.fixed_agent_yx),
            goal_yx=self._sample_spawn_vec(kg, num_envs, self.fixed_goal_yx),
        )
        return jax.vmap(self.observe)(state), state

    def step_vec(self, key: jax.Array, state: RoomsState, action: jax.Array):
        B = action.shape[0]
        ku, kg, ka = jax.random.split(key, 3)
        u = jax.random.uniform(ku, (B,))
        executed = jax.vmap(self.exec_action)(action, u)
        mid, rew, done, trunc = jax.vmap(self.advance)(state, executed)
        reset_mask = done | trunc
        new_state = jax.vmap(self.apply_reset)(
            mid,
            reset_mask,
            self._sample_spawn_vec(kg, B, self.fixed_goal_yx),
            self._sample_spawn_vec(ka, B, self.fixed_agent_yx),
        )
        obs = jax.vmap(self.observe)(new_state)
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return obs, new_state, rew, done, trunc, info
