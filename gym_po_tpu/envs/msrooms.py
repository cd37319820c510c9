"""Vectorizable JAX Multistory FourRooms.

Re-expresses the reference ``MultistoryFourRoomsEnv`` (reference
``gym_po/envs/rooms/msrooms.py:257-433``) as a pure-functional JAX
environment: S stacked 13x13 FourRooms floors connected by stairs
(up-stairs at NE=(1,11) on floors 0..S-2, down-stairs at SW=(11,1) on
floors 1..S-1; transiting a stair teleports to the matching square of the
adjacent floor, reference msrooms.py:69-90,419-428).

The reference module is broken at runtime — several ``: NDArray``
annotations lost their colon (e.g. ``agent_zyxNDArray``,
``msrooms.py:132,163,193,383,415,419``), so every obs/step path raises
``NameError``.  This implementation follows the code's evident semantics with
the annotations mechanically restored; the parity oracle applies the same
mechanical repair to the reference (see ``tests/_reference.py``).

Replicated reference behaviors (numerics preserved, documented):

* a FIXED ``goal_xyz`` always falls back to the default top-floor goal
  (9, 7): the guard ``grid[goal_zyx] <= MAX_GR_CNST`` is always true because
  walk-map values never exceed 3 (reference msrooms.py:341-347).
* RANDOM goals may land on the top floor's stair squares
  (``valid_goal_states`` filters only walls, reference msrooms.py:319-321).
* Hansen observations collapse rooms and stairs to the same value 2: the
  alias chain ``squares[(squares>0)&(squares<=3)]=2`` hits rooms (value 1)
  too, and the intended ``>MAX_GR_CNST -> 1`` branch never fires
  (reference msrooms.py:154-155,184-185).  Scalar Hansen obs are float64
  (int dot-product times a float ``goal_mult``, reference msrooms.py:186-189).
* the 'room' obs_type is NOT implemented: the reference's room map
  construction is shape-broken (``map[map>0] + i*n_rooms`` flattens to 1-D,
  reference msrooms.py:86) and its obs would emit negative ids
  (``grid - 4`` on values <= 3, reference msrooms.py:211-213).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import Box, Discrete, Environment, EnvState, Space
from ..utils.actions import (
    ACTIONS_CARDINAL_Z,
    ACTIONS_ORDINAL_Z,
    failure_cumsum,
    make_exec_action,
)

__all__ = [
    "MultistoryFourRooms",
    "MSRoomsState",
    "FR_MAP",
    "build_walk_map",
    "make_msrooms_obs",
]

# cell-type codes (reference msrooms.py:27-34)
WALL, GOAL_CODE, STAIR_DOWN, STAIR_UP = 0, 1, 2, 3
MAX_CODE = 3
UPSTAIRS_NE = (1, 11)  # stair-up square (reference msrooms.py:21-23)
DOWNSTAIRS_SW = (11, 1)  # stair-down square (reference msrooms.py:19-24)
END_XYZ = (9, 7, -1)  # default goal, east hallway top floor (msrooms.py:17)
START_XYZ = (1, 1, 0)  # default agent, NW corner ground floor (msrooms.py:18)

# 13x13 FourRooms; 0 = wall, rooms numbered 1-4 clockwise.  Same public-domain
# FourRooms geometry as the reference (msrooms.py:50-66), rebuilt procedurally.
def _four_rooms_map() -> np.ndarray:
    m = np.zeros((13, 13), np.int64)
    m[1:6, 1:6] = 4  # NW room (rows 1-5)
    m[1:7, 7:12] = 1  # NE room (rows 1-6, one row taller than NW)
    m[7:12, 1:6] = 3  # SW room (rows 7-11)
    m[8:12, 7:12] = 2  # SE room (rows 8-11)
    m[3, 6] = 4  # doorway NW <-> NE
    m[6, 2] = 3  # doorway NW <-> SW
    m[7, 9] = 1  # doorway NE <-> SE
    m[10, 6] = 2  # doorway SW <-> SE
    return m


FR_MAP = _four_rooms_map()


def build_walk_map(floor_map: np.ndarray = FR_MAP, num_floors: int = 1) -> np.ndarray:
    """Stack S floors and plant stairs (reference msrooms.py:69-90)."""
    walk = (floor_map > 0).astype(np.int64)
    ms = np.stack([walk] * num_floors, 0)
    if num_floors > 1:
        ms[1:, DOWNSTAIRS_SW[0], DOWNSTAIRS_SW[1]] = STAIR_DOWN
        ms[:-1, UPSTAIRS_NE[0], UPSTAIRS_NE[1]] = STAIR_UP
    return ms


def make_msrooms_obs(
    obs_type: str, grid: np.ndarray
) -> Tuple[Space, Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]]:
    """Obs factory for the multistory walk map (reference msrooms.py:192-254).

    Builds single-instance jittable obs functions obs(agent_zyx, goal_zyx).
    """
    is_vector = "vector" in obs_type
    has_goal = "goal" in obs_type
    grid_flat = jnp.asarray(grid.reshape(-1), jnp.int32)
    _HW = grid.shape[1] * grid.shape[2]
    _W = grid.shape[2]

    def grid_at(zyx):
        """grid[z, y, x] from the flat grid."""
        return grid_flat[zyx[..., 0] * _HW + zyx[..., 1] * _W + zyx[..., 2]]

    S = grid.shape[0]

    a_max = np.asarray(grid.shape, np.int64) - 2
    a_max[0] += 1
    a_min = np.array([0, 1, 1], np.int64)

    if "mdp" in obs_type:
        if is_vector:
            if has_goal:
                space = Box(np.tile(a_min, 2), np.tile(a_max, 2), (6,), dtype=jnp.int32)
                def obs(agent, goal):
                    return jnp.concatenate((agent, goal), -1)
            else:
                space = Box(a_min, a_max, (3,), dtype=jnp.int32)
                def obs(agent, goal):
                    return agent
        else:
            # dense ids over all non-wall cells incl. stairs (msrooms.py:226)
            sg_np = ((grid - 1) >= 0).cumsum().reshape(grid.shape) - 1
            n = int((grid > 0).sum())
            sg_flat = jnp.asarray(sg_np.reshape(-1), jnp.int32)

            def sg_at(zyx):
                return sg_flat[
                    zyx[..., 0] * _HW + zyx[..., 1] * _W + zyx[..., 2]
                ]

            if has_goal:
                space = Discrete(int(n**2))
                def obs(agent, goal):
                    return sg_at(agent) + n * sg_at(goal)
            else:
                space = Discrete(int(n))
                def obs(agent, goal):
                    return sg_at(agent)
    elif "hansen" in obs_type:
        base_n = 8 if "8" in obs_type else 4
        offs = jnp.asarray(
            ACTIONS_CARDINAL_Z if base_n == 4 else ACTIONS_ORDINAL_Z, jnp.int32
        )

        def neighbor_codes(agent, goal):
            nb = agent[None, :] + offs  # [k, 3]
            vals = grid_at(nb)
            # alias chain (msrooms.py:154-155): every non-wall square -> 2
            sq = jnp.where(vals > 0, 2, 0)
            is_goal = (nb == goal[None, :]).all(-1)
            return sq, is_goal

        if is_vector:
            hi = 3 if has_goal else 2
            space = Box(0, hi, (base_n,), dtype=jnp.int32)
            if has_goal:
                def obs(agent, goal):
                    sq, is_goal = neighbor_codes(agent, goal)
                    return jnp.where(is_goal, 3, sq)
            else:
                def obs(agent, goal):
                    sq, _ = neighbor_codes(agent, goal)
                    return sq
        else:
            space = Discrete(int(3**base_n * (base_n + 1)))
            mult = jnp.asarray([3**i for i in range(base_n)], jnp.int32)

            def obs(agent, goal):
                sq, is_goal = neighbor_codes(agent, goal)
                code = (sq * mult).sum()
                goal_mult = jnp.where(
                    is_goal.any(), jnp.argmax(is_goal) + 1, 1
                )
                # reference returns float64 (int dot * float ones,
                # msrooms.py:180,189)
                return (code * goal_mult).astype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    else:
        raise NotImplementedError(
            f"Observation type {obs_type!r} not supported for MultistoryFourRooms "
            "('room' is broken in the reference, see module docstring)"
        )
    return space, obs


class MSRoomsState(EnvState):
    agent_zyx: jax.Array  # int32 [3]
    goal_zyx: jax.Array  # int32 [3]


class MultistoryFourRooms(Environment[MSRoomsState]):
    """Multistory FourRooms (reference msrooms.py:257-433).

    Args mirror the reference constructor (msrooms.py:266-303) minus
    ``num_envs``/``render_mode``.  Defaults preserved: 1 floor, 500-step
    limit, 'mdp' obs, 1/3 action failure, cardinal actions, fixed top-floor
    goal, random ground-floor agent spawn, rewards (0, 0, 1).
    """

    def __init__(
        self,
        grid_z: int = 1,
        floor_map: np.ndarray = FR_MAP,
        time_limit: int = 500,
        obs_type: str = "mdp",
        obs_n: int = 3,
        action_failure_probability: float = 1.0 / 3,
        action_type: str = "cardinal",
        agent_xyz: Optional[Sequence[int]] = None,
        goal_xyz: Optional[Sequence[int]] = END_XYZ,
        step_reward: float = 0.0,
        wall_reward: float = 0.0,
        goal_reward: float = 1.0,
        **kwargs,
    ):
        self.name = f"MultistoryFourRooms{grid_z}__{action_type}__{obs_type}"
        grid = build_walk_map(floor_map, grid_z)
        self.grid_np = grid
        self.gridshape = np.asarray(grid.shape, np.int64)
        self.time_limit = int(time_limit)
        self.step_reward = float(step_reward)
        self.wall_reward = float(wall_reward)
        self.goal_reward = float(goal_reward)

        self._grid = jnp.asarray(grid, jnp.int32)
        self._grid_flat = jnp.asarray(grid.reshape(-1), jnp.int32)
        self._HW = grid.shape[1] * grid.shape[2]
        self._W3 = grid.shape[2]
        actions = ACTIONS_CARDINAL_Z if action_type == "cardinal" else ACTIONS_ORDINAL_Z
        self._actions = jnp.asarray(actions, jnp.int32)
        self.num_actions = actions.shape[0]
        self._cum = failure_cumsum(self.num_actions, action_failure_probability)
        self._exec = make_exec_action(self._cum)

        self._observation_space, self._obs_fn = make_msrooms_obs(obs_type, grid)
        self._action_space = Discrete(self.num_actions)

        # spawn banks (reference msrooms.py:314-321)
        spawn_vs = np.array(np.nonzero(grid > WALL))  # [3, N]
        self.valid_agent_states = np.ravel_multi_index(
            spawn_vs[:, spawn_vs[0] == 0], grid.shape
        )
        self.valid_goal_states = np.ravel_multi_index(
            spawn_vs[:, spawn_vs[0] == grid.shape[0] - 1], grid.shape
        )
        agent_yx3 = np.stack(
            np.unravel_index(self.valid_agent_states, grid.shape), -1
        )
        goal_yx3 = np.stack(np.unravel_index(self.valid_goal_states, grid.shape), -1)
        self._valid_agent_zyx = jnp.asarray(agent_yx3, jnp.int32)
        self._valid_goal_zyx = jnp.asarray(goal_yx3, jnp.int32)

        # fixed spawns (reference msrooms.py:340-364)
        self.fixed_goal_zyx: Optional[np.ndarray] = None
        if goal_xyz is not None:
            # grid values never exceed MAX_CODE, so the reference's stair
            # guard ALWAYS falls back to END_XYZ (see module docstring)
            zyx = np.asarray(tuple(reversed(END_XYZ)), np.int64)
            if zyx[0] == -1:
                zyx[0] = grid.shape[0] - 1
            self.fixed_goal_zyx = zyx
        self.fixed_agent_zyx: Optional[np.ndarray] = None
        if agent_xyz is not None:
            zyx = tuple(reversed(agent_xyz))
            if grid[zyx] == WALL:
                zyx = tuple(reversed(START_XYZ))
            self.fixed_agent_zyx = np.asarray(zyx, np.int64)

        self._up_target = jnp.asarray(UPSTAIRS_NE, jnp.int32)
        self._down_target = jnp.asarray(DOWNSTAIRS_SW, jnp.int32)

    # ---------------------------------------------------------------- spaces
    @property
    def action_space(self) -> Discrete:
        return self._action_space

    @property
    def observation_space(self):
        return self._observation_space

    # ------------------------------------------------- deterministic stages
    def exec_action(self, action: jax.Array, u: jax.Array) -> jax.Array:
        """Stochastic action failure given uniform u (reference msrooms.py:400)."""
        return self._exec(action, u)

    def advance(
        self, state: MSRoomsState, executed: jax.Array
    ) -> Tuple[MSRoomsState, jax.Array, jax.Array, jax.Array]:
        """Move + stair transit + reward (reference msrooms.py:398-413)."""
        elapsed = state.elapsed + 1
        proposed = state.agent_zyx + self._actions[executed]
        cell = self._grid_flat[
            proposed[..., 0] * self._HW + proposed[..., 1] * self._W3 + proposed[..., 2]
        ]
        oob = cell == WALL
        agent = jnp.where(oob, state.agent_zyx, proposed)
        # stair transit only when the agent moved (reference :419-428)
        acell = self._grid_flat[
            agent[..., 0] * self._HW + agent[..., 1] * self._W3 + agent[..., 2]
        ]
        go_up = (acell == STAIR_UP) & ~oob
        go_down = (acell == STAIR_DOWN) & ~oob
        up_pos = jnp.concatenate(
            [(agent[0] + 1)[None], jnp.asarray(DOWNSTAIRS_SW, jnp.int32)]
        )
        down_pos = jnp.concatenate(
            [(agent[0] - 1)[None], jnp.asarray(UPSTAIRS_NE, jnp.int32)]
        )
        agent = jnp.where(go_up, up_pos, jnp.where(go_down, down_pos, agent))
        done = (agent == state.goal_zyx).all(-1)
        rew = jnp.where(
            done,
            jnp.float32(self.goal_reward),
            jnp.where(oob, jnp.float32(self.wall_reward), jnp.float32(self.step_reward)),
        )
        trunc = elapsed > self.time_limit
        return state.replace(agent_zyx=agent, elapsed=elapsed), rew, done, trunc

    def apply_reset(
        self,
        state: MSRoomsState,
        mask: jax.Array,
        goal_new: jax.Array,
        agent_new: jax.Array,
    ) -> MSRoomsState:
        """Masked partial reset (reference msrooms.py:383-388)."""
        return state.replace(
            agent_zyx=jnp.where(mask, agent_new, state.agent_zyx),
            goal_zyx=jnp.where(mask, goal_new, state.goal_zyx),
            elapsed=jnp.where(mask, 0, state.elapsed),
        )

    def observe(self, state: MSRoomsState) -> jax.Array:
        return self._obs_fn(state.agent_zyx, state.goal_zyx)

    # ------------------------------------------------------- random sampling
    def sample_goal(self, key: jax.Array) -> jax.Array:
        if self.fixed_goal_zyx is not None:
            return jnp.asarray(self.fixed_goal_zyx, jnp.int32)
        idx = jax.random.randint(key, (), 0, self._valid_goal_zyx.shape[0])
        return self._valid_goal_zyx[idx]

    def sample_agent(self, key: jax.Array) -> jax.Array:
        if self.fixed_agent_zyx is not None:
            return jnp.asarray(self.fixed_agent_zyx, jnp.int32)
        idx = jax.random.randint(key, (), 0, self._valid_agent_zyx.shape[0])
        return self._valid_agent_zyx[idx]

    # -------------------------------------------------------------- protocol
    def reset_env(self, key: jax.Array) -> Tuple[jax.Array, MSRoomsState]:
        kg, ka = jax.random.split(key)
        state = MSRoomsState(
            elapsed=jnp.zeros((), jnp.int32),
            agent_zyx=self.sample_agent(ka),
            goal_zyx=self.sample_goal(kg),
        )
        return self.observe(state), state

    def step_env(
        self, key: jax.Array, state: MSRoomsState, action: jax.Array
    ) -> Tuple[jax.Array, MSRoomsState, jax.Array, jax.Array, jax.Array, Dict[str, Any]]:
        ku, kg, ka = jax.random.split(key, 3)
        u = jax.random.uniform(ku, ())
        executed = self.exec_action(action, u)
        mid, rew, done, trunc = self.advance(state, executed)
        reset_mask = done | trunc
        new_state = self.apply_reset(
            mid, reset_mask, self.sample_goal(kg), self.sample_agent(ka)
        )
        obs = self.observe(new_state)
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return obs, new_state, rew, done, trunc, info

    # ------------------------------------------------------ batched fast path
    def _sample_spawn_vec(self, key, num: int, fixed, bank) -> jax.Array:
        if fixed is not None:
            return jnp.broadcast_to(jnp.asarray(fixed, jnp.int32), (num, 3))
        idx = jax.random.randint(key, (num,), 0, bank.shape[0])
        return bank[idx]

    def reset_vec(self, key: jax.Array, num_envs: int):
        kg, ka = jax.random.split(key)
        state = MSRoomsState(
            elapsed=jnp.zeros(num_envs, jnp.int32),
            agent_zyx=self._sample_spawn_vec(
                ka, num_envs, self.fixed_agent_zyx, self._valid_agent_zyx
            ),
            goal_zyx=self._sample_spawn_vec(
                kg, num_envs, self.fixed_goal_zyx, self._valid_goal_zyx
            ),
        )
        return jax.vmap(self.observe)(state), state

    def step_vec(self, key: jax.Array, state: MSRoomsState, action: jax.Array):
        B = action.shape[0]
        ku, kg, ka = jax.random.split(key, 3)
        u = jax.random.uniform(ku, (B,))
        executed = jax.vmap(self.exec_action)(action, u)
        mid, rew, done, trunc = jax.vmap(self.advance)(state, executed)
        reset_mask = done | trunc
        new_state = jax.vmap(self.apply_reset)(
            mid,
            reset_mask,
            self._sample_spawn_vec(kg, B, self.fixed_goal_zyx, self._valid_goal_zyx),
            self._sample_spawn_vec(ka, B, self.fixed_agent_zyx, self._valid_agent_zyx),
        )
        obs = jax.vmap(self.observe)(new_state)
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return obs, new_state, rew, done, trunc, info
