"""Vectorizable JAX Taxi / PO-Taxi.

Re-expresses the reference ``TaxiVecEnv`` (reference
``gym_po/envs/extended_taxi.py:149-377``) as a pure-functional JAX environment.
The entire per-step dynamics reduce to two int32 gathers from compiled tables
(:mod:`gym_po_tpu.maps.taxi_maps`) plus a handful of elementwise ops — there is
no geometry at runtime.

The dynamics are factored into deterministic stages (``advance``,
``apply_task_reset``, ``apply_full_reset``) that take all randomness as
explicit arguments.  ``step_env`` composes them with counter-based
``jax.random`` draws (perf mode); the parity harness composes the same jitted
stages with draws mirrored bit-exactly from the reference's NumPy
``Generator`` consumption order (see ``gym_po_tpu/compat/parity.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import Discrete, Environment, EnvState
from ..maps.taxi_maps import (
    NUM_ACTIONS,
    TAXI_MAP,
    EXTENDED_TAXI_MAP,
    TaxiTables,
    compile_taxi_map,
)

__all__ = ["Taxi", "TaxiState", "TAXI_MAP", "EXTENDED_TAXI_MAP"]


class TaxiState(EnvState):
    s: jax.Array  # int32 encoded (taxi row, taxi col, passenger, destination)
    completed: jax.Array  # int32 dropoffs completed this episode


def _decode(s: jax.Array, cols: int, nlocs: int):
    """Reference extended_taxi.py:84-94, in jnp."""
    d = s % nlocs
    tmp = s // nlocs
    p = tmp % (nlocs + 1)
    tmp = tmp // (nlocs + 1)
    return tmp // cols, tmp % cols, p, d


def _encode(r, c, p, d, cols: int, nlocs: int):
    """Reference extended_taxi.py:97-99, in jnp."""
    return ((r * cols + c) * (nlocs + 1) + p) * nlocs + d


class Taxi(Environment[TaxiState]):
    """Taxi / Hansen-PO-Taxi on 5x5 or extended 8x8 maps.

    Args mirror the reference constructor (reference extended_taxi.py:158-169)
    minus ``num_envs`` (batching is external via vmap) and ``render_mode``
    (rendering is a host-side pure function of state, see
    :mod:`gym_po_tpu.render`).
    """

    def __init__(
        self,
        map: Sequence[str] = TAXI_MAP,
        hansen_obs: bool = False,
        num_passengers: int = 1,
        time_limit: int = 200,
        reward_goal: float = 1.0,
        reward_bad: float = -0.5,
        reward_any: float = -0.05,
    ):
        self.tables: TaxiTables = compile_taxi_map(map)
        t = self.tables
        self.name = "HansenTaxi-v4" if hansen_obs else "Taxi-v4"
        self.hansen = bool(hansen_obs)
        self.num_passengers = int(num_passengers)
        self.time_limit = int(time_limit)
        self.reward_goal = float(reward_goal)
        self.reward_bad = float(reward_bad)
        self.reward_any = float(reward_any)
        self.cols = t.cols
        self.nlocs = t.nlocs

        # Device constants (embedded into the jitted executable).
        self._next_s = jnp.asarray(t.next_s)
        self._event = jnp.asarray(t.event)
        self._valid_init = jnp.asarray(t.valid_init)
        self._hansen_obs = jnp.asarray(t.hansen_obs)
        # transition gathers are the hot path.  The full [ns,5] state table
        # factors through the cell: movement only changes (r,c) and
        # pickup/dropoff only consults which landmark is at (r,c), so two
        # TINY tables (cell_move [cells*4], loc_at [cells]) + integer codec
        # arithmetic replace the big gather.
        ncells = t.rows * t.cols
        pd = (t.nlocs + 1) * t.nlocs
        s0 = np.arange(ncells, dtype=np.int64) * pd  # states with p=0, d=0
        cell_move = t.next_s[s0][:, :4] // pd  # [cells, 4] -> new cell
        self._cell_move = jnp.asarray(cell_move.reshape(-1), jnp.int32)
        loc_at = np.full(ncells, t.nlocs, np.int64)  # sentinel: no landmark
        lm = t.np_locs[: t.nlocs]
        loc_at[lm[:, 0] * t.cols + lm[:, 1]] = np.arange(t.nlocs)
        self._loc_at = jnp.asarray(loc_at, jnp.int32)
        # Hansen obs = (wall_code[r,c]*(nlocs+1)+p)*nlocs+d — also cell-level
        self._hansen_cell = jnp.asarray(t.hansen_grid.reshape(-1), jnp.int32)
        self._pd = pd
        # when every cell is navigable, episode-start states can be sampled
        # arithmetically (r,c,p,d components) with zero gathers
        self._all_cells_valid = bool((t.tgrid != "|").all())

        self._obs_n = t.n_hansen_obs if hansen_obs else t.ns
        self._action_space = Discrete(NUM_ACTIONS)
        self._observation_space = Discrete(self._obs_n)

    # ---------------------------------------------------------------- spaces
    @property
    def action_space(self) -> Discrete:
        return self._action_space

    @property
    def observation_space(self) -> Discrete:
        return self._observation_space

    # ------------------------------------------------- deterministic stages
    def advance(
        self, state: TaxiState, action: jax.Array
    ) -> Tuple[TaxiState, jax.Array, jax.Array, jax.Array, jax.Array]:
        """Stage A: deterministic transition (reference extended_taxi.py:244-281).

        Returns (mid_state, reward, done, truncated, task_completed).
        """
        elapsed = state.elapsed + 1
        # decode cell / passenger / destination (reference :84-94)
        rc = state.s // self._pd
        rem = state.s % self._pd
        p = rem // self.nlocs
        d = rem % self.nlocs
        # movement actions 0-3 via the cell-level table
        rc_mv = self._cell_move[rc * 4 + jnp.minimum(action, 3)]
        # pickup/dropoff action 4 (reference :262-275)
        is_pd = action == NUM_ACTIONS - 1
        loc = self._loc_at[rc]
        goal = is_pd & (p == self.nlocs) & (loc == d)
        pickup = is_pd & (p < self.nlocs) & (loc == p)
        bad = is_pd & ~goal & ~pickup
        p2 = jnp.where(pickup, self.nlocs, p)
        rc2 = jnp.where(is_pd, rc, rc_mv)
        s2 = (rc2 * (self.nlocs + 1) + p2) * self.nlocs + d
        completed = state.completed + goal.astype(jnp.int32)
        rew = jnp.where(
            goal,
            jnp.float32(self.reward_goal),
            jnp.where(bad, jnp.float32(self.reward_bad), jnp.float32(self.reward_any)),
        )
        done = completed == self.num_passengers
        trunc = elapsed > self.time_limit  # strict >, reference :279
        task_completed = goal & ~(done | trunc)  # reference :282
        return (
            state.replace(s=s2, completed=completed, elapsed=elapsed),
            rew,
            done,
            trunc,
            task_completed,
        )

    def apply_task_reset(
        self, state: TaxiState, mask: jax.Array, p_new: jax.Array, d_new: jax.Array
    ) -> TaxiState:
        """Stage B1: re-place passenger & destination, keep taxi position
        (reference extended_taxi.py:354-364)."""
        r, c, p, d = _decode(state.s, self.cols, self.nlocs)
        s_task = _encode(r, c, p_new, d_new, self.cols, self.nlocs)
        return state.replace(s=jnp.where(mask, s_task, state.s))

    def apply_full_reset(
        self, state: TaxiState, mask: jax.Array, s_new: jax.Array
    ) -> TaxiState:
        """Stage B2: masked full episode reset (reference extended_taxi.py:344-352)."""
        z = jnp.zeros((), jnp.int32)
        return state.replace(
            s=jnp.where(mask, s_new, state.s),
            elapsed=jnp.where(mask, z, state.elapsed),
            completed=jnp.where(mask, z, state.completed),
        )

    def observe(self, state: TaxiState) -> jax.Array:
        """Full state id, or Hansen-coded partial obs (reference :366-372).

        Hansen obs = (wall_code[cell]*(nlocs+1)+p)*nlocs+d — computed from
        the cell-level wall-code table + codec arithmetic (no [ns] gather).
        """
        if self.hansen:
            rc = state.s // self._pd
            rem = state.s % self._pd
            h = self._hansen_cell[rc]
            return (h * (self.nlocs + 1) + rem // self.nlocs) * self.nlocs + (
                rem % self.nlocs
            )
        return state.s

    # ------------------------------------------------------- random sampling
    def sample_init_state(self, key: jax.Array) -> jax.Array:
        """Uniform over valid initial states.

        NOTE: the reference samples via ``multinomial(ns, dist, b).argmax(-1)``
        (reference :348-350), which is asymptotically uniform over valid states
        but has a first-index tie-break bias.  Perf mode uses a true uniform
        gather; parity mode feeds the exact reference draw into
        ``apply_full_reset`` instead.
        """
        idx = jax.random.randint(key, (), 0, self._valid_init.shape[0])
        return self._valid_init[idx]

    def sample_passenger_destination(self, key: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """p uniform over nlocs, d uniform over nlocs-1 excluding p — the
        rejection-free equivalent of reference :360-363."""
        kp, kd = jax.random.split(key)
        p = jax.random.randint(kp, (), 0, self.nlocs)
        d0 = jax.random.randint(kd, (), 0, self.nlocs - 1)
        return p, d0 + (d0 >= p)

    # -------------------------------------------------------------- protocol
    def reset_env(self, key: jax.Array) -> Tuple[jax.Array, TaxiState]:
        s = self.sample_init_state(key)
        state = TaxiState(
            elapsed=jnp.zeros((), jnp.int32),
            s=s.astype(jnp.int32),
            completed=jnp.zeros((), jnp.int32),
        )
        return self.observe(state), state

    def step_env(
        self, key: jax.Array, state: TaxiState, action: jax.Array
    ) -> Tuple[jax.Array, TaxiState, jax.Array, jax.Array, jax.Array, Dict[str, Any]]:
        k_task, k_reset = jax.random.split(key)
        mid, rew, done, trunc, task = self.advance(state, action)
        p_new, d_new = self.sample_passenger_destination(k_task)
        mid = self.apply_task_reset(mid, task, p_new, d_new)
        s_new = self.sample_init_state(k_reset)
        reset_mask = done | trunc
        new_state = self.apply_full_reset(mid, reset_mask, s_new)
        obs = self.observe(new_state)
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return obs, new_state, rew, done, trunc, info

    # ------------------------------------------------------ batched fast path
    # Every stage above is shape-polymorphic (gathers + elementwise), so the
    # batched step needs no vmap at all — only [B]-shaped draws from one key.
    def _sample_init_vec(self, key: jax.Array, num: int) -> jax.Array:
        """[num] uniform valid episode-start states.

        Zero-gather arithmetic path when every cell is navigable (both
        shipped maps): sample r, c, p, d components directly — the uniform
        product over (cells × p × d≠p) IS the valid-state distribution
        (reference extended_taxi.py:205-218).
        """
        if not self._all_cells_valid:
            idx = jax.random.randint(key, (num,), 0, self._valid_init.shape[0])
            return self._valid_init[idx].astype(jnp.int32)
        t = self.tables
        kr_, kc_, kp_, kd_ = jax.random.split(key, 4)
        r = jax.random.randint(kr_, (num,), 0, t.rows)
        c = jax.random.randint(kc_, (num,), 0, t.cols)
        p = jax.random.randint(kp_, (num,), 0, self.nlocs)
        d0 = jax.random.randint(kd_, (num,), 0, self.nlocs - 1)
        d = d0 + (d0 >= p)
        return _encode(r, c, p, d, self.cols, self.nlocs).astype(jnp.int32)

    def reset_vec(self, key: jax.Array, num_envs: int):
        zeros = jnp.zeros(num_envs, jnp.int32)
        state = TaxiState(
            elapsed=zeros, s=self._sample_init_vec(key, num_envs), completed=zeros
        )
        return self.observe(state), state

    def step_vec(self, key: jax.Array, state: TaxiState, action: jax.Array):
        B = action.shape[0]
        kp, kd, kr = jax.random.split(key, 3)
        mid, rew, done, trunc, task = self.advance(state, action)
        p = jax.random.randint(kp, (B,), 0, self.nlocs)
        d0 = jax.random.randint(kd, (B,), 0, self.nlocs - 1)
        mid = self.apply_task_reset(mid, task, p, d0 + (d0 >= p))
        reset_mask = done | trunc
        new_state = self.apply_full_reset(
            mid, reset_mask, self._sample_init_vec(kr, B)
        )
        obs = self.observe(new_state)
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return obs, new_state, rew, done, trunc, info
