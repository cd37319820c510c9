"""RockSample(n, k) — vectorizable JAX implementation.

The reference ships only an empty stub (reference
``gym_po/envs/rocksample/rocksample.py:22-42``: enums ``Obs{NULL,GOOD,BAD}``
and ``ACTION{NORTH,EAST,SOUTH,WEST,SAMPLE}``, bodies are ``...``), so this is
a **documented extension** implementing the canonical POMDP of Smith &
Simmons, "Heuristic Search Value Iteration for POMDPs" (UAI 2004), matching
the stub's enums and constructor surface (``map_size``, ``init_pos``):

* an n×n grid with k rocks at fixed positions; each rock is good/bad with
  p=0.5 per episode; the rover position is fully observable, rock quality is
  not (the "PO" part);
* actions: NORTH, EAST, SOUTH, WEST, SAMPLE, CHECK_1..CHECK_k (5+k total);
* moving EAST off the map exits the episode with reward +10; other off-grid
  moves are no-ops;
* SAMPLE on a rock: +10 if good (the rock becomes bad), -10 if bad;
  SAMPLE off-rock: -100 (illegal-sample penalty);
* CHECK_i reads rock i's quality through a noisy sensor with accuracy
  eta(d) = 0.5 * (1 + 2**(-d / d0)), d = Euclidean rover→rock distance,
  d0 = half-efficiency distance (default 20): deterministic at d=0,
  coin-flip as d→inf.

Observation = ``pos_index * 3 + reading`` where reading ∈ {NULL, GOOD, BAD}
follows the stub's ``Obs`` enum (NULL unless the action was a CHECK).
``obs_type='vector'`` gives ``[y, x, reading]`` instead.

All dynamics are fixed-shape array ops: rock positions are device constants,
goodness/collection are length-k bit vectors, the sensor draw is one uniform
against eta — jit/vmap/scan/shard_map-safe with in-graph autoreset.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import Box, Discrete, Environment, EnvState

__all__ = ["RockSample", "RockSampleState", "OBS_NULL", "OBS_GOOD", "OBS_BAD"]

# stub enums (reference rocksample.py:8-20)
OBS_NULL, OBS_GOOD, OBS_BAD = 0, 1, 2
A_NORTH, A_EAST, A_SOUTH, A_WEST, A_SAMPLE = 0, 1, 2, 3, 4

_MOVES_YX = np.array(
    [[-1, 0], [0, 1], [1, 0], [0, -1], [0, 0]], dtype=np.int32
)  # N, E, S, W, stay(sample)

GOOD_REWARD = 10.0
BAD_PENALTY = -10.0
EXIT_REWARD = 10.0
ILLEGAL_SAMPLE_PENALTY = -100.0


class RockSampleState(EnvState):
    pos_yx: jax.Array  # int32 [2]
    rock_good: jax.Array  # bool [k]
    reading: jax.Array  # int32 [] in {NULL, GOOD, BAD}


class RockSample(Environment[RockSampleState]):
    """Canonical RockSample(n, k) with a vectorizable pure-functional core."""

    def __init__(
        self,
        map_size: Sequence[int] = (5, 5),
        num_rocks: int = 5,
        init_pos: Sequence[int] = (1, 1),
        rock_positions: Optional[Sequence[Sequence[int]]] = None,
        half_efficiency_distance: float = 20.0,
        time_limit: int = 200,
        obs_type: str = "discrete",
        layout_seed: int = 0,
    ):
        self.rows, self.cols = int(map_size[0]), int(map_size[1])
        self.k = int(num_rocks)
        self.time_limit = int(time_limit)
        self.d0 = float(half_efficiency_distance)
        self.obs_type = obs_type
        self.name = f"RockSample({self.rows}x{self.cols},{self.k})"

        if rock_positions is None:
            # fixed per-instance layout, sampled once at construction
            rng = np.random.default_rng(layout_seed)
            flat = rng.choice(self.rows * self.cols, self.k, replace=False)
            rock_positions = np.stack(
                np.unravel_index(flat, (self.rows, self.cols)), -1
            )
        self.rock_positions_np = np.asarray(rock_positions, np.int32)
        assert self.rock_positions_np.shape == (self.k, 2)
        self._rocks = jnp.asarray(self.rock_positions_np)
        self._init_pos = jnp.asarray(np.asarray(init_pos, np.int32))
        self._moves = jnp.asarray(_MOVES_YX)

        self.num_actions = 5 + self.k
        self._action_space = Discrete(self.num_actions)
        if obs_type == "vector":
            self._observation_space = Box(
                np.zeros(3, np.float32),
                np.array([self.rows - 1, self.cols - 1, 2], np.float32),
                (3,),
                dtype=jnp.int32,
            )
        else:
            self._observation_space = Discrete(self.rows * self.cols * 3 + 3)

    @property
    def action_space(self) -> Discrete:
        return self._action_space

    @property
    def observation_space(self):
        return self._observation_space

    # ------------------------------------------------- deterministic stages
    def advance(
        self,
        state: RockSampleState,
        action: jax.Array,
        sensor_u: jax.Array,
    ) -> Tuple[RockSampleState, jax.Array, jax.Array, jax.Array]:
        """One transition; ``sensor_u`` is the uniform used by CHECK noise."""
        elapsed = state.elapsed + 1
        is_move = action < 4
        is_sample = action == A_SAMPLE
        is_check = action > A_SAMPLE
        rock_idx = jnp.clip(action - 5, 0, self.k - 1)

        # movement (exit east off-grid terminates; other off-grid = no-op)
        delta = self._moves[jnp.minimum(action, 4)]
        proposed = state.pos_yx + jnp.where(is_move, delta, 0)
        exited = is_move & (proposed[1] >= self.cols)
        inside = (
            (proposed[0] >= 0)
            & (proposed[0] < self.rows)
            & (proposed[1] >= 0)
            & (proposed[1] < self.cols)
        )
        pos = jnp.where(inside, proposed, state.pos_yx)

        # sampling
        at_rock = (state.pos_yx[None, :] == self._rocks).all(-1)  # [k]
        on_any = at_rock.any()
        here_good = (at_rock & state.rock_good).any()
        sample_rew = jnp.where(
            on_any,
            jnp.where(here_good, GOOD_REWARD, BAD_PENALTY),
            ILLEGAL_SAMPLE_PENALTY,
        )
        rock_good = jnp.where(is_sample & on_any, state.rock_good & ~at_rock,
                              state.rock_good)

        # sensing: accuracy eta = 0.5 * (1 + 2^(-d/d0)); the per-rock selects
        # are one-hot contractions over k (k is tiny)
        ksel = jax.nn.one_hot(rock_idx, self.k, dtype=jnp.float32)  # [k]
        rpos = jnp.matmul(ksel, self._rocks.astype(jnp.float32))
        diff = state.pos_yx.astype(jnp.float32) - rpos
        dist = jnp.sqrt((diff * diff).sum())
        eta = 0.5 * (1.0 + jnp.exp2(-dist / self.d0))
        correct = sensor_u < eta
        truth = (ksel * state.rock_good).sum() > 0.5
        seen_good = jnp.where(correct, truth, ~truth)
        reading = jnp.where(
            is_check,
            jnp.where(seen_good, OBS_GOOD, OBS_BAD),
            OBS_NULL,
        ).astype(jnp.int32)

        rew = jnp.where(
            exited,
            jnp.float32(EXIT_REWARD),
            jnp.where(is_sample, sample_rew.astype(jnp.float32), 0.0),
        )
        done = exited
        trunc = elapsed >= self.time_limit
        mid = state.replace(
            elapsed=elapsed, pos_yx=pos, rock_good=rock_good, reading=reading
        )
        return mid, rew, done, trunc

    def apply_reset(
        self, state: RockSampleState, mask: jax.Array, rock_good_new: jax.Array
    ) -> RockSampleState:
        return state.replace(
            elapsed=jnp.where(mask, 0, state.elapsed),
            pos_yx=jnp.where(mask, self._init_pos, state.pos_yx),
            rock_good=jnp.where(mask, rock_good_new, state.rock_good),
            reading=jnp.where(mask, OBS_NULL, state.reading),
        )

    def observe(self, state: RockSampleState) -> jax.Array:
        if self.obs_type == "vector":
            return jnp.concatenate(
                [state.pos_yx, state.reading[None]]
            ).astype(jnp.int32)
        pos_idx = state.pos_yx[0] * self.cols + state.pos_yx[1]
        return (pos_idx * 3 + state.reading).astype(jnp.int32)

    # -------------------------------------------------------------- protocol
    def reset_env(self, key: jax.Array) -> Tuple[jax.Array, RockSampleState]:
        rock_good = jax.random.bernoulli(key, 0.5, (self.k,))
        state = RockSampleState(
            elapsed=jnp.zeros((), jnp.int32),
            pos_yx=self._init_pos,
            rock_good=rock_good,
            reading=jnp.zeros((), jnp.int32),
        )
        return self.observe(state), state

    def step_env(
        self, key: jax.Array, state: RockSampleState, action: jax.Array
    ) -> Tuple[jax.Array, RockSampleState, jax.Array, jax.Array, jax.Array, Dict[str, Any]]:
        ks, kr = jax.random.split(key)
        mid, rew, done, trunc = self.advance(
            state, action, jax.random.uniform(ks, ())
        )
        reset_mask = done | trunc
        rock_good_new = jax.random.bernoulli(kr, 0.5, (self.k,))
        new_state = self.apply_reset(mid, reset_mask, rock_good_new)
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return self.observe(new_state), new_state, rew, done, trunc, info

    # ------------------------------------------------------ batched fast path
    def reset_vec(self, key: jax.Array, num_envs: int):
        state = RockSampleState(
            elapsed=jnp.zeros(num_envs, jnp.int32),
            pos_yx=jnp.broadcast_to(self._init_pos, (num_envs, 2)),
            rock_good=jax.random.bernoulli(key, 0.5, (num_envs, self.k)),
            reading=jnp.zeros(num_envs, jnp.int32),
        )
        return jax.vmap(self.observe)(state), state

    def step_vec(self, key: jax.Array, state: RockSampleState, action: jax.Array):
        B = action.shape[0]
        ks, kr = jax.random.split(key)
        mid, rew, done, trunc = jax.vmap(self.advance)(
            state, action, jax.random.uniform(ks, (B,))
        )
        reset_mask = done | trunc
        rock_good_new = jax.random.bernoulli(kr, 0.5, (B, self.k))
        new_state = jax.vmap(self.apply_reset)(mid, reset_mask, rock_good_new)
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return jax.vmap(self.observe)(new_state), new_state, rew, done, trunc, info
