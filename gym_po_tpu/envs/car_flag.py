"""Vectorizable JAX Car-Flag (heaven/hell car).

Re-expresses the reference ``CarVecEnv`` / ``DiscreteActionCarVecEnv``
(reference ``gym_po/envs/car_flag.py:23-303``) as a pure-functional JAX
environment: 1-D continuous control where a car must visit a "priest" region
(|pos - priest| <= 0.2) to observe which end is heaven (+1 reward) vs hell
(-1 reward).

Replicated reference behaviors (numerics preserved):

* velocity zeroed only at the LEFT edge (``pos == MIN_POS & vel < 0``,
  reference car_flag.py:123) — asymmetric on purpose.
* truncation uses ``elapsed >= time_limit`` (reference :129; the other envs
  use strict ``>``).
* the priest-window comparison happens in the priest array's dtype: float64
  in the reference (``np.full`` default, reference :77).  Perf mode keeps
  float32 state; parity mode stores float64 priests (under ``jax_enable_x64``)
  so the window test promotes exactly like NumPy.
* the discrete wrapper maps ``linspace(-1, 1, num_actions)`` onto the
  continuous force (reference :286-303), which promotes the physics to
  float64 before the float32 state store — reproduced by passing the float64
  force straight into the same stage.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import Box, Discrete, Environment, EnvState

__all__ = ["CarFlag", "DiscreteCarFlag", "CarFlagState"]

MAX_POS = 1.1
MIN_POS = -MAX_POS
MAX_SPEED = 0.07
MIN_ACT = -1.0
MAX_ACT = 1.0
PRIEST = 0.5
PRIEST_THRESHOLD = 0.2
POWER = 0.0015


class CarFlagState(EnvState):
    pos: jax.Array  # float32 []
    vel: jax.Array  # float32 []
    dirn: jax.Array  # float32 [] — heaven direction if within priest window
    heaven: jax.Array  # float32 [] ∈ {-1, +1}
    priest: jax.Array  # float [] ∈ {-0.5, +0.5} (float64 in parity mode)


class CarFlag(Environment[CarFlagState]):
    """Continuous-control heaven/hell car (reference car_flag.py:23-283)."""

    def __init__(self, time_limit: int = 160):
        self.name = "CarFlag-v0"
        self.time_limit = int(time_limit)
        self._observation_space = Box(
            np.array([MIN_POS, -MAX_SPEED, -1.0], np.float32),
            np.array([MAX_POS, MAX_SPEED, 1.0], np.float32),
            (3,),
            dtype=jnp.float32,
        )
        self._action_space = Box(MIN_ACT, MAX_ACT, (1,), dtype=jnp.float32)

    @property
    def observation_space(self) -> Box:
        return self._observation_space

    @property
    def action_space(self):
        return self._action_space

    # ------------------------------------------------- deterministic stages
    def advance(
        self, state: CarFlagState, force: jax.Array
    ) -> Tuple[CarFlagState, jax.Array, jax.Array, jax.Array]:
        """One physics step (reference car_flag.py:114-139).

        ``force`` is the already-clipped scalar control; its dtype drives the
        arithmetic promotion exactly as in the reference.
        Returns (mid_state, reward, done, truncated).
        """
        elapsed = state.elapsed + 1
        # NOTE: on CPU the LLVM backend may contract this multiply-add into an
        # FMA inside the XLA fusion, which breaks bit-exact NumPy parity under
        # cancellation; parity tests pin --xla_cpu_max_isa=SSE4_2 (conftest).
        nv = jnp.clip(state.vel + force * POWER, -MAX_SPEED, MAX_SPEED)
        npos = jnp.clip(state.pos + nv, MIN_POS, MAX_POS)
        nv = jnp.where((npos == MIN_POS) & (nv < 0), jnp.zeros_like(nv), nv)
        done = jnp.abs(npos) >= 1.0
        hh = jnp.sign(npos)
        rew = jnp.where(
            done & (hh == state.heaven),
            jnp.float32(1.0),
            jnp.where(done & (hh == -state.heaven), jnp.float32(-1.0), jnp.float32(0.0)),
        )
        trunc = elapsed >= self.time_limit  # >= here, > elsewhere (reference :129)
        in_window = (npos >= state.priest - PRIEST_THRESHOLD) & (
            npos <= state.priest + PRIEST_THRESHOLD
        )
        dirn = jnp.where(in_window, state.heaven, jnp.float32(0.0))
        mid = state.replace(
            pos=npos.astype(jnp.float32),
            vel=nv.astype(jnp.float32),
            dirn=dirn.astype(jnp.float32),
            elapsed=elapsed,
        )
        return mid, rew, done, trunc

    def apply_reset(
        self,
        state: CarFlagState,
        mask: jax.Array,
        pos_new: jax.Array,
        heaven_new: jax.Array,
        priest_new: jax.Array,
    ) -> CarFlagState:
        """Masked partial reset (reference car_flag.py:97-110)."""
        z32 = jnp.float32(0.0)
        return state.replace(
            pos=jnp.where(mask, pos_new.astype(jnp.float32), state.pos),
            vel=jnp.where(mask, z32, state.vel),
            dirn=jnp.where(mask, z32, state.dirn),
            heaven=jnp.where(mask, heaven_new.astype(jnp.float32), state.heaven),
            priest=jnp.where(mask, priest_new.astype(state.priest.dtype), state.priest),
            elapsed=jnp.where(mask, 0, state.elapsed),
        )

    def observe(self, state: CarFlagState) -> jax.Array:
        return jnp.stack([state.pos, state.vel, state.dirn])

    # ------------------------------------------------------- random sampling
    def sample_reset(self, key: jax.Array):
        """pos ~ U(-0.2, 0.2); heaven, priest ~ fair coin (reference :100-110)."""
        kp, kh, kr = jax.random.split(key, 3)
        pos = jax.random.uniform(kp, (), jnp.float32, -0.2, 0.2)
        heaven = jnp.where(
            jax.random.bernoulli(kh), jnp.float32(1.0), jnp.float32(-1.0)
        )
        priest = jnp.where(
            jax.random.bernoulli(kr), jnp.float32(PRIEST), jnp.float32(-PRIEST)
        )
        return pos, heaven, priest

    # -------------------------------------------------------------- protocol
    def reset_env(self, key: jax.Array) -> Tuple[jax.Array, CarFlagState]:
        pos, heaven, priest = self.sample_reset(key)
        state = CarFlagState(
            elapsed=jnp.zeros((), jnp.int32),
            pos=pos,
            vel=jnp.float32(0.0),
            dirn=jnp.float32(0.0),
            heaven=heaven,
            priest=priest,
        )
        return self.observe(state), state

    def _force(self, action: jax.Array) -> jax.Array:
        """Continuous control: clip to [-1, 1] (reference :116-117)."""
        return jnp.clip(action.reshape(()), MIN_ACT, MAX_ACT)

    def step_env(
        self, key: jax.Array, state: CarFlagState, action: jax.Array
    ) -> Tuple[jax.Array, CarFlagState, jax.Array, jax.Array, jax.Array, Dict[str, Any]]:
        mid, rew, done, trunc = self.advance(state, self._force(action))
        reset_mask = done | trunc
        pos, heaven, priest = self.sample_reset(key)
        new_state = self.apply_reset(mid, reset_mask, pos, heaven, priest)
        obs = self.observe(new_state)
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return obs, new_state, rew, done, trunc, info

    # ------------------------------------------------------ batched fast path
    def _sample_reset_vec(self, key: jax.Array, num: int):
        kp, kh, kr = jax.random.split(key, 3)
        pos = jax.random.uniform(kp, (num,), jnp.float32, -0.2, 0.2)
        sign = lambda k: jnp.where(  # noqa: E731
            jax.random.bernoulli(k, shape=(num,)),
            jnp.float32(1.0),
            jnp.float32(-1.0),
        )
        return pos, sign(kh), sign(kr) * jnp.float32(PRIEST)

    def reset_vec(self, key: jax.Array, num_envs: int):
        pos, heaven, priest = self._sample_reset_vec(key, num_envs)
        zeros = jnp.zeros(num_envs, jnp.float32)
        state = CarFlagState(
            elapsed=jnp.zeros(num_envs, jnp.int32),
            pos=pos,
            vel=zeros,
            dirn=zeros,
            heaven=heaven,
            priest=priest,
        )
        return jax.vmap(self.observe)(state), state

    def step_vec(self, key: jax.Array, state: CarFlagState, action: jax.Array):
        B = action.shape[0]
        # advance/apply_reset are shape-polymorphic; _force and observe are not
        mid, rew, done, trunc = self.advance(state, jax.vmap(self._force)(action))
        reset_mask = done | trunc
        pos, heaven, priest = self._sample_reset_vec(key, B)
        new_state = self.apply_reset(mid, reset_mask, pos, heaven, priest)
        obs = jax.vmap(self.observe)(new_state)
        info = {"terminal_state": mid, "reset_mask": reset_mask}
        return obs, new_state, rew, done, trunc, info


class DiscreteCarFlag(CarFlag):
    """Evenly-spaced discrete forces (reference car_flag.py:286-303).

    The float64 ``linspace`` force reproduces the reference's promotion of
    the physics to float64 (visible only in parity mode under x64).
    """

    def __init__(self, num_actions: int = 3, time_limit: int = 160):
        super().__init__(time_limit=time_limit)
        self.name = "DiscreteCarFlag-v0"
        self.num_actions = int(num_actions)
        self.forces_np = np.linspace(MIN_ACT, MAX_ACT, num_actions)
        self._forces = jnp.asarray(self.forces_np)  # float64 under x64
        self._action_space = Discrete(self.num_actions)

    def _force(self, action: jax.Array) -> jax.Array:
        return jnp.clip(self._forces[action.reshape(())], MIN_ACT, MAX_ACT)
