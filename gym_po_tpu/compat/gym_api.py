"""Drop-in gymnasium vector API over the functional JAX envs.

A user of the reference (``gym_po``) drives stateful vec envs:

    env = TaxiVecEnv(num_envs=256, hansen_obs=True)
    obs, info = env.reset(seed=0)
    obs, rew, done, trunc, info = env.step(actions)

This module reproduces that exact surface — same class names, same
constructor signatures (reference ``extended_taxi.py:158-169,375-377``,
``rooms.py:84-118``, ``crooms.py:104-153``, ``msrooms.py:266-303``,
``car_flag.py:50-85,286-303``), same API quirks — on top of the
pure-functional envs: the adapter holds the jitted vmapped step, a PRNG key,
and the state pytree, and returns NumPy arrays.

Semantics are the *perf-mode* (counter-based ``jax.random``) dynamics —
identical distributions, not the reference's ``np.random.Generator`` draw
order.  Bit-exact seed parity lives in :mod:`gym_po_tpu.compat.parity`.

Replicated quirks (documented reference deviations from gymnasium):

* ``RoomsEnv.reset`` / ``CRoomsEnv.reset`` / ``MultistoryFourRoomsEnv.reset``
  return the bare obs with no info dict (reference ``rooms.py:177-189``,
  ``crooms.py:251-266``, ``msrooms.py:369-381``); Taxi and Car return
  ``(obs, {})``.
* ``CRoomsEnv`` exposes ``seed()`` (reference ``crooms.py:246-249``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import gymnasium
import jax
import numpy as np

from ..core import Environment
from ..envs.car_flag import CarFlag, DiscreteCarFlag
from ..envs.crooms import CRooms
from ..envs.msrooms import MultistoryFourRooms
from ..envs.rooms import Rooms
from ..envs.taxi import EXTENDED_TAXI_MAP, TAXI_MAP, Taxi

__all__ = [
    "GymnasiumVecAdapter",
    "TaxiVecEnv",
    "HansenTaxiVecEnv",
    "ExtendedTaxiVecEnv",
    "ExtendedHansenTaxiVecEnv",
    "RoomsEnv",
    "CRoomsEnv",
    "MultistoryFourRoomsEnv",
    "CarVecEnv",
    "DiscreteActionCarVecEnv",
]


class GymnasiumVecAdapter(gymnasium.Env):
    """Stateful gymnasium-style vec-env view of a functional env.

    Subclasses ``gymnasium.Env`` like the reference's vec envs (reference
    ``extended_taxi.py:149``) so isinstance checks and gymnasium wrappers
    work on it.
    """

    metadata = {"render_modes": ["rgb_array", "human"], "render_fps": 5}

    #: subclasses set True to replicate the reference's bare-obs reset quirk
    _bare_reset = False

    def __init__(
        self,
        env: Environment,
        num_envs: int,
        render_mode: Optional[str] = None,
        info_mode: str = "reference",
    ):
        if info_mode not in ("reference", "full"):
            raise ValueError(
                f"info_mode must be 'reference' or 'full', got {info_mode!r}"
            )
        self.env = env
        self.num_envs = int(num_envs)
        self.is_vector_env = True
        self.render_mode = render_mode
        self.info_mode = info_mode
        self._window = None

        self.single_observation_space = env.observation_space.to_gymnasium()
        self.single_action_space = env.action_space.to_gymnasium()
        import gymnasium.vector.utils as gvu

        self.observation_space = gvu.batch_space(
            self.single_observation_space, self.num_envs
        )
        self.action_space = gvu.batch_space(
            self.single_action_space, self.num_envs
        )

        self._reset_jit = jax.jit(lambda k: env.reset_vec(k, self.num_envs))
        self._step_jit = jax.jit(lambda k, s, a: env.step_vec(k, s, a))
        self._key = jax.random.PRNGKey(0)
        self._state = None

    # ----------------------------------------------------------------- api
    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._key = jax.random.PRNGKey(seed)
        self._key, kr = jax.random.split(self._key)
        obs, self._state = self._reset_jit(kr)
        obs = np.asarray(obs)
        return obs if self._bare_reset else (obs, {})

    def step(self, actions):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        self._key, ks = jax.random.split(self._key)
        obs, self._state, rew, done, trunc, info = self._step_jit(
            ks, self._state, np.asarray(actions)
        )
        # Reference quirk: the reference vec envs return an empty info dict
        # (extended_taxi.py:287); ``info_mode="full"`` opts in to the
        # functional layer's info instead (``terminal_state`` for bootstrap-
        # through-truncation, episode stats when the inner env is wrapped in
        # :class:`~gym_po_tpu.vector.RecordEpisodeStatistics`).
        if self.info_mode == "full":
            out_info = jax.tree.map(np.asarray, dict(info))
        else:
            out_info = {}
        return (
            np.asarray(obs),
            np.asarray(rew),
            np.asarray(done),
            np.asarray(trunc),
            out_info,
        )

    def render(self, idx: Optional[Sequence[int]] = None):
        from ..render import human_view, render

        img = render(self.env, self._state, idx)
        if self.render_mode == "human":
            self._window = human_view(img, self._window)
        return img

    def close(self):
        if self._window is not None:  # pragma: no cover
            import pygame

            pygame.quit()
            self._window = None

    @property
    def state(self):
        """The underlying state pytree (for checkpointing / rendering)."""
        return self._state

    def __repr__(self):  # pragma: no cover
        return f"{type(self).__name__}(num_envs={self.num_envs})"


# --------------------------------------------------------------- concrete
class TaxiVecEnv(GymnasiumVecAdapter):
    """Reference ``TaxiVecEnv`` surface (extended_taxi.py:149-230)."""

    metadata = {"render_modes": ["rgb_array", "human"], "render_fps": 5,
                "name": "Taxi"}
    ACTIONS_YX = np.array([[-1, 0], [1, 0], [0, -1], [0, 1], [0, 0]], int)
    ACTION_NAMES = ["North", "South", "West", "East", "Pickup/Dropoff"]
    ACTION_DICT = {i: n for i, n in enumerate(ACTION_NAMES)}

    def __init__(
        self,
        num_envs: int = 1,
        time_limit: int = 200,
        num_passengers: int = 1,
        map: Sequence[str] = TAXI_MAP,
        hansen_obs: bool = False,
        reward_goal: float = 1.0,
        reward_bad: float = -0.5,
        reward_any: float = -0.05,
        render_mode: Optional[str] = None,
        info_mode: str = "reference",
    ):
        super().__init__(
            Taxi(
                map=map,
                hansen_obs=hansen_obs,
                num_passengers=num_passengers,
                time_limit=time_limit,
                reward_goal=reward_goal,
                reward_bad=reward_bad,
                reward_any=reward_any,
            ),
            num_envs,
            render_mode,
            info_mode,
        )


HansenTaxiVecEnv = functools.partial(TaxiVecEnv, hansen_obs=True)
ExtendedTaxiVecEnv = functools.partial(TaxiVecEnv, map=EXTENDED_TAXI_MAP)
ExtendedHansenTaxiVecEnv = functools.partial(
    TaxiVecEnv, map=EXTENDED_TAXI_MAP, hansen_obs=True
)


class RoomsEnv(GymnasiumVecAdapter):
    """Reference ``RoomsEnv`` surface (rooms.py:71-226)."""

    _bare_reset = True

    def __init__(self, num_envs: int, render_mode: Optional[str] = None,
                 info_mode: str = "reference", **kw):
        super().__init__(Rooms(**kw), num_envs, render_mode, info_mode)


class CRoomsEnv(GymnasiumVecAdapter):
    """Reference ``CRoomsEnv`` surface (crooms.py:91-338)."""

    _bare_reset = True

    def __init__(self, num_envs: int, render_mode: Optional[str] = None,
                 info_mode: str = "reference", **kw):
        super().__init__(CRooms(**kw), num_envs, render_mode, info_mode)

    def seed(self, seed: Optional[int] = None):
        """Reference crooms.py:246-249: reseed the private stream."""
        if seed is not None:
            self._key = jax.random.PRNGKey(seed)


class MultistoryFourRoomsEnv(GymnasiumVecAdapter):
    """Reference ``MultistoryFourRoomsEnv`` surface (msrooms.py:257-433)."""

    def __init__(self, num_envs: int, render_mode: Optional[str] = None,
                 info_mode: str = "reference", **kw):
        super().__init__(
            MultistoryFourRooms(**kw), num_envs, render_mode, info_mode
        )


class CarVecEnv(GymnasiumVecAdapter):
    """Reference ``CarVecEnv`` surface (car_flag.py:23-283)."""

    def __init__(
        self,
        num_envs: int,
        time_limit: int = 160,
        render_mode: Optional[str] = None,
        info_mode: str = "reference",
    ):
        super().__init__(
            CarFlag(time_limit=time_limit), num_envs, render_mode, info_mode
        )


class DiscreteActionCarVecEnv(GymnasiumVecAdapter):
    """Reference ``DiscreteActionCarVecEnv`` surface (car_flag.py:286-303)."""

    def __init__(
        self,
        num_actions: int,
        num_envs: int,
        time_limit: int = 160,
        render_mode: Optional[str] = None,
        info_mode: str = "reference",
    ):
        super().__init__(
            DiscreteCarFlag(num_actions=num_actions, time_limit=time_limit),
            num_envs,
            render_mode,
            info_mode,
        )
        nact = num_actions // 2
        self.action_names = ["<" * i + ":" for i in reversed(range(1, nact + 1))] + [
            ":" + ">" * i for i in range(1, nact + 1)
        ]
        if num_actions % 2 == 1:
            self.action_names.insert(nact, ":")
