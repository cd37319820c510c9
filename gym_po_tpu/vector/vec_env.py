"""Batched environment execution.

The reference's only parallelism is *internal batch vectorization*: each env
object holds ``[B]`` NumPy state arrays and steps them together on the host
(e.g. reference ``gym_po/envs/extended_taxi.py:244-287``, SURVEY.md §2.5).
Here the batch axis is native to the device: a :class:`VecEnv` is a thin
``vmap`` of the single-instance pure functions, entirely jit-compatible, with
in-graph masked autoreset already provided by ``Environment.step_env`` —
stepping B envs is one fused XLA program with zero host synchronization.

Multi-device scaling shards the same functions over a mesh
(:mod:`gym_po_tpu.parallel`); this module is deliberately device-count
agnostic.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core import Environment, EnvState, Space, batch_space

__all__ = ["VecEnv", "Transition", "rollout", "RecordEpisodeStatistics", "EpisodeStatsState"]


class VecEnv:
    """Leading-batch-axis view of an :class:`Environment`.

    Mirrors the reference vec-env surface (``num_envs``,
    ``single_observation_space``, batched ``observation_space`` — reference
    ``extended_taxi.py:171-202``) on top of ``jax.vmap``.
    """

    def __init__(self, env: Environment, num_envs: int):
        self.env = env
        self.num_envs = int(num_envs)
        self.is_vector_env = True

    # ------------------------------------------------------------- spaces
    @property
    def single_observation_space(self) -> Space:
        return self.env.observation_space

    @property
    def single_action_space(self) -> Space:
        return self.env.action_space

    @property
    def observation_space(self) -> Space:
        return batch_space(self.env.observation_space, self.num_envs)

    @property
    def action_space(self) -> Space:
        return batch_space(self.env.action_space, self.num_envs)

    # ------------------------------------------------------------ protocol
    @functools.partial(jax.jit, static_argnums=0)
    def reset(self, key: jax.Array) -> Tuple[jax.Array, EnvState]:
        return self.env.reset_vec(key, self.num_envs)

    @functools.partial(jax.jit, static_argnums=0)
    def step(self, key: jax.Array, state: EnvState, actions: jax.Array):
        return self.env.step_vec(key, state, actions)

    def __repr__(self) -> str:  # pragma: no cover
        return f"VecEnv({self.env!r}, num_envs={self.num_envs})"


class Transition(NamedTuple):
    """One time-slice of a rollout, shapes ``[B, ...]`` (or ``[T, B, ...]``
    when stacked by ``lax.scan``)."""

    obs: jax.Array
    action: jax.Array
    reward: jax.Array
    done: jax.Array
    truncated: jax.Array
    info: Dict[str, Any]


def rollout(
    env: Environment,
    key: jax.Array,
    policy: Optional[Callable[[jax.Array, jax.Array], jax.Array]],
    num_envs: int,
    num_steps: int,
    init: Optional[Tuple[jax.Array, EnvState]] = None,
    keep_infos: bool = False,
) -> Tuple[Transition, Tuple[jax.Array, EnvState]]:
    """Collect a ``[T, B]`` trajectory with a single ``lax.scan``.

    The entire T×B rollout — env dynamics, autoreset, action sampling — is one
    XLA program: no host round-trips inside the loop (the reference pays a
    Python interpreter step per time-step, ``extended_taxi.py:380-391``).

    Args:
      env: single-instance environment.
      policy: ``(key, obs[B]) -> actions[B]``; ``None`` samples the action
        space uniformly (the reference smoke loop's behavior).
      init: optional ``(obs, state)`` from a previous call to continue from.
      keep_infos: stack per-step infos (costs memory: T×B×state).

    Returns:
      ``(traj, (final_obs, final_state))`` where ``traj`` fields have a
      leading time axis.
    """
    if policy is None:
        space = env.action_space

        def policy(k, obs):  # noqa: F811 — uniform random policy
            return space.sample_vec(k, obs.shape[0])

    if init is None:
        key, kr = jax.random.split(key)
        obs, state = env.reset_vec(kr, num_envs)
    else:
        obs, state = init

    def one_step(carry, _):
        key, obs, state = carry
        key, ka, ks = jax.random.split(key, 3)
        actions = policy(ka, obs)
        nobs, nstate, rew, done, trunc, info = env.step_vec(ks, state, actions)
        if not keep_infos:
            info = {}
        return (key, nobs, nstate), Transition(obs, actions, rew, done, trunc, info)

    (key, obs, state), traj = jax.lax.scan(
        one_step, (key, obs, state), None, length=num_steps
    )
    return traj, (obs, state)


class EpisodeStatsState(EnvState):
    """Wrapper state: inner env state + in-graph episode accumulators."""

    env_state: EnvState
    episode_return: jax.Array  # running return of the current episode
    episode_length: jax.Array  # running length of the current episode
    returned_return: jax.Array  # return of the last finished episode
    returned_length: jax.Array  # length of the last finished episode


class RecordEpisodeStatistics(Environment):
    """In-graph episode return/length accounting.

    The reference has no episode-statistics machinery (a gymnasium wrapper
    use is commented out at reference ``tester.py:38``); this provides the
    standard gymnax-style accumulator as a pure wrapper so stats survive
    jit/vmap/scan without host syncs (SURVEY.md §5 metrics plan).
    """

    def __init__(self, env: Environment):
        self.env = env
        self.name = f"Stats({env.name})"

    @property
    def observation_space(self) -> Space:
        return self.env.observation_space

    @property
    def action_space(self) -> Space:
        return self.env.action_space

    def reset_env(self, key: jax.Array):
        obs, inner = self.env.reset(key)
        zf = jnp.zeros((), jnp.float32)
        zi = jnp.zeros((), jnp.int32)
        return obs, EpisodeStatsState(
            elapsed=inner.elapsed,
            env_state=inner,
            episode_return=zf,
            episode_length=zi,
            returned_return=zf,
            returned_length=zi,
        )

    def step_env(self, key: jax.Array, state: EpisodeStatsState, action: jax.Array):
        out = self.env.step(key, state.env_state, action)
        return self._account(state, out)

    # the accumulator arithmetic is shape-polymorphic, so the batched fast
    # path simply delegates to the inner env's batched step
    def reset_vec(self, key: jax.Array, num_envs: int):
        obs, inner = self.env.reset_vec(key, num_envs)
        zf = jnp.zeros(num_envs, jnp.float32)
        zi = jnp.zeros(num_envs, jnp.int32)
        return obs, EpisodeStatsState(
            elapsed=inner.elapsed,
            env_state=inner,
            episode_return=zf,
            episode_length=zi,
            returned_return=zf,
            returned_length=zi,
        )

    def step_vec(self, key: jax.Array, state: EpisodeStatsState, action: jax.Array):
        out = self.env.step_vec(key, state.env_state, action)
        return self._account(state, out)

    def _account(self, state: EpisodeStatsState, out):
        obs, inner, rew, done, trunc, info = out
        fin = done | trunc
        ret = state.episode_return + rew.astype(jnp.float32)
        length = state.episode_length + 1
        new_state = EpisodeStatsState(
            elapsed=inner.elapsed,
            env_state=inner,
            episode_return=jnp.where(fin, 0.0, ret),
            episode_length=jnp.where(fin, 0, length),
            returned_return=jnp.where(fin, ret, state.returned_return),
            returned_length=jnp.where(fin, length, state.returned_length),
        )
        info = dict(info)
        info["episode_return"] = new_state.returned_return
        info["episode_length"] = new_state.returned_length
        info["episode_done"] = fin
        return obs, new_state, rew, done, trunc, info

    def observe(self, state: EpisodeStatsState) -> jax.Array:
        return self.env.observe(state.env_state)
