"""In-graph batched tabular Q-learning.

The suite's discrete-observation envs (taxi's whole state is one int,
reference ``extended_taxi.py:226``) are classic tabular domains; vanilla PPO
gets stuck in taxi's avoid-action-4 local optimum, while Q-learning's
per-transition credit assignment solves it outright.

Design: the Q-table lives on the device; B envs step in lockstep under one
``lax.scan``; every transition applies ``Q[s,a] += lr * td`` as a
scatter-add, with duplicate (s,a) pairs within a batch accumulating — the
standard vectorized-Q approximation, exact as lr → 0.  ``Q[obs]`` row
lookups are gathers, so values stay exact f32.  Bootstrapping uses the
PRE-reset terminal observation from ``info["terminal_state"]`` so autoreset
never leaks next-episode value into the target; ``done`` cuts the
bootstrap, truncation does not (time limits are not environment dynamics).
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import Discrete, Environment

__all__ = [
    "QConfig",
    "q_learning",
    "greedy_policy",
    "fused_q_learning",
    "fused_actor_critic",
]


class QConfig(NamedTuple):
    num_envs: int = 4096
    learning_rate: float = 0.1
    gamma: float = 0.99
    epsilon: float = 0.1  # epsilon-greedy exploration
    steps_per_update: int = 128  # scan length per jit call


_TRAINERS: "weakref.WeakKeyDictionary" = None  # built lazily below


def _make_trainer(
    env: Environment, B: int, steps_per_update: int, num_updates: int
):
    n_obs = int(env.observation_space.n)
    n_act = int(env.action_space.n)

    def update(q, obs, state, key, lr, gamma, eps):
        def one_step(carry, _):
            q, obs, state, key = carry
            key, ke, ka, ks = jax.random.split(key, 4)
            q_rows = q[obs]
            greedy = jnp.argmax(q_rows, axis=-1).astype(jnp.int32)
            random_a = jax.random.randint(ka, (B,), 0, n_act)
            explore = jax.random.uniform(ke, (B,)) < eps
            action = jnp.where(explore, random_a, greedy)
            nobs, nstate, rew, done, trunc, info = env.step_vec(
                ks, state, action
            )
            # bootstrap from the PRE-reset terminal observation
            term_obs = env.observe(info["terminal_state"])
            next_v = jnp.max(q[term_obs], axis=-1)
            target = rew + gamma * next_v * (1.0 - done.astype(jnp.float32))
            td = target - jnp.take_along_axis(q_rows, action[:, None], 1)[:, 0]
            q = q.at[obs, action].add(lr * td)
            return (q, nobs, nstate, key), (rew.mean(), done.mean())

        (q, obs, state, key), (rews, dones) = jax.lax.scan(
            one_step, (q, obs, state, key), None, length=steps_per_update
        )
        return (q, obs, state, key), (rews.mean(), dones.mean())

    # the whole run is ONE dispatch: a scan over updates wrapping the scan
    # over steps.  lr/gamma/eps are traced (not closure) scalars so an
    # epsilon/lr schedule reuses ONE executable.
    @jax.jit
    def train(q, obs, state, key, lr, gamma, eps):
        return jax.lax.scan(
            lambda c, _: update(*c, lr, gamma, eps), (q, obs, state, key),
            None, length=num_updates,
        )

    return train


def _get_trainer(env: Environment, B: int, spu: int, num_updates: int):
    """Compiled-trainer cache keyed on the static shape knobs only.

    ``q_learning`` is re-entrant (epsilon/lr schedules call it repeatedly);
    without the cache every call builds a fresh closure and jit entry."""
    global _TRAINERS
    if _TRAINERS is None:
        _TRAINERS = weakref.WeakKeyDictionary()
    per_env = _TRAINERS.setdefault(env, {})
    k = (B, spu, num_updates)
    if k not in per_env:
        per_env[k] = _make_trainer(env, B, spu, num_updates)
    return per_env[k]


def q_learning(
    env: Environment,
    config: QConfig,
    key: jax.Array,
    num_updates: int = 100,
    q_init: jax.Array | None = None,
):
    """Train a Q-table; returns (Q [n_obs, n_act], diagnostics history)."""
    if not isinstance(env.observation_space, Discrete) or not isinstance(
        env.action_space, Discrete
    ):
        raise ValueError("tabular Q-learning needs Discrete obs and actions")
    n_obs = int(env.observation_space.n)
    n_act = int(env.action_space.n)
    q = (
        q_init
        if q_init is not None
        else jnp.zeros((n_obs, n_act), jnp.float32)
    )
    key, kr = jax.random.split(key)
    obs, state = env.reset_vec(kr, config.num_envs)
    train = _get_trainer(
        env, config.num_envs, config.steps_per_update, num_updates
    )
    (q, obs, state, key), (hist_r, hist_d) = train(
        q, obs, state, key,
        jnp.float32(config.learning_rate),
        jnp.float32(config.gamma),
        jnp.float32(config.epsilon),
    )
    hist_r, hist_d = np.asarray(hist_r), np.asarray(hist_d)
    return q, [(float(r), float(d)) for r, d in zip(hist_r, hist_d)]


def greedy_policy(q: jax.Array):
    """(key, obs[B]) -> argmax actions — plugs into vector.rollout."""

    def policy(key, obs):
        return jnp.argmax(q[obs], axis=-1).astype(jnp.int32)

    return policy


def fused_q_learning(
    env,
    seed: int,
    schedule,
    num_envs: int = 8192,
    gamma: float = 0.99,
    chunk_steps: int = 4096,
    q_init: np.ndarray | None = None,
    average_duplicates: bool = True,
    expected_sarsa: bool = False,
    lam: float = 0.0,
    trace_len: int = 8,
    watkins_cut: bool = True,
    mesh=None,
):
    """Tabular Q-learning with the whole chunk fused into one loop.

    High-level driver over the ``ops.fused_qlearning`` trainer family.
    ``schedule`` is ``[(lr, epsilon, num_steps), ...]``; phases reuse ONE
    compiled executable because lr/epsilon are traced scalars.  Returns ``(q [n_obs, n_act], history)`` with one
    mean-reward-per-step entry per executed chunk.

    Env support: :class:`~gym_po_tpu.envs.taxi.Taxi` (classic AND extended
    maps; MDP or Hansen-POMDP Q indexing),
    :class:`~gym_po_tpu.envs.rooms.Rooms`,
    :class:`~gym_po_tpu.envs.msrooms.MultistoryFourRooms`, and the
    continuous-state :class:`~gym_po_tpu.envs.crooms.CRooms` with a
    discrete action type (fixed goal, any discrete obs model).

    ``lam > 0`` (Taxi and Rooms) switches to fused **Watkins Q(λ)**:
    truncated backward-view eligibility traces over the last ``trace_len``
    visited pairs, cut at non-greedy actions unless ``watkins_cut=False``
    (Rooms: :func:`~gym_po_tpu.ops.fused_qlambda
    .make_fused_qlambda_trainer_rooms`; Taxi: the ``lam`` kwarg of
    :func:`~gym_po_tpu.ops.fused_qlearning.make_fused_q_trainer`, where the
    trace survives mid-episode task resets).

    **Multi-device**: pass ``mesh`` (a 1-D ``('data',)``
    :class:`jax.sharding.Mesh`) to run the chunk-synchronous data-parallel
    scheme from ``docs/MULTIHOST.md``: the env batch is sharded over the
    mesh, each device trains on its shard with a private table copy under a
    disjoint seed, and the ``[nb, 128]`` Q banks are ``pmean``-averaged
    across devices between chunks (16 KB per collective).  ``num_envs`` is
    the GLOBAL batch (must split into per-device multiples of 128).
    ``average_duplicates=True`` (the default) keeps the effective step size
    invariant to the global batch.
    """
    from ..envs.crooms import CRooms
    from ..envs.msrooms import MultistoryFourRooms
    from ..envs.rooms import Rooms
    from ..envs.taxi import Taxi
    from ..ops import (
        banks_to_q,
        make_fused_q_trainer,
        make_fused_q_trainer_crooms,
        make_fused_q_trainer_msrooms,
        make_fused_q_trainer_rooms,
        q_to_banks,
    )
    from ..ops.fused_qlearning import bank_geometry
    from ..parallel import (
        chunk_seeds,
        replicate,
        shard_batch,
        shard_fused_trainer,
    )

    if expected_sarsa and not isinstance(env, Taxi):
        raise ValueError("expected_sarsa is currently taxi-only")
    if lam > 0.0 and not isinstance(env, (Rooms, Taxi)):
        raise ValueError("lam > 0 (Watkins Q(λ)) supports Taxi and Rooms")
    ndev = 1 if mesh is None else int(mesh.shape["data"])
    if num_envs % ndev:
        raise ValueError(
            f"global num_envs={num_envs} not divisible by mesh size {ndev}"
        )
    shard_envs = num_envs // ndev
    key = jax.random.PRNGKey(seed)
    _, st = env.reset_vec(key, num_envs)
    if isinstance(env, CRooms):
        # continuous-state variant: four float tiles instead of one int tile
        n_act = int(env.num_actions)
        n_obs = int(env.observation_space.n)
        nsb, _ = bank_geometry(n_obs, n_act)
        nsp = nsb * 128
        run = make_fused_q_trainer_crooms(
            env, shard_envs, chunk_steps, gamma,
            average_duplicates=average_duplicates,
        )
        z = jnp.zeros((num_envs // 128, 128), jnp.float32)
        tiles = [
            jnp.asarray(st.agent_yx[:, 0].reshape(-1, 128)),
            jnp.asarray(st.agent_yx[:, 1].reshape(-1, 128)),
            z, z,
        ]
        q0 = np.zeros((nsp, n_act), np.float32)
        if q_init is not None:
            q0[: q_init.shape[0]] = np.asarray(q_init, np.float32)
        qb = jnp.asarray(q_to_banks(q0, nsb))
        if mesh is not None:
            # args after seed: (lr, eps, y, x, vy, vx, q); outs: (y, x, vy,
            # vx, q, rew) — 4 sharded state tiles, table banks averaged
            run = shard_fused_trainer(
                run, mesh, sharded_args=(2, 3, 4, 5), averaged_outs=(4,),
                num_outs=6,
            )
            tiles = [shard_batch(mesh, t) for t in tiles]
            qb = replicate(mesh, qb)
        history = []
        i = 0
        for lr, eps, steps in schedule:
            for _ in range(-(-int(steps) // chunk_steps)):
                i += 1
                *tiles, qb, rew = run(
                    jnp.asarray(chunk_seeds(seed, i, ndev)),
                    float(lr), float(eps), *tiles, qb)
                history.append(rew)
        history = [
            float(np.asarray(r).mean()) / chunk_steps for r in history
        ]
        return banks_to_q(np.asarray(qb), nsp, na=n_act, nsb=nsb)[:n_obs], \
            history
    if isinstance(env, Taxi):
        def make(env, B, K, g, average_duplicates):
            return make_fused_q_trainer(
                env, B, K, g, average_duplicates=average_duplicates,
                expected_sarsa=expected_sarsa, lam=lam, trace_len=trace_len,
                watkins_cut=watkins_cut,
            )
        n_act = 5
        state0 = np.asarray(st.s)
    elif isinstance(env, Rooms):
        if lam > 0.0:
            from ..ops import make_fused_qlambda_trainer_rooms

            def make(env, B, K, g, average_duplicates):
                return make_fused_qlambda_trainer_rooms(
                    env, B, K, g, lam=lam, trace_len=trace_len,
                    watkins_cut=watkins_cut,
                    average_duplicates=average_duplicates,
                )
        else:
            make = make_fused_q_trainer_rooms
        n_act = int(env.num_actions)
        GW = env.grid_np.shape[1]
        a = np.asarray(st.agent_yx)
        state0 = a[:, 0] * GW + a[:, 1]
    elif isinstance(env, MultistoryFourRooms):
        make, n_act = make_fused_q_trainer_msrooms, int(env.num_actions)
        _, H, GW = env.grid_np.shape
        a = np.asarray(st.agent_zyx)
        state0 = a[:, 0] * H * GW + a[:, 1] * GW + a[:, 2]
    else:
        raise ValueError(f"no fused Q trainer for {type(env).__name__}")

    n_obs = int(env.observation_space.n)
    nsb, _ = bank_geometry(n_obs, n_act)
    nsp = nsb * 128
    run = make(env, shard_envs, chunk_steps, gamma,
               average_duplicates=average_duplicates)
    s = jnp.asarray(state0.reshape(-1, 128), jnp.int32)
    q0 = np.zeros((nsp, n_act), np.float32)
    if q_init is not None:
        q0[: q_init.shape[0]] = np.asarray(q_init, np.float32)
    qb = jnp.asarray(q_to_banks(q0, nsb))
    if mesh is not None:
        # args after seed: (lr, eps, s, q); outs: (s, q, rew)
        run = shard_fused_trainer(
            run, mesh, sharded_args=(2,), averaged_outs=(1,), num_outs=3
        )
        s = shard_batch(mesh, s)
        qb = replicate(mesh, qb)
    history = []
    i = 0
    for lr, eps, steps in schedule:
        for _ in range(-(-int(steps) // chunk_steps)):
            i += 1
            s, qb, rew = run(jnp.asarray(chunk_seeds(seed, i, ndev)),
                             float(lr), float(eps), s, qb)
            history.append(rew)  # fetch deferred: keep the pipeline full
    history = [float(np.asarray(r).mean()) / chunk_steps for r in history]
    return banks_to_q(np.asarray(qb), nsp, na=n_act, nsb=nsb)[:n_obs], history


def fused_actor_critic(
    env,
    seed: int,
    schedule,
    num_envs: int = 8192,
    gamma: float = 0.99,
    chunk_steps: int = 4096,
    mesh=None,
):
    """Softmax actor-critic with the whole chunk fused into one loop (ROOMS).

    ``schedule`` is ``[(alpha_pi, alpha_v, num_steps), ...]``; returns
    ``(logits [n_obs, A], v [n_obs], history)``.  See
    :func:`~gym_po_tpu.ops.fused_ac.make_fused_ac_trainer_rooms`.

    ``mesh``: optional 1-D ``('data',)`` mesh for the chunk-synchronous
    data-parallel scheme (docs/MULTIHOST.md) — policy-logit AND value banks
    are both ``pmean``-averaged across devices between chunks.
    """
    from ..envs.rooms import Rooms
    from ..ops import make_fused_ac_trainer_rooms
    from ..ops.fused_qlearning import banks_to_q, q_to_banks
    from ..parallel import (
        chunk_seeds,
        replicate,
        shard_batch,
        shard_fused_trainer,
    )

    if not isinstance(env, Rooms):
        raise ValueError(f"no fused AC trainer for {type(env).__name__}")
    ndev = 1 if mesh is None else int(mesh.shape["data"])
    if num_envs % ndev:
        raise ValueError(
            f"global num_envs={num_envs} not divisible by mesh size {ndev}"
        )
    key = jax.random.PRNGKey(seed)
    _, st = env.reset_vec(key, num_envs)
    GW = env.grid_np.shape[1]
    a0 = np.asarray(st.agent_yx)
    agent = jnp.asarray(
        (a0[:, 0] * GW + a0[:, 1]).reshape(-1, 128), jnp.int32
    )
    A = int(env.num_actions)
    n_obs = int(env.observation_space.n)
    run = make_fused_ac_trainer_rooms(env, num_envs // ndev, chunk_steps,
                                      gamma)
    th = jnp.asarray(q_to_banks(np.zeros((512, A), np.float32)))
    v = jnp.asarray(q_to_banks(np.zeros((512, 1), np.float32)))
    if mesh is not None:
        # args after seed: (api, apv, th, v, agent); outs: (th, v, agent, rew)
        run = shard_fused_trainer(
            run, mesh, sharded_args=(4,), averaged_outs=(0, 1), num_outs=4
        )
        agent = shard_batch(mesh, agent)
        th, v = replicate(mesh, th), replicate(mesh, v)
    history = []
    i = 0
    for api, apv, steps in schedule:
        for _ in range(-(-int(steps) // chunk_steps)):
            i += 1
            th, v, agent, rew = run(jnp.asarray(chunk_seeds(seed, i, ndev)),
                                    float(api), float(apv), th, v, agent)
            history.append(rew)
    history = [float(np.asarray(r).mean()) / chunk_steps for r in history]
    return (
        banks_to_q(np.asarray(th), 512, na=A)[:n_obs],
        banks_to_q(np.asarray(v), 512, na=1)[:n_obs, 0],
        history,
    )
