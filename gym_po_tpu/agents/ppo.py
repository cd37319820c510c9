"""Podracer-style PPO (Anakin architecture).

North-star config 5 (BASELINE.md): a learner consuming sharded rollouts.
The reference has no learner at all — its README merely links the Podracer
paper (reference ``README.md``); this module realizes it the accelerator way:

* **Anakin layout** (Hessel et al. 2021): params replicated on every device,
  env batch sharded over the ``data`` mesh axis.  Each device rolls out its
  env shard with the current policy inside ``lax.scan``, computes PPO
  gradients on its own trajectories, and a single ``psum`` over ICI merges
  gradients — the only cross-device communication in the whole update.
* The entire update (T-step rollout + GAE + E epochs × M minibatches) is ONE
  jitted, shard_mapped program: no host round-trips, no data reshuffling
  between "actor" and "learner" — they are the same device.
* Minibatching permutes the *local* env axis only (device-local shuffle), so
  no all-to-all is needed.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from ..parallel.mesh import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core import Environment, PyTreeNode
from . import networks
from ..vector.chunked import DISPATCH_BATCH
from .networks import ActorCritic, make_actor_critic

__all__ = ["PPOConfig", "TrainState", "make_train_step", "init_train_state", "train"]


class PPOConfig(NamedTuple):
    """Hyperparameters (PPO defaults per Schulman et al. 2017)."""

    num_envs: int = 4096  # global, across all devices
    rollout_steps: int = 128
    epochs: int = 4
    minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    max_grad_norm: float = 0.5
    learning_rate: float = 2.5e-4
    hidden: Tuple[int, ...] = (64, 64)
    compute_dtype: Any = jnp.float32
    #: epoch minibatch reassignment: 'permute' = full Fisher-Yates shuffle
    #: (faithful PPO, but a gather of the whole [T*B] batch every epoch),
    #: 'roll' = random circular shift (cheap copy;
    #: minibatch composition still changes every epoch), 'none' = fixed split
    shuffle: str = "permute"


class TrainState(PyTreeNode):
    params: Any
    opt_state: Any
    env_obs: jax.Array  # [B_local] per-device obs
    env_state: Any  # per-device env state pytree
    key: jax.Array  # per-device PRNG key
    update_idx: jax.Array


class _Batch(NamedTuple):
    obs: jax.Array
    action: jax.Array
    logp: jax.Array
    value: jax.Array
    advantage: jax.Array
    target: jax.Array


def _gae(rewards, values, next_values, dones, continues, gamma, lam):
    """Generalized advantage estimation over the scan (time) axis.

    ``next_values[t]`` is the value of the PRE-reset successor state of step
    ``t`` (``V(observe(info["terminal_state"]))`` — on non-boundary steps
    this is exactly ``V(obs[t+1])``), so time-limit truncation bootstraps
    *through* the reset while true termination (``dones``) zeroes the
    bootstrap.  ``continues = 1 - (done | truncated)`` only stops the
    λ-recursion at episode boundaries; it never cuts the one-step bootstrap.
    The reference's stateful API can't express this (its autoreset discards
    the terminal obs, reset-before-obs, SURVEY.md §3.2 ⚠); the functional
    core's ``terminal_state`` info makes the unbiased estimator free, and it
    matches the semantics of the tabular learner
    (:mod:`gym_po_tpu.agents.qlearning`).
    """

    def step(gae, x):
        reward, value, next_value, done, cont = x
        delta = reward + gamma * next_value * (1.0 - done) - value
        gae = delta + gamma * lam * cont * gae
        return gae, gae

    _, adv = jax.lax.scan(
        step,
        jnp.zeros_like(values[-1]),
        (rewards, values, next_values, dones, continues),
        reverse=True,
    )
    return adv, adv + values


def init_train_state(
    env: Environment,
    config: PPOConfig,
    key: jax.Array,
    num_devices: int = 1,
) -> Tuple[ActorCritic, TrainState]:
    """Initialize replicated params + a host template of per-device state.

    The returned TrainState is for ONE device shard (``B_local = num_envs /
    num_devices``); :func:`make_train_step` shard_maps over the mesh and each
    device folds its own key.
    """
    net = make_actor_critic(env, config.hidden, config.compute_dtype)
    b_local = config.num_envs // num_devices
    kp, kr = jax.random.split(key)
    obs0, state0 = env.reset_vec(kr, b_local)
    params = net.init(kp, obs0)
    tx = _optimizer(config)
    return net, TrainState(
        params=params,
        opt_state=tx.init(params),
        env_obs=obs0,
        env_state=state0,
        key=kr,
        update_idx=jnp.zeros((), jnp.int32),
    )


def _optimizer(config: PPOConfig):
    return optax.chain(
        optax.clip_by_global_norm(config.max_grad_norm),
        optax.adam(config.learning_rate, eps=1e-5),
    )


def _loss_fn(params, net, batch: _Batch, config: PPOConfig):
    pi, value = net.apply(params, batch.obs)
    logp = networks.log_prob(pi, batch.action)
    ratio = jnp.exp(logp - batch.logp)
    adv = (batch.advantage - batch.advantage.mean()) / (
        batch.advantage.std() + 1e-8
    )
    pg = -jnp.minimum(
        ratio * adv,
        jnp.clip(ratio, 1 - config.clip_eps, 1 + config.clip_eps) * adv,
    ).mean()
    v_clipped = batch.value + jnp.clip(
        value - batch.value, -config.clip_eps, config.clip_eps
    )
    v_loss = 0.5 * jnp.maximum(
        (value - batch.target) ** 2, (v_clipped - batch.target) ** 2
    ).mean()
    ent = networks.entropy(pi).mean()
    loss = pg + config.value_coef * v_loss - config.entropy_coef * ent
    return loss, {"pg_loss": pg, "v_loss": v_loss, "entropy": ent}


def make_local_update(
    env: Environment,
    net: ActorCritic,
    config: PPOConfig,
    n_dev: int = 1,
    axis: Optional[str] = None,
) -> Callable[[TrainState], Tuple[TrainState, dict]]:
    """One device's share of the Anakin update (unjitted): rollout of its
    ``num_envs / n_dev`` envs, GAE, epochs × minibatches.  With ``axis``,
    gradients and metrics are ``pmean``-ed over that named axis — under
    ``shard_map`` (:func:`make_train_step`) or under ``jax.vmap`` with
    ``axis_name`` (the same update emulated on one device)."""
    tx = _optimizer(config)
    b_local = config.num_envs // n_dev
    if config.num_envs % n_dev:
        raise ValueError("num_envs must divide the device count")
    mb_size = (b_local * config.rollout_steps) // config.minibatches

    def local_update(ts: TrainState) -> Tuple[TrainState, dict]:
        key = ts.key

        # ---------------------------------------------------- rollout (scan)
        def env_step(carry, _):
            obs, est, key = carry
            key, ka, ks = jax.random.split(key, 3)
            pi, value = net.apply(ts.params, obs)
            action, logp = networks.sample_action(pi, ka)
            nobs, nest, rew, done, trunc, info = env.step_vec(ks, est, action)
            # value of the PRE-reset successor: bootstraps truncation (_gae)
            _, v_term = net.apply(
                ts.params, env.observe_vec(info["terminal_state"])
            )
            fin = (done | trunc).astype(jnp.float32)
            out = (obs, action, logp, value, v_term,
                   done.astype(jnp.float32), rew.astype(jnp.float32),
                   1.0 - fin)
            return (nobs, nest, key), out

        (obs_f, est_f, key), (
            obs, action, logp, value, v_term, done, rew, cont
        ) = jax.lax.scan(
            env_step,
            (ts.env_obs, ts.env_state, key),
            None,
            length=config.rollout_steps,
        )
        adv, target = _gae(
            rew, value, v_term, done, cont, config.gamma, config.gae_lambda
        )
        flat = _Batch(
            obs=obs.reshape(-1, *obs.shape[2:]),
            action=action.reshape(-1, *action.shape[2:]),
            logp=logp.reshape(-1),
            value=value.reshape(-1),
            advantage=adv.reshape(-1),
            target=target.reshape(-1),
        )

        # ------------------------------------------- epochs × minibatches
        def epoch(carry, _):
            params, opt_state, key = carry
            key, kp = jax.random.split(key)
            n = flat.obs.shape[0]
            if config.shuffle == "permute":
                perm = jax.random.permutation(kp, n)
                shuffled = jax.tree.map(lambda x: x[perm], flat)
            elif config.shuffle == "roll":
                shift = jax.random.randint(kp, (), 0, n)
                shuffled = jax.tree.map(
                    lambda x: jnp.roll(x, shift, axis=0), flat
                )
            else:
                shuffled = flat

            def minibatch(carry, mb):
                params, opt_state = carry
                (loss, aux), grads = jax.value_and_grad(
                    _loss_fn, has_aux=True
                )(params, net, mb, config)
                if axis is not None:
                    grads = jax.lax.pmean(grads, axis)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), {**aux, "loss": loss}

            mbs = jax.tree.map(
                lambda x: x.reshape(config.minibatches, mb_size, *x.shape[1:]),
                shuffled,
            )
            (params, opt_state), aux = jax.lax.scan(
                minibatch, (params, opt_state), mbs
            )
            return (params, opt_state, key), aux

        (params, opt_state, key), aux = jax.lax.scan(
            epoch, (ts.params, ts.opt_state, key), None, length=config.epochs
        )
        metrics = jax.tree.map(lambda x: x.mean(), aux)
        metrics["mean_reward"] = rew.mean()
        # terminal-event rates for sparse ±1 tasks (tag / heaven-hell):
        # pos = success events per env-step, neg = failure events.  The 0.5
        # threshold keeps these honest under PotentialShaped rewards (the
        # |F| ≤ ~0.05 shaping increments never count, envs/shaping.py).
        metrics["pos_reward_rate"] = (rew > 0.5).mean()
        metrics["neg_reward_rate"] = (rew < -0.5).mean()
        if axis is not None:
            metrics = jax.lax.pmean(metrics, axis)
        new_ts = TrainState(
            params=params,
            opt_state=opt_state,
            env_obs=obs_f,
            env_state=est_f,
            key=key,
            update_idx=ts.update_idx + 1,
        )
        return new_ts, metrics

    return local_update


def _build_update(
    env: Environment,
    net: ActorCritic,
    config: PPOConfig,
    mesh: Optional[Mesh] = None,
    axis: str = "data",
) -> Callable[[TrainState], Tuple[TrainState, dict]]:
    """Build the (optionally shard_mapped, unjitted) Anakin update.

    Single-device when ``mesh is None``; otherwise the returned function
    expects a TrainState whose env fields are sharded over ``axis`` and whose
    params are replicated, and performs the gradient ``psum`` over ``axis``.
    """
    n_dev = 1 if mesh is None else int(np.prod(list(mesh.shape.values())))
    local_update = make_local_update(env, net, config, n_dev,
                                     None if mesh is None else axis)

    # NOTE: no buffer donation — for envs whose obs IS a state field (e.g.
    # Taxi obs == state.s) env_obs and env_state alias the same buffer, and
    # donating the TrainState would donate it twice.
    if mesh is None:
        return local_update

    # Anakin: params/opt replicated, env fields + key sharded over `axis`.
    state_specs = TrainState(
        params=P(),
        opt_state=P(),
        env_obs=P(axis),
        env_state=P(axis),
        key=P(axis),
        update_idx=P(),
    )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(state_specs,),
        out_specs=(state_specs, P()),
        check_rep=False,
    )
    def sharded_update(ts):
        # fold the device id into the shard's key so streams are independent
        ts = ts.replace(key=ts.key[0])
        new_ts, metrics = local_update(ts)
        return new_ts.replace(key=new_ts.key[None]), metrics

    return sharded_update


def make_train_step(
    env: Environment,
    net: ActorCritic,
    config: PPOConfig,
    mesh: Optional[Mesh] = None,
    axis: str = "data",
) -> Callable[[TrainState], Tuple[TrainState, dict]]:
    """Jitted single PPO update (rollout + GAE + epochs×minibatches)."""
    return jax.jit(_build_update(env, net, config, mesh, axis))


def make_chunked_train_step(
    env: Environment,
    net: ActorCritic,
    config: PPOConfig,
    dispatch_batch: int = DISPATCH_BATCH,
) -> Callable[[TrainState], Tuple[TrainState, dict]]:
    """Single-device PPO update for ``num_envs`` above ``dispatch_batch``:
    the rollout runs as ``num_envs / dispatch_batch`` sequential dispatches
    of a ``dispatch_batch``-compiled program (``vector.chunked``), and the
    epochs×minibatches update runs once on the concatenated batch.  On the
    H100 a monolithic rollout is faster at every batch measured (PERF.md,
    the ant batch curve), so this is a fallback for batches too large for
    one program.

    Semantics match :func:`make_train_step` except PRNG chunking: chunk
    ``i`` draws from ``fold_in(key, i)`` streams (same distributions).
    Requires ``dispatch_batch | num_envs``; at or below ``dispatch_batch`` it
    just returns :func:`make_train_step`.
    """
    if config.num_envs <= dispatch_batch:
        return make_train_step(env, net, config)
    if config.num_envs % dispatch_batch:
        raise ValueError("dispatch_batch must divide num_envs")
    n_chunks = config.num_envs // dispatch_batch
    tx = _optimizer(config)
    mb_size = (config.num_envs * config.rollout_steps) // config.minibatches

    @jax.jit
    def rollout_chunk(params, key, obs0, state0):
        """T-step rollout + GAE for ONE dispatch_batch-wide chunk."""

        def env_step(carry, _):
            obs, est, key = carry
            key, ka, ks = jax.random.split(key, 3)
            pi, value = net.apply(params, obs)
            action, logp = networks.sample_action(pi, ka)
            nobs, nest, rew, done, trunc, info = env.step_vec(ks, est, action)
            _, v_term = net.apply(
                params, env.observe_vec(info["terminal_state"])
            )
            fin = (done | trunc).astype(jnp.float32)
            out = (obs, action, logp, value, v_term,
                   done.astype(jnp.float32), rew.astype(jnp.float32),
                   1.0 - fin)
            return (nobs, nest, key), out

        (obs_f, est_f, _), (
            obs, action, logp, value, v_term, done, rew, cont
        ) = jax.lax.scan(
            env_step, (obs0, state0, key), None,
            length=config.rollout_steps,
        )
        adv, target = _gae(
            rew, value, v_term, done, cont, config.gamma, config.gae_lambda
        )
        flat = _Batch(
            obs=obs.reshape(-1, *obs.shape[2:]),
            action=action.reshape(-1, *action.shape[2:]),
            logp=logp.reshape(-1),
            value=value.reshape(-1),
            advantage=adv.reshape(-1),
            target=target.reshape(-1),
        )
        return flat, (obs_f, est_f), rew.mean(), (rew > 0.5).mean(), \
            (rew < -0.5).mean()

    @jax.jit
    def update(params, opt_state, key, flat: _Batch):
        def epoch(carry, _):
            params, opt_state, key = carry
            key, kp = jax.random.split(key)
            n = flat.obs.shape[0]
            if config.shuffle == "permute":
                perm = jax.random.permutation(kp, n)
                shuffled = jax.tree.map(lambda x: x[perm], flat)
            elif config.shuffle == "roll":
                shift = jax.random.randint(kp, (), 0, n)
                shuffled = jax.tree.map(
                    lambda x: jnp.roll(x, shift, axis=0), flat
                )
            else:
                shuffled = flat

            def minibatch(carry, mb):
                params, opt_state = carry
                (loss, aux), grads = jax.value_and_grad(
                    _loss_fn, has_aux=True
                )(params, net, mb, config)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), {**aux, "loss": loss}

            mbs = jax.tree.map(
                lambda x: x.reshape(
                    config.minibatches, mb_size, *x.shape[1:]
                ),
                shuffled,
            )
            (params, opt_state), aux = jax.lax.scan(
                minibatch, (params, opt_state), mbs
            )
            return (params, opt_state, key), aux

        (params, opt_state, _), aux = jax.lax.scan(
            epoch, (params, opt_state, key), None, length=config.epochs
        )
        return params, opt_state, jax.tree.map(lambda x: x.mean(), aux)

    def split(tree, i):
        return jax.tree.map(
            lambda x: x[i * dispatch_batch:(i + 1) * dispatch_batch], tree
        )

    def step(ts: TrainState) -> Tuple[TrainState, dict]:
        key, ku = jax.random.split(ts.key)
        outs = [
            rollout_chunk(
                ts.params, jax.random.fold_in(key, i),
                split(ts.env_obs, i), split(ts.env_state, i),
            )
            for i in range(n_chunks)  # async: dispatches pipeline on-device
        ]
        flat = jax.tree.map(
            lambda *xs: jnp.concatenate(xs, axis=0), *[o[0] for o in outs]
        )
        obs_f = jnp.concatenate([o[1][0] for o in outs], axis=0)
        est_f = jax.tree.map(
            lambda *xs: jnp.concatenate(xs, axis=0),
            *[o[1][1] for o in outs]
        )
        params, opt_state, metrics = update(
            ts.params, ts.opt_state, ku, flat
        )
        metrics["mean_reward"] = sum(o[2] for o in outs) / n_chunks
        metrics["pos_reward_rate"] = sum(o[3] for o in outs) / n_chunks
        metrics["neg_reward_rate"] = sum(o[4] for o in outs) / n_chunks
        return TrainState(
            params=params,
            opt_state=opt_state,
            env_obs=obs_f,
            env_state=est_f,
            key=key,
            update_idx=ts.update_idx + 1,
        ), metrics

    return step


def make_multi_train_step(
    env: Environment,
    net: ActorCritic,
    config: PPOConfig,
    num_updates: int,
    mesh: Optional[Mesh] = None,
    axis: str = "data",
    bounded: bool = False,
) -> Callable[..., Tuple[TrainState, dict]]:
    """``num_updates`` PPO updates as ONE jitted scan — one device dispatch.

    A host loop of per-update dispatches pays the dispatch latency per
    update; the scan pays it once per run.  Returned metrics
    are stacked ``[num_updates]`` arrays.

    ``bounded=True`` returns ``multi(ts, limit)`` taking a TRACED total-update
    limit: scan iterations whose carried ``update_idx`` has reached ``limit``
    compute-and-discard (select against the old carry), so a run whose total
    is not a multiple of the chunk size reuses ONE executable for the ragged
    tail instead of paying a second cold compile (the wasted tail
    iterations cost milliseconds).  Metrics rows past the limit
    are garbage — callers slice the first ``limit - start`` rows.
    """
    upd = _build_update(env, net, config, mesh, axis)

    if bounded:

        @jax.jit
        def multi_bounded(ts: TrainState, limit) -> Tuple[TrainState, dict]:
            def body(t, _):
                new_t, metrics = upd(t)
                active = t.update_idx < limit
                t2 = jax.tree.map(
                    lambda n, o: jnp.where(active, n, o), new_t, t
                )
                return t2, metrics

            return jax.lax.scan(body, ts, None, length=num_updates)

        return multi_bounded

    @jax.jit
    def multi(ts: TrainState) -> Tuple[TrainState, dict]:
        return jax.lax.scan(lambda t, _: upd(t), ts, None, length=num_updates)

    return multi


def shard_train_state(
    ts: TrainState, mesh: Mesh, axis: str = "data"
) -> TrainState:
    """Lay out a host TrainState for the Anakin update: params replicated,
    env fields sharded over ``axis``, one PRNG key per device.

    Works multi-process too (each process holds the seed-identical host
    state; :func:`~gym_po_tpu.parallel.put_global` slices out local shards).
    """
    from jax.sharding import NamedSharding

    from ..parallel import put_global

    n = int(np.prod(list(mesh.shape.values())))
    rep = NamedSharding(mesh, P())
    shd = NamedSharding(mesh, P(axis))
    keys = jax.random.split(ts.key, n)
    return TrainState(
        params=put_global(ts.params, rep),
        opt_state=put_global(ts.opt_state, rep),
        env_obs=put_global(ts.env_obs, shd),
        env_state=put_global(ts.env_state, shd),
        key=put_global(keys, shd),
        update_idx=put_global(ts.update_idx, rep),
    )


def train(
    env: Environment,
    config: PPOConfig,
    seed: int = 0,
    num_updates: int = 100,
    mesh: Optional[Mesh] = None,
    log_every: int = 0,
):
    """Convenience driver: init, (shard,) and run ``num_updates`` updates.

    Updates run in scan chunks of ``log_every`` (the whole run when 0) so the
    per-dispatch latency is paid once per chunk, not per update.
    """
    key = jax.random.PRNGKey(seed)
    net, ts = init_train_state(env, config, key)
    if mesh is not None:
        # init made the full global env batch; lay it out across the mesh
        ts = shard_train_state(ts, mesh)
    chunk = log_every if log_every else num_updates
    # A ragged tail reuses the SAME chunk-sized executable with a traced
    # update limit (bounded mode) — never a second cold compile.
    ragged = num_updates % chunk != 0
    step = make_multi_train_step(env, net, config, chunk, mesh, bounded=ragged)
    limit = jnp.int32(num_updates)
    history = []
    done = 0
    while done < num_updates:
        ts, metrics = step(ts, limit) if ragged else step(ts)
        n_eff = min(chunk, num_updates - done)
        done += n_eff
        if log_every:
            m = {k: float(v[n_eff - 1]) for k, v in metrics.items()}
            history.append(m)
            print(f"update {done}: {m}")
    return net, ts, history
