"""Recurrent PPO (GRU actor-critic) — memory for partially-observable envs.

The suite's whole point is partial observability (Hansen masks, priest
regions, hidden rock quality); memoryless policies cap out on most of these.
This is the Anakin-layout recurrent learner:

* a GRU torso carried through the rollout `lax.scan`; hidden state resets
  in-graph where episodes ended (matching the envs' autoreset);
* BPTT over whole rollout sequences: minibatches split the ENV axis (never
  the time axis), each sequence replayed from its stored initial hidden
  state — the standard recurrent-PPO scheme, accelerator-friendly because every
  sequence has identical static length;
* same sharding story as :mod:`gym_po_tpu.agents.ppo`: params replicated,
  env batch + hidden states sharded over ``data``, one gradient ``psum``.
"""

from __future__ import annotations

import dataclasses
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
from .networks import (
    dense,
    dense_init,
    encode_obs,
    layer_key,
    obs_features,
    policy_head,
    policy_head_init,
)
from .ppo import PPOConfig, _gae, _optimizer

__all__ = ["RecurrentActorCritic", "RNNTrainState", "init_rnn_state", "make_rnn_train_step"]


def gru_init(key, n_in: int, hidden: int, name: str = "GRUCell_0"):
    """GRU cell params: lecun-normal input kernels with bias, orthogonal
    recurrent kernels (only the candidate gate's has a bias)."""
    rec = jax.nn.initializers.orthogonal()
    p = {g: dense_init(layer_key(key, name, g), n_in, hidden)
         for g in ("ir", "iz", "in")}
    for g in ("hr", "hz", "hn"):
        p[g] = dense_init(layer_key(key, name, g), hidden, hidden, rec,
                          use_bias=(g == "hn"))
    return p


def gru(p, h: jax.Array, x: jax.Array, dtype: Any) -> jax.Array:
    """One GRU step: ``h' = (1 - z) * n + z * h``."""
    r = jax.nn.sigmoid(dense(p["ir"], x, dtype) + dense(p["hr"], h, dtype))
    z = jax.nn.sigmoid(dense(p["iz"], x, dtype) + dense(p["hz"], h, dtype))
    n = jnp.tanh(dense(p["in"], x, dtype) + r * dense(p["hn"], h, dtype))
    return (1.0 - z) * n + z * h


@dataclasses.dataclass(frozen=True, eq=False)
class RecurrentActorCritic:
    """Dense embed -> GRU -> categorical/Gaussian + value heads."""

    obs_space: Any
    action_space: Any
    hidden: int = 128
    compute_dtype: Any = jnp.float32

    def init(self, key: jax.Array, h: jax.Array, obs: jax.Array,
             reset: jax.Array):
        """Parameters for inputs shaped like one :meth:`apply` step."""
        del h, obs, reset  # shapes follow from the spaces
        return {
            "embed": dense_init(layer_key(key, "Dense_0"),
                                obs_features(self.obs_space), self.hidden),
            "gru": gru_init(key, self.hidden, self.hidden),
            "head": policy_head_init(key, self.hidden, self.action_space, 1),
        }

    def apply(self, params, h: jax.Array, obs: jax.Array, reset: jax.Array):
        """One step: (h, obs[B], reset[B]) -> (h', pi, value)."""
        dt = self.compute_dtype
        x = jnp.tanh(dense(params["embed"], encode_obs(self.obs_space, obs,
                                                       dt), dt))
        # in-graph hidden reset where the previous step finished an episode
        h = jnp.where(reset[:, None], jnp.zeros_like(h), h)
        h = gru(params["gru"], h, x, dt)
        pi, value = policy_head(params["head"], h.astype(jnp.float32))
        return h, pi, value

    def initial_state(self, batch: int) -> jax.Array:
        return jnp.zeros((batch, self.hidden), self.compute_dtype)


class RNNTrainState(PyTreeNode):
    params: Any
    opt_state: Any
    env_obs: jax.Array
    env_state: Any
    hidden: jax.Array  # [B_local, H]
    prev_reset: jax.Array  # [B_local] episode boundary entering this step
    key: jax.Array
    update_idx: jax.Array


def init_rnn_state(
    env: Environment, config: PPOConfig, key: jax.Array, hidden: int = 128
):
    net = RecurrentActorCritic(
        obs_space=env.observation_space,
        action_space=env.action_space,
        hidden=hidden,
        compute_dtype=config.compute_dtype,
    )
    kp, kr = jax.random.split(key)
    obs0, state0 = env.reset_vec(kr, config.num_envs)
    h0 = net.initial_state(config.num_envs)
    params = net.init(kp, h0, obs0, jnp.zeros(config.num_envs, bool))
    tx = _optimizer(config)
    return net, RNNTrainState(
        params=params,
        opt_state=tx.init(params),
        env_obs=obs0,
        env_state=state0,
        hidden=h0,
        prev_reset=jnp.zeros(config.num_envs, bool),
        key=kr,
        update_idx=jnp.zeros((), jnp.int32),
    )


class _Seq(NamedTuple):
    obs: jax.Array  # [T, B, ...]
    action: jax.Array
    logp: jax.Array
    value: jax.Array
    reset: jax.Array  # [T, B] episode boundary entering each step
    advantage: jax.Array
    target: jax.Array
    h0: jax.Array  # [B, H] hidden entering the rollout


def _replay(net, params, seq: _Seq):
    """Re-run the GRU over a [T, B] sequence batch, return (pi, value)."""

    def step(h, x):
        obs, reset = x
        h, pi, v = net.apply(params, h, obs, reset)
        # the 'kind' tag is a static string — strip it for scan stacking
        arrays = {k: v2 for k, v2 in pi.items() if k != "kind"}
        return h, (arrays, v)

    _, (arrays, value) = jax.lax.scan(step, seq.h0, (seq.obs, seq.reset))
    kind = "categorical" if "logits" in arrays else "gaussian"
    pi = {"kind": kind, **arrays}
    if kind == "gaussian":
        pi["log_std"] = pi["log_std"][0]  # parameter, identical every step
    return pi, value


def _rnn_loss(params, net, seq: _Seq, config: PPOConfig):
    pi, value = _replay(net, params, seq)
    logp = networks.log_prob(pi, seq.action)
    ratio = jnp.exp(logp - seq.logp)
    adv = (seq.advantage - seq.advantage.mean()) / (seq.advantage.std() + 1e-8)
    pg = -jnp.minimum(
        ratio * adv,
        jnp.clip(ratio, 1 - config.clip_eps, 1 + config.clip_eps) * adv,
    ).mean()
    v_clipped = seq.value + jnp.clip(
        value - seq.value, -config.clip_eps, config.clip_eps
    )
    v_loss = 0.5 * jnp.maximum(
        (value - seq.target) ** 2, (v_clipped - seq.target) ** 2
    ).mean()
    ent = networks.entropy(pi).mean()
    loss = pg + config.value_coef * v_loss - config.entropy_coef * ent
    return loss, {"pg_loss": pg, "v_loss": v_loss, "entropy": ent}


def shard_rnn_state(ts: RNNTrainState, mesh: Mesh, axis: str = "data") -> RNNTrainState:
    """Anakin layout for the recurrent TrainState: params/opt replicated,
    env fields + hidden + reset flags sharded, one PRNG key per device.
    Multi-process-safe via :func:`~gym_po_tpu.parallel.put_global`."""
    from jax.sharding import NamedSharding

    from ..parallel import put_global

    n = int(np.prod(list(mesh.shape.values())))
    rep = NamedSharding(mesh, P())
    shd = NamedSharding(mesh, P(axis))
    keys = jax.random.split(ts.key, n)
    return RNNTrainState(
        params=put_global(ts.params, rep),
        opt_state=put_global(ts.opt_state, rep),
        env_obs=put_global(ts.env_obs, shd),
        env_state=put_global(ts.env_state, shd),
        hidden=put_global(ts.hidden, shd),
        prev_reset=put_global(ts.prev_reset, shd),
        key=put_global(keys, shd),
        update_idx=put_global(ts.update_idx, rep),
    )


def make_rnn_train_step(
    env: Environment,
    net: RecurrentActorCritic,
    config: PPOConfig,
    mesh: Optional[Mesh] = None,
    axis: str = "data",
) -> Callable[[RNNTrainState], Tuple[RNNTrainState, dict]]:
    tx = _optimizer(config)
    n_dev = 1 if mesh is None else int(np.prod(list(mesh.shape.values())))
    b_local = config.num_envs // n_dev
    if b_local % config.minibatches:
        raise ValueError("num_envs per device must divide minibatches")
    mb_envs = b_local // config.minibatches

    def local_update(ts: RNNTrainState):
        key = ts.key

        def env_step(carry, _):
            obs, est, h, prev_reset, key = carry
            key, ka, ks = jax.random.split(key, 3)
            h2, pi, value = net.apply(ts.params, h, obs, prev_reset)
            action, logp = networks.sample_action(pi, ka)
            nobs, nest, rew, done, trunc, info = env.step_vec(ks, est, action)
            # value of the PRE-reset successor under the post-step hidden —
            # bootstraps truncated episodes through the time limit (_gae)
            _, _, v_term = net.apply(
                ts.params,
                h2,
                env.observe_vec(info["terminal_state"]),
                jnp.zeros_like(done),
            )
            fin = done | trunc
            out = (obs, action, logp, value, v_term, prev_reset,
                   done.astype(jnp.float32), rew.astype(jnp.float32),
                   1.0 - fin.astype(jnp.float32))
            return (nobs, nest, h2, fin, key), out

        h0 = ts.hidden
        (obs_f, est_f, h_f, reset_f, key), (
            obs, action, logp, value, v_term, reset, done, rew, cont
        ) = jax.lax.scan(
            env_step,
            (ts.env_obs, ts.env_state, h0, ts.prev_reset, key),
            None,
            length=config.rollout_steps,
        )
        adv, target = _gae(
            rew, value, v_term, done, cont, config.gamma, config.gae_lambda
        )
        seq = _Seq(obs, action, logp, value, reset, adv, target, h0)

        def epoch(carry, _):
            params, opt_state, key = carry
            key, kp = jax.random.split(key)
            # permute the ENV axis only; sequences stay intact
            perm = jax.random.permutation(kp, b_local)

            def pick(x, batch_axis):
                return jnp.take(x, perm, axis=batch_axis)

            shuf = _Seq(
                obs=pick(seq.obs, 1),
                action=pick(seq.action, 1),
                logp=pick(seq.logp, 1),
                value=pick(seq.value, 1),
                reset=pick(seq.reset, 1),
                advantage=pick(seq.advantage, 1),
                target=pick(seq.target, 1),
                h0=pick(seq.h0, 0),
            )

            def minibatch(carry, mb):
                params, opt_state = carry
                (loss, aux), grads = jax.value_and_grad(
                    _rnn_loss, has_aux=True
                )(params, net, mb, config)
                if mesh is not None:
                    grads = jax.lax.pmean(grads, axis)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), {**aux, "loss": loss}

            def split_envs(x, batch_axis):
                # [.., B, ..] -> [M, .., B/M, ..] with M leading
                moved = jnp.moveaxis(x, batch_axis, 0)
                return jnp.stack(
                    [
                        jnp.moveaxis(
                            moved[i * mb_envs : (i + 1) * mb_envs], 0, batch_axis
                        )
                        for i in range(config.minibatches)
                    ]
                )

            mbs = _Seq(
                obs=split_envs(shuf.obs, 1),
                action=split_envs(shuf.action, 1),
                logp=split_envs(shuf.logp, 1),
                value=split_envs(shuf.value, 1),
                reset=split_envs(shuf.reset, 1),
                advantage=split_envs(shuf.advantage, 1),
                target=split_envs(shuf.target, 1),
                h0=split_envs(shuf.h0, 0),
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
        # terminal-event rates for sparse ±1 tasks (see ppo.py; 0.5
        # threshold = real terminals only, never shaping increments)
        metrics["pos_reward_rate"] = (rew > 0.5).mean()
        metrics["neg_reward_rate"] = (rew < -0.5).mean()
        if mesh is not None:
            metrics = jax.lax.pmean(metrics, axis)
        new_ts = RNNTrainState(
            params=params,
            opt_state=opt_state,
            env_obs=obs_f,
            env_state=est_f,
            hidden=h_f,
            prev_reset=reset_f,
            key=key,
            update_idx=ts.update_idx + 1,
        )
        return new_ts, metrics

    if mesh is None:
        return jax.jit(local_update)

    specs = RNNTrainState(
        params=P(),
        opt_state=P(),
        env_obs=P(axis),
        env_state=P(axis),
        hidden=P(axis),
        prev_reset=P(axis),
        key=P(axis),
        update_idx=P(),
    )

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(specs,), out_specs=(specs, P()),
        check_rep=False,
    )
    def sharded_update(ts):
        ts = ts.replace(key=ts.key[0])
        new_ts, metrics = local_update(ts)
        return new_ts.replace(key=new_ts.key[None]), metrics

    return jax.jit(sharded_update)
