"""Actor-critic networks for the Podracer learner, in plain JAX.

The reference ships no agents (SURVEY.md §0); this is the learner half of the
north-star config ("Podracer-style PPO consuming sharded rollouts").
Parameters are a pytree of arrays; a network is a small frozen object with
``init(key, ...) -> params`` and ``apply(params, ...)``.  Design notes:

* observations are embedded to a fixed feature width so the hot path is
  dense matmuls;
* compute dtype is a constructor knob — ``bfloat16`` halves memory traffic
  and runs on the tensor cores; params and the final logits/value head stay
  ``float32`` for stable optimization;
* everything is shape-static and jit/vmap/scan/shard_map-safe.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import Box, Discrete, Space

__all__ = ["ActorCritic", "obs_features", "make_actor_critic"]

_init = jax.nn.initializers


def obs_features(space: Space) -> int:
    """Feature width of the flat encoding of an observation space."""
    if isinstance(space, Discrete):
        return int(space.n)
    if isinstance(space, Box):
        return int(np.prod(space.shape)) if space.shape else 1
    raise TypeError(f"Unsupported observation space {space!r}")


def encode_obs(space: Space, obs: jax.Array, dtype: Any) -> jax.Array:
    """Flat-encode a raw observation: one-hot for Discrete, flatten for Box.

    One-hot × dense-layer is a gather expressed as a matmul, which keeps the
    small discrete POMDP observation spaces on the same dense path as Box.
    """
    if isinstance(space, Discrete):
        return jax.nn.one_hot(obs, space.n, dtype=dtype)
    flat = obs.reshape(*obs.shape[: obs.ndim - len(space.shape)], -1)
    return flat.astype(dtype)


def layer_key(key, *path) -> jax.Array:
    """Key of the first parameter of the layer at ``path`` below ``key``:
    SHA-1 of the path names and the per-layer counter folded into the key,
    the derivation of the Flax library, so initial parameters equal those of
    the same architecture written with it."""
    m = hashlib.sha1()
    for x in path + (1,):
        m.update(x.encode() if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(key, jnp.uint32(int.from_bytes(m.digest()[:4],
                                                             "big")))


def dense_init(key, n_in: int, n_out: int, kernel_init=None,
               use_bias: bool = True):
    """Parameters of one dense layer (lecun-normal kernel, zero bias);
    ``key`` is the layer's :func:`layer_key`."""
    kernel_init = kernel_init or _init.lecun_normal()
    p = {"kernel": kernel_init(key, (n_in, n_out), jnp.float32)}
    if use_bias:
        p["bias"] = jnp.zeros((n_out,), jnp.float32)
    return p


def dense(p, x: jax.Array, dtype: Any = jnp.float32) -> jax.Array:
    """``x @ kernel + bias`` with inputs and params cast to ``dtype``."""
    y = jnp.matmul(x.astype(dtype), p["kernel"].astype(dtype))
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def policy_head_init(key, n_in: int, action_space: Space, first: int):
    """Policy (orthogonal 0.01) and value (orthogonal 1.0) head params; the
    two layers are the network's dense layers ``first`` and ``first + 1``."""
    kp = layer_key(key, f"Dense_{first}")
    kv = layer_key(key, f"Dense_{first + 1}")
    small = _init.orthogonal(0.01)
    if isinstance(action_space, Discrete):
        head = {"logits": dense_init(kp, n_in, int(action_space.n), small)}
    else:
        adim = int(np.prod(action_space.shape)) or 1
        head = {"mean": dense_init(kp, n_in, adim, small),
                "log_std": jnp.zeros((adim,), jnp.float32)}
    head["value"] = dense_init(kv, n_in, 1, _init.orthogonal(1.0))
    return head


def policy_head(p, x: jax.Array):
    """(pi, value) from the f32 features ``x``."""
    if "logits" in p:
        pi = {"kind": "categorical", "logits": dense(p["logits"], x)}
    else:
        pi = {"kind": "gaussian", "mean": dense(p["mean"], x),
              "log_std": p["log_std"]}
    return pi, jnp.squeeze(dense(p["value"], x), -1)


@dataclasses.dataclass(frozen=True, eq=False)
class ActorCritic:
    """MLP torso with categorical (Discrete) or Gaussian (Box) policy head."""

    obs_space: Space
    action_space: Space
    hidden: Sequence[int] = (64, 64)
    compute_dtype: Any = jnp.float32

    def init(self, key: jax.Array, obs: jax.Array):
        """Parameters for observations shaped like ``obs``."""
        n_in = obs_features(self.obs_space)
        torso = []
        for i, width in enumerate(self.hidden):
            torso.append(dense_init(layer_key(key, f"Dense_{i}"), n_in, width,
                                    _init.orthogonal(float(np.sqrt(2)))))
            n_in = width
        head = policy_head_init(key, n_in, self.action_space, len(torso))
        return {"torso": torso, "head": head}

    def apply(self, params, obs: jax.Array) -> Tuple[Any, jax.Array]:
        x = encode_obs(self.obs_space, obs, self.compute_dtype)
        for layer in params["torso"]:
            x = jnp.tanh(dense(layer, x, self.compute_dtype))
        return policy_head(params["head"], x.astype(jnp.float32))


# ---------------------------------------------------------------- policies
def sample_action(pi, key: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Sample an action and its log-prob from a policy head output."""
    if pi["kind"] == "categorical":
        action = jax.random.categorical(key, pi["logits"])
        logp = log_prob(pi, action)
        return action, logp
    std = jnp.exp(pi["log_std"])
    eps = jax.random.normal(key, pi["mean"].shape)
    action = pi["mean"] + std * eps
    return action, log_prob(pi, action)


def log_prob(pi, action: jax.Array) -> jax.Array:
    if pi["kind"] == "categorical":
        logits = jax.nn.log_softmax(pi["logits"])
        return jnp.take_along_axis(
            logits, action[..., None].astype(jnp.int32), axis=-1
        )[..., 0]
    std = jnp.exp(pi["log_std"])
    z = (action - pi["mean"]) / std
    return jnp.sum(
        -0.5 * z**2 - pi["log_std"] - 0.5 * jnp.log(2 * jnp.pi), axis=-1
    )


def entropy(pi) -> jax.Array:
    if pi["kind"] == "categorical":
        logp = jax.nn.log_softmax(pi["logits"])
        return -jnp.sum(jnp.exp(logp) * logp, axis=-1)
    return jnp.sum(pi["log_std"] + 0.5 * jnp.log(2 * jnp.pi * jnp.e), axis=-1)


def make_actor_critic(
    env, hidden: Sequence[int] = (64, 64), compute_dtype: Any = jnp.float32
) -> ActorCritic:
    return ActorCritic(
        obs_space=env.observation_space,
        action_space=env.action_space,
        hidden=tuple(hidden),
        compute_dtype=compute_dtype,
    )
