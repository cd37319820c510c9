"""Potential-based reward shaping — the exploration aid for the sparse
±1-terminal POMDPs.

The heaven-hell tasks (reference ``gym_po/envs/ant_heaven_hell.py:121-137``
and the point-mass surrogate) pay ONLY a terminal ±1, and their geometry
defeats naive exploration: a fresh Gaussian policy's tiny state-dependent
mean drift swamps the random-walk diffusion long before the ~10-unit trek
to a terminal completes (measured: a drift-free uniform policy terminates
~2% of episodes; PPO's step-1 policy ~0.005%).  The standard remedy is
Ng-Harada-Russell potential-based shaping: an auxiliary reward

    F(s, s') = γ·Φ(s')·(1 − done) − Φ(s)

telescopes against the discount, so the optimal (and every) policy
ORDERING is exactly preserved — the shaped MDP has the same optimal
policies as the raw task [Ng et al., ICML 1999].  Crucially for the memory
claim: Φ is a function of the *state* (which knows the heaven side), but
the policy still only sees the *observation* — a memoryless policy cannot
condition on the side outside the priest radius no matter what the reward
is, so shaping accelerates both learners without leaking the bit the GRU
is supposed to remember.

Success metrics stay honest: the learners' ``pos/neg_reward_rate`` count
magnitude-≥0.5 rewards only, i.e. real heaven/hell arrivals, never the
|F| ≤ ~0.05 shaping increments.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..core import Environment, EnvState, Space

__all__ = [
    "PotentialShaped",
    "heaven_hell_potential",
    "tag_potential",
]


def heaven_hell_potential(coef: float = 0.1) -> Callable[[EnvState], jax.Array]:
    """Φ = −coef · (T-maze geodesic distance to the episode's heaven).

    Works for both the point-mass surrogate (``state.agent_xy``) and the
    articulated ant (``state.qpos[..., :2]``): distance = climb to the bar
    row (y=6) plus the walk along the bar to (±6.25, 6) — the task
    constants of reference ``ant_heaven_hell.py:29-48``.
    """

    def phi(state: EnvState) -> jax.Array:
        xy = state.agent_xy if hasattr(state, "agent_xy") \
            else state.qpos[..., :2]
        side = jnp.where(state.heaven_right, 1.0, -1.0)
        d = jnp.abs(6.0 - xy[..., 1]) + jnp.abs(6.25 * side - xy[..., 0])
        return -coef * d

    return phi


def tag_potential(coef: float = 0.1) -> Callable[[EnvState], jax.Array]:
    """Φ = −coef · (distance to the fleeing target) for the tag tasks."""

    def phi(state: EnvState) -> jax.Array:
        xy = state.agent_xy if hasattr(state, "agent_xy") \
            else state.qpos[..., :2]
        d = jnp.sqrt(((xy - state.target_xy) ** 2).sum(-1) + 1e-12)
        return -coef * d

    return phi


class PotentialShaped(Environment):
    """Wrap an env with exact PBRS: reward += γ·Φ(s')·(1−done) − Φ(s).

    ``s'`` is the PRE-reset successor (``info["terminal_state"]``), so the
    shaping never reaches across an autoreset boundary; Φ(terminal) = 0 by
    the ``(1 − done)`` factor (the Ng et al. absorbing-state convention).
    State, spaces, and observations pass through untouched.

    ``gamma`` semantics (measured on heaven-hell, docs/ARCHITECTURE.md):

    * ``gamma = learner discount`` → EXACT policy invariance, but with a
      negative Φ the term pays ``(1-γ)·|Φ|`` per step for *loitering far
      from the goal* — PPO reliably converges to a zero-terminal loiter
      policy (entropy collapse, 0 arrivals in 78M steps).
    * ``gamma = 1.0`` (recommended) → within-episode telescoping
      ``ΣF = Φ(end) − Φ(start)``: loitering pays exactly 0, progress pays
      ``+coef`` per unit.  Invariance is approximate (bias ``O(1-γ)`` per
      step), which is the standard practical trade.
    """

    def __init__(self, env: Environment,
                 potential: Callable[[EnvState], jax.Array],
                 gamma: float = 0.99):
        self.env = env
        self.potential = potential
        self.gamma = float(gamma)
        self.name = f"Shaped({env.name})"

    @property
    def observation_space(self) -> Space:
        return self.env.observation_space

    @property
    def action_space(self) -> Space:
        return self.env.action_space

    def _shape(self, prev_state, out):
        obs, nstate, rew, done, trunc, info = out
        mid = info["terminal_state"]
        f = (self.gamma * self.potential(mid)
             * (1.0 - done.astype(jnp.float32))
             - self.potential(prev_state))
        return obs, nstate, rew + f.astype(rew.dtype), done, trunc, info

    def reset_env(self, key):
        return self.env.reset_env(key)

    def step_env(self, key, state, action):
        return self._shape(state, self.env.step_env(key, state, action))

    def reset_vec(self, key, num_envs):
        return self.env.reset_vec(key, num_envs)

    def step_vec(self, key, state, action):
        return self._shape(state, self.env.step_vec(key, state, action))

    def observe(self, state):
        return self.env.observe(state)

    def observe_vec(self, state):
        return self.env.observe_vec(state)
