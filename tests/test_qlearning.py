"""In-graph tabular Q-learning: solves taxi where vanilla PPO plateaus."""

import numpy as np
import pytest

import jax

import gym_po_tpu as gpt
from gym_po_tpu.agents.qlearning import QConfig, greedy_policy, q_learning
from gym_po_tpu.vector import rollout


def test_q_learning_rejects_continuous():
    env = gpt.make("CarFlag-v0")
    with pytest.raises(ValueError):
        q_learning(env, QConfig(num_envs=8), jax.random.PRNGKey(0), 1)


def test_q_learning_learns_taxi():
    """Greedy-from-Q must complete far more dropoffs than random.

    (At B=4096 with an epsilon schedule this reaches the optimal policy,
    ``examples/solve_taxi.py``; the CI-sized run just checks strong
    learning.)
    """
    env = gpt.make("Taxi-v4")
    key = jax.random.PRNGKey(0)
    cfg = QConfig(num_envs=512, learning_rate=0.1, epsilon=0.3,
                  steps_per_update=128)
    q, hist = q_learning(env, cfg, key, num_updates=40)
    q, hist = q_learning(
        env, cfg._replace(epsilon=0.05, learning_rate=0.05), key, 40, q_init=q
    )
    traj, _ = jax.jit(lambda k: rollout(env, k, greedy_policy(q), 256, 200))(
        jax.random.PRNGKey(9)
    )
    r = np.asarray(traj.reward)
    dropoffs_per_env = (r > 0.5).sum() / 256
    # random policy completes ~0.1 per 200 steps; require >= 20x that
    assert dropoffs_per_env > 2.0, dropoffs_per_env
    # and it should not spam bad pickup/dropoffs
    assert (r < -0.4).mean() < 0.05
