"""Memory-learning smoke on the ARTICULATED heaven-hell ant, on the GPU.

GRU-PPO on ``AntHeavenHellPhysics-v0`` (euler speed knob, γ=1 PBRS
shaping as the exploration aid — policy-invariant, `envs/shaping.py`):
heaven arrivals must rise well above zero with heaven_frac near 1.0 — the
recurrent policy carries the priest's reveal through the ambiguous
corridor (full run `benchmarks/ant_learning.py --env
AntHeavenHellPhysics-v0 --rnn --shaped`).  The assertions allow a 10% hell
fraction.  150 updates = 9.8M env steps: ``gpu`` and ``slow``; its time on
the H100 is not measured yet.
"""

import jax
import numpy as np
import pytest

import gym_po_tpu as gpt
from gym_po_tpu.agents import PPOConfig, init_rnn_state, make_rnn_train_step
from gym_po_tpu.envs.shaping import PotentialShaped, heaven_hell_potential
from gym_po_tpu.utils import enable_compilation_cache

pytestmark = [pytest.mark.slow, pytest.mark.gpu]


def test_gru_ppo_reaches_heaven_on_articulated_ant():
    enable_compilation_cache()
    env = PotentialShaped(
        gpt.make("AntHeavenHellPhysics-v0", integrator="euler"),
        heaven_hell_potential(0.1), gamma=1.0,
    )
    cfg = PPOConfig(num_envs=2048, rollout_steps=32, entropy_coef=0.001,
                    hidden=(64, 64), shuffle="none")
    net, ts = init_rnn_state(env, cfg, jax.random.PRNGKey(0), hidden=64)
    step = make_rnn_train_step(env, net, cfg)

    # one dispatch per update
    pos, neg = [], []
    for _ in range(150):
        ts, m = step(ts)
        pos.append(float(m["pos_reward_rate"]))
        neg.append(float(m["neg_reward_rate"]))
    p, n = float(np.mean(pos[-25:])), float(np.mean(neg[-25:]))
    # measured: p ≈ 1.2e-3 over updates 125-150, n = 0.0 exactly
    assert p > 5e-5, (p, n)
    assert p / max(p + n, 1e-12) > 0.9, (p, n)
