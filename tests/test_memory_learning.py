"""The suite's core POMDP claim, as a default-suite test: memory WINS on
heaven-hell, where the heaven side is observable only at the priest
(reference ``gym_po/envs/ant_heaven_hell.py:88-97``).

Fast-surrogate config (agent_speed=0.75, time_limit=150 — the same
CPU-budget trick as the tag smoke in test_ppo_rnn.py): calibrated on this
machine, GRU-PPO reaches heaven_frac = 1.000 at pos rate 0.077/step within
50 updates (~8 s), while feedforward PPO at the IDENTICAL config touches
chance-level terminals (frac 0.50) then collapses to zero arrivals — the
asserted margins are >3x below the measured gap.  The articulated version
is tests/test_ant_hh_learning_hw.py.
"""

import numpy as np

import jax

import gym_po_tpu as gpt
from gym_po_tpu.agents import (
    PPOConfig,
    init_rnn_state,
    init_train_state,
    make_rnn_train_step,
    make_train_step,
)


def _env():
    return gpt.make("HeavenHellContinuous-v0", agent_speed=0.75,
                    time_limit=150)


def test_gru_ppo_solves_heaven_hell_surrogate():
    env = _env()
    cfg = PPOConfig(num_envs=128, rollout_steps=32, epochs=4, minibatches=4,
                    learning_rate=1e-3, entropy_coef=0.01, shuffle="none")
    net, ts = init_rnn_state(env, cfg, jax.random.PRNGKey(1), hidden=32)
    step = make_rnn_train_step(env, net, cfg)
    pos, neg = [], []
    for _ in range(50):
        ts, m = step(ts)
        pos.append(float(m["pos_reward_rate"]))
        neg.append(float(m["neg_reward_rate"]))
    p, n = np.mean(pos[-10:]), np.mean(neg[-10:])
    # measured: p=0.077, heaven_frac=1.000
    assert p > 0.02, (p, n)
    assert p / max(p + n, 1e-12) > 0.9, (p, n)


def test_feedforward_ppo_is_memoryless_on_heaven_hell():
    """Same budget, same config, no recurrence: arrivals stay at chance
    split or die out entirely — the task is unsolved without memory."""
    env = _env()
    cfg = PPOConfig(num_envs=128, rollout_steps=32, epochs=4, minibatches=4,
                    learning_rate=1e-3, entropy_coef=0.01)
    net, ts = init_train_state(env, cfg, jax.random.PRNGKey(1))
    step = make_train_step(env, net, cfg)
    pos, neg = [], []
    for _ in range(50):
        ts, m = step(ts)
        pos.append(float(m["pos_reward_rate"]))
        neg.append(float(m["neg_reward_rate"]))
    p, n = np.mean(pos[-10:]), np.mean(neg[-10:])
    # measured: collapses to 0.0/0.0 by update 40 (peak ~6e-5 at chance
    # split).  heaven_frac must not approach the GRU's ~1.0; arrival rate
    # must stay >20x below the GRU's.
    assert p < 1e-3, (p, n)
