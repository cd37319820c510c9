"""Fused continuous-state Q trainer: structural + learning checks.

The bit-exact tape oracle lives in tests/test_tape_trainers.py; these
tests check free-space/shape invariants and that the trainer learns.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gym_po_tpu as gpt
from gym_po_tpu.ops import make_fused_q_trainer_crooms
from gym_po_tpu.ops.fused_qlearning import banks_to_q, q_to_banks


def _init(env, B):
    _, st = env.reset_vec(jax.random.PRNGKey(0), B)
    z = jnp.zeros((B // 128, 128), jnp.float32)
    return [
        st.agent_yx[:, 0].reshape(-1, 128),
        st.agent_yx[:, 1].reshape(-1, 128),
        z,
        z,
    ]


def test_fused_q_crooms_structural():
    env = gpt.make("CRooms-v0", action_type="ordinal")
    B, K = 1024, 24
    A = int(env.num_actions)
    run = make_fused_q_trainer_crooms(env, B, K)
    q0 = np.zeros((512, A), np.float32)
    py, px, vy, vx, qb, rew = run(
        jnp.asarray([3], jnp.int32), 0.2, 0.0, *_init(env, B),
        jnp.asarray(q_to_banks(q0)),
    )
    y = np.asarray(py).reshape(-1)
    x = np.asarray(px).reshape(-1)
    grid = env.grid_np
    cy = np.floor(y / env.cell_size).astype(int)
    cx = np.floor(x / env.cell_size).astype(int)
    # agent always in free space
    assert (grid[cy, cx] >= 0).all()
    q = banks_to_q(np.asarray(qb), 512, na=A)
    assert np.isfinite(q).all() and np.abs(q).max() > 0  # updates happened
    assert np.isfinite(np.asarray(rew)).all()


def test_fused_q_crooms_rejects_bad_configs():
    cont = gpt.make("CRooms-v0")  # continuous 'yx' actions
    with pytest.raises(ValueError):
        make_fused_q_trainer_crooms(cont, 1024, 8)
    env = gpt.make("CRooms-v0", action_type="ordinal")
    with pytest.raises(ValueError):
        make_fused_q_trainer_crooms(env, 100, 8)


def test_fused_q_crooms_learns_on_hardware():
    """Hardware: tabular Q over discretized obs learns continuous-state
    navigation (goal-rate far above random)."""
    env = gpt.make("CRooms-v0", action_type="ordinal")
    B = 4096
    A = int(env.num_actions)
    n_obs = int(env.observation_space.n)
    run = make_fused_q_trainer_crooms(env, B, 4096)
    init = [jnp.asarray(a, jnp.float32) for a in _init(env, B)]
    qb = jnp.asarray(q_to_banks(np.zeros((512, A), np.float32)))
    rates = []
    for i, (lr, eps) in enumerate([(0.2, 0.3)] * 2 + [(0.05, 0.05)] * 2):
        *init, qb, rew = run(jnp.asarray([i + 1], jnp.int32), lr, eps,
                             *init, qb)
        rates.append(float(np.asarray(rew).mean()) / 4096)
    # random-policy goal rate is ~1e-3/step in crooms; require >> that
    assert rates[-1] > 0.02, rates


def test_fused_q_learning_wrapper_crooms():
    from gym_po_tpu.agents import fused_q_learning

    env = gpt.make("CRooms-v0", action_type="ordinal")
    q, hist = fused_q_learning(
        env, seed=0, schedule=[(0.1, 0.0, 8)], num_envs=1024,
        chunk_steps=8,
    )
    assert q.shape == (int(env.observation_space.n), int(env.num_actions))
    assert len(hist) == 1 and np.isfinite(hist[0])
