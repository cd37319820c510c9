"""Fused continuous-ROOMS rollout: semantic checks."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gym_po_tpu as gpt
from gym_po_tpu.ops import make_fused_crooms_rollout


def _init(env, B):
    key = jax.random.PRNGKey(0)
    _, st = env.reset_vec(key, B)
    return [
        st.agent_yx[:, 0].reshape(-1, 128),
        st.agent_yx[:, 1].reshape(-1, 128),
        st.vel_yx[:, 0].reshape(-1, 128),
        st.vel_yx[:, 1].reshape(-1, 128),
        st.goal_yx[:, 0].reshape(-1, 128),
        st.goal_yx[:, 1].reshape(-1, 128),
    ]


@pytest.mark.parametrize("use_velocity", [False, True])
def test_fused_crooms_validity(use_velocity):
    env = gpt.make("CRooms-v0", layout="4", obs_type="mdp", goal_xy=None,
                   use_velocity=use_velocity)
    B, K = 256, 32
    run = make_fused_crooms_rollout(env, B, K)
    out = run(jnp.asarray([3], jnp.int32), *_init(env, B))
    py, px = np.asarray(out[0]).reshape(-1), np.asarray(out[1]).reshape(-1)
    H, GW = env.grid_np.shape
    assert (py >= 0).all() and (py < H).all()
    assert (px >= 0).all() and (px < GW).all()
    cells = env.grid_np[np.floor(py).astype(int), np.floor(px).astype(int)]
    assert (cells >= 0).all(), "agent rests inside a wall"
    assert np.isfinite(np.asarray(out[-1])).all()


def test_fused_crooms_rejects_discrete_actions():
    env = gpt.make("CRooms-v0", layout="4", action_type="cardinal")
    with pytest.raises(ValueError):
        make_fused_crooms_rollout(env, 256, 8)


def test_fused_crooms_stats_match_scan():
    """Hardware check (verified: -0.01981 vs -0.01981 at B=64k)."""
    from gym_po_tpu.vector import rollout

    env = gpt.make("CRooms-v0", layout="4", obs_type="mdp", goal_xy=None,
                   use_velocity=True, step_reward=-0.01, wall_reward=-0.1)
    B, K = 4096, 128
    run = make_fused_crooms_rollout(env, B, K)
    _, _, *rest = out = run(jnp.asarray([5], jnp.int32), *_init(env, B))
    fused_mean = float(np.asarray(out[-1]).mean()) / K
    traj, _ = jax.jit(lambda k: rollout(env, k, None, B, K))(jax.random.PRNGKey(0))
    scan_mean = float(np.asarray(traj.reward).mean())
    assert abs(fused_mean - scan_mean) < 0.003, (fused_mean, scan_mean)


def test_fused_crooms_episode_stats():
    """Every env terminates or truncates
    within K, so the stats fields must be populated and self-consistent."""
    env = gpt.make("CRooms-v0", layout="4", obs_type="mdp", goal_xy=None,
                   time_limit=40)
    B = 256
    K = env.time_limit + 10
    run = make_fused_crooms_rollout(env, B, K,
                                    episode_stats=True)
    out = run(jnp.asarray([3], jnp.int32), *_init(env, B))
    assert len(out) == 10
    ep_ret, ep_len, ep_cnt = (np.asarray(o).reshape(-1) for o in out[7:])
    assert (ep_cnt >= 1).all()
    assert (ep_len <= (env.time_limit + 1) * ep_cnt).all()
    assert np.isfinite(ep_ret).all()
