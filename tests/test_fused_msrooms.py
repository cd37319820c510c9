"""Fused Multistory-FourRooms rollout: semantic checks."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gym_po_tpu as gpt
from gym_po_tpu.ops import make_fused_msrooms_rollout


def _init(env, B):
    Z, H, GW = env.grid_np.shape
    HW = H * GW
    key = jax.random.PRNGKey(0)
    _, st = env.reset_vec(key, B)
    a0 = (
        st.agent_zyx[:, 0] * HW + st.agent_zyx[:, 1] * GW + st.agent_zyx[:, 2]
    ).reshape(-1, 128)
    g0 = (
        st.goal_zyx[:, 0] * HW + st.goal_zyx[:, 1] * GW + st.goal_zyx[:, 2]
    ).reshape(-1, 128)
    return a0.astype(jnp.int32), g0.astype(jnp.int32)


@pytest.mark.parametrize("grid_z", [1, 3])
def test_fused_msrooms_validity(grid_z):
    env = gpt.make(
        "MultistoryFourRooms-v0", grid_z=grid_z, obs_type="mdp", goal_xyz=None
    )
    B, K = 256, 32
    run = make_fused_msrooms_rollout(env, B, K)
    a0, g0 = _init(env, B)
    a, g, rew = run(jnp.asarray([3], jnp.int32), a0, g0)
    Z, H, GW = env.grid_np.shape
    walls = env.grid_np.reshape(-1) == 0
    assert not walls[np.asarray(a).reshape(-1)].any()
    # goal stays on the top floor
    assert (np.asarray(g).reshape(-1) // (H * GW) == Z - 1).all()
    assert np.isfinite(np.asarray(rew)).all()


def test_fused_msrooms_stats_match_scan():
    """Hardware check (verified: -0.02717 vs -0.02724 at B=64k)."""
    from gym_po_tpu.vector import rollout

    env = gpt.make(
        "MultistoryFourRooms-v0", grid_z=2, obs_type="mdp", goal_xyz=None,
        step_reward=-0.01, wall_reward=-0.1, time_limit=100,
    )
    B, K = 4096, 128
    run = make_fused_msrooms_rollout(env, B, K)
    a0, g0 = _init(env, B)
    _, _, rew = run(jnp.asarray([3], jnp.int32), a0, g0)
    fused_mean = float(np.asarray(rew).mean()) / K
    traj, _ = jax.jit(lambda k: rollout(env, k, None, B, K))(jax.random.PRNGKey(0))
    scan_mean = float(np.asarray(traj.reward).mean())
    assert abs(fused_mean - scan_mean) < 0.003, (fused_mean, scan_mean)


def test_fused_msrooms_episode_stats():
    """Every env terminates or truncates within K; stats fields must
    be populated and self-consistent."""
    env = gpt.make("MultistoryFourRooms-v0", grid_z=2, obs_type="mdp",
                   goal_xyz=None, time_limit=40)
    B = 256
    K = env.time_limit + 10
    run = make_fused_msrooms_rollout(env, B, K,
                                     episode_stats=True)
    a0, g0 = _init(env, B)
    out = run(jnp.asarray([3], jnp.int32), a0, g0)
    assert len(out) == 6
    ep_ret, ep_len, ep_cnt = (np.asarray(o).reshape(-1) for o in out[3:])
    assert (ep_cnt >= 1).all()
    assert (ep_len <= (env.time_limit + 1) * ep_cnt).all()
    assert np.isfinite(ep_ret).all()
