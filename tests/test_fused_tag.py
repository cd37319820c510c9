"""Fused Tag / HeavenHell rollouts: structural and distributional checks
against the scan path (the bit-exact tape oracles live in
tests/test_tape_rollouts.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gym_po_tpu as gpt
from gym_po_tpu.envs.tag_jax import CAGE, MIN_SPAWN_DIST
from gym_po_tpu.ops import make_fused_heavenhell_rollout, make_fused_tag_rollout


def _tag_init(env, B):
    _, st = env.reset_vec(jax.random.PRNGKey(0), B)
    return [
        st.agent_xy[:, 0].reshape(-1, 128),
        st.agent_xy[:, 1].reshape(-1, 128),
        st.target_xy[:, 0].reshape(-1, 128),
        st.target_xy[:, 1].reshape(-1, 128),
    ]


def _hh_init(env, B):
    _, st = env.reset_vec(jax.random.PRNGKey(0), B)
    return [
        st.agent_xy[:, 0].reshape(-1, 128),
        st.agent_xy[:, 1].reshape(-1, 128),
        st.heaven_right.astype(jnp.int32).reshape(-1, 128),
    ]


def test_fused_tag_validity():
    env = gpt.make("TagContinuous-v0")
    B, K = 256, 32
    run = make_fused_tag_rollout(env, B, K)
    out = run(jnp.asarray([3], jnp.int32), *_tag_init(env, B))
    a0, a1, t0, t1, rew = (np.asarray(o).reshape(-1) for o in out)
    assert (np.abs(a0) <= CAGE).all() and (np.abs(a1) <= CAGE).all()
    assert (np.abs(t0) <= CAGE).all() and (np.abs(t1) <= CAGE).all()
    assert np.isfinite(rew).all() and (rew >= 0).all()


def test_fused_heavenhell_validity():
    env = gpt.make("HeavenHellContinuous-v0")
    B, K = 256, 32
    run = make_fused_heavenhell_rollout(env, B, K)
    out = run(jnp.asarray([3], jnp.int32), *_hh_init(env, B))
    x, y, h = (np.asarray(o).reshape(-1) for o in out[:3])
    # agent always inside the T-maze free space (stem union bar)
    in_stem = (np.abs(x) <= 2.0) & (y >= -1.5) & (y <= 4.5)
    in_bar = (np.abs(x) <= 8.0) & (y >= 4.0) & (y <= 8.0)
    assert (in_stem | in_bar).all()
    assert np.isin(h, [0, 1]).all()
    assert np.isfinite(np.asarray(out[-1])).all()


def test_fused_tag_rejects_bad_batch():
    env = gpt.make("TagContinuous-v0")
    with pytest.raises(ValueError):
        make_fused_tag_rollout(env, 100, 8)  # not a multiple of 128


def test_fused_tag_stats_match_scan():
    """Hardware check: random-policy tag rate matches the scan path."""
    from gym_po_tpu.vector import rollout

    env = gpt.make("TagContinuous-v0")
    B, K = 8192, 256
    run = make_fused_tag_rollout(env, B, K)
    out = run(jnp.asarray([5], jnp.int32), *_tag_init(env, B))
    a0, a1, t0, t1 = (np.asarray(o).reshape(-1) for o in out[:4])
    # post-rollout invariants: in-cage, never inside the tag radius after
    # the masked respawn (spawn distance >= MIN_SPAWN_DIST or farthest corner)
    assert (np.abs(a0) <= CAGE).all() and (np.abs(t1) <= CAGE).all()
    fused_mean = float(np.asarray(out[-1]).mean()) / K
    traj, _ = jax.jit(lambda k: rollout(env, k, None, B, K))(jax.random.PRNGKey(0))
    scan_mean = float(np.asarray(traj.reward).mean())
    assert abs(fused_mean - scan_mean) < 5e-4, (fused_mean, scan_mean)


def test_fused_heavenhell_stats_match_scan():
    """Hardware check: random-policy ±1 terminal rate matches the scan path."""
    from gym_po_tpu.vector import rollout

    env = gpt.make("HeavenHellContinuous-v0")
    B, K = 8192, 256
    run = make_fused_heavenhell_rollout(env, B, K)
    out = run(jnp.asarray([5], jnp.int32), *_hh_init(env, B))
    fused_mean = float(np.asarray(out[-1]).mean()) / K
    traj, _ = jax.jit(lambda k: rollout(env, k, None, B, K))(jax.random.PRNGKey(0))
    scan_mean = float(np.asarray(traj.reward).mean())
    # random walk rarely reaches either arm; both means are near 0 — require
    # the fused and scan estimates to agree tightly in absolute terms
    assert abs(fused_mean - scan_mean) < 5e-4, (fused_mean, scan_mean)


def test_fused_tag_episode_stats():
    """Zero-PRNG interpret: every env completes episodes within K; stats
    fields must be populated and self-consistent."""
    env = gpt.make("TagContinuous-v0", time_limit=30)
    B = 256
    K = env.time_limit + 10
    run = make_fused_tag_rollout(env, B, K,
                                 episode_stats=True)
    out = run(jnp.asarray([3], jnp.int32), *_tag_init(env, B))
    assert len(out) == 8
    ep_ret, ep_len, ep_cnt = (np.asarray(o).reshape(-1) for o in out[5:])
    assert (ep_cnt >= 1).all()
    assert (ep_len <= env.time_limit * ep_cnt).all()
    assert np.isfinite(ep_ret).all()


def test_fused_heavenhell_episode_stats():
    env = gpt.make("HeavenHellContinuous-v0", time_limit=30)
    B = 256
    K = env.time_limit + 10
    run = make_fused_heavenhell_rollout(env, B, K,
                                        episode_stats=True)
    out = run(jnp.asarray([3], jnp.int32), *_hh_init(env, B))
    assert len(out) == 7
    ep_ret, ep_len, ep_cnt = (np.asarray(o).reshape(-1) for o in out[4:])
    assert (ep_cnt >= 1).all()
    assert (ep_len <= env.time_limit * ep_cnt).all()
    # HH episode rewards are in {-1, 0, +1} per episode
    assert (np.abs(ep_ret) <= ep_cnt).all()
