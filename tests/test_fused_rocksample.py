"""Fused RockSample rollout: semantic checks."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gym_po_tpu as gpt
from gym_po_tpu.ops import make_fused_rocksample_rollout


def _init(env, B):
    key = jax.random.PRNGKey(0)
    _, st = env.reset_vec(key, B)
    pos = (st.pos_yx[:, 0] * env.cols + st.pos_yx[:, 1]).reshape(-1, 128)
    mask = (
        (st.rock_good.astype(jnp.int32) * (2 ** jnp.arange(env.k)))
        .sum(-1)
        .reshape(-1, 128)
    )
    return pos.astype(jnp.int32), mask.astype(jnp.int32)


def test_fused_rocksample_validity():
    env = gpt.make("RockSample-v0", map_size=(7, 7), num_rocks=8)
    B, K = 256, 32
    run = make_fused_rocksample_rollout(env, B, K)
    pos0, mask0 = _init(env, B)
    pos, mask, rew = run(jnp.asarray([3], jnp.int32), pos0, mask0)
    pn = np.asarray(pos)
    assert (pn >= 0).all() and (pn < 49).all()
    mn = np.asarray(mask)
    assert (mn >= 0).all() and (mn < 2**8).all()
    assert np.isfinite(np.asarray(rew)).all()


def test_fused_rocksample_guards():
    env = gpt.make("RockSample-v0", map_size=(15, 15), num_rocks=31)
    with pytest.raises(ValueError):  # 31 rocks overflow the int32 bitmask
        make_fused_rocksample_rollout(env, 256, 8)
    with pytest.raises(ValueError):  # not a multiple of 128 envs
        make_fused_rocksample_rollout(gpt.make("RockSample-v0"), 100, 8)


def test_fused_rocksample_stats_match_scan():
    """Hardware check (verified: -5.84 vs -5.83 at B=64k)."""
    from gym_po_tpu.vector import rollout

    env = gpt.make("RockSample-v0", map_size=(7, 7), num_rocks=8)
    B, K = 4096, 128
    run = make_fused_rocksample_rollout(env, B, K)
    pos0, mask0 = _init(env, B)
    _, _, rew = run(jnp.asarray([3], jnp.int32), pos0, mask0)
    fused_mean = float(np.asarray(rew).mean()) / K
    traj, _ = jax.jit(lambda k: rollout(env, k, None, B, K))(jax.random.PRNGKey(0))
    scan_mean = float(np.asarray(traj.reward).mean())
    assert abs(fused_mean - scan_mean) < 0.15, (fused_mean, scan_mean)


def test_fused_rocksample_episode_stats():
    """Every env truncates within K (action 0 = north,
    never exits east); stats fields must be populated and self-consistent."""
    env = gpt.make("RockSample-v0", map_size=(7, 7), num_rocks=8,
                   time_limit=40)
    B = 256
    K = env.time_limit + 10
    run = make_fused_rocksample_rollout(env, B, K,
                                        episode_stats=True)
    pos0, mask0 = _init(env, B)
    out = run(jnp.asarray([3], jnp.int32), pos0, mask0)
    assert len(out) == 6
    ep_ret, ep_len, ep_cnt = (np.asarray(o).reshape(-1) for o in out[3:])
    assert (ep_cnt >= 1).all()
    # trunc fires at elapsed >= time_limit -> episodes are <= time_limit long
    assert (ep_len <= env.time_limit * ep_cnt).all()
    assert np.isfinite(ep_ret).all()
