"""Sequential-dispatch batching (vector.chunked).

Correctness on CPU: chunked results must carry the full batch with the
right shapes and the same per-chunk dynamics as single-dispatch calls
(chunk i of a chunked call sees exactly the key ``fold_in(key, i)``, so
equality against a manual per-chunk loop is exact).  Whether chunking pays
on the card is the ant batch curve in PERF.md.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gym_po_tpu as gpt
from gym_po_tpu.vector import chunked_rollout, make_chunked_step, rollout


def test_chunked_rollout_shapes_and_exactness():
    env = gpt.make("HansenTaxi-v4")
    B, Bc, T = 64, 16, 12
    key = jax.random.PRNGKey(3)
    obs, state = env.reset_vec(jax.random.PRNGKey(9), B)

    traj, (fobs, fstate) = chunked_rollout(
        env, key, None, B, T, dispatch_batch=Bc, init=(obs, state)
    )
    assert traj.obs.shape[:2] == (T, B)
    assert fobs.shape[0] == B

    # chunk i must equal a direct rollout of that state slice under
    # fold_in(key, i) — the chunked path adds no other randomness
    for i in range(B // Bc):
        sl = slice(i * Bc, (i + 1) * Bc)
        init_i = jax.tree.map(lambda x: x[sl], (obs, state))
        traj_i, (fobs_i, _) = rollout(
            env, jax.random.fold_in(key, i), None, Bc, T, init=init_i
        )
        np.testing.assert_array_equal(
            np.asarray(traj.obs[:, sl]), np.asarray(traj_i.obs)
        )
        np.testing.assert_array_equal(np.asarray(fobs[sl]), np.asarray(fobs_i))


def test_chunked_rollout_small_batch_is_single_dispatch():
    env = gpt.make("Taxi-v4")
    key = jax.random.PRNGKey(0)
    traj, _ = chunked_rollout(env, key, None, 8, 5, dispatch_batch=4096)
    ref, _ = rollout(env, key, None, 8, 5)
    np.testing.assert_array_equal(np.asarray(traj.obs), np.asarray(ref.obs))


def test_chunked_rollout_rejects_ragged_batch():
    env = gpt.make("Taxi-v4")
    with pytest.raises(ValueError):
        chunked_rollout(env, jax.random.PRNGKey(0), None, 24, 4,
                        dispatch_batch=16)


def test_make_chunked_step_matches_per_chunk_step():
    env = gpt.make("CRooms-v0")
    B, Bc = 32, 8
    key = jax.random.PRNGKey(1)
    obs, state = env.reset_vec(jax.random.PRNGKey(2), B)
    actions = jax.random.uniform(
        jax.random.PRNGKey(4), (B, 2), jnp.float32, -1, 1
    )
    step = make_chunked_step(env, dispatch_batch=Bc)
    nobs, nstate, rew, done, trunc, info = step(key, state, actions)
    assert nobs.shape[0] == B and rew.shape == (B,)

    for i in range(B // Bc):
        sl = slice(i * Bc, (i + 1) * Bc)
        o_i, _, r_i, d_i, _, _ = env.step_vec(
            jax.random.fold_in(key, i),
            jax.tree.map(lambda x: x[sl], state),
            actions[sl],
        )
        np.testing.assert_array_equal(np.asarray(nobs[sl]), np.asarray(o_i))
        np.testing.assert_array_equal(np.asarray(rew[sl]), np.asarray(r_i))
        np.testing.assert_array_equal(np.asarray(done[sl]), np.asarray(d_i))


def test_chunked_step_on_ant_physics_tiny():
    """The API's actual target env: one chunked step on a tiny ant batch
    (cheap array pipeline so the CPU compile stays in budget)."""
    env = gpt.make("AntTagPhysics-v0", frame_skip=1, solver_iters=1,
                   integrator="euler", pipeline="array")
    B, Bc = 8, 4
    obs, state = env.reset_vec(jax.random.PRNGKey(0), B)
    actions = jnp.zeros((B, 8), jnp.float32)
    step = make_chunked_step(env, dispatch_batch=Bc)
    nobs, nstate, rew, done, trunc, info = step(
        jax.random.PRNGKey(1), state, actions
    )
    assert nobs.shape == (B, 29)
    assert np.isfinite(np.asarray(nobs)).all()


def test_chunked_train_step_runs_and_learns_shape():
    """Learner-side cliff remedy: chunked rollout dispatches + one
    full-batch update.  Checks the TrainState round-trips with full-B env
    fields, params change, and metrics are finite; throughput is the
    hardware bench's job."""
    from gym_po_tpu.agents import (PPOConfig, init_train_state,
                                   make_chunked_train_step)

    env = gpt.make("HansenTaxi-v4")
    cfg = PPOConfig(num_envs=64, rollout_steps=8, epochs=2, minibatches=2,
                    hidden=(16, 16))
    net, ts = init_train_state(env, cfg, jax.random.PRNGKey(0))
    step = make_chunked_train_step(env, net, cfg, dispatch_batch=16)
    before = jax.tree.map(lambda x: np.asarray(x).copy(), ts.params)
    ts, m = step(ts)
    ts, m = step(ts)
    assert int(ts.update_idx) == 2
    assert ts.env_obs.shape[0] == 64
    assert np.isfinite(float(m["loss"]))
    changed = jax.tree.map(
        lambda a, b: not np.allclose(a, np.asarray(b)), before, ts.params)
    assert any(jax.tree.leaves(changed))


def test_chunked_train_step_small_batch_is_plain_train_step():
    from gym_po_tpu.agents import (PPOConfig, init_train_state,
                                   make_chunked_train_step, make_train_step)

    env = gpt.make("Taxi-v4")
    cfg = PPOConfig(num_envs=16, rollout_steps=4, epochs=1, minibatches=1,
                    hidden=(8,))
    net, ts = init_train_state(env, cfg, jax.random.PRNGKey(0))
    sc = make_chunked_train_step(env, net, cfg, dispatch_batch=4096)
    sp = make_train_step(env, net, cfg)
    tc, mc = sc(ts)
    tp, mp = sp(ts)
    np.testing.assert_allclose(float(mc["loss"]), float(mp["loss"]),
                               rtol=1e-6)
