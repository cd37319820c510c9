"""Batched fast-path consistency of the env steps."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gym_po_tpu as gpt


# ---------------------------------------------------------- fast-path parity
@pytest.mark.parametrize(
    "name,kw",
    [
        ("Taxi-v4", {}),
        ("HansenTaxi-v4", {}),
        ("ExtendedHansenTaxi-v4", {}),
        ("Rooms-v0", {"obs_type": "hansen", "goal_xy": None}),
        ("CRooms-v0", {"obs_type": "vector_mdp", "use_velocity": True}),
        ("MultistoryFourRooms-v0", {"grid_z": 2, "obs_type": "mdp"}),
        ("DiscreteCarFlag-v0", {"num_actions": 3}),
        ("RockSample-v0", {}),
    ],
)
def test_step_vec_matches_spaces_and_invariants(name, kw):
    """The batched fast path yields valid obs/rewards and respects autoreset
    the same as vmap(step) (draw mapping differs, distributions match)."""
    env = gpt.make(name, **kw)
    B = 16
    key = jax.random.PRNGKey(0)
    obs, state = jax.jit(lambda k: env.reset_vec(k, B), static_argnums=())(key)
    assert jax.tree.leaves(state)[0].shape[0] == B
    step = jax.jit(env.step_vec)
    saw_reset = False
    for t in range(120):
        key, ka, ks = jax.random.split(key, 3)
        a = env.action_space.sample_vec(ka, B)
        obs, state, r, d, tr, info = step(ks, state, a)
        assert r.shape == d.shape == tr.shape == (B,)
        saw_reset |= bool(np.asarray(d | tr).any())
        fin = np.asarray(info["reset_mask"])
        if fin.any():
            # autoreset: elapsed back to 0 for finished envs
            assert (np.asarray(state.elapsed)[fin] == 0).all()
    # 120 steps of random actions should finish at least one episode for
    # every env here except possibly long-horizon ones with no time limit
    if getattr(env, "time_limit", 10**9) <= 120:
        assert saw_reset


def test_taxi_arithmetic_reset_distribution():
    """Zero-gather reset sampling is uniform over valid initial states."""
    env = gpt.make("Taxi-v4")
    assert env._all_cells_valid
    key = jax.random.PRNGKey(0)
    _, state = env.reset_vec(key, 200_000)
    s = np.asarray(state.s)
    valid = set(np.asarray(env._valid_init).tolist())
    assert set(np.unique(s).tolist()) <= valid
    # p never equals d at spawn, p never in-taxi
    from gym_po_tpu.maps.taxi_maps import decode_state_np

    r, c, p, d = decode_state_np(s.astype(np.int64), env.cols, env.nlocs)
    assert (p != d).all() and (p < env.nlocs).all()
    # roughly uniform: each valid state within 4x of the mean count
    counts = np.bincount(s, minlength=env.tables.ns)[sorted(valid)]
    assert counts.min() > 0 and counts.max() < 4 * counts.mean()


def test_exec_action_batched_matches_scalar():
    from gym_po_tpu.utils.actions import failure_cumsum, make_exec_action

    cum = failure_cumsum(8, 0.2)
    exec_fn = make_exec_action(cum)
    rng = np.random.default_rng(0)
    actions = jnp.asarray(rng.integers(0, 8, 64), jnp.int32)
    us = jnp.asarray(rng.uniform(size=64), jnp.float32)
    batched = exec_fn(actions, us)
    scalar = jnp.stack([exec_fn(actions[i], us[i]) for i in range(64)])
    np.testing.assert_array_equal(np.asarray(batched), np.asarray(scalar))
