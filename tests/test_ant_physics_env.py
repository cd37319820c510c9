"""Task-layer tests for the articulated ant POMDPs on the JAX engine.

Physics-vs-MuJoCo parity lives in ``tests/test_physics*.py``; here we test
the Environment protocol around it (reference task semantics from
``gym_po/envs/ant_tag.py`` / ``ant_heaven_hell.py``).  Tests use reduced
frame_skip / solver iters where the physics exactness is irrelevant to keep
CPU runtime small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_po_tpu.envs import (
    AntHeavenHellPhysics,
    AntTagPhysics,
)
from gym_po_tpu.envs.ant_physics import (
    HH_RADIUS,
    HH_SITES,
    STAND_POSE,
    TAG_RADIUS,
    VISIBLE_RADIUS,
    _move_target,
)


def _light(cls, **kw):
    return cls(frame_skip=3, solver_iters=8, **kw)


def _place(env, state, xy):
    return state.replace(qpos=state.qpos.at[:2].set(jnp.asarray(xy)))


@pytest.mark.slow
def test_tag_protocol_and_shapes():
    env = _light(AntTagPhysics)
    key = jax.random.PRNGKey(0)
    obs, state = env.reset(key)
    assert obs.shape == (29,)
    step = jax.jit(env.step)
    for t in range(4):
        key, ks, ka = jax.random.split(key, 3)
        a = jax.random.uniform(ka, (8,), jnp.float32, -1, 1)
        obs, state, r, d, tr, info = step(ks, state, a)
        assert jnp.isfinite(obs).all()
        assert "terminal_state" in info
    # the ant neither sinks through the floor nor launches
    assert 0.1 < float(state.qpos[2]) < 1.5


@pytest.mark.slow
def test_tag_reward_and_autoreset():
    env = _light(AntTagPhysics)
    key = jax.random.PRNGKey(1)
    _, state = env.reset(key)
    # put the target on top of the ant: the flee step is 0.5 < tag radius
    state = state.replace(target_xy=state.qpos[:2] + 0.1)
    obs, new_state, r, d, tr, info = jax.jit(env.step)(
        key, state, jnp.zeros(8)
    )
    assert bool(d) and float(r) == 1.0
    # autoreset: elapsed back to 0, terminal_state keeps the tagged frame
    assert int(new_state.elapsed) == 0
    assert int(info["terminal_state"].elapsed) == 1
    assert bool(info["reset_mask"])


@pytest.mark.slow
def test_tag_truncation_resets():
    env = _light(AntTagPhysics, time_limit=2)
    key = jax.random.PRNGKey(2)
    _, state = env.reset(key)
    step = jax.jit(env.step)
    _, state, _, d, tr, _ = step(key, state, jnp.zeros(8))
    assert not bool(tr)
    _, state, _, d, tr, info = step(key, state, jnp.zeros(8))
    assert bool(tr) and int(state.elapsed) == 0


def test_tag_visibility_gating():
    env = _light(AntTagPhysics)
    _, state = env.reset(jax.random.PRNGKey(3))
    near = state.replace(target_xy=state.qpos[:2] + 2.0)  # dist 2.83 < 3
    far = state.replace(target_xy=state.qpos[:2] + 3.0)   # dist 4.24 > 3
    assert np.allclose(np.asarray(env.observe(near))[-2:],
                       np.asarray(near.target_xy))
    assert np.allclose(np.asarray(env.observe(far))[-2:], 0.0)


def test_move_target_flee_rule():
    agent = jnp.asarray([0.0, 0.0])
    target = jnp.asarray([1.0, 0.0])
    away = np.asarray(_move_target(agent, target, jnp.asarray(0)))
    np.testing.assert_allclose(away, [1.5, 0.0], atol=1e-6)  # flees +x
    stay = np.asarray(_move_target(agent, target, jnp.asarray(3)))
    np.testing.assert_allclose(stay, [1.0, 0.0], atol=1e-6)
    # cancelled at the cage edge
    edge = np.asarray(
        _move_target(agent, jnp.asarray([4.3, 0.0]), jnp.asarray(0))
    )
    np.testing.assert_allclose(edge, [4.3, 0.0], atol=1e-6)


def test_tag_spawn_distance():
    env = _light(AntTagPhysics)
    _, state = env.reset_vec(jax.random.PRNGKey(4), 256)
    d = np.linalg.norm(
        np.asarray(state.qpos[:, :2]) - np.asarray(state.target_xy), axis=-1
    )
    assert (d > 5.0).all()
    assert (np.abs(np.asarray(state.target_xy)) <= 4.5).all()


def test_tag_spawn_distribution():
    """The target spawn is the reference's exact conditional distribution
    (uniform over cage ∩ {dist ≥ 5}, ant_tag.py:94-100) — compared against
    a NumPy rejection-sampling oracle at matched sample size.  Guards the
    regression the old 8-candidates + farthest-corner scheme had: a 5-10%
    point mass on the corner nearest-farthest from a central ant."""
    env = _light(AntTagPhysics)
    n = 4096
    agent = jnp.zeros(2)  # cage center = worst case (lowest accept rate)
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    xy = np.asarray(
        jax.jit(jax.vmap(lambda k: env._spawn_target(k, agent)))(keys)
    )
    r = np.linalg.norm(xy, axis=-1)
    assert (r >= 5.0).all()
    assert (np.abs(xy) <= 4.5).all()

    # no corner atom: only f32 birthday collisions repeat, corner mass tiny
    assert len(np.unique(xy[:, 0])) > 0.99 * n
    assert not np.isin(np.abs(xy), 4.5).any()
    corners = np.array([[-4.5, -4.5], [-4.5, 4.5], [4.5, -4.5], [4.5, 4.5]])
    d_corner = np.linalg.norm(xy[:, None] - corners[None], axis=-1).min(-1)
    # oracle corner mass at 0.3: area ~4·(π/4·0.09)/8.33 ≈ 3.4%
    assert (d_corner < 0.3).mean() < 0.07

    # radial histogram vs the NumPy rejection oracle
    rng = np.random.default_rng(0)
    acc = []
    while sum(len(a) for a in acc) < n:
        c = rng.uniform(-4.5, 4.5, size=(4 * n, 2))
        acc.append(c[(c**2).sum(-1) >= 25.0])
    ref = np.concatenate(acc)[:n]
    bins = np.linspace(5.0, 4.5 * np.sqrt(2.0), 7)
    h = np.histogram(r, bins)[0] / n
    h_ref = np.histogram(np.linalg.norm(ref, axis=-1), bins)[0] / n
    np.testing.assert_allclose(h, h_ref, atol=0.05)
    # quadrant symmetry
    quad = (xy[:, 0] > 0).astype(int) * 2 + (xy[:, 1] > 0)
    frac = np.bincount(quad, minlength=4) / n
    np.testing.assert_allclose(frac, 0.25, atol=0.05)


def test_hh_reveal_and_rewards():
    env = _light(AntHeavenHellPhysics)
    _, state = env.reset(jax.random.PRNGKey(5))
    state = state.replace(heaven_right=jnp.asarray(True))
    # near the priest: obs tail reveals +1 (heaven right)
    at_priest = _place(env, state, HH_SITES[2])
    assert float(env.observe(at_priest)[-1]) == 1.0
    assert float(env.observe(state)[-1]) == 0.0  # spawn is far from priest

    done, rew = env._task(at_priest.qpos.at[:2].set(jnp.asarray(HH_SITES[1])),
                          jnp.asarray(True))
    assert bool(done) and float(rew) == 1.0      # heaven side
    done, rew = env._task(at_priest.qpos.at[:2].set(jnp.asarray(HH_SITES[0])),
                          jnp.asarray(True))
    assert bool(done) and float(rew) == -1.0     # hell side


@pytest.mark.slow
def test_hh_step_vec_batch():
    env = _light(AntHeavenHellPhysics)
    key = jax.random.PRNGKey(6)
    obs, state = env.reset_vec(key, 8)
    assert obs.shape == (8, 28)
    a = jax.random.uniform(key, (8, 8), jnp.float32, -1, 1)
    obs, state, r, d, tr, info = jax.jit(env.step_vec)(key, state, a)
    assert obs.shape == (8, 28) and r.shape == (8,)
    assert jnp.isfinite(obs).all()
    # both heaven sides appear across a batch of resets
    sides = np.asarray(state.heaven_right)
    assert sides.dtype == bool


def test_stand_pose_matches_host_env():
    from gym_po_tpu.envs import ant as host_ant

    np.testing.assert_allclose(STAND_POSE, host_ant._STAND_POSE)


@pytest.mark.slow
def test_ppo_train_step_on_ant():
    """The Anakin PPO learner trains the articulated ant end-to-end
    (Gaussian head over the 8-torque Box action, 29-D Box obs)."""
    from gym_po_tpu.agents import PPOConfig, init_train_state, make_train_step

    env = AntTagPhysics(frame_skip=1, solver_iters=2)
    cfg = PPOConfig(
        num_envs=4, rollout_steps=4, epochs=1, minibatches=2, hidden=(16, 16)
    )
    net, ts = init_train_state(env, cfg, jax.random.PRNGKey(0))
    ts2, metrics = make_train_step(env, net, cfg)(ts)
    for v in jax.tree_util.tree_leaves(metrics):
        assert jnp.isfinite(v).all()
    # params moved
    moved = jax.tree_util.tree_map(
        lambda a, b: float(jnp.abs(a - b).max()), ts.params, ts2.params
    )
    assert max(jax.tree_util.tree_leaves(moved)) > 0


@pytest.mark.slow
def test_rnn_ppo_train_step_on_ant():
    """GRU-PPO (the POMDP learner) over the ant's Gaussian action head."""
    from gym_po_tpu.agents import PPOConfig
    from gym_po_tpu.agents.ppo_rnn import init_rnn_state, make_rnn_train_step

    env = AntHeavenHellPhysics(frame_skip=1, solver_iters=2)
    cfg = PPOConfig(
        num_envs=4, rollout_steps=4, epochs=1, minibatches=2, hidden=(16,)
    )
    net, ts = init_rnn_state(env, cfg, jax.random.PRNGKey(0), hidden=8)
    ts2, metrics = make_rnn_train_step(env, net, cfg)(ts)
    for v in jax.tree_util.tree_leaves(metrics):
        assert jnp.isfinite(v).all()
