"""Fused tabular actor-critic: exact-oracle and learning checks.

An all-zero tape makes the trainer deterministic: identical Gumbel perturbations
make sampling collapse to first-argmax of the logits, the failure coin
always fires with alternate action 0, and resets spawn at valid_cells[0] —
a NumPy mirror reproduces θ/V trajectories to f32 tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gym_po_tpu as gpt
from gym_po_tpu.ops import make_fused_ac_trainer_rooms
from gym_po_tpu.ops.fused_qlearning import banks_to_q, q_to_banks


def _mirror(env, a0, th, v, K, api, apv, gamma):
    grid = env.grid_np
    H, GW = grid.shape
    disp = np.asarray(env._actions)
    disp_flat = disp[:, 0] * GW + disp[:, 1]
    goal_flat = int(env.fixed_goal_yx[0] * GW + env.fixed_goal_yx[1])
    valid0 = int(np.flatnonzero(grid.reshape(-1) >= 0)[0])
    wall = grid.reshape(-1) == -1
    n_obs = int(env.observation_space.n)
    A = int(env.num_actions)
    cells_yx = np.stack(np.divmod(np.arange(H * GW), GW), -1).astype(np.int32)
    obs_tab = np.asarray(
        jax.vmap(lambda yx: env._obs_fn(yx, jnp.asarray(env.fixed_goal_yx)))(
            jnp.asarray(cells_yx)
        ),
        np.int64,
    )
    obs_tab = np.clip(obs_tab, 0, n_obs - 1)
    obs_tab[wall] = 0

    agent = a0.astype(np.int64).copy()
    th = th.astype(np.float64).copy()
    v = v.astype(np.float64).copy()
    elapsed = np.zeros_like(agent)
    racc = np.zeros(agent.shape, np.float64)
    for _ in range(K):
        qidx = obs_tab[agent]
        logits = th[qidx]  # [B, A]
        a_cmd = np.argmax(logits, axis=1)  # tied gumbels -> first argmax
        mx = logits.max(axis=1, keepdims=True)
        ex = np.exp(logits - mx)
        probs = ex / ex.sum(axis=1, keepdims=True)

        executed = np.where(a_cmd == 0, 1, 0)
        proposed = np.clip(agent + disp_flat[executed], 0, H * GW - 1)
        oob = wall[proposed]
        agent2 = np.where(oob, agent, proposed)
        done = agent2 == goal_flat
        rew = np.where(
            done, env.goal_reward,
            np.where(oob, env.wall_reward, env.step_reward),
        )
        elapsed += 1
        trunc = elapsed > env.time_limit
        qidx2 = obs_tab[agent2]
        delta = rew + gamma * v[qidx2] * (1.0 - done) - v[qidx]

        cnt = np.zeros(n_obs)
        np.add.at(cnt, qidx, 1.0)
        dv = np.zeros(n_obs)
        np.add.at(dv, qidx, apv * delta)
        v = v + dv / np.maximum(cnt, 1.0)
        for ap in range(A):
            dth = np.zeros(n_obs)
            np.add.at(dth, qidx,
                      api * delta * ((a_cmd == ap) - probs[:, ap]))
            th[:, ap] = th[:, ap] + dth / np.maximum(cnt, 1.0)

        reset = done | trunc
        agent = np.where(reset, valid0, agent2)
        elapsed = np.where(reset, 0, elapsed)
        racc += rew
    return agent, th, v, racc


def test_fused_ac_matches_numpy_mirror():
    env = gpt.make("Rooms-v0")
    B, K = 1024, 16
    api, apv, gamma = 0.2, 0.3, 0.9
    GW = env.grid_np.shape[1]
    _, st = env.reset_vec(jax.random.PRNGKey(5), B)
    a0 = np.asarray(st.agent_yx[:, 0] * GW + st.agent_yx[:, 1], np.int64)
    n_obs = int(env.observation_space.n)
    A = int(env.num_actions)
    rng = np.random.default_rng(4)
    th0 = np.zeros((512, A), np.float32)
    th0[:n_obs] = rng.normal(scale=0.3, size=(n_obs, A)).astype(np.float32)
    v0 = np.zeros((512, 1), np.float32)
    v0[:n_obs] = rng.normal(scale=0.2, size=(n_obs, 1)).astype(np.float32)

    run = make_fused_ac_trainer_rooms(env, B, K, gamma, rng_tape=True)
    th_k, v_k, a_k, racc_k = run(
        jnp.asarray([3], jnp.int32), api, apv,
        jnp.asarray(q_to_banks(th0)),
        jnp.asarray(q_to_banks(v0)),
        jnp.asarray(a0.reshape(-1, 128), jnp.int32),
        jnp.zeros(run.tape_shape, jnp.int32),  # all-zero draws
    )
    th_kk = banks_to_q(np.asarray(th_k), 512, na=A)
    v_kk = banks_to_q(np.asarray(v_k), 512, na=1)[:, 0]

    a_m, th_m, v_m, racc_m = _mirror(
        env, a0, th0[:n_obs], v0[:n_obs, 0], K, api, apv, gamma
    )
    np.testing.assert_array_equal(np.asarray(a_k).reshape(-1), a_m)
    np.testing.assert_allclose(np.asarray(racc_k).reshape(-1), racc_m,
                               atol=1e-5)
    np.testing.assert_allclose(v_kk[:n_obs], v_m, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(th_kk[:n_obs], th_m, rtol=1e-3, atol=1e-4)


def test_fused_ac_rejects_bad_configs():
    env = gpt.make("Rooms-v0")
    with pytest.raises(ValueError):
        make_fused_ac_trainer_rooms(env, 100, 8)
    cf = gpt.make("CarFlag-v0")
    with pytest.raises(ValueError):
        make_fused_ac_trainer_rooms(cf, 1024, 8)


def test_fused_ac_learns_on_hardware():
    """The fused actor-critic learns goal-directed navigation."""
    env = gpt.make("Rooms-v0")
    B = 4096
    GW = env.grid_np.shape[1]
    A = int(env.num_actions)
    n_obs = int(env.observation_space.n)
    run = make_fused_ac_trainer_rooms(env, B, 4096)
    _, st = env.reset_vec(jax.random.PRNGKey(0), B)
    a = jnp.asarray(
        np.asarray(st.agent_yx[:, 0] * GW + st.agent_yx[:, 1]).reshape(-1, 128),
        jnp.int32,
    )
    th = jnp.asarray(q_to_banks(np.zeros((512, A), np.float32)))
    v = jnp.asarray(q_to_banks(np.zeros((512, 1), np.float32)))
    rates = []
    for i in range(4):
        th, v, a, rew = run(jnp.asarray([i + 1], jnp.int32), 0.1, 0.2, th, v, a)
        rates.append(float(np.asarray(rew).mean()) / 4096)
    # random policy reaches the goal ~0.0006/step; trained AC measured 0.072
    # (≈14-step paths under 1/3 action failure — near-optimal)
    assert rates[-1] > 0.03, rates

def test_fused_actor_critic_wrapper():
    from gym_po_tpu.agents import fused_actor_critic

    env = gpt.make("Rooms-v0")
    th, v, hist = fused_actor_critic(
        env, seed=0, schedule=[(0.1, 0.2, 8)], num_envs=1024,
        chunk_steps=8,
    )
    n_obs = int(env.observation_space.n)
    assert th.shape == (n_obs, int(env.num_actions))
    assert v.shape == (n_obs,)
    assert len(hist) == 1 and np.isfinite(hist[0])
