"""Fused double Q-learning: exact-oracle and learning checks."""

import numpy as np

import jax
import jax.numpy as jnp

import gym_po_tpu as gpt
from gym_po_tpu.ops import make_fused_double_q_trainer
from gym_po_tpu.ops.fused_qlearning import banks_to_q, q_to_banks


def _mirror(env, s0, qa, qb, K, lr, gamma):
    """All-zero-tape mirror: coin always A, greedy on Q_A+Q_B, zero-draw
    resets (rc=0, task dn=1)."""
    t = env.tables
    nlocs = t.nlocs
    pd = (nlocs + 1) * nlocs
    cm = np.asarray(env._cell_move).reshape(-1, 4)
    la = np.asarray(env._loc_at)
    n_pass = env.num_passengers

    s = s0.astype(np.int64).copy()
    qa = qa.astype(np.float64).copy()
    qb = qb.astype(np.float64).copy()
    completed = np.zeros_like(s)
    elapsed = np.zeros_like(s)
    racc = np.zeros(s.shape, np.float64)
    for _ in range(K):
        a = np.argmax(qa[s] + qb[s], axis=1)
        q_taken = qa[s, a]  # coin = A always

        rc, rem = s // pd, s % pd
        p, d = rem // nlocs, rem % nlocs
        moved = cm[rc, np.minimum(a, 3)]
        is_pd = a == 4
        loc = la[rc]
        goal = is_pd & (p == nlocs) & (loc == d)
        pickup = is_pd & (p < nlocs) & (loc == p)
        bad = is_pd & ~goal & ~pickup
        p2 = np.where(pickup, nlocs, p)
        rc2 = np.where(is_pd, rc, moved)
        completed = completed + goal
        rew = np.where(goal, env.reward_goal,
                       np.where(bad, env.reward_bad, env.reward_any))
        elapsed += 1
        done = completed == n_pass
        trunc = elapsed > env.time_limit
        task = goal & ~(done | trunc)
        p3 = np.where(task, 0, p2)
        d3 = np.where(task, 1, d)
        s_mid = (rc2 * (nlocs + 1) + p3) * nlocs + d3
        a_sel = np.argmax(qa[s_mid], axis=1)  # select with A...
        next_v = qb[s_mid, a_sel]  # ...evaluate with B
        td = rew + gamma * next_v * (1.0 - done) - q_taken
        dq = np.zeros_like(qa)
        cnt = np.zeros_like(qa)
        np.add.at(dq, (s, a), lr * td)
        np.add.at(cnt, (s, a), 1.0)
        qa = qa + dq / np.maximum(cnt, 1.0)

        reset = done | trunc
        rc3 = np.where(reset, 0, rc2)
        p4 = np.where(reset, 0, p3)
        d4 = np.where(reset, 1, d3)
        completed = np.where(reset, 0, completed)
        elapsed = np.where(reset, 0, elapsed)
        s = (rc3 * (nlocs + 1) + p4) * nlocs + d4
        racc += rew
    return s, qa, qb, racc


def test_fused_double_q_matches_mirror():
    env = gpt.make("Taxi-v4")
    B, K = 1024, 20
    lr, gamma = 0.2, 0.9
    _, st = env.reset_vec(jax.random.PRNGKey(3), B)
    s0 = np.asarray(st.s)
    ns = env.tables.ns
    rng = np.random.default_rng(6)
    qa0 = np.zeros((512, 5), np.float32)
    qb0 = np.zeros((512, 5), np.float32)
    qa0[:ns] = rng.normal(scale=0.1, size=(ns, 5)).astype(np.float32)
    qb0[:ns] = rng.normal(scale=0.1, size=(ns, 5)).astype(np.float32)

    run = make_fused_double_q_trainer(env, B, K, gamma, rng_tape=True)
    q2 = jnp.asarray(np.concatenate([q_to_banks(qa0), q_to_banks(qb0)]))
    s_k, q2_k, racc_k = run(
        jnp.asarray([5], jnp.int32), lr, 0.0,
        jnp.asarray(s0.reshape(-1, 128), jnp.int32), q2,
        jnp.zeros(run.tape_shape, jnp.int32),  # all-zero draws
    )
    q2_k = np.asarray(q2_k)
    qa_k = banks_to_q(q2_k[:32], 512)
    qb_k = banks_to_q(q2_k[32:], 512)

    s_m, qa_m, qb_m, racc_m = _mirror(env, s0, qa0, qb0, K, lr, gamma)
    np.testing.assert_array_equal(np.asarray(s_k).reshape(-1), s_m)
    np.testing.assert_allclose(np.asarray(racc_k).reshape(-1), racc_m,
                               atol=1e-5)
    np.testing.assert_allclose(qa_k[:ns], qa_m[:ns], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(qb_k[:ns], qb0[:ns])  # B never updated


def test_fused_double_q_learns_on_hardware():
    """Hardware: double-Q training reaches a strong taxi policy."""
    from gym_po_tpu.agents import greedy_policy
    from gym_po_tpu.vector import rollout

    env = gpt.make("Taxi-v4")
    B = 4096
    run = make_fused_double_q_trainer(env, B, 4096)
    _, st = env.reset_vec(jax.random.PRNGKey(0), B)
    s = jnp.asarray(np.asarray(st.s).reshape(-1, 128), jnp.int32)
    q2 = jnp.asarray(np.zeros((64, 128), np.float32))
    for i, (lr, eps) in enumerate([(0.1, 0.3)] * 2 + [(0.05, 0.05)] * 2):
        s, q2, _ = run(jnp.asarray([i + 1], jnp.int32), lr, eps, s, q2)
    q2 = np.asarray(q2)
    q = (banks_to_q(q2[:32], 512) + banks_to_q(q2[32:], 512))[:500] / 2

    traj, _ = jax.jit(
        lambda k: rollout(env, k, greedy_policy(jnp.asarray(q)), 1024, 256)
    )(jax.random.PRNGKey(9))
    r = np.asarray(traj.reward)
    assert (r > 0.5).sum() / 1024 > 15, (r > 0.5).sum() / 1024
    assert (r < -0.4).mean() < 0.01
