"""Fused Q-learning trainer: exact-oracle and learning checks.

An all-zero tape makes the trainer fully deterministic (every draw is 0
and the test pins epsilon=0), so a NumPy mirror of
the same greedy/TD/duplicate-accumulation semantics must match the kernel's
Q-table trajectory almost exactly (f32 trainer vs f64 mirror).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gym_po_tpu as gpt
from gym_po_tpu.ops.fused_qlearning import (
    banks_to_q,
    make_fused_q_trainer,
    make_fused_q_trainer_msrooms,
    make_fused_q_trainer_rooms,
    q_to_banks,
)


def _numpy_mirror(env, s0, q, K, lr, gamma, average_duplicates=False):
    """Greedy (eps=0), all-zero-draw mirror of the trainer's loop."""
    t = env.tables
    nlocs, rows, cols = t.nlocs, t.rows, t.cols
    pd = (nlocs + 1) * nlocs
    cm = np.asarray(env._cell_move).reshape(-1, 4)
    la = np.asarray(env._loc_at)
    n_pass = env.num_passengers
    time_limit = env.time_limit
    # zero-draw full reset: first valid cell (0 on all-valid classic maps)
    rc_reset = int(np.flatnonzero((t.tgrid != "|").reshape(-1))[0])
    if getattr(env, "hansen", False):
        hc = np.asarray(env._hansen_cell)

        def obs_of(s):
            rc, rem = s // pd, s % pd
            return (hc[rc] * (nlocs + 1) + rem // nlocs) * nlocs + rem % nlocs
    else:
        def obs_of(s):
            return s

    s = s0.astype(np.int64).copy()
    q = q.astype(np.float64).copy()  # f64 accumulate: mirror is the oracle
    completed = np.zeros_like(s)
    elapsed = np.zeros_like(s)
    racc = np.zeros(s.shape, np.float64)
    for _ in range(K):
        qidx = obs_of(s)
        vals = q[qidx]  # [B, 5]
        a = np.argmax(vals, axis=1)  # first-max ties, as the trainer
        q_taken = vals[np.arange(s.size), a]

        rc = s // pd
        rem = s % pd
        p = rem // nlocs
        d = rem % nlocs
        moved = cm[rc, np.minimum(a, 3)]
        is_pd = a == 4
        loc = la[rc]
        goal = is_pd & (p == nlocs) & (loc == d)
        pickup = is_pd & (p < nlocs) & (loc == p)
        bad = is_pd & ~goal & ~pickup
        p2 = np.where(pickup, nlocs, p)
        rc2 = np.where(is_pd, rc, moved)
        completed = completed + goal
        rew = np.where(
            goal, env.reward_goal, np.where(bad, env.reward_bad, env.reward_any)
        )
        elapsed += 1
        done = completed == n_pass
        trunc = elapsed > time_limit

        # task reset with zero draws: pn=0, dn = 0 + (0 >= 0) = 1
        task = goal & ~(done | trunc)
        p3 = np.where(task, 0, p2)
        d3 = np.where(task, 1, d)
        s_mid = (rc2 * (nlocs + 1) + p3) * nlocs + d3
        next_v = q[obs_of(s_mid)].max(axis=1)
        td = rew + gamma * next_v * (1.0 - done) - q_taken
        if average_duplicates:
            dq = np.zeros_like(q)
            cnt = np.zeros_like(q)
            np.add.at(dq, (qidx, a), lr * td)
            np.add.at(cnt, (qidx, a), 1.0)
            q = q + dq / np.maximum(cnt, 1.0)
        else:
            np.add.at(q, (qidx, a), lr * td)

        # full reset with zero draws: rc=rc_reset, pr=0, dr=1
        reset = done | trunc
        rc3 = np.where(reset, rc_reset, rc2)
        p4 = np.where(reset, 0, p3)
        d4 = np.where(reset, 1, d3)
        completed = np.where(reset, 0, completed)
        elapsed = np.where(reset, 0, elapsed)
        s = (rc3 * (nlocs + 1) + p4) * nlocs + d4
        racc += rew
    return s, q, racc


def test_fused_q_trainer_matches_numpy_mirror():
    env = gpt.make("Taxi-v4")
    B, K = 1024, 24
    lr, gamma = 0.25, 0.9
    _, st = env.reset_vec(jax.random.PRNGKey(3), B)
    s0 = np.asarray(st.s)
    rng = np.random.default_rng(0)
    q0 = rng.normal(scale=0.1, size=(512, 5)).astype(np.float32)
    q0[env.tables.ns:] = 0.0

    run = make_fused_q_trainer(env, B, K, gamma, rng_tape=True)
    s_k, qb_k, racc_k = run(
        jnp.asarray([5], jnp.int32),
        lr,
        0.0,
        jnp.asarray(s0.reshape(-1, 128), jnp.int32),
        jnp.asarray(q_to_banks(q0)),
        jnp.zeros(run.tape_shape, jnp.int32),  # all-zero draws
    )
    q_k = banks_to_q(np.asarray(qb_k), 512)

    s_m, q_m, racc_m = _numpy_mirror(env, s0, q0, K, lr, gamma)
    np.testing.assert_array_equal(np.asarray(s_k).reshape(-1), s_m)
    np.testing.assert_allclose(
        np.asarray(racc_k).reshape(-1), racc_m, atol=1e-5
    )
    # relative tolerance: the all-zero-draw deterministic config funnels many
    # envs into identical states, so duplicate sums make some Q entries
    # huge — f32 (trainer) vs f64 (mirror) then drift ~1e-5 relatively
    np.testing.assert_allclose(q_k[: env.tables.ns], q_m[: env.tables.ns],
                               rtol=1e-3, atol=1e-4)


def test_fused_q_trainer_average_duplicates_matches_mirror():
    """Mean-duplicate mode: batch-size-invariant effective lr (sum mode
    measurably diverges at B=8192 lr=0.05)."""
    env = gpt.make("Taxi-v4")
    B, K = 1024, 24
    lr, gamma = 0.25, 0.9
    _, st = env.reset_vec(jax.random.PRNGKey(3), B)
    s0 = np.asarray(st.s)
    rng = np.random.default_rng(1)
    q0 = rng.normal(scale=0.1, size=(512, 5)).astype(np.float32)
    q0[env.tables.ns:] = 0.0

    run = make_fused_q_trainer(env, B, K, gamma, average_duplicates=True, rng_tape=True)
    s_k, qb_k, _ = run(
        jnp.asarray([5], jnp.int32), lr, 0.0,
        jnp.asarray(s0.reshape(-1, 128), jnp.int32),
        jnp.asarray(q_to_banks(q0)),
        jnp.zeros(run.tape_shape, jnp.int32),  # all-zero draws
    )
    q_k = banks_to_q(np.asarray(qb_k), 512)
    s_m, q_m, _ = _numpy_mirror(env, s0, q0, K, lr, gamma,
                                average_duplicates=True)
    np.testing.assert_array_equal(np.asarray(s_k).reshape(-1), s_m)
    # mean mode keeps Q bounded, so plain tolerances suffice
    np.testing.assert_allclose(q_k[: env.tables.ns], q_m[: env.tables.ns],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["ExtendedTaxi-v4", "ExtendedHansenTaxi-v4"])
def test_fused_q_trainer_extended_map_matches_mirror(name):
    """Extended 8x8 map: per-action move banks, interior-wall resets, and
    (full-state) 10 obs banks per action (ns=1280 > 512)."""
    from gym_po_tpu.ops.fused_qlearning import bank_geometry

    env = gpt.make(name)
    B, K = 1024, 20
    lr, gamma = 0.1, 0.9
    _, st = env.reset_vec(jax.random.PRNGKey(9), B)
    s0 = np.asarray(st.s)
    idx_n = int(env.observation_space.n)
    nsb, nb = bank_geometry(idx_n, 5)
    nsp = nsb * 128
    rng = np.random.default_rng(3)
    q0 = np.zeros((nsp, 5), np.float32)
    q0[:idx_n] = rng.normal(scale=0.1, size=(idx_n, 5)).astype(np.float32)

    run = make_fused_q_trainer(env, B, K, gamma, average_duplicates=True, rng_tape=True)
    s_k, qb_k, racc_k = run(
        jnp.asarray([5], jnp.int32), lr, 0.0,
        jnp.asarray(s0.reshape(-1, 128), jnp.int32),
        jnp.asarray(q_to_banks(q0, nsb)),
        jnp.zeros(run.tape_shape, jnp.int32),  # all-zero draws
    )
    q_k = banks_to_q(np.asarray(qb_k), nsp, na=5, nsb=nsb)
    s_m, q_m, racc_m = _numpy_mirror(env, s0, q0, K, lr, gamma,
                                     average_duplicates=True)
    np.testing.assert_array_equal(np.asarray(s_k).reshape(-1), s_m)
    np.testing.assert_allclose(np.asarray(racc_k).reshape(-1), racc_m,
                               atol=1e-5)
    np.testing.assert_allclose(q_k[:idx_n], q_m[:idx_n], rtol=1e-4, atol=1e-5)


def test_fused_q_trainer_hansen_pomdp_matches_mirror():
    """POMDP mode: the Q-table is indexed by the trainer-computed Hansen
    observation code, not the full state."""
    env = gpt.make("HansenTaxi-v4")
    B, K = 1024, 16
    lr, gamma = 0.1, 0.9
    _, st = env.reset_vec(jax.random.PRNGKey(7), B)
    s0 = np.asarray(st.s)
    rng = np.random.default_rng(2)
    q0 = rng.normal(scale=0.1, size=(512, 5)).astype(np.float32)
    q0[int(env.observation_space.n):] = 0.0

    run = make_fused_q_trainer(env, B, K, gamma, average_duplicates=True, rng_tape=True)
    s_k, qb_k, _ = run(
        jnp.asarray([5], jnp.int32), lr, 0.0,
        jnp.asarray(s0.reshape(-1, 128), jnp.int32),
        jnp.asarray(q_to_banks(q0)),
        jnp.zeros(run.tape_shape, jnp.int32),  # all-zero draws
    )
    q_k = banks_to_q(np.asarray(qb_k), 512)
    s_m, q_m, _ = _numpy_mirror(env, s0, q0, K, lr, gamma,
                                average_duplicates=True)
    n_obs = int(env.observation_space.n)
    np.testing.assert_array_equal(np.asarray(s_k).reshape(-1), s_m)
    np.testing.assert_allclose(q_k[:n_obs], q_m[:n_obs], rtol=1e-4, atol=1e-5)


def _numpy_mirror_rooms(env, a0, q, K, lr, gamma, average_duplicates=True):
    """All-zero-draw greedy mirror of the rooms trainer (eps=0).

    With zero draws: the failure coin always fires (p_fail > 0), the
    alternate action is 0 → executed = 1 if commanded==0 else 0; resets
    spawn at valid_cells[0]."""
    grid = env.grid_np
    H, GW = grid.shape
    disp = np.asarray(env._actions)
    disp_flat = disp[:, 0] * GW + disp[:, 1]
    goal_flat = int(env.fixed_goal_yx[0] * GW + env.fixed_goal_yx[1])
    valid0 = int(np.flatnonzero(grid.reshape(-1) >= 0)[0])
    wall = grid.reshape(-1) == -1
    n_obs = int(env.observation_space.n)
    cells_yx = np.stack(np.divmod(np.arange(H * GW), GW), -1).astype(np.int32)
    obs_tab = np.asarray(
        jax.vmap(lambda yx: env._obs_fn(yx, jnp.asarray(env.fixed_goal_yx)))(
            jnp.asarray(cells_yx)
        ),
        np.int64,
    )
    obs_tab = np.clip(obs_tab, 0, n_obs - 1)
    obs_tab[wall] = 0
    p_fail = 1.0 - float(env._cum[0][0])
    assert p_fail > 0  # zero-draw mirror assumes the coin always fires

    agent = a0.astype(np.int64).copy()
    q = q.astype(np.float64).copy()
    elapsed = np.zeros_like(agent)
    racc = np.zeros(agent.shape, np.float64)
    for _ in range(K):
        qidx = obs_tab[agent]
        a_cmd = np.argmax(q[qidx], axis=1)
        q_taken = q[qidx, a_cmd]
        executed = np.where(a_cmd == 0, 1, 0)
        proposed = np.clip(agent + disp_flat[executed], 0, H * GW - 1)
        oob = wall[proposed]
        agent2 = np.where(oob, agent, proposed)
        done = agent2 == goal_flat
        rew = np.where(
            done, env.goal_reward, np.where(oob, env.wall_reward,
                                            env.step_reward)
        )
        elapsed += 1
        trunc = elapsed > env.time_limit
        qidx2 = obs_tab[agent2]
        next_v = q[qidx2].max(axis=1)
        td = rew + gamma * next_v * (1.0 - done) - q_taken
        if average_duplicates:
            dq = np.zeros_like(q)
            cnt = np.zeros_like(q)
            np.add.at(dq, (qidx, a_cmd), lr * td)
            np.add.at(cnt, (qidx, a_cmd), 1.0)
            q = q + dq / np.maximum(cnt, 1.0)
        else:
            np.add.at(q, (qidx, a_cmd), lr * td)
        reset = done | trunc
        agent = np.where(reset, valid0, agent2)
        elapsed = np.where(reset, 0, elapsed)
        racc += rew
    return agent, q, racc


def test_fused_q_trainer_rooms_matches_mirror():
    env = gpt.make("Rooms-v0")  # layout '4', mdp obs, 8 ordinal actions
    B, K = 1024, 20
    lr, gamma = 0.2, 0.9
    GW = env.grid_np.shape[1]
    _, st = env.reset_vec(jax.random.PRNGKey(5), B)
    a0 = np.asarray(st.agent_yx[:, 0] * GW + st.agent_yx[:, 1], np.int64)
    n_obs = int(env.observation_space.n)
    rng = np.random.default_rng(4)
    q0 = np.zeros((512, 8), np.float32)
    q0[:n_obs] = rng.normal(scale=0.1, size=(n_obs, 8)).astype(np.float32)

    run = make_fused_q_trainer_rooms(env, B, K, gamma,
                                     average_duplicates=True, rng_tape=True)
    a_k, qb_k, racc_k = run(
        jnp.asarray([3], jnp.int32), lr, 0.0,
        jnp.asarray(a0.reshape(-1, 128), jnp.int32),
        jnp.asarray(q_to_banks(q0)),
        jnp.zeros(run.tape_shape, jnp.int32),  # all-zero draws
    )
    q_k = banks_to_q(np.asarray(qb_k), 512, na=8)
    a_m, q_m, racc_m = _numpy_mirror_rooms(env, a0, q0, K, lr, gamma)
    np.testing.assert_array_equal(np.asarray(a_k).reshape(-1), a_m)
    np.testing.assert_allclose(np.asarray(racc_k).reshape(-1), racc_m,
                               atol=1e-5)
    np.testing.assert_allclose(q_k[:n_obs], q_m[:n_obs], rtol=1e-4, atol=1e-5)


def _numpy_mirror_msrooms(env, a0, q, K, lr, gamma):
    """All-zero-draw greedy mirror of the msrooms trainer (eps=0, mean dups)."""
    from gym_po_tpu.envs.msrooms import (
        DOWNSTAIRS_SW,
        STAIR_DOWN,
        STAIR_UP,
        UPSTAIRS_NE,
        WALL,
    )

    grid = env.grid_np
    Z, H, GW = grid.shape
    HW = H * GW
    ncells = Z * HW
    disp = np.asarray(env._actions)
    disp_flat = disp[:, 1] * GW + disp[:, 2]
    gz, gy, gx = (int(v) for v in env.fixed_goal_zyx)
    goal_flat = gz * HW + gy * GW + gx
    sw_flat = DOWNSTAIRS_SW[0] * GW + DOWNSTAIRS_SW[1]
    ne_flat = UPSTAIRS_NE[0] * GW + UPSTAIRS_NE[1]
    cellv = grid.reshape(-1)
    spawn0 = int(np.asarray(env.valid_agent_states)[0])
    n_obs = int(env.observation_space.n)
    cells_zyx = np.stack(
        np.unravel_index(np.arange(ncells), grid.shape), -1
    ).astype(np.int32)
    obs_tab = np.asarray(
        jax.vmap(lambda zyx: env._obs_fn(zyx, jnp.asarray(env.fixed_goal_zyx)))(
            jnp.asarray(cells_zyx)
        ),
        np.int64,
    )
    obs_tab = np.clip(obs_tab, 0, n_obs - 1)
    obs_tab[cellv == WALL] = 0

    agent = a0.astype(np.int64).copy()
    q = q.astype(np.float64).copy()
    elapsed = np.zeros_like(agent)
    racc = np.zeros(agent.shape, np.float64)
    for _ in range(K):
        qidx = obs_tab[agent]
        a_cmd = np.argmax(q[qidx], axis=1)
        q_taken = q[qidx, a_cmd]
        executed = np.where(a_cmd == 0, 1, 0)  # zero-draw failure coin
        proposed = np.clip(agent + disp_flat[executed], 0, ncells - 1)
        oob = cellv[proposed] == WALL
        agent2 = np.where(oob, agent, proposed)
        acell = cellv[agent2]
        z = agent2 // HW
        go_up = (acell == STAIR_UP) & ~oob
        go_down = (acell == STAIR_DOWN) & ~oob
        agent2 = np.where(go_up, (z + 1) * HW + sw_flat, agent2)
        agent2 = np.where(go_down, (z - 1) * HW + ne_flat, agent2)
        done = agent2 == goal_flat
        rew = np.where(
            done, env.goal_reward, np.where(oob, env.wall_reward,
                                            env.step_reward)
        )
        elapsed += 1
        trunc = elapsed > env.time_limit
        next_v = q[obs_tab[agent2]].max(axis=1)
        td = rew + gamma * next_v * (1.0 - done) - q_taken
        dq = np.zeros_like(q)
        cnt = np.zeros_like(q)
        np.add.at(dq, (qidx, a_cmd), lr * td)
        np.add.at(cnt, (qidx, a_cmd), 1.0)
        q = q + dq / np.maximum(cnt, 1.0)
        reset = done | trunc
        agent = np.where(reset, spawn0, agent2)
        elapsed = np.where(reset, 0, elapsed)
        racc += rew
    return agent, q, racc


def test_fused_q_trainer_msrooms_matches_mirror():
    env = gpt.make("MultistoryFourRooms-v0", grid_z=3)
    B, K = 1024, 20
    lr, gamma = 0.2, 0.9
    Z, H, GW = env.grid_np.shape
    _, st = env.reset_vec(jax.random.PRNGKey(6), B)
    zyx = np.asarray(st.agent_zyx, np.int64)
    a0 = zyx[:, 0] * H * GW + zyx[:, 1] * GW + zyx[:, 2]
    n_obs = int(env.observation_space.n)
    A = env.num_actions
    rng = np.random.default_rng(8)
    q0 = np.zeros((512, A), np.float32)
    q0[:n_obs] = rng.normal(scale=0.1, size=(n_obs, A)).astype(np.float32)

    run = make_fused_q_trainer_msrooms(env, B, K, gamma,
                                       average_duplicates=True, rng_tape=True)
    a_k, qb_k, racc_k = run(
        jnp.asarray([3], jnp.int32), lr, 0.0,
        jnp.asarray(a0.reshape(-1, 128), jnp.int32),
        jnp.asarray(q_to_banks(q0)),
        jnp.zeros(run.tape_shape, jnp.int32),  # all-zero draws
    )
    q_k = banks_to_q(np.asarray(qb_k), 512, na=A)
    a_m, q_m, racc_m = _numpy_mirror_msrooms(env, a0, q0, K, lr, gamma)
    np.testing.assert_array_equal(np.asarray(a_k).reshape(-1), a_m)
    np.testing.assert_allclose(np.asarray(racc_k).reshape(-1), racc_m,
                               atol=1e-5)
    np.testing.assert_allclose(q_k[:n_obs], q_m[:n_obs], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "name,kw",
    [
        ("Taxi-v4", {}),
        ("Rooms-v0", {}),
        ("MultistoryFourRooms-v0", {"grid_z": 2}),
    ],
)
def test_fused_q_learning_wrapper(name, kw):
    """High-level driver dispatches to the right trainer per env family."""
    from gym_po_tpu.agents import fused_q_learning

    env = gpt.make(name, **kw)
    q, hist = fused_q_learning(
        env, seed=0, schedule=[(0.1, 0.0, 8)], num_envs=1024,
        chunk_steps=8,
    )
    n_obs = int(env.observation_space.n)
    n_act = int(env.action_space.n)
    assert q.shape == (n_obs, n_act)
    assert len(hist) == 1 and np.isfinite(hist[0])


def test_fused_q_learning_wrapper_rejects_unknown_env():
    from gym_po_tpu.agents import fused_q_learning

    env = gpt.make("CarFlag-v0")
    with pytest.raises(ValueError):
        fused_q_learning(env, 0, [(0.1, 0.1, 8)], num_envs=1024)


def test_fused_q_trainer_rejects_bad_configs():
    env = gpt.make("Taxi-v4")
    with pytest.raises(ValueError):
        make_fused_q_trainer(env, 100, 8)  # not a multiple of 1024


def test_fused_q_trainer_rooms_learns_on_hardware():
    """Fused training must learn goal-directed navigation
    (greedy reward far above the random policy's)."""
    from gym_po_tpu.agents import greedy_policy
    from gym_po_tpu.vector import rollout

    env = gpt.make("Rooms-v0")
    B = 4096
    GW = env.grid_np.shape[1]
    n_obs = int(env.observation_space.n)
    run = make_fused_q_trainer_rooms(env, B, 4096, average_duplicates=True)
    _, st = env.reset_vec(jax.random.PRNGKey(0), B)
    a = jnp.asarray(
        np.asarray(st.agent_yx[:, 0] * GW + st.agent_yx[:, 1]).reshape(-1, 128),
        jnp.int32,
    )
    qb = jnp.asarray(q_to_banks(np.zeros((512, 8), np.float32)))
    for i, (lr, eps) in enumerate([(0.2, 0.3)] * 2 + [(0.05, 0.05)] * 2):
        a, qb, _ = run(jnp.asarray([i + 1], jnp.int32), lr, eps, a, qb)
    q = banks_to_q(np.asarray(qb), 512, na=8)[:n_obs]

    traj, _ = jax.jit(
        lambda k: rollout(env, k, greedy_policy(jnp.asarray(q)), 1024, 256)
    )(jax.random.PRNGKey(9))
    r = np.asarray(traj.reward)
    goals_per_env = (r > 0.5).sum() / 1024
    assert goals_per_env > 2.0, goals_per_env


def test_fused_q_trainer_extended_learns_on_hardware():
    """Hardware: extended 8x8 map, full-state ns=1280 (10 obs banks per
    action). Measured 11.85 dropoffs/env/256 with zero bad moves."""
    from gym_po_tpu.agents import fused_q_learning, greedy_policy
    from gym_po_tpu.vector import rollout

    env = gpt.make("ExtendedTaxi-v4")
    q, _ = fused_q_learning(
        env, seed=0,
        schedule=[(0.1, 0.3, 16384), (0.05, 0.05, 16384), (0.02, 0.01, 8192)],
        num_envs=8192,
    )
    traj, _ = jax.jit(
        lambda k: rollout(env, k, greedy_policy(jnp.asarray(q)), 1024, 256)
    )(jax.random.PRNGKey(9))
    r = np.asarray(traj.reward)
    assert (r > 0.5).sum() / 1024 > 6.0, (r > 0.5).sum() / 1024
    assert (r < -0.4).mean() < 0.01


def test_fused_q_trainer_msrooms_learns_on_hardware():
    """Hardware: learns multistory navigation — ground floor to the
    top-floor goal VIA THE STAIRS (greedy 5.6 goals/env/500 measured;
    random ~0.03)."""
    from gym_po_tpu.agents import greedy_policy
    from gym_po_tpu.vector import rollout

    env = gpt.make("MultistoryFourRooms-v0", grid_z=3)
    B = 4096
    Z, H, GW = env.grid_np.shape
    A = env.num_actions
    n_obs = int(env.observation_space.n)
    run = make_fused_q_trainer_msrooms(env, B, 4096, average_duplicates=True)
    _, st = env.reset_vec(jax.random.PRNGKey(0), B)
    zyx = np.asarray(st.agent_zyx)
    a = jnp.asarray(
        (zyx[:, 0] * H * GW + zyx[:, 1] * GW + zyx[:, 2]).reshape(-1, 128),
        jnp.int32,
    )
    qb = jnp.asarray(q_to_banks(np.zeros((512, A), np.float32)))
    for i, (lr, eps) in enumerate([(0.2, 0.3)] * 2 + [(0.05, 0.05)] * 2):
        a, qb, _ = run(jnp.asarray([i + 1], jnp.int32), lr, eps, a, qb)
    q = banks_to_q(np.asarray(qb), 512, na=A)[:n_obs]

    traj, _ = jax.jit(
        lambda k: rollout(env, k, greedy_policy(jnp.asarray(q)), 1024, 500)
    )(jax.random.PRNGKey(9))
    r = np.asarray(traj.reward)
    assert (r > 0.5).sum() / 1024 > 1.0, (r > 0.5).sum() / 1024


def test_fused_q_trainer_learns_on_hardware():
    """Epsilon-greedy fused training must reach a strong taxi
    policy (the scan-path agent reaches +0.0285/step optimal; require the
    same learning signature: positive reward, frequent dropoffs)."""
    from gym_po_tpu.agents import greedy_policy
    from gym_po_tpu.vector import rollout

    env = gpt.make("Taxi-v4")
    B = 4096  # ~8 same-state duplicates per batch: effective lr stays <0.5
    q = np.zeros((512, 5), np.float32)
    # ONE executable; the lr/epsilon schedule rides traced scalars (same
    # 3-phase shape as solve_taxi)
    run = make_fused_q_trainer(env, B, 4096)
    _, st = env.reset_vec(jax.random.PRNGKey(0), B)
    s = jnp.asarray(np.asarray(st.s).reshape(-1, 128), jnp.int32)
    qb = jnp.asarray(q_to_banks(q))
    for i, (lr, eps) in enumerate(
        [(0.05, 0.3)] * 3 + [(0.02, 0.05)] * 3 + [(0.01, 0.01)] * 2
    ):
        s, qb, _ = run(jnp.asarray([i + 1], jnp.int32), lr, eps, s, qb)
    q = banks_to_q(np.asarray(qb), 512)

    traj, _ = jax.jit(
        lambda k: rollout(env, k, greedy_policy(jnp.asarray(q[:500])), 1024, 256)
    )(jax.random.PRNGKey(9))
    r = np.asarray(traj.reward)
    assert r.mean() > 0.02, r.mean()
    assert (r > 0.5).sum() / 1024 > 15, (r > 0.5).sum() / 1024


def test_fused_taxi_qlambda_learns_on_hardware():
    """Hardware: taxi Watkins Q(λ) (the lam>0 ring-trace path of the taxi
    trainer) trains to a strong policy at a SMALLER transition budget than
    the one-step learning check (half the chunks) — traces shorten the
    credit path from dropoff back through the pickup."""
    from gym_po_tpu.agents import greedy_policy
    from gym_po_tpu.vector import rollout

    env = gpt.make("Taxi-v4")
    B = 4096
    run = make_fused_q_trainer(env, B, 4096, lam=0.9, trace_len=16,
                               average_duplicates=True)
    _, st = env.reset_vec(jax.random.PRNGKey(0), B)
    s = jnp.asarray(np.asarray(st.s).reshape(-1, 128), jnp.int32)
    qb = jnp.asarray(q_to_banks(np.zeros((512, 5), np.float32)))
    for i, (lr, eps) in enumerate(
        [(0.3, 0.3)] * 2 + [(0.1, 0.05)] + [(0.05, 0.01)]
    ):
        s, qb, _ = run(jnp.asarray([i + 1], jnp.int32), lr, eps, s, qb)
    q = banks_to_q(np.asarray(qb), 512)

    traj, _ = jax.jit(
        lambda k: rollout(env, k, greedy_policy(jnp.asarray(q[:500])),
                          1024, 256)
    )(jax.random.PRNGKey(9))
    r = np.asarray(traj.reward)
    assert r.mean() > 0.02, r.mean()
    assert (r > 0.5).sum() / 1024 > 15, (r > 0.5).sum() / 1024


def test_fused_q_trainer_expected_sarsa_matches_mirror():
    """On-policy expectation target: with eps=0 it reduces to the max
    bootstrap only when the argmax is unique; the mirror computes the same
    (1-eps)·max + (eps/A)·sum expectation explicitly (eps=0.25 here so the
    expectation genuinely differs from the max)."""
    env = gpt.make("Taxi-v4")
    B, K = 1024, 16
    lr, gamma, eps = 0.2, 0.9, 0.25
    _, st = env.reset_vec(jax.random.PRNGKey(3), B)
    s0 = np.asarray(st.s)
    rng = np.random.default_rng(7)
    q0 = np.zeros((512, 5), np.float32)
    q0[:500] = rng.normal(scale=0.1, size=(500, 5)).astype(np.float32)

    run = make_fused_q_trainer(env, B, K, gamma, average_duplicates=True,
                               expected_sarsa=True, rng_tape=True)
    # NOTE: all-zero draws mean the exploration coin never fires even
    # with eps>0 (draws are 0 and 0 < eps... is TRUE) — actually r24()=0 <
    # eps24 makes every env explore with action 0.  The mirror replicates
    # exactly that: action = 0 always, target expectation uses eps.
    s_k, qb_k, _ = run(
        jnp.asarray([5], jnp.int32), lr, eps,
        jnp.asarray(s0.reshape(-1, 128), jnp.int32),
        jnp.asarray(q_to_banks(q0)),
        jnp.zeros(run.tape_shape, jnp.int32),  # all-zero draws
    )
    q_k = banks_to_q(np.asarray(qb_k), 512)

    # NumPy mirror with action pinned to 0 (zero-draw explore) and the
    # expected-sarsa target
    t = env.tables
    nlocs = t.nlocs
    pd = (nlocs + 1) * nlocs
    cm = np.asarray(env._cell_move).reshape(-1, 4)
    la = np.asarray(env._loc_at)
    s = s0.astype(np.int64).copy()
    q = q0.astype(np.float64).copy()
    completed = np.zeros_like(s)
    elapsed = np.zeros_like(s)
    for _ in range(K):
        a = np.zeros_like(s)  # explore fires with alt action 0 every step
        q_taken = q[s, a]
        rc, rem = s // pd, s % pd
        p, d = rem // nlocs, rem % nlocs
        moved = cm[rc, np.minimum(a, 3)]
        rc2 = moved  # a=0 is a move action
        completed = completed
        rew = np.full(s.shape, env.reward_any)
        elapsed += 1
        done = completed == env.num_passengers
        trunc = elapsed > env.time_limit
        s_mid = (rc2 * (nlocs + 1) + p) * nlocs + d
        vals2 = q[s_mid]
        next_v = (1 - 0.25) * vals2.max(1) + 0.25 * vals2.mean(1)
        td = rew + gamma * next_v * (1.0 - done) - q_taken
        dq = np.zeros_like(q)
        cnt = np.zeros_like(q)
        np.add.at(dq, (s, a), lr * td)
        np.add.at(cnt, (s, a), 1.0)
        q = q + dq / np.maximum(cnt, 1.0)
        reset = done | trunc
        rc3 = np.where(reset, 0, rc2)
        p4 = np.where(reset, 0, p)
        d4 = np.where(reset, 1, d)
        completed = np.where(reset, 0, completed)
        elapsed = np.where(reset, 0, elapsed)
        s = (rc3 * (nlocs + 1) + p4) * nlocs + d4
    np.testing.assert_array_equal(np.asarray(s_k).reshape(-1), s)
    np.testing.assert_allclose(q_k[:500], q[:500], rtol=1e-4, atol=1e-5)
