"""Bit-exact stochastic-path tests for the fused TRAINERS (CPU).

Tape mode (``rng_tape=True``) replaces every counter-generator draw with a
slice of a precomputed uint32 buffer, so the epsilon-greedy exploration
coin, random actions, action-failure resamples, Gumbel perturbations,
Box-Muller noise, and respawn draws of all the trainers (taxi Q / rooms Q /
msrooms Q / double-Q / actor-critic / crooms Q) are replayed bit-exactly on
CPU against independent NumPy oracles.

Oracles re-derive control flow, draw order, and f32 arithmetic in NumPy;
the scatter-add is mirrored with ``np.add.at`` in the same row-major order,
and libm transcendentals (log/cos/exp) delegate to jitted jnp (see
tests/_tape.py).  Everything else — the Q lookups, first-argmax
tie-breaks, TD arithmetic, duplicate averaging — is plain NumPy, so a
regression in any of those stages fails these tests exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gym_po_tpu as gpt
from gym_po_tpu.ops.fused_ac import make_fused_ac_trainer_rooms
from gym_po_tpu.ops.fused_double_q import make_fused_double_q_trainer
from gym_po_tpu.ops.fused_q_crooms import make_fused_q_trainer_crooms
from gym_po_tpu.ops.fused_qlearning import (
    NSB,
    bank_geometry,
    make_fused_q_trainer,
    make_fused_q_trainer_msrooms,
    make_fused_q_trainer_rooms,
    q_to_banks,
)

from _tape import (
    TapeOracle,
    _jexp,
    _jlog,
    ac_scatter_oracle,
    first_argmax_oracle,
    make_tape,
    scatter_oracle,
    q_lookup_oracle,
)

SEED0 = jnp.asarray([3], jnp.int32)
W = 128


def _f32(x):
    return np.float32(x)


def _eps24(eps):
    """Mirror of the trainers' (eps_f32 * 2^24).astype(int32)."""
    return np.int32(_f32(eps) * _f32(1 << 24))


def _pfail24(p_fail):
    """Mirror of the trainers' trace-time int(p_fail * (1 << 24))."""
    return np.int32(int(p_fail * (1 << 24)))


def _obs_table(env, goal, coords):
    """The per-cell obs table exactly as the trainer builders compute it."""
    n_obs = int(env.observation_space.n)
    obs_all = np.asarray(
        jax.vmap(lambda c: env._obs_fn(c, goal))(jnp.asarray(coords)),
        np.int64,
    )
    obs_tab = np.clip(obs_all, 0, n_obs - 1).astype(np.int32)
    obs_tab[env.grid_np.reshape(-1) == -1] = 0
    return obs_tab


# ------------------------------------------------------------------ taxi Q
def _taxi_q_oracle(env, s, q, tape, K, R, lr, eps, gamma,
                   average_duplicates, expected_sarsa=False,
                   lam=0.0, trace_len=8, watkins_cut=True):
    t = env.tables
    nlocs, rows, cols = t.nlocs, t.rows, t.cols
    nc = rows * cols
    pd = (nlocs + 1) * nlocs
    hansen = bool(getattr(env, "hansen", False))
    nsb, nb = bank_geometry(int(env.observation_space.n), 5)
    cm = np.asarray(env._cell_move).reshape(nc, 4)
    la = np.asarray(env._loc_at)
    hc = np.asarray(env._hansen_cell).reshape(-1)[:nc] if hansen else None
    valid = np.flatnonzero((t.tgrid != "|").reshape(-1)).astype(np.int32)
    all_valid = env._all_cells_valid
    n_pass, tl = env.num_passengers, env.time_limit
    r_goal, r_bad, r_any = (_f32(env.reward_goal), _f32(env.reward_bad),
                            _f32(env.reward_any))
    eps24 = _eps24(eps)
    lr_f, gam, eps_f = _f32(lr), _f32(gamma), _f32(eps)
    coefs = [np.float32((float(gamma) * float(lam)) ** k)
             for k in range(int(trace_len))]
    L = max(k for k, c in enumerate(coefs) if float(c) != 0.0) + 1
    coefs = coefs[:L]
    use_trace = float(lam) > 0.0 and L > 1
    o = TapeOracle(tape, K, R)
    q = np.asarray(q, np.float32).copy()
    s = s.copy()
    completed = np.zeros_like(s)
    elapsed = np.zeros_like(s)
    age = np.zeros_like(s)
    racc = np.zeros(s.shape, np.float32)
    hist_hi = np.zeros((L, R, W), np.int32)
    hist_lo = np.zeros((L, R, W), np.int32)

    def obs_of(s):
        if not hansen:
            return s
        rc, rem = s // pd, s % pd
        return (hc[rc] * (nlocs + 1) + rem // nlocs) * nlocs + rem % nlocs

    for step in range(K):
        o.begin_step(step)
        qidx = obs_of(s)
        vals = q_lookup_oracle(q, qidx, 5, nsb)
        greedy, best_v = first_argmax_oracle(vals)
        explore = o.r24() < eps24
        a = np.where(explore, o.rbits(5), greedy)
        q_taken = vals[0]
        for i in range(1, 5):
            q_taken = np.where(a == i, vals[i], q_taken)
        if use_trace and watkins_cut:
            age = np.where(q_taken < best_v, 0, age)

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
        completed = completed + goal.astype(np.int32)
        rew = np.where(goal, r_goal, np.where(bad, r_bad, r_any)).astype(
            np.float32
        )
        elapsed = elapsed + 1
        done = completed == n_pass
        trunc = elapsed > tl
        task = goal & ~(done | trunc)
        pn = o.rbits(nlocs)
        d0 = o.rbits(nlocs - 1)
        dn = d0 + (d0 >= pn)
        p3 = np.where(task, pn, p2)
        d3 = np.where(task, dn, d)
        s_mid = (rc2 * (nlocs + 1) + p3) * nlocs + d3

        vals2 = q_lookup_oracle(q, obs_of(s_mid), 5, nsb)
        _, next_max = first_argmax_oracle(vals2)
        if expected_sarsa:
            ssum = vals2[0]
            for i in range(1, 5):
                ssum = ssum + vals2[i]
            # XLA's simplifier reassociates eps*(sum*0.2) -> (eps*0.2)*sum
            # (constant folding through the traced scalar); mirror that.
            next_v = (_f32(1.0) - eps_f) * next_max + (eps_f * _f32(0.2)) * ssum
        else:
            next_v = next_max
        target = rew + gam * next_v * np.where(done, _f32(0.0), _f32(1.0))
        td = target - q_taken
        if use_trace:
            hist_hi[step % L] = a * nsb + (qidx >> 7)
            hist_lo[step % L] = qidx & (W - 1)
            age = np.minimum(age + 1, L)
            wd = lr_f * td
            sc_hi = np.empty((L * R, W), np.int32)
            sc_lo = np.empty((L * R, W), np.int32)
            sc_w = np.empty((L * R, W), np.float32)
            for k in range(L):
                slot_r = (step - k + L) % L
                live = k < age
                sc_hi[k * R : (k + 1) * R] = np.where(live, hist_hi[slot_r],
                                                      -1)
                sc_lo[k * R : (k + 1) * R] = hist_lo[slot_r]
                sc_w[k * R : (k + 1) * R] = np.where(live, coefs[k] * wd,
                                                     _f32(0.0))
            q = q + scatter_oracle(sc_hi, sc_lo, sc_w, L * R,
                                       average_duplicates, nb)
        else:
            hi = a * nsb + (qidx >> 7)
            lo = qidx & (W - 1)
            q = q + scatter_oracle(hi, lo, lr_f * td, R,
                                       average_duplicates, nb)

        reset = done | trunc
        if all_valid:
            rc_new = o.rbits(rows) * cols + o.rbits(cols)
        else:
            rc_new = valid[o.rbits(valid.size)]
        pr = o.rbits(nlocs)
        dr0 = o.rbits(nlocs - 1)
        dr = dr0 + (dr0 >= pr)
        rc3 = np.where(reset, rc_new, rc2)
        p4 = np.where(reset, pr, p3)
        d4 = np.where(reset, dr, d3)
        completed = np.where(reset, 0, completed)
        elapsed = np.where(reset, 0, elapsed)
        if use_trace:
            age = np.where(reset, 0, age)
        s = (rc3 * (nlocs + 1) + p4) * nlocs + d4
        racc = racc + rew
    return s, q, racc


@pytest.mark.parametrize(
    "name,avg,esarsa",
    [
        ("Taxi-v4", False, False),
        ("Taxi-v4", True, True),
        ("HansenTaxi-v4", True, False),
        ("ExtendedTaxi-v4", True, False),
    ],
)
def test_tape_taxi_q_trainer_bit_exact(name, avg, esarsa):
    env = gpt.make(name, time_limit=5)
    B, K = 1024, 16
    lr, eps, gamma = 0.2, 0.3, 0.9
    _, st = env.reset_vec(jax.random.PRNGKey(3), B)
    s0 = np.asarray(st.s, np.int32).reshape(-1, W)
    nsb, _ = bank_geometry(int(env.observation_space.n), 5)
    nsp = nsb * W
    rng = np.random.default_rng(0)
    q0 = np.zeros((nsp, 5), np.float32)
    idx_n = int(env.observation_space.n)
    q0[:idx_n] = rng.normal(scale=0.1, size=(idx_n, 5)).astype(np.float32)
    qb0 = q_to_banks(q0, nsb)

    run = make_fused_q_trainer(env, B, K, gamma, average_duplicates=avg,
                               expected_sarsa=esarsa,
                               rng_tape=True)
    tape = make_tape(rng, run.n_sites, K, B // W)
    assert tape.shape == run.tape_shape
    s_k, qb_k, racc_k = run(SEED0, lr, eps, jnp.asarray(s0),
                            jnp.asarray(qb0), jnp.asarray(tape))
    s_o, qb_o, racc_o = _taxi_q_oracle(env, s0, qb0, tape, K, B // W,
                                       lr, eps, gamma, avg, esarsa)
    np.testing.assert_array_equal(np.asarray(s_k), s_o)
    np.testing.assert_array_equal(np.asarray(racc_k), racc_o)
    np.testing.assert_array_equal(np.asarray(qb_k), qb_o)
    # the tape exercised exploration AND greedy exploitation
    assert 0 < np.count_nonzero(qb_o != qb0) < qb_o.size


@pytest.mark.parametrize(
    "name,watkins_cut,avg",
    [
        ("Taxi-v4", True, False),
        ("Taxi-v4", False, True),
        ("ExtendedTaxi-v4", True, True),
    ],
)
def test_tape_taxi_qlambda_bit_exact(name, watkins_cut, avg):
    """Taxi Watkins Q(λ): the ring-buffer trace path of the one-step taxi
    trainer (lam > 0) matches the NumPy oracle bit-exactly — incl. the
    trace surviving mid-episode task resets and dying at full resets."""
    env = gpt.make(name, time_limit=6)
    B, K, L = 1024, 16, 4
    lr, eps, gamma, lam = 0.2, 0.4, 0.9, 0.8
    _, st = env.reset_vec(jax.random.PRNGKey(3), B)
    s0 = np.asarray(st.s, np.int32).reshape(-1, W)
    nsb, _ = bank_geometry(int(env.observation_space.n), 5)
    nsp = nsb * W
    rng = np.random.default_rng(1)
    q0 = np.zeros((nsp, 5), np.float32)
    idx_n = int(env.observation_space.n)
    q0[:idx_n] = rng.normal(scale=0.1, size=(idx_n, 5)).astype(np.float32)
    qb0 = q_to_banks(q0, nsb)

    run = make_fused_q_trainer(env, B, K, gamma, average_duplicates=avg,
                               lam=lam, trace_len=L,
                               watkins_cut=watkins_cut, rng_tape=True)
    assert run.trace_len == L
    tape = make_tape(rng, run.n_sites, K, B // W)
    s_k, qb_k, racc_k = run(SEED0, lr, eps, jnp.asarray(s0),
                            jnp.asarray(qb0), jnp.asarray(tape))
    s_o, qb_o, racc_o = _taxi_q_oracle(
        env, s0, qb0, tape, K, B // W, lr, eps, gamma, avg,
        lam=lam, trace_len=L, watkins_cut=watkins_cut,
    )
    np.testing.assert_array_equal(np.asarray(s_k), s_o)
    np.testing.assert_array_equal(np.asarray(racc_k), racc_o)
    np.testing.assert_array_equal(np.asarray(qb_k), qb_o)


def test_taxi_qlambda_zero_lambda_equals_one_step():
    """lam=0 must reproduce the one-step taxi trainer bit-for-bit on the
    same tape (identical draw-site layout, single scatter block)."""
    env = gpt.make("Taxi-v4", time_limit=6)
    B, K = 1024, 16
    lr, eps, gamma = 0.2, 0.3, 0.9
    _, st = env.reset_vec(jax.random.PRNGKey(5), B)
    s0 = np.asarray(st.s, np.int32).reshape(-1, W)
    rng = np.random.default_rng(2)
    q0 = rng.normal(scale=0.1, size=(512, 5)).astype(np.float32)
    qb0 = q_to_banks(q0)
    run_l = make_fused_q_trainer(env, B, K, gamma, lam=0.0, trace_len=8, rng_tape=True)
    assert run_l.trace_len == 1
    run_1 = make_fused_q_trainer(env, B, K, gamma,
                                 rng_tape=True)
    assert run_l.n_sites == run_1.n_sites
    tape = make_tape(rng, run_l.n_sites, K, B // W)
    out_l = run_l(SEED0, lr, eps, jnp.asarray(s0), jnp.asarray(qb0),
                  jnp.asarray(tape))
    out_1 = run_1(SEED0, lr, eps, jnp.asarray(s0), jnp.asarray(qb0),
                  jnp.asarray(tape))
    for got, want, nm in zip(out_l, out_1, "s q racc".split()):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=nm)


def test_taxi_qlambda_rejects_bad_configs():
    env = gpt.make("Taxi-v4")
    with pytest.raises(ValueError):
        make_fused_q_trainer(env, 1024, 8, lam=1.5)
    with pytest.raises(ValueError):
        make_fused_q_trainer(env, 1024, 8, lam=0.5, trace_len=0)
    with pytest.raises(ValueError):
        make_fused_q_trainer(env, 1024, 8, lam=0.5, expected_sarsa=True)


# ----------------------------------------------------------------- rooms Q
def _rooms_q_oracle(env, agent, q, tape, K, R, lr, eps, gamma,
                    average_duplicates):
    grid = env.grid_np
    H, GW = grid.shape
    ncells = H * GW
    A = int(env.num_actions)
    disp = np.asarray(env._actions)
    disp_flat = (disp[:, 0] * GW + disp[:, 1]).astype(np.int32)
    goal_flat = int(env.fixed_goal_yx[0] * GW + env.fixed_goal_yx[1])
    wall = grid.reshape(-1) == -1
    valid = np.flatnonzero(grid.reshape(-1) >= 0).astype(np.int32)
    cells_yx = np.stack(np.divmod(np.arange(ncells), GW), -1).astype(np.int32)
    obs_tab = _obs_table(env, jnp.asarray(env.fixed_goal_yx), cells_yx)
    pf24 = _pfail24(1.0 - float(env._cum[0][0]))
    step_r, wall_r, goal_r = (_f32(env.step_reward), _f32(env.wall_reward),
                              _f32(env.goal_reward))
    tl = int(env.time_limit)
    eps24 = _eps24(eps)
    lr_f, gam = _f32(lr), _f32(gamma)
    fixed = env.fixed_agent_yx
    o = TapeOracle(tape, K, R)
    q = np.asarray(q, np.float32).copy()
    agent = agent.copy()
    elapsed = np.zeros_like(agent)
    racc = np.zeros(agent.shape, np.float32)
    for step in range(K):
        o.begin_step(step)
        qidx = obs_tab[agent]
        vals = q_lookup_oracle(q, qidx, A)
        greedy, _ = first_argmax_oracle(vals)
        explore = o.r24() < eps24
        a_cmd = np.where(explore, o.rbits(A), greedy)
        q_taken = vals[0]
        for i in range(1, A):
            q_taken = np.where(a_cmd == i, vals[i], q_taken)

        fail = o.r24() < pf24
        alt = o.rbits(A - 1)
        executed = np.where(fail, alt + (alt >= a_cmd), a_cmd)
        proposed = np.clip(agent + disp_flat[executed], 0, ncells - 1)
        oob = wall[proposed]
        agent2 = np.where(oob, agent, proposed)
        done = agent2 == goal_flat
        rew = np.where(done, goal_r, np.where(oob, wall_r, step_r)).astype(
            np.float32
        )
        elapsed = elapsed + 1
        trunc = elapsed > tl

        _, next_v = first_argmax_oracle(q_lookup_oracle(q, obs_tab[agent2], A))
        target = rew + gam * next_v * np.where(done, _f32(0.0), _f32(1.0))
        td = target - q_taken
        hi = a_cmd * NSB + (qidx >> 7)
        lo = qidx & (W - 1)
        q = q + scatter_oracle(hi, lo, lr_f * td, R, average_duplicates,
                                   32)

        reset = done | trunc
        if fixed is not None:
            spawn = np.full(agent.shape,
                            int(fixed[0] * GW + fixed[1]), np.int32)
        else:
            spawn = valid[o.rbits(valid.size)]
        agent = np.where(reset, spawn, agent2)
        elapsed = np.where(reset, 0, elapsed)
        racc = racc + rew
    return agent, q, racc


def test_tape_rooms_q_trainer_bit_exact():
    env = gpt.make("Rooms-v0", time_limit=8)
    B, K = 1024, 16
    lr, eps, gamma = 0.2, 0.3, 0.9
    GW = env.grid_np.shape[1]
    _, st = env.reset_vec(jax.random.PRNGKey(5), B)
    a0 = np.asarray(st.agent_yx[:, 0] * GW + st.agent_yx[:, 1],
                    np.int32).reshape(-1, W)
    n_obs = int(env.observation_space.n)
    A = int(env.num_actions)
    rng = np.random.default_rng(4)
    q0 = np.zeros((512, A), np.float32)
    q0[:n_obs] = rng.normal(scale=0.1, size=(n_obs, A)).astype(np.float32)
    qb0 = q_to_banks(q0)

    run = make_fused_q_trainer_rooms(env, B, K, gamma,
                                     average_duplicates=True, rng_tape=True)
    tape = make_tape(rng, run.n_sites, K, B // W)
    a_k, qb_k, racc_k = run(SEED0, lr, eps, jnp.asarray(a0),
                            jnp.asarray(qb0), jnp.asarray(tape))
    a_o, qb_o, racc_o = _rooms_q_oracle(env, a0, qb0, tape, K, B // W,
                                        lr, eps, gamma, True)
    np.testing.assert_array_equal(np.asarray(a_k), a_o)
    np.testing.assert_array_equal(np.asarray(racc_k), racc_o)
    np.testing.assert_array_equal(np.asarray(qb_k), qb_o)


# --------------------------------------------------------------- msrooms Q
def _msrooms_q_oracle(env, agent, q, tape, K, R, lr, eps, gamma,
                      average_duplicates):
    from gym_po_tpu.envs.msrooms import (DOWNSTAIRS_SW, STAIR_DOWN, STAIR_UP,
                                         UPSTAIRS_NE, WALL)

    grid = env.grid_np
    Z, H, GW = grid.shape
    HW = H * GW
    ncells = Z * HW
    A = int(env.num_actions)
    disp = np.asarray(env._actions)
    disp_flat = (disp[:, 1] * GW + disp[:, 2]).astype(np.int32)
    gz, gy, gx = (int(v) for v in env.fixed_goal_zyx)
    goal_flat = gz * HW + gy * GW + gx
    cells = grid.reshape(-1).astype(np.int32)
    agent_bank = np.asarray(env.valid_agent_states, np.int32)
    sw_flat = DOWNSTAIRS_SW[0] * GW + DOWNSTAIRS_SW[1]
    ne_flat = UPSTAIRS_NE[0] * GW + UPSTAIRS_NE[1]
    cells_zyx = np.stack(
        np.unravel_index(np.arange(ncells), grid.shape), -1
    ).astype(np.int32)
    n_obs = int(env.observation_space.n)
    obs_all = np.asarray(
        jax.vmap(
            lambda zyx: env._obs_fn(zyx, jnp.asarray(env.fixed_goal_zyx))
        )(jnp.asarray(cells_zyx)),
        np.int64,
    )
    obs_tab = np.clip(obs_all, 0, n_obs - 1).astype(np.int32)
    obs_tab[grid.reshape(-1) == WALL] = 0
    pf24 = _pfail24(1.0 - float(env._cum[0][0]))
    step_r, wall_r, goal_r = (_f32(env.step_reward), _f32(env.wall_reward),
                              _f32(env.goal_reward))
    tl = int(env.time_limit)
    eps24 = _eps24(eps)
    lr_f, gam = _f32(lr), _f32(gamma)
    o = TapeOracle(tape, K, R)
    q = np.asarray(q, np.float32).copy()
    agent = agent.copy()
    elapsed = np.zeros_like(agent)
    racc = np.zeros(agent.shape, np.float32)
    for step in range(K):
        o.begin_step(step)
        qidx = obs_tab[agent]
        vals = q_lookup_oracle(q, qidx, A)
        greedy, _ = first_argmax_oracle(vals)
        explore = o.r24() < eps24
        a_cmd = np.where(explore, o.rbits(A), greedy)
        q_taken = vals[0]
        for i in range(1, A):
            q_taken = np.where(a_cmd == i, vals[i], q_taken)

        fail = o.r24() < pf24
        alt = o.rbits(A - 1)
        executed = np.where(fail, alt + (alt >= a_cmd), a_cmd)
        proposed = np.clip(agent + disp_flat[executed], 0, ncells - 1)
        oob = cells[proposed] == WALL
        agent2 = np.where(oob, agent, proposed)
        acell = cells[agent2]
        z = agent2 // HW
        go_up = (acell == STAIR_UP) & ~oob
        go_down = (acell == STAIR_DOWN) & ~oob
        agent2 = np.where(go_up, (z + 1) * HW + sw_flat, agent2)
        agent2 = np.where(go_down, (z - 1) * HW + ne_flat, agent2)
        done = agent2 == goal_flat
        rew = np.where(done, goal_r, np.where(oob, wall_r, step_r)).astype(
            np.float32
        )
        elapsed = elapsed + 1
        trunc = elapsed > tl

        _, next_v = first_argmax_oracle(q_lookup_oracle(q, obs_tab[agent2], A))
        target = rew + gam * next_v * np.where(done, _f32(0.0), _f32(1.0))
        td = target - q_taken
        hi = a_cmd * NSB + (qidx >> 7)
        lo = qidx & (W - 1)
        q = q + scatter_oracle(hi, lo, lr_f * td, R, average_duplicates,
                                   32)

        reset = done | trunc
        spawn = agent_bank[o.rbits(agent_bank.size)]
        agent = np.where(reset, spawn, agent2)
        elapsed = np.where(reset, 0, elapsed)
        racc = racc + rew
    return agent, q, racc


def test_tape_msrooms_q_trainer_bit_exact():
    env = gpt.make("MultistoryFourRooms-v0", grid_z=3, time_limit=8)
    B, K = 1024, 16
    lr, eps, gamma = 0.2, 0.3, 0.9
    Z, H, GW = env.grid_np.shape
    HW = H * GW
    _, st = env.reset_vec(jax.random.PRNGKey(6), B)
    zyx = np.asarray(st.agent_zyx, np.int64)
    a0 = (zyx[:, 0] * HW + zyx[:, 1] * GW + zyx[:, 2]).astype(
        np.int32
    ).reshape(-1, W)
    n_obs = int(env.observation_space.n)
    A = int(env.num_actions)
    rng = np.random.default_rng(8)
    q0 = np.zeros((512, A), np.float32)
    q0[:n_obs] = rng.normal(scale=0.1, size=(n_obs, A)).astype(np.float32)
    qb0 = q_to_banks(q0)

    run = make_fused_q_trainer_msrooms(env, B, K, gamma,
                                       average_duplicates=True, rng_tape=True)
    tape = make_tape(rng, run.n_sites, K, B // W)
    a_k, qb_k, racc_k = run(SEED0, lr, eps, jnp.asarray(a0),
                            jnp.asarray(qb0), jnp.asarray(tape))
    a_o, qb_o, racc_o = _msrooms_q_oracle(env, a0, qb0, tape, K, B // W,
                                          lr, eps, gamma, True)
    np.testing.assert_array_equal(np.asarray(a_k), a_o)
    np.testing.assert_array_equal(np.asarray(racc_k), racc_o)
    np.testing.assert_array_equal(np.asarray(qb_k), qb_o)


# ---------------------------------------------------------------- double Q
def _double_q_oracle(env, s, q2, tape, K, R, lr, eps, gamma,
                     average_duplicates):
    t = env.tables
    nlocs, rows, cols = t.nlocs, t.rows, t.cols
    nc = rows * cols
    pd = (nlocs + 1) * nlocs
    nsb, nb = bank_geometry(nc * pd, 5)
    cm = np.asarray(env._cell_move).reshape(nc, 4)
    la = np.asarray(env._loc_at)
    n_pass, tl = env.num_passengers, env.time_limit
    r_goal, r_bad, r_any = (_f32(env.reward_goal), _f32(env.reward_bad),
                            _f32(env.reward_any))
    eps24 = _eps24(eps)
    lr_f, gam = _f32(lr), _f32(gamma)
    o = TapeOracle(tape, K, R)
    q2 = np.asarray(q2, np.float32).copy()
    s = s.copy()
    completed = np.zeros_like(s)
    elapsed = np.zeros_like(s)
    racc = np.zeros(s.shape, np.float32)

    def pick(vals, a):
        out = vals[0]
        for i in range(1, 5):
            out = np.where(a == i, vals[i], out)
        return out

    for step in range(K):
        o.begin_step(step)
        va = q_lookup_oracle(q2[:nb], s, 5, nsb)
        vb = q_lookup_oracle(q2[nb:], s, 5, nsb)
        greedy, _ = first_argmax_oracle([va[i] + vb[i] for i in range(5)])
        explore = o.r24() < eps24
        a = np.where(explore, o.rbits(5), greedy)
        coin = o.rbits(2)
        q_taken = np.where(coin == 0, pick(va, a), pick(vb, a))

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
        completed = completed + goal.astype(np.int32)
        rew = np.where(goal, r_goal, np.where(bad, r_bad, r_any)).astype(
            np.float32
        )
        elapsed = elapsed + 1
        done = completed == n_pass
        trunc = elapsed > tl
        task = goal & ~(done | trunc)
        pn = o.rbits(nlocs)
        d0 = o.rbits(nlocs - 1)
        dn = d0 + (d0 >= pn)
        p3 = np.where(task, pn, p2)
        d3 = np.where(task, dn, d)
        s_mid = (rc2 * (nlocs + 1) + p3) * nlocs + d3

        va2 = q_lookup_oracle(q2[:nb], s_mid, 5, nsb)
        vb2 = q_lookup_oracle(q2[nb:], s_mid, 5, nsb)
        a_sel_a, _ = first_argmax_oracle(va2)
        a_sel_b, _ = first_argmax_oracle(vb2)
        a_sel = np.where(coin == 0, a_sel_a, a_sel_b)
        next_v = np.where(coin == 0, pick(vb2, a_sel), pick(va2, a_sel))
        target = rew + gam * next_v * np.where(done, _f32(0.0), _f32(1.0))
        td = target - q_taken
        hi = coin * nb + a * nsb + (s >> 7)
        lo = s & (W - 1)
        q2 = q2 + scatter_oracle(hi, lo, lr_f * td, R,
                                     average_duplicates, 2 * nb)

        reset = done | trunc
        rc_new = o.rbits(rows) * cols + o.rbits(cols)
        pr = o.rbits(nlocs)
        dr0 = o.rbits(nlocs - 1)
        dr = dr0 + (dr0 >= pr)
        rc3 = np.where(reset, rc_new, rc2)
        p4 = np.where(reset, pr, p3)
        d4 = np.where(reset, dr, d3)
        completed = np.where(reset, 0, completed)
        elapsed = np.where(reset, 0, elapsed)
        s = (rc3 * (nlocs + 1) + p4) * nlocs + d4
        racc = racc + rew
    return s, q2, racc


def test_tape_double_q_trainer_bit_exact():
    env = gpt.make("Taxi-v4", time_limit=5)
    B, K = 1024, 16
    lr, eps, gamma = 0.2, 0.3, 0.9
    _, st = env.reset_vec(jax.random.PRNGKey(7), B)
    s0 = np.asarray(st.s, np.int32).reshape(-1, W)
    ns = env.tables.ns
    rng = np.random.default_rng(6)
    qa0 = np.zeros((512, 5), np.float32)
    qb0 = np.zeros((512, 5), np.float32)
    qa0[:ns] = rng.normal(scale=0.1, size=(ns, 5)).astype(np.float32)
    qb0[:ns] = rng.normal(scale=0.1, size=(ns, 5)).astype(np.float32)
    q20 = np.concatenate([q_to_banks(qa0), q_to_banks(qb0)])

    run = make_fused_double_q_trainer(env, B, K, gamma,
                                      rng_tape=True)
    tape = make_tape(rng, run.n_sites, K, B // W)
    s_k, q2_k, racc_k = run(SEED0, lr, eps, jnp.asarray(s0),
                            jnp.asarray(q20), jnp.asarray(tape))
    s_o, q2_o, racc_o = _double_q_oracle(env, s0, q20, tape, K, B // W,
                                         lr, eps, gamma, True)
    np.testing.assert_array_equal(np.asarray(s_k), s_o)
    np.testing.assert_array_equal(np.asarray(racc_k), racc_o)
    np.testing.assert_array_equal(np.asarray(q2_k), q2_o)
    # the tape's coin routed updates into BOTH tables
    assert np.count_nonzero(q2_o[:32] != q20[:32]) > 0
    assert np.count_nonzero(q2_o[32:] != q20[32:]) > 0


# ------------------------------------------------------------ actor-critic
def _ac_oracle(env, agent, th, v, tape, K, R, api, apv, gamma):
    grid = env.grid_np
    H, GW = grid.shape
    ncells = H * GW
    A = int(env.num_actions)
    disp = np.asarray(env._actions)
    disp_flat = (disp[:, 0] * GW + disp[:, 1]).astype(np.int32)
    goal_flat = int(env.fixed_goal_yx[0] * GW + env.fixed_goal_yx[1])
    wall = grid.reshape(-1) == -1
    valid = np.flatnonzero(grid.reshape(-1) >= 0).astype(np.int32)
    cells_yx = np.stack(np.divmod(np.arange(ncells), GW), -1).astype(np.int32)
    obs_tab = _obs_table(env, jnp.asarray(env.fixed_goal_yx), cells_yx)
    pf24 = _pfail24(1.0 - float(env._cum[0][0]))
    step_r, wall_r, goal_r = (_f32(env.step_reward), _f32(env.wall_reward),
                              _f32(env.goal_reward))
    tl = int(env.time_limit)
    api_f, apv_f, gam = _f32(api), _f32(apv), _f32(gamma)
    fixed = env.fixed_agent_yx
    o = TapeOracle(tape, K, R)
    th = np.asarray(th, np.float32).copy()
    v = np.asarray(v, np.float32).copy()
    agent = agent.copy()
    elapsed = np.zeros_like(agent)
    racc = np.zeros(agent.shape, np.float32)

    def gumbel():
        u = (o.r24().astype(np.float32) + _f32(0.5)) * _f32(2.0**-24)
        inner = np.asarray(_jlog(u))
        return -np.asarray(_jlog(-inner))

    for step in range(K):
        o.begin_step(step)
        qidx = obs_tab[agent]
        logits = q_lookup_oracle(th, qidx, A)
        pert = [logits[a] + gumbel() for a in range(A)]
        a_cmd, _ = first_argmax_oracle(pert)
        _, mx = first_argmax_oracle(logits)
        exps = [np.asarray(_jexp(logits[a] - mx)) for a in range(A)]
        z = exps[0]
        for a in range(1, A):
            z = z + exps[a]
        probs = [e / z for e in exps]

        fail = o.r24() < pf24
        alt = o.rbits(A - 1)
        executed = np.where(fail, alt + (alt >= a_cmd), a_cmd)
        proposed = np.clip(agent + disp_flat[executed], 0, ncells - 1)
        oob = wall[proposed]
        agent2 = np.where(oob, agent, proposed)
        done = agent2 == goal_flat
        rew = np.where(done, goal_r, np.where(oob, wall_r, step_r)).astype(
            np.float32
        )
        elapsed = elapsed + 1
        trunc = elapsed > tl

        v_next = q_lookup_oracle(v, obs_tab[agent2], 1)[0]
        v_here = q_lookup_oracle(v, qidx, 1)[0]
        delta = (rew + gam * v_next * np.where(done, _f32(0.0), _f32(1.0))
                 - v_here)

        lo = qidx & (W - 1)
        hi0 = qidx >> 7
        v = v + ac_scatter_oracle(hi0, lo, apv_f * delta, R, 32)
        for ap in range(A):
            wgt = api_f * delta * (
                np.where(a_cmd == ap, _f32(1.0), _f32(0.0)) - probs[ap]
            )
            th = th + ac_scatter_oracle(ap * NSB + hi0, lo, wgt, R, 32)

        reset = done | trunc
        if fixed is not None:
            spawn = np.full(agent.shape,
                            int(fixed[0] * GW + fixed[1]), np.int32)
        else:
            spawn = valid[o.rbits(valid.size)]
        agent = np.where(reset, spawn, agent2)
        elapsed = np.where(reset, 0, elapsed)
        racc = racc + rew
    return th, v, agent, racc


def test_tape_ac_trainer_bit_exact():
    env = gpt.make("Rooms-v0", time_limit=8)
    B, K = 1024, 12
    api, apv, gamma = 0.2, 0.3, 0.9
    GW = env.grid_np.shape[1]
    _, st = env.reset_vec(jax.random.PRNGKey(5), B)
    a0 = np.asarray(st.agent_yx[:, 0] * GW + st.agent_yx[:, 1],
                    np.int32).reshape(-1, W)
    n_obs = int(env.observation_space.n)
    A = int(env.num_actions)
    rng = np.random.default_rng(9)
    th0 = np.zeros((512, A), np.float32)
    th0[:n_obs] = rng.normal(scale=0.3, size=(n_obs, A)).astype(np.float32)
    v0 = np.zeros((512, 1), np.float32)
    v0[:n_obs] = rng.normal(scale=0.2, size=(n_obs, 1)).astype(np.float32)
    thb0, vb0 = q_to_banks(th0), q_to_banks(v0)

    run = make_fused_ac_trainer_rooms(env, B, K, gamma,
                                      rng_tape=True)
    tape = make_tape(rng, run.n_sites, K, B // W)
    th_k, v_k, a_k, racc_k = run(SEED0, api, apv, jnp.asarray(thb0),
                                 jnp.asarray(vb0), jnp.asarray(a0),
                                 jnp.asarray(tape))
    th_o, v_o, a_o, racc_o = _ac_oracle(env, a0, thb0, vb0, tape, K, B // W,
                                        api, apv, gamma)
    np.testing.assert_array_equal(np.asarray(a_k), a_o)
    np.testing.assert_array_equal(np.asarray(racc_k), racc_o)
    np.testing.assert_array_equal(np.asarray(v_k), v_o)
    np.testing.assert_array_equal(np.asarray(th_k), th_o)


# ---------------------------------------------------------------- crooms Q
def _crooms_q_oracle(env, state4, q, tape, K, R, lr, eps, gamma,
                     average_duplicates):
    from gym_po_tpu.envs.crooms import MAX_VELOCITY

    grid = env.grid_np
    H, GW = grid.shape
    cs = _f32(env.cell_size)
    std = _f32(env.action_std)
    power = _f32(env.action_power)
    use_vel = bool(env.use_velocity)
    thr2 = _f32(float(env.goal_threshold) ** 2)
    step_r, wall_r, goal_r = (_f32(env.step_reward), _f32(env.wall_reward),
                              _f32(env.goal_reward))
    tl = int(env.time_limit)
    pos_hi_y, pos_hi_x = _f32(env._pos_hi[0]), _f32(env._pos_hi[1])
    gy_f, gx_f = (_f32(v) for v in env.fixed_goal_coord)
    A = int(env.num_actions)
    disp = np.asarray(env._disp, np.float32)
    wall = (grid.reshape(-1) == -1).astype(np.int32)
    valid = np.flatnonzero(grid.reshape(-1) >= 0).astype(np.int32)
    fa = env.fixed_agent_coord
    pf24 = _pfail24(1.0 - float(env._cum[0][0]))
    eps24 = _eps24(eps)
    lr_f, gam = _f32(lr), _f32(gamma)
    # obs table at cell centers, exactly as the builder computes it
    iy, ix = np.divmod(np.arange(H * GW), GW)
    centers = np.stack([(iy + 0.5) * float(env.cell_size),
                        (ix + 0.5) * float(env.cell_size)], -1).astype(
        np.float32
    )
    n_obs = int(env.observation_space.n)
    obs_all = np.asarray(
        jax.vmap(
            lambda c: env._obs_fn(
                c, jnp.asarray(env.fixed_goal_coord, jnp.float32)
            )
        )(jnp.asarray(centers)),
        np.int64,
    )
    obs_tab = np.clip(obs_all, 0, n_obs - 1).astype(np.int32)
    obs_tab[grid.reshape(-1) == -1] = 0

    o = TapeOracle(tape, K, R)
    q = np.asarray(q, np.float32).copy()
    py, px, vy, vx = (x.copy() for x in state4)
    elapsed = np.zeros(py.shape, np.int32)
    racc = np.zeros(py.shape, np.float32)

    def cell_of(y, x):
        return (np.floor(y / cs).astype(np.int32) * GW
                + np.floor(x / cs).astype(np.int32))

    for step in range(K):
        o.begin_step(step)
        qidx = obs_tab[cell_of(py, px)]
        vals = q_lookup_oracle(q, qidx, A)
        greedy, _ = first_argmax_oracle(vals)
        explore = o.r24() < eps24
        a_cmd = np.where(explore, o.rbits(A), greedy)
        q_taken = vals[0]
        for i in range(1, A):
            q_taken = np.where(a_cmd == i, vals[i], q_taken)

        fail = o.r24() < pf24
        alt = o.rbits(A - 1)
        executed = np.where(fail, alt + (alt >= a_cmd), a_cmd)
        ay = (disp[executed, 0] + o.rnormal() * std) * power
        ax = (disp[executed, 1] + o.rnormal() * std) * power
        if use_vel:
            vy2 = np.clip(vy + ay, _f32(-MAX_VELOCITY), _f32(MAX_VELOCITY))
            vx2 = np.clip(vx + ax, _f32(-MAX_VELOCITY), _f32(MAX_VELOCITY))
            ny, nx = py + vy2, px + vx2
        else:
            vy2, vx2 = vy, vx
            ny, nx = py + ay, px + ax
        ny = np.clip(ny, _f32(0.0), pos_hi_y)
        nx = np.clip(nx, _f32(0.0), pos_hi_x)
        oob = wall[cell_of(ny, nx)] == 1
        ceny = np.floor(py / cs) * cs + _f32(env.cell_size / 2)
        cenx = np.floor(px / cs) * cs + _f32(env.cell_size / 2)
        hiy = np.nextafter(ceny + _f32(env.cell_size / 2), _f32(0.0))
        hix = np.nextafter(cenx + _f32(env.cell_size / 2), _f32(0.0))
        ry = np.clip(ceny + o.rnormal() * _f32(0.5),
                     ceny - _f32(env.cell_size / 2), hiy)
        rx = np.clip(cenx + o.rnormal() * _f32(0.5),
                     cenx - _f32(env.cell_size / 2), hix)
        py2 = np.where(oob, ry, ny)
        px2 = np.where(oob, rx, nx)
        vy3 = np.where(oob, _f32(0.0), vy2)
        vx3 = np.where(oob, _f32(0.0), vx2)
        ddy = py2 - gy_f
        ddx = px2 - gx_f
        done = ddy * ddy + ddx * ddx <= thr2
        rew = np.where(done, goal_r, np.where(oob, wall_r, step_r)).astype(
            np.float32
        )
        elapsed = elapsed + 1
        trunc = elapsed > tl

        qidx2 = obs_tab[cell_of(py2, px2)]
        _, next_v = first_argmax_oracle(q_lookup_oracle(q, qidx2, A))
        target = rew + gam * next_v * np.where(done, _f32(0.0), _f32(1.0))
        td = target - q_taken
        hi = a_cmd * NSB + (qidx >> 7)
        lo = qidx & (W - 1)
        q = q + scatter_oracle(hi, lo, lr_f * td, R, average_duplicates,
                                   32)

        reset = done | trunc
        if fa is not None:
            nay = np.full(py.shape, _f32(fa[0]), np.float32)
            nax = np.full(py.shape, _f32(fa[1]), np.float32)
        else:
            cell = valid[o.rbits(valid.size)]
            nay = (cell // GW).astype(np.float32) + _f32(0.5)
            nax = (cell % GW).astype(np.float32) + _f32(0.5)
        py = np.where(reset, nay, py2)
        px = np.where(reset, nax, px2)
        vy = np.where(reset, _f32(0.0), vy3)
        vx = np.where(reset, _f32(0.0), vx3)
        elapsed = np.where(reset, 0, elapsed)
        racc = racc + rew
    return py, px, vy, vx, q, racc


@pytest.mark.parametrize("use_velocity", [False, True])
def test_tape_crooms_q_trainer_bit_exact(use_velocity):
    env = gpt.make("CRooms-v0", action_type="ordinal",
                   use_velocity=use_velocity, time_limit=8)
    B, K = 1024, 12
    lr, eps, gamma = 0.2, 0.3, 0.9
    A = int(env.num_actions)
    _, st = env.reset_vec(jax.random.PRNGKey(8), B)
    z = jnp.zeros((B // W, W), jnp.float32)
    state4 = [
        st.agent_yx[:, 0].reshape(-1, W),
        st.agent_yx[:, 1].reshape(-1, W),
        z,
        z,
    ]
    n_obs = int(env.observation_space.n)
    rng = np.random.default_rng(10)
    q0 = np.zeros((512, A), np.float32)
    q0[:n_obs] = rng.normal(scale=0.1, size=(n_obs, A)).astype(np.float32)
    qb0 = q_to_banks(q0)

    run = make_fused_q_trainer_crooms(env, B, K, gamma,
                                      rng_tape=True)
    tape = make_tape(rng, run.n_sites, K, B // W)
    out = run(SEED0, lr, eps, *state4, jnp.asarray(qb0), jnp.asarray(tape))
    oracle = _crooms_q_oracle(env, [np.asarray(x) for x in state4], qb0,
                              tape, K, B // W, lr, eps, gamma, True)
    for got, want, name in zip(out, oracle, "py px vy vx q racc".split()):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=name)
    # wall resamples and resets were exercised
    assert len(np.unique(oracle[0])) > 10
