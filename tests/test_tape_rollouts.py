"""Bit-exact stochastic-path tests for the fused rollouts (CPU).

Tape mode (``rng_tape=True``) replaces every counter-generator draw with a
slice of a precomputed uint32 buffer; these tests replay the same tape
through an independent NumPy oracle of each rollout's dynamics (action
draws, failure coins, Box-Muller noise, respawn sampling) and assert exact
equality — every stochastic branch, bit for bit.

Oracles re-derive control flow, draw order, and arithmetic in NumPy;
transcendental primitives delegate to jitted jnp (see tests/_tape.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gym_po_tpu as gpt
from gym_po_tpu.ops import make_fused_rooms_rollout

from _tape import TapeOracle, make_tape

SEED0 = jnp.asarray([3], jnp.int32)


def _f32(x):
    return np.float32(x)


# ---------------------------------------------------------------- rooms
def _rooms_oracle(env, agent, goal, tape, K, R):
    H, GW = env.grid_np.shape
    ncells = H * GW
    A = env.num_actions
    disp = np.asarray(env._actions)
    disp_flat = (disp[:, 0] * GW + disp[:, 1]).astype(np.int32)
    wall = env.grid_np.reshape(-1) == -1
    valid = np.flatnonzero(env.grid_np.reshape(-1) >= 0).astype(np.int32)
    p_fail = _f32(1.0 - float(env._cum[0][0]))
    step_r, wall_r, goal_r = (_f32(env.step_reward), _f32(env.wall_reward),
                              _f32(env.goal_reward))
    o = TapeOracle(tape, K, R)
    agent = agent.copy()
    goal = goal.copy()
    elapsed = np.zeros_like(agent)
    racc = np.zeros(agent.shape, np.float32)
    for t in range(K):
        o.begin_step(t)
        a_cmd = o.rbits(A)
        fail = o.runiform() < p_fail
        alt = o.rbits(A - 1)
        executed = np.where(fail, alt + (alt >= a_cmd), a_cmd)
        proposed = np.clip(agent + disp_flat[executed], 0, ncells - 1)
        oob = wall[proposed]
        agent2 = np.where(oob, agent, proposed)
        done = agent2 == goal
        rew = np.where(done, goal_r, np.where(oob, wall_r, step_r)).astype(
            np.float32
        )
        elapsed = elapsed + 1
        reset = done | (elapsed > env.time_limit)
        # the rollout samples goal first, then agent (body-trace order)
        goal = np.where(reset, valid[o.rbits(valid.size)], goal)
        agent = np.where(reset, valid[o.rbits(valid.size)], agent2)
        elapsed = np.where(reset, 0, elapsed)
        racc = racc + rew
    return agent, goal, racc


@pytest.mark.parametrize("rows_per_tile", [128, 1])
def test_tape_rooms_bit_exact(rows_per_tile):
    env = gpt.make("Rooms-v0", layout="4", obs_type="mdp", goal_xy=None,
                   time_limit=30)
    B, K = 256, 64
    GW = env.grid_np.shape[1]
    run = make_fused_rooms_rollout(env, B, K, rows_per_tile=rows_per_tile, rng_tape=True)
    _, st = env.reset_vec(jax.random.PRNGKey(0), B)
    a0 = (st.agent_yx[:, 0] * GW + st.agent_yx[:, 1]).reshape(-1, 128).astype(jnp.int32)
    g0 = (st.goal_yx[:, 0] * GW + st.goal_yx[:, 1]).reshape(-1, 128).astype(jnp.int32)
    tape = make_tape(np.random.default_rng(7), run.n_sites, K,
                     run.tape_shape[0] // run.n_sites // K)
    assert tape.shape == run.tape_shape
    a, g, racc = run(SEED0, a0, g0, jnp.asarray(tape))
    # oracle, per grid tile
    R = min(rows_per_tile, B // 128)
    grid_n = (B // 128) // R
    slab = run.tape_shape[0] // grid_n
    ao = np.empty((B // 128, 128), np.int32)
    go = np.empty_like(ao)
    ro = np.empty((B // 128, 128), np.float32)
    a0n, g0n = np.asarray(a0), np.asarray(g0)
    for i in range(grid_n):
        rows = slice(i * R, (i + 1) * R)
        at, gt, rt = _rooms_oracle(env, a0n[rows], g0n[rows],
                                   tape[i * slab : (i + 1) * slab], K, R)
        ao[rows], go[rows], ro[rows] = at, gt, rt
    np.testing.assert_array_equal(np.asarray(a), ao)
    np.testing.assert_array_equal(np.asarray(g), go)
    np.testing.assert_array_equal(np.asarray(racc), ro)
    # the tape must actually exercise the stochastic branches
    assert len(np.unique(ao)) > 1


def test_tape_site_contract_enforced():
    """A mis-sized tape (wrong draw-site count) must fail loudly, not read
    garbage."""
    env = gpt.make("Rooms-v0", layout="4", obs_type="mdp", goal_xy=None)
    B, K = 256, 8
    run = make_fused_rooms_rollout(env, B, K, rng_tape=True)
    GW = env.grid_np.shape[1]
    _, st = env.reset_vec(jax.random.PRNGKey(0), B)
    a0 = (st.agent_yx[:, 0] * GW + st.agent_yx[:, 1]).reshape(-1, 128).astype(jnp.int32)
    g0 = (st.goal_yx[:, 0] * GW + st.goal_yx[:, 1]).reshape(-1, 128).astype(jnp.int32)
    bad = jnp.zeros((run.tape_shape[0] // 2, 128), jnp.int32)
    with pytest.raises(Exception):
        run(SEED0, a0, g0, bad)


# ----------------------------------------------------------------- taxi
def _taxi_oracle(env, s, tape, K, R):
    t = env.tables
    nlocs, rows, cols = t.nlocs, t.rows, t.cols
    nc = rows * cols
    pd = (nlocs + 1) * nlocs
    cm = np.asarray(env._cell_move).reshape(nc, 4)
    loc_at = np.asarray(env._loc_at)
    valid = np.flatnonzero((t.tgrid != "|").reshape(-1)).astype(np.int32)
    all_valid = env._all_cells_valid
    n_pass, tl = env.num_passengers, env.time_limit
    r_goal, r_bad, r_any = (_f32(env.reward_goal), _f32(env.reward_bad),
                            _f32(env.reward_any))
    o = TapeOracle(tape, K, R)
    s = s.copy()
    completed = np.zeros_like(s)
    elapsed = np.zeros_like(s)
    racc = np.zeros(s.shape, np.float32)
    for step in range(K):
        o.begin_step(step)
        a = o.rbits(5)
        rc = s // pd
        rem = s % pd
        p = rem // nlocs
        d = rem % nlocs
        moved = cm[rc, np.minimum(a, 3)]
        is_pd = a == 4
        loc = loc_at[rc]
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
        s = (rc3 * (nlocs + 1) + p4) * nlocs + d4
        racc = racc + rew
    return s, racc


@pytest.mark.parametrize("env_id", ["Taxi-v4", "ExtendedTaxi-v4"])
def test_tape_taxi_bit_exact(env_id):
    from gym_po_tpu.ops import make_fused_taxi_rollout

    env = gpt.make(env_id, time_limit=25)
    B, K = 256, 60
    run = make_fused_taxi_rollout(env, B, K, rng_tape=True)
    _, st = env.reset_vec(jax.random.PRNGKey(1), B)
    s0 = st.s.reshape(-1, 128).astype(jnp.int32)
    tape = make_tape(np.random.default_rng(11), run.n_sites, K, B // 128)
    s, racc = run(SEED0, s0, jnp.asarray(tape))
    so, ro = _taxi_oracle(env, np.asarray(s0), tape, K, B // 128)
    np.testing.assert_array_equal(np.asarray(s), so)
    np.testing.assert_array_equal(np.asarray(racc), ro)
    assert len(np.unique(so)) > 1


# ---------------------------------------------------------------- crooms
def _crooms_oracle(env, state6, tape, K, R):
    from gym_po_tpu.envs.crooms import MAX_VELOCITY

    grid_np = env.grid_np
    H, GW = grid_np.shape
    ncells = H * GW
    cs = _f32(env.cell_size)
    std = _f32(env.action_std)
    power = _f32(env.action_power)
    use_vel = env.use_velocity
    thr2 = _f32(float(env.goal_threshold) ** 2)
    step_r, wall_r, goal_r = (_f32(env.step_reward), _f32(env.wall_reward),
                              _f32(env.goal_reward))
    pos_hi_y, pos_hi_x = _f32(env._pos_hi[0]), _f32(env._pos_hi[1])
    wall = (grid_np.reshape(-1) == -1).astype(np.int32)
    valid = np.flatnonzero(grid_np.reshape(-1) >= 0).astype(np.int32)
    fg = env.fixed_goal_coord
    fa = env.fixed_agent_coord
    tl = env.time_limit
    o = TapeOracle(tape, K, R)
    py, px, vy, vx, gy, gx = (x.copy() for x in state6)
    elapsed = np.zeros(py.shape, np.int32)
    racc = np.zeros(py.shape, np.float32)

    def sample_coords(fixed):
        if fixed is not None:
            return (np.full(py.shape, _f32(fixed[0]), np.float32),
                    np.full(py.shape, _f32(fixed[1]), np.float32))
        cell = valid[o.rbits(valid.size)]
        return ((cell // GW).astype(np.float32) + _f32(0.5),
                (cell % GW).astype(np.float32) + _f32(0.5))

    for step in range(K):
        o.begin_step(step)
        ay = (o.runiform() * _f32(2.0) - _f32(1.0) + o.rnormal() * std) * power
        ax = (o.runiform() * _f32(2.0) - _f32(1.0) + o.rnormal() * std) * power
        if use_vel:
            vy2 = np.clip(vy + ay, _f32(-MAX_VELOCITY), _f32(MAX_VELOCITY))
            vx2 = np.clip(vx + ax, _f32(-MAX_VELOCITY), _f32(MAX_VELOCITY))
            ny, nx = py + vy2, px + vx2
        else:
            vy2, vx2 = vy, vx
            ny, nx = py + ay, px + ax
        ny = np.clip(ny, _f32(0.0), pos_hi_y)
        nx = np.clip(nx, _f32(0.0), pos_hi_x)
        cyi = np.floor(ny / cs).astype(np.int32)
        cxi = np.floor(nx / cs).astype(np.int32)
        oob = wall[cyi * GW + cxi] == 1
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
        dy = py2 - gy
        dx = px2 - gx
        done = dy * dy + dx * dx <= thr2
        rew = np.where(done, goal_r, np.where(oob, wall_r, step_r)).astype(
            np.float32
        )
        elapsed = elapsed + 1
        reset = done | (elapsed > tl)
        ngy, ngx = sample_coords(fg)
        nay, nax = sample_coords(fa)
        gy = np.where(reset, ngy, gy)
        gx = np.where(reset, ngx, gx)
        py = np.where(reset, nay, py2)
        px = np.where(reset, nax, px2)
        vy = np.where(reset, _f32(0.0), vy3)
        vx = np.where(reset, _f32(0.0), vx3)
        elapsed = np.where(reset, 0, elapsed)
        racc = racc + rew
    return py, px, vy, vx, gy, gx, racc


@pytest.mark.parametrize("use_velocity", [False, True])
def test_tape_crooms_bit_exact(use_velocity):
    from gym_po_tpu.ops import make_fused_crooms_rollout

    env = gpt.make("CRooms-v0", layout="4", obs_type="mdp", goal_xy=None,
                   use_velocity=use_velocity, time_limit=25)
    B, K = 256, 60
    run = make_fused_crooms_rollout(env, B, K, rng_tape=True)
    _, st = env.reset_vec(jax.random.PRNGKey(2), B)
    state6 = [
        st.agent_yx[:, 0].reshape(-1, 128), st.agent_yx[:, 1].reshape(-1, 128),
        st.vel_yx[:, 0].reshape(-1, 128), st.vel_yx[:, 1].reshape(-1, 128),
        st.goal_yx[:, 0].reshape(-1, 128), st.goal_yx[:, 1].reshape(-1, 128),
    ]
    tape = make_tape(np.random.default_rng(13), run.n_sites, K, B // 128)
    out = run(SEED0, *state6, jnp.asarray(tape))
    oracle = _crooms_oracle(env, [np.asarray(x) for x in state6], tape, K,
                            B // 128)
    for got, want, name in zip(out, oracle,
                               "py px vy vx gy gx racc".split()):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=name)
    # stochastic branches actually exercised: wall resamples happened
    assert len(np.unique(oracle[0])) > 10


# --------------------------------------------------------------- msrooms
def _msrooms_oracle(env, agent, goal, tape, K, R):
    from gym_po_tpu.envs.msrooms import (DOWNSTAIRS_SW, STAIR_DOWN, STAIR_UP,
                                         UPSTAIRS_NE, WALL)

    grid_np = env.grid_np
    Z, H, GW = grid_np.shape
    HW = H * GW
    ncells = Z * HW
    A = env.num_actions
    disp = np.asarray(env._actions)
    disp_flat = (disp[:, 1] * GW + disp[:, 2]).astype(np.int32)
    p_fail = _f32(1.0 - float(env._cum[0][0]))
    cells = grid_np.reshape(-1).astype(np.int32)
    agent_bank = np.asarray(env.valid_agent_states, np.int32)
    goal_bank = np.asarray(env.valid_goal_states, np.int32)
    sw_flat = DOWNSTAIRS_SW[0] * GW + DOWNSTAIRS_SW[1]
    ne_flat = UPSTAIRS_NE[0] * GW + UPSTAIRS_NE[1]
    step_r, wall_r, goal_r = (_f32(env.step_reward), _f32(env.wall_reward),
                              _f32(env.goal_reward))
    tl = env.time_limit
    o = TapeOracle(tape, K, R)
    agent, goal = agent.copy(), goal.copy()
    elapsed = np.zeros_like(agent)
    racc = np.zeros(agent.shape, np.float32)
    for step in range(K):
        o.begin_step(step)
        a_cmd = o.rbits(A)
        fail = o.runiform() < p_fail
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
        done = agent2 == goal
        rew = np.where(done, goal_r, np.where(oob, wall_r, step_r)).astype(
            np.float32
        )
        elapsed = elapsed + 1
        reset = done | (elapsed > tl)
        goal = np.where(reset, goal_bank[o.rbits(goal_bank.size)], goal)
        agent = np.where(reset, agent_bank[o.rbits(agent_bank.size)], agent2)
        elapsed = np.where(reset, 0, elapsed)
        racc = racc + rew
    return agent, goal, racc


def test_tape_msrooms_bit_exact():
    from gym_po_tpu.ops import make_fused_msrooms_rollout

    env = gpt.make("MultistoryFourRooms-v0", grid_z=3, obs_type="mdp",
                   goal_xyz=None, time_limit=25)
    B, K = 256, 60
    Z, H, GW = env.grid_np.shape
    run = make_fused_msrooms_rollout(env, B, K, rng_tape=True)
    _, st = env.reset_vec(jax.random.PRNGKey(3), B)
    HW = H * GW
    a0 = (st.agent_zyx[:, 0] * HW + st.agent_zyx[:, 1] * GW
          + st.agent_zyx[:, 2]).reshape(-1, 128).astype(jnp.int32)
    g0 = (st.goal_zyx[:, 0] * HW + st.goal_zyx[:, 1] * GW
          + st.goal_zyx[:, 2]).reshape(-1, 128).astype(jnp.int32)
    tape = make_tape(np.random.default_rng(17), run.n_sites, K, B // 128)
    a, g, racc = run(SEED0, a0, g0, jnp.asarray(tape))
    ao, go, ro = _msrooms_oracle(env, np.asarray(a0), np.asarray(g0), tape,
                                 K, B // 128)
    np.testing.assert_array_equal(np.asarray(a), ao)
    np.testing.assert_array_equal(np.asarray(g), go)
    np.testing.assert_array_equal(np.asarray(racc), ro)


# ------------------------------------------------------------ rocksample
def _rocksample_oracle(env, pos, mask, tape, K, R):
    from gym_po_tpu.envs.rocksample import (BAD_PENALTY, EXIT_REWARD,
                                            GOOD_REWARD,
                                            ILLEGAL_SAMPLE_PENALTY)

    rows, cols, k = env.rows, env.cols, env.k
    n_actions = 5 + k
    rp = env.rock_positions_np
    rock_at = np.full(rows * cols, k, np.int32)
    rock_at[rp[:, 0] * cols + rp[:, 1]] = np.arange(k)
    init_flat = (int(np.asarray(env._init_pos)[0]) * cols
                 + int(np.asarray(env._init_pos)[1]))
    full_mask = (1 << k) - 1
    tl = env.time_limit
    o = TapeOracle(tape, K, R)
    pos, mask = pos.copy(), mask.copy()
    elapsed = np.zeros_like(pos)
    racc = np.zeros(pos.shape, np.float32)
    for step in range(K):
        o.begin_step(step)
        a = o.rbits(n_actions)
        y = pos // cols
        x = pos % cols
        dy = np.where(a == 0, -1, np.where(a == 2, 1, 0))
        dx = np.where(a == 1, 1, np.where(a == 3, -1, 0))
        is_move = a < 4
        ny = np.where(is_move, y + dy, y)
        nx = np.where(is_move, x + dx, x)
        exited = is_move & (nx >= cols)
        inside = (ny >= 0) & (ny < rows) & (nx >= 0) & (nx < cols)
        pos2 = np.where(inside, ny * cols + nx, pos)
        ridx_here = rock_at[pos]
        on_rock = ridx_here < k
        here_bit = (mask >> np.minimum(ridx_here, k - 1)) & 1
        is_sample = a == 4
        sample_rew = np.where(
            on_rock,
            np.where(here_bit == 1, _f32(GOOD_REWARD), _f32(BAD_PENALTY)),
            _f32(ILLEGAL_SAMPLE_PENALTY),
        )
        clear = np.where(is_sample & on_rock,
                         1 << np.minimum(ridx_here, k - 1), 0)
        mask2 = mask & ~clear
        _ = o.runiform()  # sensor draw (reading not materialized)
        rew = np.where(exited, _f32(EXIT_REWARD),
                       np.where(is_sample, sample_rew, _f32(0.0))).astype(
            np.float32
        )
        elapsed = elapsed + 1
        reset = exited | (elapsed >= tl)
        new_mask = o.rbits(full_mask + 1)
        pos = np.where(reset, init_flat, pos2)
        mask = np.where(reset, new_mask, mask2)
        elapsed = np.where(reset, 0, elapsed)
        racc = racc + rew
    return pos, mask, racc


def test_tape_rocksample_bit_exact():
    from gym_po_tpu.ops import make_fused_rocksample_rollout

    env = gpt.make("RockSample-v0", map_size=(7, 7), num_rocks=8,
                   time_limit=25)
    B, K = 256, 60
    run = make_fused_rocksample_rollout(env, B, K,
                                        rng_tape=True)
    _, st = env.reset_vec(jax.random.PRNGKey(4), B)
    pos0 = (st.pos_yx[:, 0] * env.cols + st.pos_yx[:, 1]).reshape(-1, 128).astype(jnp.int32)
    mask0 = ((st.rock_good.astype(jnp.int32) * (2 ** jnp.arange(env.k)))
             .sum(-1)).reshape(-1, 128).astype(jnp.int32)
    tape = make_tape(np.random.default_rng(19), run.n_sites, K, B // 128)
    pos, mask, racc = run(SEED0, pos0, mask0, jnp.asarray(tape))
    po, mo, ro = _rocksample_oracle(env, np.asarray(pos0), np.asarray(mask0),
                                    tape, K, B // 128)
    np.testing.assert_array_equal(np.asarray(pos), po)
    np.testing.assert_array_equal(np.asarray(mask), mo)
    np.testing.assert_array_equal(np.asarray(racc), ro)


# ------------------------------------------------------------------- tag
def _tag_oracle(env, state4, tape, K, R):
    from gym_po_tpu.envs.tag_jax import (CAGE, MIN_SPAWN_DIST, TAG_RADIUS,
                                         TARGET_STEP)

    speed = _f32(env.agent_speed)
    tl = int(env.time_limit)
    cage = _f32(CAGE)
    tstep = _f32(TARGET_STEP)
    tag2 = _f32(TAG_RADIUS**2)
    min2 = _f32(MIN_SPAWN_DIST**2)
    corners = np.array([[-CAGE, -CAGE], [-CAGE, CAGE], [CAGE, -CAGE],
                        [CAGE, CAGE]], np.float32)
    o = TapeOracle(tape, K, R)
    a0, a1, t0, t1 = (x.copy() for x in state4)
    elapsed = np.zeros(a0.shape, np.int32)
    racc = np.zeros(a0.shape, np.float32)

    def rcage():
        return o.runiform() * _f32(2 * CAGE) - cage

    def spawn_target(sa0, sa1):
        fc0 = np.full(sa0.shape, corners[0, 0], np.float32)
        fc1 = np.full(sa0.shape, corners[0, 1], np.float32)
        best = (fc0 - sa0) ** 2 + (fc1 - sa1) ** 2
        for c0, c1 in corners[1:]:
            d = (c0 - sa0) ** 2 + (c1 - sa1) ** 2
            better = d > best
            fc0 = np.where(better, c0, fc0)
            fc1 = np.where(better, c1, fc1)
            best = np.maximum(best, d)
        out0, out1 = fc0, fc1
        found = np.zeros(sa0.shape, bool)
        for _ in range(8):
            c0 = rcage()
            c1 = rcage()
            ok = (c0 - sa0) ** 2 + (c1 - sa1) ** 2 >= min2
            pick = ok & ~found
            out0 = np.where(pick, c0, out0)
            out1 = np.where(pick, c1, out1)
            found = found | ok
        return out0, out1

    for step in range(K):
        o.begin_step(step)
        a0 = np.clip(a0 + (o.runiform() * _f32(2.0) - _f32(1.0)) * speed,
                     -cage, cage)
        a1 = np.clip(a1 + (o.runiform() * _f32(2.0) - _f32(1.0)) * speed,
                     -cage, cage)
        mode = o.rbits(4)
        w0 = t0 - a0
        w1 = t1 - a1
        nrm = np.sqrt(w0 * w0 + w1 * w1)
        inv = np.where(nrm > _f32(1e-9),
                       _f32(1.0) / np.maximum(nrm, _f32(1e-9)), _f32(0.0))
        u0 = w0 * inv
        u1 = w1 * inv
        s0 = np.where(mode == 0, u0,
                      np.where(mode == 1, -u1,
                               np.where(mode == 2, u1, _f32(0.0))))
        s1 = np.where(mode == 0, u1,
                      np.where(mode == 1, u0,
                               np.where(mode == 2, -u0, _f32(0.0))))
        n0 = t0 + s0 * tstep
        n1 = t1 + s1 * tstep
        oc = (np.abs(n0) > cage) | (np.abs(n1) > cage)
        t0 = np.where(oc, t0, n0)
        t1 = np.where(oc, t1, n1)
        d2 = (a0 - t0) ** 2 + (a1 - t1) ** 2
        done = d2 <= tag2
        rew = done.astype(np.float32)
        elapsed = elapsed + 1
        reset = done | (elapsed >= tl)
        na0 = rcage()
        na1 = rcage()
        nt0, nt1 = spawn_target(na0, na1)
        a0 = np.where(reset, na0, a0)
        a1 = np.where(reset, na1, a1)
        t0 = np.where(reset, nt0, t0)
        t1 = np.where(reset, nt1, t1)
        elapsed = np.where(reset, 0, elapsed)
        racc = racc + rew
    return a0, a1, t0, t1, racc


def test_tape_tag_bit_exact():
    from gym_po_tpu.ops import make_fused_tag_rollout

    env = gpt.make("TagContinuous-v0", time_limit=25)
    B, K = 256, 60
    run = make_fused_tag_rollout(env, B, K, rng_tape=True)
    _, st = env.reset_vec(jax.random.PRNGKey(5), B)
    state4 = [
        st.agent_xy[:, 0].reshape(-1, 128), st.agent_xy[:, 1].reshape(-1, 128),
        st.target_xy[:, 0].reshape(-1, 128),
        st.target_xy[:, 1].reshape(-1, 128),
    ]
    tape = make_tape(np.random.default_rng(23), run.n_sites, K, B // 128)
    out = run(SEED0, *state4, jnp.asarray(tape))
    oracle = _tag_oracle(env, [np.asarray(x) for x in state4], tape, K,
                         B // 128)
    for got, want, name in zip(out, oracle, "a0 a1 t0 t1 racc".split()):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=name)


# ------------------------------------------------------------ heavenhell
def _hh_oracle(env, state3, tape, K, R):
    from gym_po_tpu.envs.tag_jax import BAR, HH_RADIUS, HH_SITES, STEM

    speed = _f32(env.agent_speed)
    tl = int(env.time_limit)
    hx, hy = _f32(HH_SITES[0, 0]), _f32(HH_SITES[0, 1])
    r2 = _f32(HH_RADIUS**2)
    o = TapeOracle(tape, K, R)
    x, y, h = (s.copy() for s in state3)
    elapsed = np.zeros(x.shape, np.int32)
    racc = np.zeros(x.shape, np.float32)

    def in_free(fx, fy):
        stem = ((fx >= _f32(STEM[0])) & (fx <= _f32(STEM[1]))
                & (fy >= _f32(STEM[2])) & (fy <= _f32(STEM[3])))
        bar = ((fx >= _f32(BAR[0])) & (fx <= _f32(BAR[1]))
               & (fy >= _f32(BAR[2])) & (fy <= _f32(BAR[3])))
        return stem | bar

    for step in range(K):
        o.begin_step(step)
        px = x + (o.runiform() * _f32(2.0) - _f32(1.0)) * speed
        py = y + (o.runiform() * _f32(2.0) - _f32(1.0)) * speed
        ok = in_free(px, py)
        x = np.where(ok, px, x)
        y = np.where(ok, py, y)
        dl = (x - hx) ** 2 + (y - hy) ** 2
        dr = (x + hx) ** 2 + (y - hy) ** 2
        at_left = dl <= r2
        at_right = dr <= r2
        done = at_left | at_right
        right_side = h == 1
        reached = (right_side & at_right) | (~right_side & at_left)
        rew = np.where(done, np.where(reached, _f32(1.0), _f32(-1.0)),
                       _f32(0.0)).astype(np.float32)
        elapsed = elapsed + 1
        reset = done | (elapsed >= tl)
        nx = o.runiform() * _f32(2.0) - _f32(1.0)
        ny = o.runiform()
        nh = (o.draw32() & np.uint32(1)).astype(np.int32)
        x = np.where(reset, nx, x)
        y = np.where(reset, ny, y)
        h = np.where(reset, nh, h)
        elapsed = np.where(reset, 0, elapsed)
        racc = racc + rew
    return x, y, h, racc


def test_tape_heavenhell_bit_exact():
    from gym_po_tpu.ops import make_fused_heavenhell_rollout

    env = gpt.make("HeavenHellContinuous-v0", time_limit=25)
    B, K = 256, 60
    run = make_fused_heavenhell_rollout(env, B, K,
                                        rng_tape=True)
    _, st = env.reset_vec(jax.random.PRNGKey(6), B)
    state3 = [
        st.agent_xy[:, 0].reshape(-1, 128), st.agent_xy[:, 1].reshape(-1, 128),
        st.heaven_right.astype(jnp.int32).reshape(-1, 128),
    ]
    tape = make_tape(np.random.default_rng(29), run.n_sites, K, B // 128)
    out = run(SEED0, *state3, jnp.asarray(tape))
    oracle = _hh_oracle(env, [np.asarray(x) for x in state3], tape, K,
                        B // 128)
    for got, want, name in zip(out, oracle, "x y h racc".split()):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=name)
    # both heaven sides must appear (the coin branch is exercised)
    assert set(np.unique(oracle[2])) == {0, 1}
