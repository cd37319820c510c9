"""Fused Watkins Q(λ): bit-exact tape oracle + reduction checks.

Three correctness anchors:
1. λ=0 is BIT-identical to the one-step rooms Q trainer on the same tape
   (the trace statically truncates to one R-row scatter block).
2. λ>0 matches an independent NumPy oracle of the ring-buffer trace
   semantics bit-exactly on an injected PRNG tape (both Watkins-cut and
   naive variants).
3. Q(λ) learns ROOMS faster than one-step Q (see
   test_fused_qlambda_learns_on_hardware).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gym_po_tpu as gpt
from gym_po_tpu.ops.fused_qlambda import make_fused_qlambda_trainer_rooms
from gym_po_tpu.ops.fused_qlearning import (
    NSB,
    make_fused_q_trainer_rooms,
    q_to_banks,
)

from _tape import (
    TapeOracle,
    first_argmax_oracle,
    make_tape,
    scatter_oracle,
    q_lookup_oracle,
)

SEED0 = jnp.asarray([3], jnp.int32)
W = 128


def _f32(x):
    return np.float32(x)


def _setup(env, B, seed=5):
    GW = env.grid_np.shape[1]
    _, st = env.reset_vec(jax.random.PRNGKey(seed), B)
    a0 = np.asarray(st.agent_yx[:, 0] * GW + st.agent_yx[:, 1],
                    np.int32).reshape(-1, W)
    n_obs = int(env.observation_space.n)
    A = int(env.num_actions)
    rng = np.random.default_rng(11)
    q0 = np.zeros((512, A), np.float32)
    q0[:n_obs] = rng.normal(scale=0.1, size=(n_obs, A)).astype(np.float32)
    return a0, q_to_banks(q0), rng


def _qlambda_oracle(env, agent, q, tape, K, R, lr, eps, gamma, lam, L,
                    average_duplicates, watkins_cut):
    grid = env.grid_np
    H, GW = grid.shape
    ncells = H * GW
    A = int(env.num_actions)
    disp = np.asarray(env._actions)
    disp_flat = (disp[:, 0] * GW + disp[:, 1]).astype(np.int32)
    goal_flat = int(env.fixed_goal_yx[0] * GW + env.fixed_goal_yx[1])
    wall = grid.reshape(-1) == -1
    valid = np.flatnonzero(grid.reshape(-1) >= 0).astype(np.int32)
    n_obs = int(env.observation_space.n)
    cells_yx = np.stack(np.divmod(np.arange(ncells), GW), -1).astype(np.int32)
    obs_all = np.asarray(
        jax.vmap(lambda yx: env._obs_fn(yx, jnp.asarray(env.fixed_goal_yx)))(
            jnp.asarray(cells_yx)
        ),
        np.int64,
    )
    obs_tab = np.clip(obs_all, 0, n_obs - 1).astype(np.int32)
    obs_tab[wall] = 0
    pf24 = np.int32(int((1.0 - float(env._cum[0][0])) * (1 << 24)))
    step_r, wall_r, goal_r = (_f32(env.step_reward), _f32(env.wall_reward),
                              _f32(env.goal_reward))
    tl = int(env.time_limit)
    eps24 = np.int32(_f32(eps) * _f32(1 << 24))
    lr_f, gam = _f32(lr), _f32(gamma)
    coefs = [np.float32((float(gamma) * float(lam)) ** k) for k in range(L)]
    L = max(k for k, c in enumerate(coefs) if float(c) != 0.0) + 1
    coefs = coefs[:L]

    o = TapeOracle(tape, K, R)
    q = np.asarray(q, np.float32).copy()
    agent = agent.copy()
    age = np.zeros_like(agent)
    elapsed = np.zeros_like(agent)
    racc = np.zeros(agent.shape, np.float32)
    hist_hi = np.zeros((L, R, W), np.int32)
    hist_lo = np.zeros((L, R, W), np.int32)
    for step in range(K):
        o.begin_step(step)
        qidx = obs_tab[agent]
        vals = q_lookup_oracle(q, qidx, A)
        greedy, best_v = first_argmax_oracle(vals)
        explore = o.r24() < eps24
        a_cmd = np.where(explore, o.rbits(A), greedy)
        q_taken = vals[0]
        for i in range(1, A):
            q_taken = np.where(a_cmd == i, vals[i], q_taken)
        if watkins_cut:  # pre-update cut: exploratory δ reaches only k=0
            age = np.where(q_taken < best_v, 0, age)

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

        hist_hi[step % L] = a_cmd * NSB + (qidx >> 7)
        hist_lo[step % L] = qidx & (W - 1)
        age = np.minimum(age + 1, L)
        wd = lr_f * td
        sc_hi = np.empty((L * R, W), np.int32)
        sc_lo = np.empty((L * R, W), np.int32)
        sc_w = np.empty((L * R, W), np.float32)
        for k in range(L):
            slot_r = (step - k + L) % L
            live = k < age
            sc_hi[k * R : (k + 1) * R] = np.where(live, hist_hi[slot_r], -1)
            sc_lo[k * R : (k + 1) * R] = hist_lo[slot_r]
            sc_w[k * R : (k + 1) * R] = np.where(live, coefs[k] * wd,
                                                 _f32(0.0))
        q = q + scatter_oracle(sc_hi, sc_lo, sc_w, L * R,
                                   average_duplicates, 32)

        reset = done | trunc
        age = np.where(reset, 0, age)
        spawn = valid[o.rbits(valid.size)]
        agent = np.where(reset, spawn, agent2)
        elapsed = np.where(reset, 0, elapsed)
        racc = racc + rew
    return agent, q, racc


@pytest.mark.parametrize("watkins_cut,avg", [(True, False), (False, True)])
def test_tape_qlambda_bit_exact(watkins_cut, avg):
    env = gpt.make("Rooms-v0", time_limit=8)
    B, K, L = 1024, 16, 4
    lr, eps, gamma, lam = 0.2, 0.3, 0.9, 0.8
    a0, qb0, rng = _setup(env, B)
    run = make_fused_qlambda_trainer_rooms(
        env, B, K, gamma, lam=lam, trace_len=L, watkins_cut=watkins_cut,
        average_duplicates=avg, rng_tape=True,
    )
    assert run.trace_len == L
    tape = make_tape(rng, run.n_sites, K, B // W)
    a_k, qb_k, racc_k = run(SEED0, lr, eps, jnp.asarray(a0),
                            jnp.asarray(qb0), jnp.asarray(tape))
    a_o, qb_o, racc_o = _qlambda_oracle(env, a0, qb0, tape, K, B // W,
                                        lr, eps, gamma, lam, L, avg,
                                        watkins_cut)
    np.testing.assert_array_equal(np.asarray(a_k), a_o)
    np.testing.assert_array_equal(np.asarray(racc_k), racc_o)
    np.testing.assert_array_equal(np.asarray(qb_k), qb_o)


@pytest.mark.parametrize("avg", [False, True])
def test_qlambda_zero_lambda_equals_one_step(avg):
    """λ=0 must reproduce the one-step rooms Q trainer bit-for-bit on the
    same tape (the trace statically truncates to a single scatter block)."""
    env = gpt.make("Rooms-v0", time_limit=8)
    B, K = 1024, 16
    lr, eps, gamma = 0.2, 0.3, 0.9
    a0, qb0, rng = _setup(env, B)
    run_l = make_fused_qlambda_trainer_rooms(
        env, B, K, gamma, lam=0.0, trace_len=8, average_duplicates=avg, rng_tape=True,
    )
    assert run_l.trace_len == 1
    run_1 = make_fused_q_trainer_rooms(env, B, K, gamma,
                                       average_duplicates=avg, rng_tape=True)
    assert run_l.n_sites == run_1.n_sites  # same draw-site layout
    tape = make_tape(rng, run_l.n_sites, K, B // W)
    out_l = run_l(SEED0, lr, eps, jnp.asarray(a0), jnp.asarray(qb0),
                  jnp.asarray(tape))
    out_1 = run_1(SEED0, lr, eps, jnp.asarray(a0), jnp.asarray(qb0),
                  jnp.asarray(tape))
    for got, want, name in zip(out_l, out_1, "agent q racc".split()):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=name)


def test_qlambda_rejects_bad_configs():
    env = gpt.make("Rooms-v0")
    with pytest.raises(ValueError):
        make_fused_qlambda_trainer_rooms(env, 100, 8)
    with pytest.raises(ValueError):
        make_fused_qlambda_trainer_rooms(env, 1024, 8, lam=1.5)
    with pytest.raises(ValueError):
        make_fused_qlambda_trainer_rooms(env, 1024, 8, trace_len=0)
    nogoal = gpt.make("Rooms-v0", goal_xy=None)
    with pytest.raises(ValueError):
        make_fused_qlambda_trainer_rooms(nogoal, 1024, 8)


def test_fused_q_learning_wrapper_lambda():
    """The high-level driver dispatches lam>0 to the Q(λ) trainers (Rooms
    and Taxi); unsupported env families still raise."""
    from gym_po_tpu.agents import fused_q_learning

    env = gpt.make("Rooms-v0")
    q, hist = fused_q_learning(
        env, seed=0, schedule=[(0.1, 0.0, 8)], num_envs=1024,
        chunk_steps=8, lam=0.9, trace_len=4,
    )
    assert q.shape == (int(env.observation_space.n), int(env.action_space.n))
    assert len(hist) == 1 and np.isfinite(hist[0])
    taxi = gpt.make("Taxi-v4")
    q, hist = fused_q_learning(
        taxi, seed=0, schedule=[(0.1, 0.0, 8)], num_envs=1024,
        chunk_steps=8, lam=0.9, trace_len=4,
    )
    assert q.shape == (int(taxi.observation_space.n),
                       int(taxi.action_space.n))
    assert len(hist) == 1 and np.isfinite(hist[0])
    with pytest.raises(ValueError):
        fused_q_learning(gpt.make("MultistoryFourRooms-v0"), seed=0,
                         schedule=[(0.1, 0.0, 8)], num_envs=1024,
                         chunk_steps=8, lam=0.9)
    with pytest.raises(ValueError):
        fused_q_learning(taxi, seed=0, schedule=[(0.1, 0.0, 8)],
                         num_envs=1024, chunk_steps=8, lam=0.9,
                         expected_sarsa=True)


def test_fused_qlambda_learns_on_hardware():
    """On the long-corridor 16-room layout, Watkins Q(λ) beats one-step
    Q-learning decisively at an EQUAL transition budget of one 512-step
    chunk — the point of eligibility traces (15.0 vs 1.8 greedy goals/env
    on the CPU backend; cutting the trace AFTER the exploratory update
    instead scored 0.01)."""
    from gym_po_tpu.agents import greedy_policy
    from gym_po_tpu.vector import rollout
    from gym_po_tpu.ops.fused_qlearning import banks_to_q

    B, K = 1024, 512
    env = gpt.make("Rooms-v0", layout="16")
    A = int(env.num_actions)
    n_obs = int(env.observation_space.n)
    GW = env.grid_np.shape[1]
    _, st = env.reset_vec(jax.random.PRNGKey(0), B)
    a0 = jnp.asarray(
        np.asarray(st.agent_yx[:, 0] * GW + st.agent_yx[:, 1],
                   np.int32).reshape(-1, W)
    )
    qz = jnp.zeros((32, W), jnp.float32)

    def train_eval(run):
        a, q, _ = run(jnp.asarray([1], jnp.int32), 0.3, 0.3, a0, qz)
        qt = banks_to_q(np.asarray(q), 512, na=A)[:n_obs]
        traj, _ = jax.jit(
            lambda k: rollout(env, k, greedy_policy(jnp.asarray(qt)),
                              1024, 512)
        )(jax.random.PRNGKey(9))
        return float((np.asarray(traj.reward) > 0.5).sum() / 1024)

    goals_l = train_eval(
        make_fused_qlambda_trainer_rooms(env, B, K, 0.99, lam=0.9,
                                         trace_len=16,
                                         average_duplicates=True)
    )
    goals_1 = train_eval(
        make_fused_q_trainer_rooms(env, B, K, 0.99, average_duplicates=True)
    )
    assert goals_l > 8.0, f"Q(λ) greedy goals/env too low: {goals_l}"
    assert goals_l > 2.0 * goals_1, (
        f"Q(λ) ({goals_l}) should decisively beat one-step Q ({goals_1}) "
        "at equal transitions on the 16-room layout"
    )
