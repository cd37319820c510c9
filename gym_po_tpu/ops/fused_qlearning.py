"""Fused tabular Q-learning: the whole trainer in one ``fori_loop``.

The generic XLA Q-learner (`agents/qlearning.py`) runs ``env.step_vec``
under a scan with ``jax.random`` keys.  These trainers fuse everything for
K steps — epsilon-greedy acting, the env transition (reference
``extended_taxi.py:244-287`` semantics for taxi, same as
:mod:`.fused_taxi`), TD targets from the PRE-reset terminal state, and the
duplicate-accumulating ``Q[s,a] += lr*td`` update — with the counter-based
generator (:mod:`.kernel_rng`) as the only source of randomness, so a
recorded tape replays the whole run on the CPU.

The update is XLA's native scatter-add over the flat table.  With
``average_duplicates`` a second scatter counts the updates to each entry
and the summed update is divided by the count.

Q-table layout: entry ``(s, a)`` lives at bank ``hi = a·(NSP/128) + s>>7``,
lane ``lo = s&127`` of a ``[nb, 128]`` f32 table (NSP = ns padded to a
multiple of 128), i.e. at flat index ``a·NSP + s``.  Three trainers share
the machinery: taxi on both maps (classic and extended 8x8 — interior-wall
reset table, ns up to 1280 via ``bank_geometry``; fully-observable and
Hansen-POMDP Q indexing), ROOMS with a fixed goal (Q indexed by ANY
discrete observation model via a precomputed per-cell obs table), and
MultistoryFourRooms (3-D cells + in-loop stair transit).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .kernel_rng import KernelRNG, W, check_tape, fused_loop

__all__ = [
    "make_fused_q_trainer",
    "make_fused_q_trainer_rooms",
    "make_fused_q_trainer_msrooms",
]

NB = 32  # default Q bank rows: 5 actions x (512/128) obs banks = 20, pad 32
NSB = 4  # default obs banks per action (512 / 128)


def bank_geometry(idx_n: int, n_act: int):
    """(nsb, nb): obs banks per action and total bank rows (8-aligned,
    min 32, so every index space <= 512 keeps the canonical [32, 128]
    layout q_to_banks/banks_to_q default to) for an ``idx_n``-entry index
    space."""
    nsb = max(NSB, -(-idx_n // W))
    nb = max(NB, -(-(n_act * nsb) // 8) * 8)
    return nsb, nb


def rows_of(num_envs: int) -> int:
    """Rows of the ``[rows, 128]`` env layout the trainers take."""
    if num_envs % W:
        raise ValueError("num_envs must be a multiple of 128")
    return num_envs // W


def q_lookup(q, idx, n_act, nsb=NSB):
    """``Q[idx, a]`` for every action, from the ``[nb, 128]`` table."""
    flat = q.reshape(-1)
    return [flat[a * nsb * W + idx] for a in range(n_act)]


def first_argmax(vals):
    """First-max index over the action values (matches jnp.argmax ties)."""
    best_v = vals[0]
    best_a = jnp.zeros(vals[0].shape, jnp.int32)
    for a in range(1, len(vals)):
        better = vals[a] > best_v
        best_v = jnp.where(better, vals[a], best_v)
        best_a = jnp.where(better, a, best_a)
    return best_a, best_v


def pick(vals, a):
    """``vals[a]`` per env."""
    out = vals[0]
    for i in range(1, len(vals)):
        out = jnp.where(a == i, vals[i], out)
    return out


def scatter_update(q, idx, w, average_duplicates, live=None):
    """``q + dq`` with ``dq[i] = Σ w`` over the entries whose flat index is
    ``i`` (divided by their count when ``average_duplicates``); entries with
    ``live == False`` are dropped from both sums."""
    size = q.size
    idx = idx.reshape(-1)
    if live is not None:
        idx = jnp.where(live.reshape(-1), idx, size)  # out of range: dropped
    dq = jnp.zeros((size,), jnp.float32).at[idx].add(w.reshape(-1),
                                                     mode="drop")
    if average_duplicates:
        cnt = jnp.zeros((size,), jnp.float32).at[idx].add(1.0, mode="drop")
        dq = dq / jnp.maximum(cnt, jnp.float32(1.0))
    return q + dq.reshape(q.shape)


def obs_table(env, cells, goal, n_obs, is_wall):
    """Per-cell observation index through the env's own obs fn (host,
    once); wall cells map to 0 (never queried)."""
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        obs_all = np.asarray(
            jax.vmap(lambda c: env._obs_fn(c, jnp.asarray(goal)))(
                jnp.asarray(cells)
            ),
            np.int64,
        )
    obs_tab = np.clip(obs_all, 0, n_obs - 1).astype(np.int32)
    obs_tab[is_wall] = 0
    return obs_tab


def _trainer_run(make_body, n_counters, n_sites, num_steps, R, rng_tape,
                 ring_len=0):
    """``run(seed, lr, epsilon, state, q, *tape) -> (state', q', rew)``
    around a loop body over ``(state, q, *counters, [ring], racc)``:
    ``n_counters`` int32 per-env counters and, when ``ring_len``, an
    ``[ring_len, rows, 128]`` table-address ring (Q(λ) traces)."""
    tape_shape = (KernelRNG.tape_rows(n_sites, num_steps, R), W)

    @jax.jit
    def run(seed, lr, epsilon, s, q, *tape):
        if rng_tape:
            check_tape(tape[0], tape_shape)
        lr = jnp.asarray(lr, jnp.float32).reshape(())
        eps = jnp.asarray(epsilon, jnp.float32).reshape(())
        zi = jnp.zeros(s.shape, jnp.int32)
        ring = (jnp.zeros((ring_len,) + s.shape, jnp.int32),) if ring_len else ()
        init = (s, q) + (zi,) * n_counters + ring + (
            jnp.zeros(s.shape, jnp.float32),
        )
        out = fused_loop(
            lambda rng: make_body(rng, lr, eps), init, seed[0],
            tape[0] if rng_tape else None, num_steps=num_steps,
            n_sites=n_sites,
        )
        return out[0], out[1], out[-1]

    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run


def make_fused_q_trainer(env, num_envs: int, num_steps: int,
                         gamma: float = 0.99,
                         average_duplicates: bool = False,
                         expected_sarsa: bool = False,
                         lam: float = 0.0,
                         trace_len: int = 8,
                         watkins_cut: bool = True,
                         rng_tape: bool = False):
    """Build ``run(seed, lr, epsilon, s, q) -> (s', q', reward_sums)``.

    ``expected_sarsa=True`` swaps the off-policy max-bootstrap for the
    ON-policy expectation under the epsilon-greedy behavior policy,
    ``next_v = (1-eps)·max_a Q + (eps/A)·Σ_a Q`` — Expected SARSA (van
    Seijen et al. 2009), lower-variance and safe under exploration.

    ``s``: int32 ``[num_envs//128, 128]`` encoded taxi states (from
    ``state.s.reshape(-1, 128)``); ``q``: f32 ``[nb, 128]`` banked Q-table
    (see :func:`q_to_banks` / :func:`banks_to_q`); ``reward_sums``: f32
    per-env accumulated reward over the ``num_steps`` training steps.
    ``lr``/``epsilon`` are traced scalars, so lr/epsilon schedules reuse
    one executable.  ``rng_tape=True`` makes ``run`` take a trailing int32
    tape of shape ``run.tape_shape`` (one tile of all rows).

    ``average_duplicates=False`` SUMS same-(s,a) updates within a batch
    (the XLA agent's scatter-add semantics) — but the effective per-state
    step is then ``lr × B/ns``, which DIVERGES for ``lr ≳ ns/B`` (measured:
    NaN at B=8192, lr=0.05).  ``average_duplicates=True`` divides each
    entry's summed update by its duplicate count, making lr
    batch-size-invariant.

    Works on the fully-observable Taxi (Q indexed by the state int) AND the
    Hansen partial-obs variant (``env.hansen``): the trainer computes the
    Hansen code arithmetically from the wall-code table each step and
    indexes the Q-table by OBSERVATION (reference obs encode
    extended_taxi.py:366-372).  NOTE a memoryless tabular policy cannot
    solve Hansen taxi (perceptual aliasing) — the POMDP path is for
    aliasing/abstraction research, not for reaching the MDP optimum (use
    ``agents.ppo_rnn`` for memoryful POMDP control).

    ``lam > 0`` switches to **Watkins Q(λ)** with the same ring-buffer
    truncated-trace scheme as the ROOMS variant
    (:func:`~gym_po_tpu.ops.fused_qlambda.make_fused_qlambda_trainer_rooms`):
    the last ``trace_len`` visited table addresses per env, each step's
    L-deep update one combined scatter with baked ``(γλ)^k`` weights.
    ``watkins_cut=True`` clears the prior trace BEFORE the update at
    non-greedy-VALUED actions; the trace survives mid-episode task resets
    (a dropoff is a real MDP transition) and is cut at full episode resets.
    ``lam=0`` reduces bit-exactly to the one-step path.  Incompatible with
    ``expected_sarsa`` (Watkins' trace soundness argument needs the
    off-policy max bootstrap).
    """
    if not 0.0 <= float(lam) <= 1.0:
        raise ValueError(f"lam={lam} out of range [0, 1]")
    if not 1 <= int(trace_len) <= 64:
        raise ValueError(f"trace_len={trace_len} out of range [1, 64]")
    if float(lam) > 0.0 and expected_sarsa:
        raise ValueError("lam > 0 requires the max bootstrap "
                         "(expected_sarsa=False)")
    L, coefs = trace_weights(gamma, lam, trace_len)
    use_trace = float(lam) > 0.0 and L > 1
    t = env.tables
    nc = t.rows * t.cols
    nlocs, rows, cols = t.nlocs, t.rows, t.cols
    pd = (nlocs + 1) * nlocs
    hansen = bool(getattr(env, "hansen", False))
    idx_n = int(env.observation_space.n)  # ns, or the Hansen obs count
    nsb, _ = bank_geometry(idx_n, 5)
    n_pass = env.num_passengers
    time_limit = env.time_limit
    r_goal, r_bad, r_any = env.reward_goal, env.reward_bad, env.reward_any
    all_valid = bool(env._all_cells_valid)
    R = rows_of(num_envs)

    cell_move = jnp.asarray(np.asarray(env._cell_move, np.int32).reshape(-1))
    loc_at = jnp.asarray(np.asarray(env._loc_at, np.int32).reshape(-1))
    hansen_cell = jnp.asarray(
        np.asarray(env._hansen_cell, np.int32).reshape(-1)[:nc]
        if hansen else np.zeros((nc,), np.int32)
    )
    valid_cells_np = np.flatnonzero((t.tgrid != "|").reshape(-1))
    n_valid = int(valid_cells_np.size)
    valid_cells = jnp.asarray(valid_cells_np.astype(np.int32))
    gamma_f = float(gamma)

    # draw sites per step, in body-trace order: explore r24, random action,
    # task pn, task d0, full-reset cell (2 draws when all cells navigable,
    # else 1), reset pr, reset dr0
    n_sites = 6 + (2 if all_valid else 1)

    def obs_of(s):
        """Q index: the state itself, or its Hansen observation code."""
        if not hansen:
            return s
        rc = s // pd
        rem = s % pd
        return (hansen_cell[rc] * (nlocs + 1) + rem // nlocs) * nlocs + (
            rem % nlocs
        )

    def make_body(rng, lr, eps):
        rbits, r24 = rng.rbits, rng.r24
        # epsilon compares against raw 24-bit uniform draws
        eps24 = (eps * jnp.float32(1 << 24)).astype(jnp.int32)

        def body(step, carry):
            if use_trace:
                s, q, completed, elapsed, age, ring, racc = carry
            else:
                s, q, completed, elapsed, racc = carry
            rng.begin_step(step)
            qidx = obs_of(s)
            vals = q_lookup(q, qidx, 5, nsb)
            greedy, best_v = first_argmax(vals)
            explore = r24() < eps24
            a = jnp.where(explore, rbits(5), greedy)
            q_taken = pick(vals, a)
            # Watkins cut BEFORE the update (value-compare: argmax ties are
            # greedy) — see make_fused_qlambda_trainer_rooms for why cutting
            # after collapses learning
            if use_trace and watkins_cut:
                age = jnp.where(q_taken < best_v, 0, age)

            # --- taxi transition (reference extended_taxi.py:244-287) ---
            rc = s // pd
            rem = s % pd
            p = rem // nlocs
            d = rem % nlocs
            moved = cell_move[rc * 4 + jnp.minimum(a, 3)]
            is_pd = a == 4
            loc = loc_at[rc]
            goal = is_pd & (p == nlocs) & (loc == d)
            pickup = is_pd & (p < nlocs) & (loc == p)
            bad = is_pd & (~goal) & (~pickup)
            p2 = jnp.where(pickup, nlocs, p)
            rc2 = jnp.where(is_pd, rc, moved)
            completed = completed + goal.astype(jnp.int32)
            rew = jnp.where(
                goal, jnp.float32(r_goal),
                jnp.where(bad, jnp.float32(r_bad), jnp.float32(r_any)),
            )
            elapsed = elapsed + 1
            done = completed == n_pass
            trunc = elapsed > time_limit

            # --- task reset BEFORE the TD target: the episode continues
            # with a new passenger/destination, so that IS the next state
            # (matches the scan path's terminal_state, taxi.py step_vec) ---
            task = goal & ~(done | trunc)
            pn = rbits(nlocs)
            d0 = rbits(nlocs - 1)
            dn = d0 + (d0 >= pn)
            p3 = jnp.where(task, pn, p2)
            d3 = jnp.where(task, dn, d)
            s_mid = (rc2 * (nlocs + 1) + p3) * nlocs + d3

            # --- TD target from the PRE-(full-)reset terminal state ---
            vals2 = q_lookup(q, obs_of(s_mid), 5, nsb)
            _, next_max = first_argmax(vals2)
            if expected_sarsa:
                mean2 = vals2[0]
                for i in range(1, 5):
                    mean2 = mean2 + vals2[i]
                mean2 = mean2 * jnp.float32(0.2)
                next_v = (jnp.float32(1.0) - eps) * next_max + eps * mean2
            else:
                next_v = next_max
            target = rew + jnp.float32(gamma_f) * next_v * jnp.where(
                done, jnp.float32(0.0), jnp.float32(1.0)
            )
            td = target - q_taken

            # --- scatter-add: Q[obs, a] += lr*td over all envs ---
            addr = a * (nsb * W) + qidx
            if use_trace:
                ring, age, idx, w, live = trace_scatter_args(
                    ring, age, step, addr, lr * td, coefs
                )
                q = scatter_update(q, idx, w, average_duplicates, live)
            else:
                q = scatter_update(q, addr, lr * td, average_duplicates)

            # --- full episode resets (as fused_taxi) ---
            reset = done | trunc
            if all_valid:
                rc_new = rbits(rows) * cols + rbits(cols)
            else:
                rc_new = valid_cells[rbits(n_valid)]
            pr = rbits(nlocs)
            dr0 = rbits(nlocs - 1)
            dr = dr0 + (dr0 >= pr)
            rc3 = jnp.where(reset, rc_new, rc2)
            p4 = jnp.where(reset, pr, p3)
            d4 = jnp.where(reset, dr, d3)
            completed = jnp.where(reset, 0, completed)
            elapsed = jnp.where(reset, 0, elapsed)
            s2 = (rc3 * (nlocs + 1) + p4) * nlocs + d4
            if use_trace:  # trace dies with the episode (not at task resets)
                age = jnp.where(reset, 0, age)
                return (s2, q, completed, elapsed, age, ring, racc + rew)
            return (s2, q, completed, elapsed, racc + rew)

        return body

    run = _trainer_run(make_body, 3 if use_trace else 2, n_sites, num_steps,
                       R, rng_tape, ring_len=L if use_trace else 0)
    run.trace_len = L if use_trace else 1
    return run


def trace_weights(gamma, lam, trace_len):
    """``(L, coefs)``: the (γλ)^k trace weights as f32 constants, statically
    truncated where the weight is exactly zero (λ=0 then reduces BIT-exactly
    to the one-step trainer)."""
    L = int(trace_len)
    coefs = [np.float32((float(gamma) * float(lam)) ** k) for k in range(L)]
    L = max(k for k, c in enumerate(coefs) if float(c) != 0.0) + 1
    return L, coefs[:L]


def trace_scatter_args(ring, age, step, addr, wd, coefs):
    """Ring-write the current table address; return the combined L-deep
    update: ``(ring', age', idx [L, ...], w [L, ...], live [L, ...])``.

    Age-k entries read ring slot ``(step - k) mod L`` with the baked
    ``(γλ)^k`` weight; entries past the trace cut are not live (no update
    AND no duplicate count)."""
    L = len(coefs)
    ring = jax.lax.dynamic_update_index_in_dim(ring, addr, step % L, 0)
    age = jnp.minimum(age + 1, L)
    idx, w, live = [], [], []
    for k in range(L):
        slot = jax.lax.rem(step - k + L, L)
        idx.append(jax.lax.dynamic_index_in_dim(ring, slot, 0, keepdims=False))
        lv = k < age
        live.append(lv)
        w.append(jnp.where(lv, coefs[k] * wd, jnp.float32(0.0)))
    return ring, age, jnp.stack(idx), jnp.stack(w), jnp.stack(live)


def _rooms_common(env, kind):
    """Shared host-side set-up of the ROOMS / multistory trainers."""
    from ..core import Discrete

    if not isinstance(env.observation_space, Discrete):
        raise ValueError(f"{kind} needs a Discrete observation space")
    n_obs = int(env.observation_space.n)
    if n_obs > 512:
        raise ValueError(f"n_obs={n_obs} > 512: Q banks would exceed 32 rows")
    A = int(env.num_actions)
    if A * NSB > NB:
        raise ValueError(f"{A} actions exceed the {NB}-row Q bank")
    p_fail = 1.0 - float(env._cum[0][0])
    return n_obs, A, p_fail


def make_fused_q_trainer_rooms(env, num_envs: int, num_steps: int,
                               gamma: float = 0.99,
                               average_duplicates: bool = False,
                               rng_tape: bool = False):
    """Fused tabular Q-learning for :class:`Rooms` (fixed goal).

    Same contract as :func:`make_fused_q_trainer` —
    ``run(seed, lr, epsilon, agent, q) -> (agent', q', reward_sums)`` with
    ``agent`` the flat-cell array ``[B//128, 128]`` — generalized to ANY
    discrete observation model: the per-cell observation table is
    precomputed host-side by evaluating the env's own ``_obs_fn`` on every
    cell (mdp / hansen / room abstractions all work), and the trainer
    indexes the Q-table by observation.  Stochastic action failure is
    sampled from its generative process exactly as :mod:`.fused_rooms`;
    the Q update is indexed by the COMMANDED action (the agent's choice),
    matching the XLA agent.

    ``lr=0, epsilon=0`` turns the same executable into greedy POLICY
    EVALUATION of the supplied Q-table.
    """
    n_obs, A, p_fail = _rooms_common(env, "rooms Q trainer")
    if env.fixed_goal_yx is None:
        raise ValueError("rooms Q trainer requires a fixed goal")
    grid_np = env.grid_np
    H, GW = grid_np.shape
    ncells = H * GW
    disp = np.asarray(env._actions)
    disp_flat = jnp.asarray((disp[:, 0] * GW + disp[:, 1]).astype(np.int32))
    step_r, wall_r, goal_r = env.step_reward, env.wall_reward, env.goal_reward
    time_limit = int(env.time_limit)
    goal_flat = int(env.fixed_goal_yx[0] * GW + env.fixed_goal_yx[1])
    fixed_agent = env.fixed_agent_yx
    fixed_agent_flat = (
        int(fixed_agent[0] * GW + fixed_agent[1])
        if fixed_agent is not None else -1
    )
    walls = grid_np.reshape(-1) == -1
    cells_yx = np.stack(np.divmod(np.arange(ncells), GW), -1).astype(np.int32)
    obs_tab = jnp.asarray(
        obs_table(env, cells_yx, env.fixed_goal_yx, n_obs, walls)
    )
    is_wall = jnp.asarray(walls.astype(np.int32))
    valid_np = np.flatnonzero(~walls).astype(np.int32)
    n_valid = valid_np.size
    valid_cells = jnp.asarray(valid_np)
    R = rows_of(num_envs)
    gamma_f = float(gamma)

    # draw sites per step, in body-trace order: explore r24, random action,
    # failure r24, alt action, agent respawn (fixed spawn: no draw)
    n_sites = 4 + (0 if fixed_agent_flat >= 0 else 1)

    def make_body(rng, lr, eps):
        rbits, r24 = rng.rbits, rng.r24
        eps24 = (eps * jnp.float32(1 << 24)).astype(jnp.int32)

        def sample_agent(like):
            if fixed_agent_flat >= 0:
                return jnp.full(like.shape, fixed_agent_flat, jnp.int32)
            return valid_cells[rbits(n_valid)]

        def body(step, carry):
            agent, q, elapsed, racc = carry
            rng.begin_step(step)
            qidx = obs_tab[agent]
            vals = q_lookup(q, qidx, A)
            greedy, _ = first_argmax(vals)
            explore = r24() < eps24
            a_cmd = jnp.where(explore, rbits(A), greedy)
            q_taken = pick(vals, a_cmd)

            # stochastic failure from its generative process
            fail = r24() < jnp.int32(int(p_fail * (1 << 24)))
            alt = rbits(A - 1)
            executed = jnp.where(fail, alt + (alt >= a_cmd), a_cmd)
            proposed = jnp.clip(agent + disp_flat[executed], 0, ncells - 1)
            oob = is_wall[proposed] == 1
            agent2 = jnp.where(oob, agent, proposed)
            done = agent2 == goal_flat
            rew = jnp.where(
                done,
                jnp.float32(goal_r),
                jnp.where(oob, jnp.float32(wall_r), jnp.float32(step_r)),
            )
            elapsed = elapsed + 1
            trunc = elapsed > time_limit

            # TD target from the pre-reset next state
            _, next_v = first_argmax(q_lookup(q, obs_tab[agent2], A))
            target = rew + jnp.float32(gamma_f) * next_v * jnp.where(
                done, jnp.float32(0.0), jnp.float32(1.0)
            )
            td = target - q_taken
            q = scatter_update(q, a_cmd * (NSB * W) + qidx, lr * td,
                               average_duplicates)

            reset = done | trunc
            agent3 = jnp.where(reset, sample_agent(agent), agent2)
            elapsed = jnp.where(reset, 0, elapsed)
            return (agent3, q, elapsed, racc + rew)

        return body

    return _trainer_run(make_body, 1, n_sites, num_steps, R, rng_tape)


def make_fused_q_trainer_msrooms(env, num_envs: int, num_steps: int,
                                 gamma: float = 0.99,
                                 average_duplicates: bool = False,
                                 rng_tape: bool = False):
    """Fused tabular Q-learning for :class:`MultistoryFourRooms`.

    Same contract as :func:`make_fused_q_trainer_rooms` with the flat zyx
    cell index as state (``z*H*W + y*W + x``) and in-loop stair transit
    (stair_up teleports +floor to the SW square, stair_down -floor to NE —
    reference msrooms.py:419-428).  Requires a fixed goal; the observation
    table is precomputed through the env's own obs fn.
    """
    from ..envs.msrooms import (
        DOWNSTAIRS_SW,
        STAIR_DOWN,
        STAIR_UP,
        UPSTAIRS_NE,
        WALL,
    )

    n_obs, A, p_fail = _rooms_common(env, "msrooms Q trainer")
    if env.fixed_goal_zyx is None:
        raise ValueError("msrooms Q trainer requires a fixed goal")
    grid_np = env.grid_np
    Z, H, GW = grid_np.shape
    HW = H * GW
    ncells = Z * HW
    disp = np.asarray(env._actions)
    disp_flat = jnp.asarray((disp[:, 1] * GW + disp[:, 2]).astype(np.int32))
    step_r, wall_r, goal_r = env.step_reward, env.wall_reward, env.goal_reward
    time_limit = int(env.time_limit)
    gz, gy, gx = (int(v) for v in env.fixed_goal_zyx)
    goal_flat = gz * HW + gy * GW + gx
    sw_flat = DOWNSTAIRS_SW[0] * GW + DOWNSTAIRS_SW[1]
    ne_flat = UPSTAIRS_NE[0] * GW + UPSTAIRS_NE[1]

    cells_zyx = np.stack(
        np.unravel_index(np.arange(ncells), grid_np.shape), -1
    ).astype(np.int32)
    obs_tab = jnp.asarray(obs_table(
        env, cells_zyx, env.fixed_goal_zyx, n_obs,
        grid_np.reshape(-1) == WALL,
    ))
    cell_code = jnp.asarray(grid_np.reshape(-1).astype(np.int32))
    agent_cells = jnp.asarray(np.asarray(env.valid_agent_states, np.int32))
    n_agent = int(agent_cells.size)
    R = rows_of(num_envs)
    gamma_f = float(gamma)

    # draw sites per step, in body-trace order: explore r24, random action,
    # failure r24, alt action, agent respawn
    n_sites = 5

    def make_body(rng, lr, eps):
        rbits, r24 = rng.rbits, rng.r24
        eps24 = (eps * jnp.float32(1 << 24)).astype(jnp.int32)

        def body(step, carry):
            agent, q, elapsed, racc = carry
            rng.begin_step(step)
            qidx = obs_tab[agent]
            vals = q_lookup(q, qidx, A)
            greedy, _ = first_argmax(vals)
            explore = r24() < eps24
            a_cmd = jnp.where(explore, rbits(A), greedy)
            q_taken = pick(vals, a_cmd)

            fail = r24() < jnp.int32(int(p_fail * (1 << 24)))
            alt = rbits(A - 1)
            executed = jnp.where(fail, alt + (alt >= a_cmd), a_cmd)
            proposed = jnp.clip(agent + disp_flat[executed], 0, ncells - 1)
            oob = cell_code[proposed] == WALL
            agent2 = jnp.where(oob, agent, proposed)
            # stair transit (reference msrooms.py:419-428)
            acell = cell_code[agent2]
            z = agent2 // HW
            go_up = (acell == STAIR_UP) & ~oob
            go_down = (acell == STAIR_DOWN) & ~oob
            agent2 = jnp.where(go_up, (z + 1) * HW + sw_flat, agent2)
            agent2 = jnp.where(go_down, (z - 1) * HW + ne_flat, agent2)
            done = agent2 == goal_flat
            rew = jnp.where(
                done,
                jnp.float32(goal_r),
                jnp.where(oob, jnp.float32(wall_r), jnp.float32(step_r)),
            )
            elapsed = elapsed + 1
            trunc = elapsed > time_limit

            _, next_v = first_argmax(q_lookup(q, obs_tab[agent2], A))
            target = rew + jnp.float32(gamma_f) * next_v * jnp.where(
                done, jnp.float32(0.0), jnp.float32(1.0)
            )
            td = target - q_taken
            q = scatter_update(q, a_cmd * (NSB * W) + qidx, lr * td,
                               average_duplicates)

            reset = done | trunc
            spawn = agent_cells[rbits(n_agent)]
            agent3 = jnp.where(reset, spawn, agent2)
            elapsed = jnp.where(reset, 0, elapsed)
            return (agent3, q, elapsed, racc + rew)

        return body

    return _trainer_run(make_body, 1, n_sites, num_steps, R, rng_tape)


def q_to_banks(q: np.ndarray, nsb: int = NSB) -> np.ndarray:
    """[ns, na] table -> [nb, 128] banked layout
    (bank ``a*nsb + s>>7``, lane ``s&127``)."""
    ns, na = q.shape
    nb = max(NB, -(-(na * nsb) // 8) * 8)
    out = np.zeros((nb * W,), np.float32)
    for a in range(na):
        out[a * nsb * W : a * nsb * W + ns] = q[:, a]
    return out.reshape(nb, W)


def banks_to_q(banks: np.ndarray, ns: int, na: int = 5,
               nsb: int = NSB) -> np.ndarray:
    """Inverse of :func:`q_to_banks`."""
    flat = np.asarray(banks, np.float32).reshape(-1)
    return np.stack(
        [flat[a * nsb * W : a * nsb * W + ns] for a in range(na)], -1
    )
