"""Fused Watkins Q(λ): eligibility-trace credit assignment in one loop.

Third algorithm family member after one-step Q (:mod:`.fused_qlearning`)
and actor-critic (:mod:`.fused_ac`).  Backward-view TD(λ) propagates each
TD error to RECENTLY visited state-actions, collapsing the credit-
assignment horizon from O(1/(1-γ)) sweeps to one:

    δ_t = r + γ·max_a Q(s',a)·(1-done) - Q(s_t,a_t)
    Q[s_{t-k}, a_{t-k}] += lr · (γλ)^k · δ_t      for k = 0..L-1

The classic obstruction to batching this is the trace tensor: a faithful
per-env eligibility trace is ``[B, ns, A]`` (82 MB at B=8192 on taxi).
The trainer instead keeps the TRUNCATED trace implicitly, as a ring buffer
of the last ``L`` visited table addresses per env (``[L, rows, 128]``
int32), and applies each step's L-deep update as ONE combined scatter-add
over ``L·B`` entries (:func:`.fused_qlearning.trace_scatter_args`).  Stale
or cut ring entries are dropped from both the update AND the duplicate
count.

Truncation at L is exact for (γλ)^k weights below f32 resolution anyway
(L=16 at γλ=0.45 is ~3e-6); Watkins' variant cuts the prior trace BEFORE
the update whenever the taken action is not greedy-valued (so an
exploratory step's δ reaches only the current pair), keeping effective
trace runs short under meaningful epsilon.  λ=0 reduces bit-exactly to
the one-step trainer (tested).

Same contract as the rest of the family: traced lr/epsilon scalars
(schedules reuse one executable), counter generator or injected tape
(``rng_tape=True``, bit-exact CPU oracle tests), ROOMS with a fixed goal
and any discrete observation model via the host-precomputed per-cell obs
table.  Traces do not span chunk boundaries (the age counter starts at
zero each ``run`` call) — with chunk_steps in the thousands the loss is
negligible.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .fused_qlearning import (
    NSB,
    W,
    _rooms_common,
    _trainer_run,
    first_argmax,
    obs_table,
    pick,
    q_lookup,
    rows_of,
    scatter_update,
    trace_scatter_args,
    trace_weights,
)

__all__ = ["make_fused_qlambda_trainer_rooms"]


def make_fused_qlambda_trainer_rooms(env, num_envs: int, num_steps: int,
                                     gamma: float = 0.99,
                                     lam: float = 0.9,
                                     trace_len: int = 8,
                                     average_duplicates: bool = False,
                                     watkins_cut: bool = True,
                                     rng_tape: bool = False):
    """Build ``run(seed, lr, epsilon, agent, q) -> (agent', q', reward_sums)``.

    ``lam``/``trace_len`` are compile-time (the (γλ)^k weights are baked
    constants); lr/epsilon are traced scalars.  ``watkins_cut=True`` clears
    the prior trace before the update at non-greedy-valued actions
    (Watkins' Q(λ) — keeps the off-policy max-bootstrap sound); ``False``
    gives Peng-style naive Q(λ), which propagates every δ through the full
    trace (biased off-policy, often stronger in practice under exploration).
    ``average_duplicates`` divides each entry's summed update by its
    duplicate count ACROSS ALL L·B trace contributions (batch-size-
    invariant steps); the default sums, which is the textbook accumulating-
    trace semantics within each env.
    """
    n_obs, A, p_fail = _rooms_common(env, "Q(λ) trainer")
    if env.fixed_goal_yx is None:
        raise ValueError("Q(λ) trainer requires a fixed goal")
    if not 1 <= int(trace_len) <= 64:
        raise ValueError(f"trace_len={trace_len} out of range [1, 64]")
    if not 0.0 <= float(lam) <= 1.0:
        raise ValueError(f"lam={lam} out of range [0, 1]")
    L, coefs = trace_weights(gamma, lam, trace_len)
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
            agent, q, age, elapsed, ring, racc = carry
            rng.begin_step(step)
            qidx = obs_tab[agent]
            vals = q_lookup(q, qidx, A)
            greedy, best_v = first_argmax(vals)
            explore = r24() < eps24
            a_cmd = jnp.where(explore, rbits(A), greedy)
            q_taken = pick(vals, a_cmd)

            # Watkins cut BEFORE the update: an exploratory step's δ is an
            # off-greedy-policy error — it must reach only the CURRENT pair,
            # never the prior trace (S&B's pseudocode cuts e via the next
            # action before the next update; applying δ_t to the past and
            # cutting after measurably collapses learning — the exploration
            # regret inflates Q along random walks).  Value-compare, not
            # index-compare: any argmax TIE counts as greedy.
            if watkins_cut:
                age = jnp.where(q_taken < best_v, 0, age)

            # env transition (== fused_rooms / step_vec)
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

            # δ from the pre-reset next state (off-policy max bootstrap)
            _, next_v = first_argmax(q_lookup(q, obs_tab[agent2], A))
            target = rew + jnp.float32(gamma_f) * next_v * jnp.where(
                done, jnp.float32(0.0), jnp.float32(1.0)
            )
            td = target - q_taken

            # ring-write the current pair, then one combined L·B scatter
            ring, age, idx, w, live = trace_scatter_args(
                ring, age, step, a_cmd * (NSB * W) + qidx, lr * td, coefs
            )
            q = scatter_update(q, idx, w, average_duplicates, live)

            # episode cut (the Watkins cut already happened pre-update)
            reset = done | trunc
            age = jnp.where(reset, 0, age)
            agent3 = jnp.where(reset, sample_agent(agent), agent2)
            elapsed = jnp.where(reset, 0, elapsed)
            return (agent3, q, age, elapsed, ring, racc + rew)

        return body

    run = _trainer_run(make_body, 2, n_sites, num_steps, R, rng_tape,
                       ring_len=L)
    run.trace_len = L
    return run
