"""Fused DOUBLE Q-learning (van Hasselt 2010) for classic Taxi.

Q-learning's max-bootstrap overestimates under noise; double Q keeps two
tables and decorrelates selection from evaluation:

    coin c ~ {A, B}                     (per env, per step)
    a* = argmax_a Q_c(s', a)            (select with the updating table)
    td = r + γ·Q_{1-c}(s', a*) - Q_c(s, a)
    Q_c[s, a] += lr·td

Both tables live STACKED in one ``[2·nb, 128]`` array, so the per-env coin
routes the update through the SAME scatter as the single-table trainer —
the coin is just one more term of the flat index (``c·nb·128 + a·NSP +
s``).  Behavior policy is epsilon-greedy on Q_A + Q_B (the standard
choice).

Same contract as :func:`.fused_qlearning.make_fused_q_trainer` (traced
lr/epsilon scalars, ``average_duplicates``, counter generator or tape).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .fused_qlearning import (
    W,
    _trainer_run,
    bank_geometry,
    first_argmax,
    pick,
    q_lookup,
    rows_of,
    scatter_update,
)

__all__ = ["make_fused_double_q_trainer"]


def make_fused_double_q_trainer(env, num_envs: int, num_steps: int,
                                gamma: float = 0.99,
                                average_duplicates: bool = True,
                                rng_tape: bool = False):
    """Build ``run(seed, lr, epsilon, s, q2) -> (s', q2', reward_sums)``.

    ``q2`` is the stacked ``[2·nb, 128]`` pair of banked tables (A then B;
    build with ``np.concatenate([q_to_banks(qa), q_to_banks(qb)])``).
    Classic-map fully-observable taxi.
    """
    t = env.tables
    nc = t.rows * t.cols
    if nc * 4 > W:
        raise ValueError("double-Q trainer supports the classic map only")
    nlocs, rows, cols = t.nlocs, t.rows, t.cols
    pd = (nlocs + 1) * nlocs
    ns = nc * pd
    nsb, nb = bank_geometry(ns, 5)
    n_pass = env.num_passengers
    time_limit = env.time_limit
    r_goal, r_bad, r_any = env.reward_goal, env.reward_bad, env.reward_any
    if not env._all_cells_valid:
        raise ValueError("double-Q trainer requires all cells navigable")
    R = rows_of(num_envs)
    cell_move = jnp.asarray(np.asarray(env._cell_move, np.int32).reshape(-1))
    loc_at = jnp.asarray(np.asarray(env._loc_at, np.int32).reshape(-1))
    gamma_f = float(gamma)

    # draw sites per step, in body-trace order: explore r24, random action,
    # table coin, task pn, task d0, reset row, reset col, reset pr, reset dr0
    n_sites = 9

    def make_body(rng, lr, eps):
        rbits, r24 = rng.rbits, rng.r24
        eps24 = (eps * jnp.float32(1 << 24)).astype(jnp.int32)

        def halves(q, s):
            """(vals_A, vals_B): per-action lookups in both stacked tables."""
            return q_lookup(q[:nb], s, 5, nsb), q_lookup(q[nb:], s, 5, nsb)

        def body(step, carry):
            s, q, completed, elapsed, racc = carry
            rng.begin_step(step)
            va, vb = halves(q, s)
            # behavior: eps-greedy on Q_A + Q_B
            greedy, _ = first_argmax([va[i] + vb[i] for i in range(5)])
            explore = r24() < eps24
            a = jnp.where(explore, rbits(5), greedy)
            coin = rbits(2)  # 0: update A, 1: update B
            q_taken = jnp.where(coin == 0, pick(va, a), pick(vb, a))

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
            task = goal & ~(done | trunc)
            pn = rbits(nlocs)
            d0 = rbits(nlocs - 1)
            dn = d0 + (d0 >= pn)
            p3 = jnp.where(task, pn, p2)
            d3 = jnp.where(task, dn, d)
            s_mid = (rc2 * (nlocs + 1) + p3) * nlocs + d3

            # --- double-Q target: select with the updating table,
            #     evaluate with the other one ---
            va2, vb2 = halves(q, s_mid)
            a_sel_a, _ = first_argmax(va2)
            a_sel_b, _ = first_argmax(vb2)
            a_sel = jnp.where(coin == 0, a_sel_a, a_sel_b)
            next_v = jnp.where(coin == 0, pick(vb2, a_sel), pick(va2, a_sel))
            target = rew + jnp.float32(gamma_f) * next_v * jnp.where(
                done, jnp.float32(0.0), jnp.float32(1.0)
            )
            td = target - q_taken

            # one scatter over the stacked tables: the coin picks the half
            q = scatter_update(q, coin * (nb * W) + a * (nsb * W) + s,
                               lr * td, average_duplicates)

            reset = done | trunc
            rc_new = rbits(rows) * cols + rbits(cols)
            pr = rbits(nlocs)
            dr0 = rbits(nlocs - 1)
            dr = dr0 + (dr0 >= pr)
            rc3 = jnp.where(reset, rc_new, rc2)
            p4 = jnp.where(reset, pr, p3)
            d4 = jnp.where(reset, dr, d3)
            completed = jnp.where(reset, 0, completed)
            elapsed = jnp.where(reset, 0, elapsed)
            s2 = (rc3 * (nlocs + 1) + p4) * nlocs + d4
            return (s2, q, completed, elapsed, racc + rew)

        return body

    return _trainer_run(make_body, 2, n_sites, num_steps, R, rng_tape)
