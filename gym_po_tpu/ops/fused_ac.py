"""Fused tabular actor-critic: softmax policy-gradient RL in one loop.

Companion to :mod:`.fused_qlearning` — a second algorithm family trained
entirely inside one ``fori_loop``.  One-step actor-critic (Sutton & Barto
ch. 13): a softmax policy over logits θ[obs, a] and a value table V[obs],
both updated every step from the TD error

    δ  = r + γ·V[obs']·(1-done) - V[obs]
    V[obs]    += α_v · δ
    θ[obs,a'] += α_π · δ · (1[a'=a] - π(a'|obs))   for every action a'

The ∇log π update touches ALL actions of the visited observation, so each
step runs A+1 scatter-adds (A policy banks + the value bank).  Action
sampling is Gumbel-max over the logits with strictly-interior uniforms
(``(bits24 + 0.5)·2⁻²⁴``, no ±inf in the transcendentals).  Duplicate
updates within a batch are averaged per visited observation
(batch-size-invariant step sizes, see the Q trainer's divergence note).

ROOMS with a fixed goal (any discrete observation model via the
host-precomputed per-cell obs table).  Counter generator → stats-matched,
not bit-exact, vs an XLA implementation with ``jax.random``; tape mode is
bit-exact against a NumPy oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .fused_qlearning import (
    NSB,
    W,
    _rooms_common,
    first_argmax,
    obs_table,
    q_lookup,
    rows_of,
    scatter_update,
)
from .kernel_rng import KernelRNG, check_tape

__all__ = ["make_fused_ac_trainer_rooms"]


def make_fused_ac_trainer_rooms(env, num_envs: int, num_steps: int,
                                gamma: float = 0.99,
                                rng_tape: bool = False):
    """Build ``run(seed, alpha_pi, alpha_v, theta, v, agent) ->
    (theta', v', agent', reward_sums)``.

    ``theta``: f32 ``[32, 128]`` banked logits (``q_to_banks`` layout);
    ``v``: f32 ``[32, 128]`` with only banks 0..3 used (value per obs);
    ``agent``: int32 flat-cell array ``[B//128, 128]``; step sizes are
    traced scalars so schedules reuse one executable.
    """
    n_obs, A, p_fail = _rooms_common(env, "AC trainer")
    if env.fixed_goal_yx is None:
        raise ValueError("AC trainer requires a fixed goal")
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

    # draw sites per step, in body-trace order: A gumbel uniforms, failure
    # r24, alt action, agent respawn (fixed spawn: no draw)
    n_sites = A + 2 + (0 if fixed_agent_flat >= 0 else 1)

    def make_body(rng, api, apv):
        rbits, r24 = rng.rbits, rng.r24

        def gumbel():
            # strictly-interior uniform keeps the double log finite
            u = (r24().astype(jnp.float32) + jnp.float32(0.5)) * jnp.float32(
                2.0**-24
            )
            return -jnp.log(-jnp.log(u))

        def sample_agent(like):
            if fixed_agent_flat >= 0:
                return jnp.full(like.shape, fixed_agent_flat, jnp.int32)
            return valid_cells[rbits(n_valid)]

        def body(step, carry):
            th, v, agent, elapsed, racc = carry
            rng.begin_step(step)
            qidx = obs_tab[agent]
            logits = q_lookup(th, qidx, A)
            # Gumbel-max sampling from the softmax policy
            pert = [logits[a] + gumbel() for a in range(A)]
            a_cmd, _ = first_argmax(pert)
            # softmax probabilities (stable: subtract the max)
            _, mx = first_argmax(logits)
            exps = [jnp.exp(logits[a] - mx) for a in range(A)]
            z = exps[0]
            for a in range(1, A):
                z = z + exps[a]
            probs = [e / z for e in exps]

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

            # one-step TD error from the pre-reset next state
            v_next = q_lookup(v, obs_tab[agent2], 1)[0]
            v_here = q_lookup(v, qidx, 1)[0]
            delta = rew + jnp.float32(gamma_f) * v_next * jnp.where(
                done, jnp.float32(0.0), jnp.float32(1.0)
            ) - v_here

            # critic: V[obs] += α_v δ (averaged per visited obs)
            v = scatter_update(v, qidx, apv * delta, True)
            # actor: θ[obs,a'] += α_π δ (1[a'=a] − π(a'))
            for ap in range(A):
                wgt = api * delta * (
                    jnp.where(a_cmd == ap, jnp.float32(1.0), jnp.float32(0.0))
                    - probs[ap]
                )
                th = scatter_update(th, ap * (NSB * W) + qidx, wgt, True)

            reset = done | trunc
            agent3 = jnp.where(reset, sample_agent(agent), agent2)
            elapsed = jnp.where(reset, 0, elapsed)
            return (th, v, agent3, elapsed, racc + rew)

        return body

    tape_shape = (KernelRNG.tape_rows(n_sites, num_steps, R), W)

    @jax.jit
    def run(seed, alpha_pi, alpha_v, theta, v, agent, *tape):
        if rng_tape:
            check_tape(tape[0], tape_shape)
        api = jnp.asarray(alpha_pi, jnp.float32).reshape(())
        apv = jnp.asarray(alpha_v, jnp.float32).reshape(())
        init = (theta, v, agent, jnp.zeros(agent.shape, jnp.int32),
                jnp.zeros(agent.shape, jnp.float32))
        # the generator follows the env layout (the carry's third entry)
        rng = KernelRNG.for_layout(seed[0], agent.shape, num_steps,
                                   tape=tape[0] if rng_tape else None)
        th, v, agent, _, racc = jax.lax.fori_loop(
            0, num_steps, make_body(rng, api, apv), init
        )
        rng.finalize(n_sites)
        return th, v, agent, racc

    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run
