"""Fused multi-step ROOMS rollout.

Same design as :mod:`gym_po_tpu.ops.fused_taxi` (only the per-env state
lives across K steps, counter-based randomness, table lookups by flat cell
index):

* the walk grid and the valid-spawn list are flat tables indexed by cell;
* stochastic action failure is sampled directly from its generative process
  (fail with prob p → uniform over the other A-1 actions), which is exactly
  the reference's row-stochastic failure matrix (reference
  action_utils.py:38-48) without any table;
* dynamics identical to :meth:`Rooms.step_vec`: blocked moves stay, goal hit
  → goal_reward + reset, ``elapsed > time_limit`` truncation, masked resets
  of agent and goal from the valid-cell table.

Scope: random-policy rollouts; policy-in-the-loop uses the scan path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .kernel_rng import (
    KernelRNG, W, check_tape, fused_loop, record_episodes, tiling,
)

__all__ = ["make_fused_rooms_rollout"]


def make_fused_rooms_rollout(env, num_envs: int, num_steps: int,
                             rows_per_tile: int = 128,
                             episode_stats: bool = False,
                             rng_tape: bool = False):
    """Build ``run(seed, agent, goal) -> (agent', goal', reward_sums)``.

    ``agent``/``goal`` are flat cell indices laid out ``[num_envs//128, 128]``
    int32 (``state.agent_yx[:, 0] * grid_W + state.agent_yx[:, 1]``).
    ``episode_stats=True`` appends per-env completed-episode return/length
    sums and counts (in-loop ``RecordEpisodeStatistics`` analogue).
    ``rng_tape=True`` makes ``run`` take a trailing int32 tape argument of
    shape ``run.tape_shape`` replacing the counter generator (see
    :mod:`gym_po_tpu.ops.kernel_rng`).
    """
    grid_np = env.grid_np
    H, GW = grid_np.shape
    ncells = H * GW
    A = env.num_actions
    disp = np.asarray(env._actions)  # [A, 2] (dy, dx)
    disp_flat = jnp.asarray((disp[:, 0] * GW + disp[:, 1]).astype(np.int32))
    # recover the failure probability from the compiled cumsum matrix:
    # cum[0, 0] = P(executed=0 | commanded=0) = 1 - p
    p_fail = 1.0 - float(env._cum[0][0])
    step_r, wall_r, goal_r = env.step_reward, env.wall_reward, env.goal_reward
    time_limit = env.time_limit

    fixed_goal = env.fixed_goal_yx
    fixed_agent = env.fixed_agent_yx
    fixed_goal_flat = (
        int(fixed_goal[0] * GW + fixed_goal[1]) if fixed_goal is not None else -1
    )
    fixed_agent_flat = (
        int(fixed_agent[0] * GW + fixed_agent[1]) if fixed_agent is not None else -1
    )

    is_wall = jnp.asarray((grid_np.reshape(-1) == -1).astype(np.int32))
    valid_cells_np = np.flatnonzero(grid_np.reshape(-1) >= 0).astype(np.int32)
    n_valid = valid_cells_np.size
    valid_cells = jnp.asarray(valid_cells_np)
    R, grid_n = tiling(num_envs, rows_per_tile)

    # draw sites per step, in body-trace order: a_cmd, fail coin, alt,
    # goal respawn, agent respawn (fixed spawns consume no draw)
    n_sites = 3 + (0 if fixed_goal_flat >= 0 else 1) + (
        0 if fixed_agent_flat >= 0 else 1
    )

    def make_body(rng):
        rbits, runiform = rng.rbits, rng.runiform

        def sample(fixed_flat, like):
            if fixed_flat >= 0:
                return jnp.full(like.shape, fixed_flat, jnp.int32)
            return valid_cells[rbits(n_valid)]

        def body(step, carry):
            agent, goal, elapsed, racc, stats = carry
            rng.begin_step(step)
            a_cmd = rbits(A)
            # action failure from its generative process (== failure matrix)
            fail = runiform() < jnp.float32(p_fail)
            alt = rbits(A - 1)
            executed = jnp.where(fail, alt + (alt >= a_cmd), a_cmd)
            # proposed cell; y/x border crossing guarded by the wall ring
            # (every layout has a full wall border, so flat arithmetic is
            # safe: stepping off a row lands on a wall cell)
            proposed = jnp.clip(agent + disp_flat[executed], 0, ncells - 1)
            oob = is_wall[proposed] == 1
            agent2 = jnp.where(oob, agent, proposed)
            done = agent2 == goal
            rew = jnp.where(
                done,
                jnp.float32(goal_r),
                jnp.where(oob, jnp.float32(wall_r), jnp.float32(step_r)),
            )
            elapsed = elapsed + 1
            trunc = elapsed > time_limit
            reset = done | trunc
            if episode_stats:
                stats = record_episodes(stats, rew, reset, elapsed)
            goal2 = jnp.where(reset, sample(fixed_goal_flat, goal), goal)
            agent3 = jnp.where(reset, sample(fixed_agent_flat, agent), agent2)
            elapsed = jnp.where(reset, 0, elapsed)
            return (agent3, goal2, elapsed, racc + rew, stats)

        return body

    slab = KernelRNG.tape_rows(n_sites, num_steps, R)
    tape_shape = (grid_n * slab, W)

    @jax.jit
    def run(seed: jax.Array, agent: jax.Array, goal: jax.Array, *tape):
        if rng_tape:
            check_tape(tape[0], tape_shape)
        zi = jnp.zeros(agent.shape, jnp.int32)
        zf = jnp.zeros(agent.shape, jnp.float32)
        agent, goal, _, racc, stats = fused_loop(
            make_body, (agent, goal, zi, zf, (zf,) * 4), seed[0],
            tape[0] if rng_tape else None,
            num_steps=num_steps, n_sites=n_sites, R=R,
        )
        return (agent, goal, racc) + (stats[1:] if episode_stats else ())

    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run
