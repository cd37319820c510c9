"""Fused multi-step Multistory-FourRooms rollout.

Extends the rooms rollout (:mod:`gym_po_tpu.ops.fused_rooms`) with the
third dimension: flat cell index over ``[Z, H, W_g]``, stair transit as
elementwise arithmetic (stair_up cell teleports +floor to the SW square,
stair_down -floor to the NE square — reference msrooms.py:419-428), and
separate agent (ground-floor) / goal (top-floor) spawn tables.
Dynamics match :meth:`MultistoryFourRooms.step_vec`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..envs.msrooms import DOWNSTAIRS_SW, STAIR_DOWN, STAIR_UP, UPSTAIRS_NE, WALL
from .kernel_rng import (
    KernelRNG, W, check_tape, fused_loop, record_episodes, tiling,
)

__all__ = ["make_fused_msrooms_rollout"]


def make_fused_msrooms_rollout(env, num_envs: int, num_steps: int,
                               rows_per_tile: int = 128,
                               episode_stats: bool = False,
                               rng_tape: bool = False):
    """Build ``run(seed, agent, goal) -> (agent', goal', reward_sums)``.

    ``agent``/``goal`` are flat zyx cell indices (``z*H*Wg + y*Wg + x``) laid
    out ``[num_envs // 128, 128]`` int32.
    ``episode_stats=True`` appends per-env completed-episode return/length
    sums and counts (in-loop ``RecordEpisodeStatistics`` analogue).
    ``rng_tape=True`` makes ``run`` take a trailing int32 tape argument of
    shape ``run.tape_shape`` replacing the counter generator (see
    :mod:`gym_po_tpu.ops.kernel_rng`).
    """
    grid_np = env.grid_np  # [Z, H, Wg], codes {0 wall, 1 room, 2 down, 3 up}
    Z, H, GW = grid_np.shape
    HW = H * GW
    ncells = Z * HW
    A = env.num_actions
    disp = np.asarray(env._actions)  # [A, 3] (dz=0, dy, dx)
    disp_flat = jnp.asarray((disp[:, 1] * GW + disp[:, 2]).astype(np.int32))
    p_fail = 1.0 - float(env._cum[0][0])
    step_r, wall_r, goal_r = env.step_reward, env.wall_reward, env.goal_reward
    time_limit = env.time_limit

    cell_code = jnp.asarray(grid_np.reshape(-1).astype(np.int32))
    agent_cells = jnp.asarray(np.asarray(env.valid_agent_states, np.int32))
    goal_cells = jnp.asarray(np.asarray(env.valid_goal_states, np.int32))
    n_agent = int(agent_cells.size)
    n_goal = int(goal_cells.size)

    fixed_goal = env.fixed_goal_zyx
    fixed_agent = env.fixed_agent_zyx
    fg_flat = (
        int(fixed_goal[0] * HW + fixed_goal[1] * GW + fixed_goal[2])
        if fixed_goal is not None
        else -1
    )
    fa_flat = (
        int(fixed_agent[0] * HW + fixed_agent[1] * GW + fixed_agent[2])
        if fixed_agent is not None
        else -1
    )
    sw_flat = DOWNSTAIRS_SW[0] * GW + DOWNSTAIRS_SW[1]
    ne_flat = UPSTAIRS_NE[0] * GW + UPSTAIRS_NE[1]
    R, grid_n = tiling(num_envs, rows_per_tile)

    # draw sites per step, in body-trace order: a_cmd, fail coin, alt,
    # goal respawn, agent respawn (fixed spawns consume no draw)
    n_sites = 3 + (0 if fg_flat >= 0 else 1) + (0 if fa_flat >= 0 else 1)

    def make_body(rng):
        rbits, runiform = rng.rbits, rng.runiform

        def sample(fixed_flat, cells, n, like):
            if fixed_flat >= 0:
                return jnp.full(like.shape, fixed_flat, jnp.int32)
            return cells[rbits(n)]

        def body(step, carry):
            agent, goal, elapsed, racc, stats = carry
            rng.begin_step(step)
            a_cmd = rbits(A)
            fail = runiform() < jnp.float32(p_fail)
            alt = rbits(A - 1)
            executed = jnp.where(fail, alt + (alt >= a_cmd), a_cmd)
            proposed = jnp.clip(agent + disp_flat[executed], 0, ncells - 1)
            oob = cell_code[proposed] == WALL
            agent2 = jnp.where(oob, agent, proposed)
            # stair transit when the agent moved (reference msrooms.py:419-428)
            acell = cell_code[agent2]
            z = agent2 // HW
            go_up = (acell == STAIR_UP) & ~oob
            go_down = (acell == STAIR_DOWN) & ~oob
            agent2 = jnp.where(go_up, (z + 1) * HW + sw_flat, agent2)
            agent2 = jnp.where(go_down, (z - 1) * HW + ne_flat, agent2)
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
            goal2 = jnp.where(
                reset, sample(fg_flat, goal_cells, n_goal, goal), goal
            )
            agent3 = jnp.where(
                reset, sample(fa_flat, agent_cells, n_agent, agent), agent2
            )
            elapsed = jnp.where(reset, 0, elapsed)
            return (agent3, goal2, elapsed, racc + rew, stats)

        return body

    slab = KernelRNG.tape_rows(n_sites, num_steps, R)
    tape_shape = (grid_n * slab, W)

    @jax.jit
    def run(seed, agent, goal, *tape):
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
