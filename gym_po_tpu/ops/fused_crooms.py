"""Fused multi-step continuous-ROOMS rollout.

Float-state member of the fused family: positions/velocities are f32
``[B/128, 128]`` arrays; Gaussian action and wall-resample noise are
generated in-loop with Box-Muller over the counter generator
(``z = sqrt(-2 ln u1) * cos(2 pi u2)``).  Dynamics match
:meth:`CRooms.step_vec` for the continuous ('yx') action type: noisy action
(+ optional velocity integration), position clip, wall test on the
discretized cell, in-cell resample on wall hits (one-ULP boundary clamp),
goal-distance termination, truncation, masked resets at cell centers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..envs.crooms import MAX_VELOCITY
from .kernel_rng import (
    KernelRNG, W, check_tape, fused_loop, record_episodes, tiling,
)

__all__ = ["make_fused_crooms_rollout"]


def make_fused_crooms_rollout(env, num_envs: int, num_steps: int,
                              rows_per_tile: int = 128,
                              episode_stats: bool = False,
                              rng_tape: bool = False):
    """Build ``run(seed, py, px, vy, vx, gy, gx) -> (state'..., reward_sums)``.

    All six state arrays are f32 ``[num_envs // 128, 128]``.
    Supports ``action_type='yx'`` (the continuous default).
    ``episode_stats=True`` appends per-env completed-episode return/length
    sums and counts (in-loop ``RecordEpisodeStatistics`` analogue).
    ``rng_tape=True`` makes ``run`` take a trailing int32 tape argument of
    shape ``run.tape_shape`` replacing the counter generator (see
    :mod:`gym_po_tpu.ops.kernel_rng`).
    """
    if env.action_type != "yx":
        raise ValueError("fused crooms rollout supports action_type='yx'")
    grid_np = env.grid_np
    H, GW = grid_np.shape
    cs = float(env.cell_size)
    std = float(env.action_std)
    power = float(env.action_power)
    use_vel = env.use_velocity
    thr2 = float(env.goal_threshold) ** 2
    step_r, wall_r, goal_r = env.step_reward, env.wall_reward, env.goal_reward
    time_limit = env.time_limit
    pos_hi_y = float(env._pos_hi[0])
    pos_hi_x = float(env._pos_hi[1])

    is_wall = jnp.asarray((grid_np.reshape(-1) == -1).astype(np.int32))
    valid_cells_np = np.flatnonzero(grid_np.reshape(-1) >= 0).astype(np.int32)
    n_valid = valid_cells_np.size
    valid_cells = jnp.asarray(valid_cells_np)

    fixed_goal = env.fixed_goal_coord  # coords (reference cell_size=1 quirk)
    fg = (float(fixed_goal[0]), float(fixed_goal[1])) if fixed_goal is not None else None
    fixed_agent = env.fixed_agent_coord
    fa = (float(fixed_agent[0]), float(fixed_agent[1])) if fixed_agent is not None else None
    R, grid_n = tiling(num_envs, rows_per_tile)

    # draw sites per step, in body-trace order: ay (uniform + 2-draw
    # normal), ax (same), wall-resample ry/rx normals (2 draws each),
    # goal respawn, agent respawn (fixed spawns consume no draw)
    n_sites = 10 + (0 if fg is not None else 1) + (0 if fa is not None else 1)

    def make_body(rng):
        rbits, runiform, rnormal = rng.rbits, rng.runiform, rng.rnormal

        def sample_coords(fixed, like):
            if fixed is not None:
                return (
                    jnp.full(like.shape, fixed[0], jnp.float32),
                    jnp.full(like.shape, fixed[1], jnp.float32),
                )
            cell = valid_cells[rbits(n_valid)]
            # cell center with implicit cell_size=1 (reference quirk,
            # crooms.py:240-244)
            cy = (cell // GW).astype(jnp.float32) + 0.5
            cx = (cell % GW).astype(jnp.float32) + 0.5
            return cy, cx

        def wall_at(y, x):
            cyi = jnp.floor(y / cs).astype(jnp.int32)
            cxi = jnp.floor(x / cs).astype(jnp.int32)
            return is_wall[cyi * GW + cxi] == 1

        def body(step, carry):
            py, px, vy, vx, gy, gx, elapsed, racc, stats = carry
            rng.begin_step(step)
            ay = (runiform() * 2.0 - 1.0 + rnormal() * std) * power
            ax = (runiform() * 2.0 - 1.0 + rnormal() * std) * power
            if use_vel:
                vy2 = jnp.clip(vy + ay, -MAX_VELOCITY, MAX_VELOCITY)
                vx2 = jnp.clip(vx + ax, -MAX_VELOCITY, MAX_VELOCITY)
                ny = py + vy2
                nx = px + vx2
            else:
                vy2, vx2 = vy, vx
                ny = py + ay
                nx = px + ax
            ny = jnp.clip(ny, 0.0, jnp.float32(pos_hi_y))
            nx = jnp.clip(nx, 0.0, jnp.float32(pos_hi_x))
            oob = wall_at(ny, nx)
            # wall hit: resample within the CURRENT cell, zero velocity
            ceny = jnp.floor(py / cs) * cs + cs / 2
            cenx = jnp.floor(px / cs) * cs + cs / 2
            hiy = jnp.nextafter(ceny + cs / 2, jnp.float32(0.0))
            hix = jnp.nextafter(cenx + cs / 2, jnp.float32(0.0))
            # NOTE: both resample normals are drawn every step (fixed draw
            # structure) even though they only land on wall hits
            ry = jnp.clip(ceny + rnormal() * 0.5, ceny - cs / 2, hiy)
            rx = jnp.clip(cenx + rnormal() * 0.5, cenx - cs / 2, hix)
            py2 = jnp.where(oob, ry, ny)
            px2 = jnp.where(oob, rx, nx)
            vy3 = jnp.where(oob, 0.0, vy2)
            vx3 = jnp.where(oob, 0.0, vx2)
            dy = py2 - gy
            dx = px2 - gx
            done = dy * dy + dx * dx <= jnp.float32(thr2)
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
            ngy, ngx = sample_coords(fg, gy)
            nay, nax = sample_coords(fa, py)
            gy2 = jnp.where(reset, ngy, gy)
            gx2 = jnp.where(reset, ngx, gx)
            py3 = jnp.where(reset, nay, py2)
            px3 = jnp.where(reset, nax, px2)
            vy4 = jnp.where(reset, 0.0, vy3)
            vx4 = jnp.where(reset, 0.0, vx3)
            elapsed = jnp.where(reset, 0, elapsed)
            return (py3, px3, vy4, vx4, gy2, gx2, elapsed, racc + rew, stats)

        return body

    slab = KernelRNG.tape_rows(n_sites, num_steps, R)
    tape_shape = (grid_n * slab, W)

    @jax.jit
    def run(seed, py, px, vy, vx, gy, gx, *tape):
        if rng_tape:
            check_tape(tape[0], tape_shape)
        zi = jnp.zeros(py.shape, jnp.int32)
        zf = jnp.zeros(py.shape, jnp.float32)
        *state, _, racc, stats = fused_loop(
            make_body, (py, px, vy, vx, gy, gx, zi, zf, (zf,) * 4), seed[0],
            tape[0] if rng_tape else None,
            num_steps=num_steps, n_sites=n_sites, R=R,
        )
        return (*state, racc) + (stats[1:] if episode_stats else ())

    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run
