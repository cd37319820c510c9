"""Fused tabular Q-learning on CONTINUOUS-state rooms (CRooms).

Completes the fused trainer family (:mod:`.fused_qlearning`,
:mod:`.fused_ac`) with continuous dynamics: positions are f32 arrays
stepped with the discrete-action CRooms physics (failure-matrix action
resample, per-component Gaussian action noise via Box-Muller, position
clip, wall test on the discretized cell, in-cell resample on wall hits —
reference ``crooms.py:175-331``), while the Q-table is indexed by the
DISCRETIZED observation (the env's own obs fn evaluated at cell centers,
any discrete obs model).  Same scatter-add update, traced lr/epsilon
scalars, and mean-duplicate option as the discrete trainers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..envs.crooms import MAX_VELOCITY
from .fused_qlearning import (
    NSB,
    W,
    _rooms_common,
    first_argmax,
    obs_table,
    pick,
    q_lookup,
    rows_of,
    scatter_update,
)
from .kernel_rng import KernelRNG, check_tape, fused_loop

__all__ = ["make_fused_q_trainer_crooms"]


def make_fused_q_trainer_crooms(env, num_envs: int, num_steps: int,
                                gamma: float = 0.99,
                                average_duplicates: bool = True,
                                rng_tape: bool = False):
    """Build ``run(seed, lr, epsilon, py, px, vy, vx, q) ->
    (py', px', vy', vx', q', reward_sums)``.

    Positions/velocities are f32 ``[B//128, 128]`` arrays (pass zero
    velocities when ``use_velocity`` is off — they ride along untouched);
    ``q`` is the ``[32, 128]`` banked table.  Requires a discrete
    ``action_type`` ('cardinal'/'ordinal'), a Discrete obs space, and a
    fixed goal.
    """
    if env.action_type == "yx":
        raise ValueError("Q trainer needs a discrete action_type "
                         "('cardinal'/'ordinal'), not continuous 'yx'")
    n_obs, A, p_fail = _rooms_common(env, "crooms Q trainer")
    if env.fixed_goal_coord is None:
        raise ValueError("crooms Q trainer requires a fixed goal")
    grid_np = env.grid_np
    H, GW = grid_np.shape
    cs = float(env.cell_size)
    std = float(env.action_std)
    power = float(env.action_power)
    use_vel = bool(env.use_velocity)
    thr2 = float(env.goal_threshold) ** 2
    step_r, wall_r, goal_r = env.step_reward, env.wall_reward, env.goal_reward
    time_limit = int(env.time_limit)
    pos_hi_y = float(env._pos_hi[0])
    pos_hi_x = float(env._pos_hi[1])
    gy_f, gx_f = (float(v) for v in env.fixed_goal_coord)
    disp = np.asarray(env._disp, np.float32)  # [A, 2]
    disp_y = jnp.asarray(disp[:, 0])
    disp_x = jnp.asarray(disp[:, 1])
    fixed_agent = env.fixed_agent_coord
    fa = (
        (float(fixed_agent[0]), float(fixed_agent[1]))
        if fixed_agent is not None else None
    )

    # per-cell observation table via the env's own obs fn at cell centers
    walls = grid_np.reshape(-1) == -1
    iy, ix = np.divmod(np.arange(H * GW), GW)
    centers = np.stack([(iy + 0.5) * cs, (ix + 0.5) * cs], -1).astype(
        np.float32
    )
    obs_tab = jnp.asarray(obs_table(
        env, centers, np.asarray(env.fixed_goal_coord, np.float32), n_obs,
        walls,
    ))
    is_wall = jnp.asarray(walls.astype(np.int32))
    valid_np = np.flatnonzero(~walls).astype(np.int32)
    n_valid = valid_np.size
    valid_cells = jnp.asarray(valid_np)
    R = rows_of(num_envs)
    gamma_f = float(gamma)

    # draw sites per step, in body-trace order: explore r24, random action,
    # failure r24, alt action, ay/ax normals (2 each), wall-resample ry/rx
    # normals (2 each), agent respawn (fixed spawn: no draw)
    n_sites = 12 + (0 if fa is not None else 1)

    def cell_of(y, x):
        cyi = jnp.floor(y / cs).astype(jnp.int32)
        cxi = jnp.floor(x / cs).astype(jnp.int32)
        return cyi * GW + cxi

    def make_body(rng, lr, eps):
        rbits, r24, rnormal = rng.rbits, rng.r24, rng.rnormal
        eps24 = (eps * jnp.float32(1 << 24)).astype(jnp.int32)

        def sample_agent_coords(like):
            if fa is not None:
                return (
                    jnp.full(like.shape, fa[0], jnp.float32),
                    jnp.full(like.shape, fa[1], jnp.float32),
                )
            cell = valid_cells[rbits(n_valid)]
            # cell center with implicit cell_size=1 (reference quirk,
            # crooms.py:240-244)
            cy = (cell // GW).astype(jnp.float32) + 0.5
            cx = (cell % GW).astype(jnp.float32) + 0.5
            return cy, cx

        def body(step, carry):
            py, px, vy, vx, q, elapsed, racc = carry
            rng.begin_step(step)
            qidx = obs_tab[cell_of(py, px)]
            vals = q_lookup(q, qidx, A)
            greedy, _ = first_argmax(vals)
            explore = r24() < eps24
            a_cmd = jnp.where(explore, rbits(A), greedy)
            q_taken = pick(vals, a_cmd)

            # effective action (reference crooms.py:182-198): failure
            # resample -> displacement -> + Gaussian noise, x power
            fail = r24() < jnp.int32(int(p_fail * (1 << 24)))
            alt = rbits(A - 1)
            executed = jnp.where(fail, alt + (alt >= a_cmd), a_cmd)
            ay = (disp_y[executed] + rnormal() * std) * power
            ax = (disp_x[executed] + rnormal() * std) * power
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
            oob = is_wall[cell_of(ny, nx)] == 1
            ceny = jnp.floor(py / cs) * cs + cs / 2
            cenx = jnp.floor(px / cs) * cs + cs / 2
            hiy = jnp.nextafter(ceny + cs / 2, jnp.float32(0.0))
            hix = jnp.nextafter(cenx + cs / 2, jnp.float32(0.0))
            ry = jnp.clip(ceny + rnormal() * 0.5, ceny - cs / 2, hiy)
            rx = jnp.clip(cenx + rnormal() * 0.5, cenx - cs / 2, hix)
            py2 = jnp.where(oob, ry, ny)
            px2 = jnp.where(oob, rx, nx)
            vy3 = jnp.where(oob, 0.0, vy2)
            vx3 = jnp.where(oob, 0.0, vx2)
            ddy = py2 - jnp.float32(gy_f)
            ddx = px2 - jnp.float32(gx_f)
            done = ddy * ddy + ddx * ddx <= jnp.float32(thr2)
            rew = jnp.where(
                done,
                jnp.float32(goal_r),
                jnp.where(oob, jnp.float32(wall_r), jnp.float32(step_r)),
            )
            elapsed = elapsed + 1
            trunc = elapsed > time_limit

            # TD target from the pre-reset next observation
            _, next_v = first_argmax(q_lookup(q, obs_tab[cell_of(py2, px2)], A))
            target = rew + jnp.float32(gamma_f) * next_v * jnp.where(
                done, jnp.float32(0.0), jnp.float32(1.0)
            )
            td = target - q_taken
            q = scatter_update(q, a_cmd * (NSB * W) + qidx, lr * td,
                               average_duplicates)

            reset = done | trunc
            nay, nax = sample_agent_coords(py)
            py3 = jnp.where(reset, nay, py2)
            px3 = jnp.where(reset, nax, px2)
            vy4 = jnp.where(reset, 0.0, vy3)
            vx4 = jnp.where(reset, 0.0, vx3)
            elapsed = jnp.where(reset, 0, elapsed)
            return (py3, px3, vy4, vx4, q, elapsed, racc + rew)

        return body

    tape_shape = (KernelRNG.tape_rows(n_sites, num_steps, R), W)

    @jax.jit
    def run(seed, lr, epsilon, py, px, vy, vx, q, *tape):
        if rng_tape:
            check_tape(tape[0], tape_shape)
        lr = jnp.asarray(lr, jnp.float32).reshape(())
        eps = jnp.asarray(epsilon, jnp.float32).reshape(())
        init = (py, px, vy, vx, q, jnp.zeros(py.shape, jnp.int32),
                jnp.zeros(py.shape, jnp.float32))
        out = fused_loop(
            lambda rng: make_body(rng, lr, eps), init, seed[0],
            tape[0] if rng_tape else None, num_steps=num_steps,
            n_sites=n_sites,
        )
        return out[:5] + (out[-1],)

    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run
