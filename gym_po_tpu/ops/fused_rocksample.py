"""Fused multi-step RockSample rollout.

Same design as the taxi/rooms fused rollouts.  RockSample's per-env state
packs exactly into two int32 lanes:

* ``pos``  — flat cell index (y * cols + x);
* ``mask`` — rock-quality bitmask (bit i set = rock i is good), so sampling
  a rock is one AND/ANDN and an episode reset is one draw of k random bits.

Lookups (rock-at-cell, rock coordinates) are flat tables; movement, the
exit-east terminal, the sensor accuracy ``eta = 0.5 * (1 + 2^(-d/d0))``,
and all rewards are elementwise.  Dynamics match
:meth:`RockSample.step_vec`; the observation (reading) is not materialized
— rollout-only, like the other fused rollouts.

Requires ``num_rocks <= 30`` (int32 bitmask).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..envs.rocksample import (
    BAD_PENALTY,
    EXIT_REWARD,
    GOOD_REWARD,
    ILLEGAL_SAMPLE_PENALTY,
)
from .kernel_rng import (
    KernelRNG, W, check_tape, fused_loop, record_episodes, tiling,
)

__all__ = ["make_fused_rocksample_rollout"]


def make_fused_rocksample_rollout(env, num_envs: int, num_steps: int,
                                  rows_per_tile: int = 128,
                                  episode_stats: bool = False,
                                  rng_tape: bool = False):
    """Build ``run(seed, pos, mask) -> (pos', mask', reward_sums)``.

    ``pos`` is the flat cell index and ``mask`` the rock-quality bitmask,
    both int32 ``[num_envs // 128, 128]``.
    ``episode_stats=True`` appends per-env completed-episode return/length
    sums and counts (in-loop ``RecordEpisodeStatistics`` analogue).
    ``rng_tape=True`` makes ``run`` take a trailing int32 tape argument of
    shape ``run.tape_shape`` replacing the counter generator (see
    :mod:`gym_po_tpu.ops.kernel_rng`).
    """
    rows, cols, k = env.rows, env.cols, env.k
    if k > 30:
        raise ValueError("fused rollout packs rock quality into int32: k <= 30")
    d0 = env.d0
    time_limit = env.time_limit
    n_actions = 5 + k
    init_flat = int(np.asarray(env._init_pos)[0]) * cols + int(
        np.asarray(env._init_pos)[1]
    )

    # tables: rock index at cell (k = sentinel), rock y, rock x
    rp = env.rock_positions_np
    rock_at_np = np.full((rows * cols,), k, np.int32)
    rock_at_np[rp[:, 0] * cols + rp[:, 1]] = np.arange(k)
    rock_at = jnp.asarray(rock_at_np)
    rock_y = jnp.asarray(rp[:, 0].astype(np.int32))
    rock_x = jnp.asarray(rp[:, 1].astype(np.int32))
    R, grid_n = tiling(num_envs, rows_per_tile)
    full_mask = (1 << k) - 1

    # draw sites per step, in body-trace order: action, sensor uniform,
    # reset rock-quality mask
    n_sites = 3

    def make_body(rng):
        rbits, runiform = rng.rbits, rng.runiform

        def body(step, carry):
            pos, mask, elapsed, racc, stats = carry
            rng.begin_step(step)
            a = rbits(n_actions)
            y = pos // cols
            x = pos % cols
            # movement (N=0 E=1 S=2 W=3); exit east off-grid terminates
            dy = jnp.where(a == 0, -1, jnp.where(a == 2, 1, 0))
            dx = jnp.where(a == 1, 1, jnp.where(a == 3, -1, 0))
            is_move = a < 4
            ny = jnp.where(is_move, y + dy, y)
            nx = jnp.where(is_move, x + dx, x)
            exited = is_move & (nx >= cols)
            inside = (ny >= 0) & (ny < rows) & (nx >= 0) & (nx < cols)
            pos2 = jnp.where(inside, ny * cols + nx, pos)
            # sampling via the rock bitmask
            ridx_here = rock_at[pos]  # rock at CURRENT cell or k
            on_rock = ridx_here < k
            here_bit = (mask >> jnp.minimum(ridx_here, k - 1)) & 1
            is_sample = a == 4
            sample_rew = jnp.where(
                on_rock,
                jnp.where(here_bit == 1, jnp.float32(GOOD_REWARD),
                          jnp.float32(BAD_PENALTY)),
                jnp.float32(ILLEGAL_SAMPLE_PENALTY),
            )
            # clear the rock's bit when sampled on a rock
            clear = jnp.where(
                is_sample & on_rock, 1 << jnp.minimum(ridx_here, k - 1), 0
            )
            mask2 = mask & ~clear
            # sensing consumes a uniform every step (fixed-shape), result
            # unused in rollout; matches step_vec's draw structure
            ridx_chk = jnp.clip(a - 5, 0, k - 1)
            cy = rock_y[ridx_chk].astype(jnp.float32)
            cx = rock_x[ridx_chk].astype(jnp.float32)
            fy = y.astype(jnp.float32) - cy
            fx = x.astype(jnp.float32) - cx
            dist = jnp.sqrt(fy * fy + fx * fx)
            eta = 0.5 * (1.0 + jnp.exp2(-dist / jnp.float32(d0)))
            _ = runiform() < eta  # sensor draw (reading not materialized)
            rew = jnp.where(
                exited,
                jnp.float32(EXIT_REWARD),
                jnp.where(is_sample, sample_rew, 0.0),
            )
            elapsed = elapsed + 1
            trunc = elapsed >= time_limit
            reset = exited | trunc
            if episode_stats:
                stats = record_episodes(stats, rew, reset, elapsed)
            new_mask = rbits(full_mask + 1)
            pos3 = jnp.where(reset, init_flat, pos2)
            mask3 = jnp.where(reset, new_mask, mask2)
            elapsed = jnp.where(reset, 0, elapsed)
            return (pos3, mask3, elapsed, racc + rew, stats)

        return body

    slab = KernelRNG.tape_rows(n_sites, num_steps, R)
    tape_shape = (grid_n * slab, W)

    @jax.jit
    def run(seed, pos, mask, *tape):
        if rng_tape:
            check_tape(tape[0], tape_shape)
        zi = jnp.zeros(pos.shape, jnp.int32)
        zf = jnp.zeros(pos.shape, jnp.float32)
        pos, mask, _, racc, stats = fused_loop(
            make_body, (pos, mask, zi, zf, (zf,) * 4), seed[0],
            tape[0] if rng_tape else None,
            num_steps=num_steps, n_sites=n_sites, R=R,
        )
        return (pos, mask, racc) + (stats[1:] if episode_stats else ())

    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run
