"""Fused multi-step rollouts for the JAX ant-task surrogates.

TagContinuous is the most randomness-hungry env in the suite (21 per-env
draws per step: 2 action, 1 flee mode, 2 agent spawn, 16 target-candidate
spawn).  The fused rollout draws all of it from the counter generator
(:mod:`.kernel_rng`), with no key splitting between steps — the same design
as :mod:`.fused_crooms`.

Semantics match :meth:`TagContinuous.step_vec` / :meth:`HeavenHellContinuous.
step_vec` under the uniform-random policy (task constants from reference
``ant_tag.py:27-158`` and ``ant_heaven_hell.py:29-137``): clipped point-mass
moves, the target's {away, two orthogonals, stay} flee rule cancelled at the
cage edge, tag/terminal radii, 8-candidate >= 5.0 target spawn with the
farthest-corner fallback, T-maze free-space clamp, priest-revealed heaven.
Like the rest of the fused family the rollouts are *stats-matched* (not
bit-exact) against the scan path — they draw from the counter generator,
not threefry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..envs.tag_jax import (
    BAR,
    CAGE,
    HH_SITES,
    HH_RADIUS,
    MIN_SPAWN_DIST,
    STEM,
    TAG_RADIUS,
    TARGET_STEP,
)
from .kernel_rng import (
    KernelRNG, W, check_tape, fused_loop, record_episodes, tiling,
)

__all__ = ["make_fused_tag_rollout", "make_fused_heavenhell_rollout"]

_CORNERS = np.array(
    [[-CAGE, -CAGE], [-CAGE, CAGE], [CAGE, -CAGE], [CAGE, CAGE]], np.float32
)


def make_fused_tag_rollout(env, num_envs: int, num_steps: int,
                           rows_per_tile: int = 128,
                           episode_stats: bool = False,
                           rng_tape: bool = False):
    """Build ``run(seed, a0, a1, t0, t1) -> (a0', a1', t0', t1', reward_sums)``.

    All five arrays are f32 ``[num_envs // 128, 128]`` (agent xy, target xy
    component tiles; reward sums accumulated over ``num_steps``).
    ``episode_stats=True`` appends per-env completed-episode return/length
    sums and counts (in-loop ``RecordEpisodeStatistics`` analogue).
    ``rng_tape=True`` makes ``run`` take a trailing int32 tape argument of
    shape ``run.tape_shape`` replacing the counter generator (see
    :mod:`gym_po_tpu.ops.kernel_rng`).
    """
    R, grid_n = tiling(num_envs, rows_per_tile)
    speed = float(env.agent_speed)
    time_limit = int(env.time_limit)
    # draw sites per step, in body-trace order: 2 agent-move uniforms, flee
    # mode, respawn agent xy (2), respawn target candidates (8 x 2)
    n_sites = 21

    def make_body(rng):
        rbits, runiform = rng.rbits, rng.runiform

        def rcage():
            return runiform() * jnp.float32(2 * CAGE) - jnp.float32(CAGE)

        def spawn_target(a0, a1):
            """8 uniform candidates, first with dist >= MIN_SPAWN_DIST wins;
            farthest cage corner as the always-valid fallback (>= 6.3)."""
            # farthest corner per env (4 static corners, running max)
            fc0 = jnp.full(a0.shape, _CORNERS[0, 0], jnp.float32)
            fc1 = jnp.full(a0.shape, _CORNERS[0, 1], jnp.float32)
            best = (fc0 - a0) ** 2 + (fc1 - a1) ** 2
            for c0, c1 in _CORNERS[1:]:
                d = (c0 - a0) ** 2 + (c1 - a1) ** 2
                better = d > best
                fc0 = jnp.where(better, c0, fc0)
                fc1 = jnp.where(better, c1, fc1)
                best = jnp.maximum(best, d)
            out0, out1 = fc0, fc1
            found = jnp.zeros(a0.shape, jnp.bool_)
            for _ in range(8):
                c0 = rcage()
                c1 = rcage()
                ok = (c0 - a0) ** 2 + (c1 - a1) ** 2 >= jnp.float32(
                    MIN_SPAWN_DIST**2
                )
                pick = ok & ~found
                out0 = jnp.where(pick, c0, out0)
                out1 = jnp.where(pick, c1, out1)
                found = found | ok
            return out0, out1

        def body(step, carry):
            a0, a1, t0, t1, elapsed, racc, stats = carry
            rng.begin_step(step)
            # agent: clipped point-mass move under the uniform-random policy
            a0 = jnp.clip(a0 + (runiform() * 2.0 - 1.0) * speed, -CAGE, CAGE)
            a1 = jnp.clip(a1 + (runiform() * 2.0 - 1.0) * speed, -CAGE, CAGE)
            # target flee rule (reference ant_tag.py:105-123)
            mode = rbits(4)
            w0 = t0 - a0
            w1 = t1 - a1
            nrm = jnp.sqrt(w0 * w0 + w1 * w1)
            inv = jnp.where(nrm > 1e-9, 1.0 / jnp.maximum(nrm, 1e-9), 0.0)
            u0 = w0 * inv
            u1 = w1 * inv
            s0 = jnp.where(
                mode == 0, u0, jnp.where(mode == 1, -u1, jnp.where(mode == 2, u1, 0.0))
            )
            s1 = jnp.where(
                mode == 0, u1, jnp.where(mode == 1, u0, jnp.where(mode == 2, -u0, 0.0))
            )
            n0 = t0 + s0 * jnp.float32(TARGET_STEP)
            n1 = t1 + s1 * jnp.float32(TARGET_STEP)
            oc = (jnp.abs(n0) > CAGE) | (jnp.abs(n1) > CAGE)
            t0 = jnp.where(oc, t0, n0)
            t1 = jnp.where(oc, t1, n1)
            d2 = (a0 - t0) ** 2 + (a1 - t1) ** 2
            done = d2 <= jnp.float32(TAG_RADIUS**2)
            rew = done.astype(jnp.float32)
            elapsed = elapsed + 1
            reset = done | (elapsed >= time_limit)
            if episode_stats:
                stats = record_episodes(stats, rew, reset, elapsed)
            na0 = rcage()
            na1 = rcage()
            nt0, nt1 = spawn_target(na0, na1)
            a0 = jnp.where(reset, na0, a0)
            a1 = jnp.where(reset, na1, a1)
            t0 = jnp.where(reset, nt0, t0)
            t1 = jnp.where(reset, nt1, t1)
            elapsed = jnp.where(reset, 0, elapsed)
            return (a0, a1, t0, t1, elapsed, racc + rew, stats)

        return body

    slab = KernelRNG.tape_rows(n_sites, num_steps, R)
    tape_shape = (grid_n * slab, W)

    @jax.jit
    def run(seed, a0, a1, t0, t1, *tape):
        if rng_tape:
            check_tape(tape[0], tape_shape)
        zi = jnp.zeros(a0.shape, jnp.int32)
        zf = jnp.zeros(a0.shape, jnp.float32)
        *state, _, racc, stats = fused_loop(
            make_body, (a0, a1, t0, t1, zi, zf, (zf,) * 4), seed[0],
            tape[0] if rng_tape else None,
            num_steps=num_steps, n_sites=n_sites, R=R,
        )
        return (*state, racc) + (stats[1:] if episode_stats else ())

    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run


def make_fused_heavenhell_rollout(env, num_envs: int, num_steps: int,
                                  rows_per_tile: int = 128,
                                         episode_stats: bool = False,
                                  rng_tape: bool = False):
    """Build ``run(seed, x, y, heaven) -> (x', y', heaven', reward_sums)``.

    ``x``/``y``/``reward_sums`` are f32 tiles, ``heaven`` is an int32 tile
    (1 = heaven on the +x side this episode).
    ``episode_stats=True`` appends per-env completed-episode return/length
    sums and counts (in-loop ``RecordEpisodeStatistics`` analogue).
    ``rng_tape=True`` makes ``run`` take a trailing int32 tape argument of
    shape ``run.tape_shape`` replacing the counter generator (see
    :mod:`gym_po_tpu.ops.kernel_rng`).
    """
    R, grid_n = tiling(num_envs, rows_per_tile)
    speed = float(env.agent_speed)
    time_limit = int(env.time_limit)
    hx, hy = float(HH_SITES[0, 0]), float(HH_SITES[0, 1])  # heaven-left site
    r2 = float(HH_RADIUS**2)
    # draw sites per step, in body-trace order: 2 move uniforms, respawn
    # x/y uniforms, heaven coin
    n_sites = 5

    def make_body(rng):
        runiform = rng.runiform

        def rbit():
            return (rng.draw32() & 1).astype(jnp.int32)

        def in_free(x, y):
            stem = (x >= STEM[0]) & (x <= STEM[1]) & (y >= STEM[2]) & (y <= STEM[3])
            bar = (x >= BAR[0]) & (x <= BAR[1]) & (y >= BAR[2]) & (y <= BAR[3])
            return stem | bar

        def body(step, carry):
            x, y, h, elapsed, racc, stats = carry
            rng.begin_step(step)
            px = x + (runiform() * 2.0 - 1.0) * speed
            py = y + (runiform() * 2.0 - 1.0) * speed
            ok = in_free(px, py)
            x = jnp.where(ok, px, x)
            y = jnp.where(ok, py, y)
            dl = (x - hx) ** 2 + (y - hy) ** 2
            dr = (x + hx) ** 2 + (y - hy) ** 2  # right site = (-hx, hy) mirrored
            at_left = dl <= r2
            at_right = dr <= r2
            done = at_left | at_right
            right_side = h == 1
            reached = (right_side & at_right) | (~right_side & at_left)
            rew = jnp.where(done, jnp.where(reached, 1.0, -1.0), 0.0).astype(
                jnp.float32
            )
            elapsed = elapsed + 1
            reset = done | (elapsed >= time_limit)
            if episode_stats:
                stats = record_episodes(stats, rew, reset, elapsed)
            # spawn: x ~ U(-1,1), y ~ U(0,1), fair heaven coin
            nx = runiform() * 2.0 - 1.0
            ny = runiform()
            nh = rbit()
            x = jnp.where(reset, nx, x)
            y = jnp.where(reset, ny, y)
            h = jnp.where(reset, nh, h)
            elapsed = jnp.where(reset, 0, elapsed)
            return (x, y, h, elapsed, racc + rew, stats)

        return body

    slab = KernelRNG.tape_rows(n_sites, num_steps, R)
    tape_shape = (grid_n * slab, W)

    @jax.jit
    def run(seed, x, y, h, *tape):
        if rng_tape:
            check_tape(tape[0], tape_shape)
        zi = jnp.zeros(x.shape, jnp.int32)
        zf = jnp.zeros(x.shape, jnp.float32)
        *state, _, racc, stats = fused_loop(
            make_body, (x, y, h, zi, zf, (zf,) * 4), seed[0],
            tape[0] if rng_tape else None,
            num_steps=num_steps, n_sites=n_sites, R=R,
        )
        return (*state, racc) + (stats[1:] if episode_stats else ())

    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run
