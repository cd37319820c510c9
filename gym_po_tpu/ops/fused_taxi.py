"""Fused multi-step Taxi rollout: K env steps in one loop, state never leaves.

``vector.rollout`` runs a generic ``lax.scan`` over ``env.step_vec`` and
materializes the ``[T, B]`` trajectory.  This rollout keeps only the
per-env encoded state, the episode counters and the reward sum live across
the K steps, and draws every random number from the counter-based generator
(:mod:`.kernel_rng`):

* the per-cell tables (``cell_move`` per action, ``loc_at``, the valid
  reset cells, an optional per-state policy) are flat arrays indexed by
  state;
* in-loop autoreset and passenger/destination task resets exactly as
  ``Taxi.step_vec`` — same dynamics, a different random stream.

One step body, two implementations with one contract:

* ``impl="xla"``: the body under ``lax.fori_loop`` on ``[B/128, 128]``
  arrays, compiled by XLA — the CPU path and the kernel's reference;
* ``impl="triton"``: the same body inside a Pallas kernel for the GPU
  (``backend="triton"``), one program per 1-D tile of envs, the state in
  registers for all K steps and the tables read by gathered loads.  The
  counter hash and the tape give both the same bits, so their results are
  bit-identical.  Under XLA the loop launches the step's fusions every
  iteration and streams the state through device memory; the kernel does
  neither (on the H100 at K=256: 105.8B against 54.6B env-steps/s at
  B=1M, 42.0B against 5.8B at B=64k, PERF.md).

Scope: random-policy rollouts (throughput benchmarking, random exploration,
dataset generation) and — via ``policy=`` — greedy tabular-policy
evaluation.  Policy-in-the-loop *training* uses the scan path.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .kernel_rng import KernelRNG, W, check_tape, record_episodes, tiling

__all__ = ["make_fused_taxi_rollout", "state_policy_table"]

IMPLS = ("xla", "triton")


def state_policy_table(env, policy) -> np.ndarray:
    """Compose the env's state→obs map with a ``(key, obs) -> action`` policy
    into an ``[ns]`` per-encoded-state action table for the fused rollout.

    Works for any deterministic policy on a ``Discrete`` obs space (e.g.
    ``agents.greedy_policy(q)``); the Hansen variants are handled because
    their obs is a pure function of the encoded state (reference
    extended_taxi.py:366-372).
    """
    from ..envs.taxi import TaxiState

    ns = env.tables.ns
    s = jnp.arange(ns, dtype=jnp.int32)
    z = jnp.zeros_like(s)
    obs = env.observe(TaxiState(elapsed=z, s=s, completed=z))
    return np.asarray(policy(None, obs), np.int32)


def _pow2_pad(values: np.ndarray, fill: int) -> np.ndarray:
    """1-D int32 table padded to a power-of-two length (Triton block rule)."""
    n = 1 << max(0, int(values.size - 1).bit_length())
    out = np.full((max(n, 1),), fill, np.int32)
    out[: values.size] = values
    return out


def _block_envs(num_envs: int, R: int) -> int:
    """Envs per Triton program: a power of two that divides the tape tile,
    at most 1024, and leaves >= 4 programs per SM of a 132-SM card."""
    tile = R * W
    t = tile & -tile  # largest power of two dividing the tape tile
    t = min(t, 1024)
    while t > 128 and num_envs // t < 4 * 132:
        t //= 2
    return t


def make_fused_taxi_rollout(env, num_envs: int, num_steps: int,
                            rows_per_tile: int = 128,
                            policy: Optional[np.ndarray] = None,
                            episode_stats: bool = False,
                            rng_tape: bool = False,
                            impl: Optional[str] = None,
                            interpret: bool = False):
    """Build ``run(seed, s) -> (s', reward_sums)`` for a :class:`Taxi` env.

    ``s`` is the encoded state laid out ``[num_envs // 128, 128]`` int32
    (use ``state.s.reshape(-1, 128)`` from ``reset_vec``); ``reward_sums``
    accumulates per-env reward over the ``num_steps`` steps.  ``seed`` is a
    ``[1]`` int32.  Actions are uniform-random draws, or — when ``policy``
    (an ``[ns]`` int32 per-state action table, see
    :func:`state_policy_table`) is given — the table's greedy actions, with
    the generator then only consumed by episode/task resets.

    ``episode_stats=True`` appends three per-env f32 outputs — summed
    COMPLETED-episode returns, summed completed-episode lengths, and the
    completed-episode count — the in-loop analogue of the scan path's
    ``RecordEpisodeStatistics`` (mean episode return =
    ``ep_ret.sum() / ep_cnt.sum()``).

    ``rng_tape=True`` makes ``run`` take a trailing int32 tape argument of
    shape ``run.tape_shape`` (tiles of ``rows_per_tile`` rows, see
    :mod:`gym_po_tpu.ops.kernel_rng`) replacing the counter generator.

    ``impl`` picks the implementation: ``"triton"`` (the GPU kernel, the
    default on a GPU backend: 1.9-7.2x the XLA twin on the H100, PERF.md)
    or ``"xla"`` (the default elsewhere).  ``interpret=True`` runs the
    Triton kernel through the Pallas interpreter (CPU tests only).
    """
    if impl is None:
        impl = "triton" if jax.default_backend() == "gpu" else "xla"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    t = env.tables
    nc = t.rows * t.cols
    nlocs, rows, cols = t.nlocs, t.rows, t.cols
    pd = (nlocs + 1) * nlocs
    n_pass = env.num_passengers
    time_limit = env.time_limit
    r_goal, r_bad, r_any = env.reward_goal, env.reward_bad, env.reward_any
    all_valid = env._all_cells_valid
    R, grid = tiling(num_envs, rows_per_tile)

    tabs = {
        # cell_move[cell * 4 + a] for the four moves
        "cm": _pow2_pad(np.asarray(env._cell_move).reshape(-1), 0),
        "la": _pow2_pad(np.asarray(env._loc_at).reshape(-1), nlocs),
    }
    valid_cells = np.flatnonzero((t.tgrid != "|").reshape(-1))
    n_valid = valid_cells.size
    if not all_valid:
        tabs["vc"] = _pow2_pad(valid_cells, 0)
    if policy is not None:
        pol_host = np.asarray(policy, np.int32).reshape(-1)
        if pol_host.size != nc * pd:
            raise ValueError(f"policy table must have {nc * pd} entries")
        tabs["pol"] = _pow2_pad(pol_host, 0)
    names = tuple(tabs)

    # draw sites per step, in body-trace order: action (random policy only),
    # task pn, task d0, full-reset cell (2 draws when every cell is
    # navigable, else 1), reset pr, reset dr0
    n_sites = (1 if policy is None else 0) + 2 + (2 if all_valid else 1) + 2

    def make_body(rng, tab):
        """One env step on arrays of any shape; ``tab[name][idx]`` is a
        gather from an array or a load from a kernel ref."""
        rbits = rng.rbits

        def body(step, carry):
            s, completed, elapsed, racc, stats = carry
            rng.begin_step(step)
            a = rbits(5) if policy is None else tab["pol"][s]
            # decode (reference extended_taxi.py:84-94)
            rc = s // pd
            rem = s % pd
            p = rem // nlocs
            d = rem % nlocs
            moved = tab["cm"][rc * 4 + jnp.minimum(a, 3)]
            is_pd = a == 4
            loc = tab["la"][rc]
            goal = is_pd & (p == nlocs) & (loc == d)
            pickup = is_pd & (p < nlocs) & (loc == p)
            bad = is_pd & (~goal) & (~pickup)
            p2 = jnp.where(pickup, nlocs, p)
            rc2 = jnp.where(is_pd, rc, moved)
            completed = completed + goal.astype(jnp.int32)
            rew = jnp.where(
                goal,
                jnp.float32(r_goal),
                jnp.where(bad, jnp.float32(r_bad), jnp.float32(r_any)),
            )
            elapsed = elapsed + 1
            done = completed == n_pass
            trunc = elapsed > time_limit
            # task reset (reference :354-364, rejection-free d != p)
            task = goal & ~(done | trunc)
            pn = rbits(nlocs)
            d0 = rbits(nlocs - 1)
            dn = d0 + (d0 >= pn).astype(jnp.int32)
            p3 = jnp.where(task, pn, p2)
            d3 = jnp.where(task, dn, d)
            # full reset: arithmetic components when every cell is navigable,
            # a valid-cell table lookup otherwise
            reset = done | trunc
            if all_valid:
                rc_new = rbits(rows) * cols + rbits(cols)
            else:
                rc_new = tab["vc"][rbits(n_valid)]
            pr = rbits(nlocs)
            dr0 = rbits(nlocs - 1)
            dr = dr0 + (dr0 >= pr).astype(jnp.int32)
            rc3 = jnp.where(reset, rc_new, rc2)
            p4 = jnp.where(reset, pr, p3)
            d4 = jnp.where(reset, dr, d3)
            completed = jnp.where(reset, 0, completed)
            s2 = (rc3 * (nlocs + 1) + p4) * nlocs + d4
            if episode_stats:
                stats = record_episodes(stats, rew, reset, elapsed)
            elapsed = jnp.where(reset, 0, elapsed)
            return (s2, completed, elapsed, racc + rew, stats)

        return body

    def loop(rng, tab, s):
        zi = jnp.zeros(s.shape, jnp.int32)
        zf = jnp.zeros(s.shape, jnp.float32)
        s, _, _, racc, stats = jax.lax.fori_loop(
            0, num_steps, make_body(rng, tab), (s, zi, zi, zf, (zf,) * 4)
        )
        rng.finalize(n_sites)
        return (s, racc) + (tuple(stats[1:]) if episode_stats else ())

    rows_total = num_envs // W
    slab = KernelRNG.tape_rows(n_sites, num_steps, R)
    tape_shape = (grid * slab, W)
    tab_arrays = tuple(jnp.asarray(tabs[k]) for k in names)

    if impl == "xla":

        @jax.jit
        def run(seed, s, *tape):
            if rng_tape:
                check_tape(tape[0], tape_shape)
            rng = KernelRNG.for_layout(
                seed[0], s.shape, num_steps,
                tape=tape[0] if rng_tape else None, R=R,
            )
            return loop(rng, dict(zip(names, tab_arrays)), s)

    else:
        run = _triton_run(loop, names, tab_arrays, num_envs, num_steps, R,
                          slab, tape_shape, rows_total, rng_tape,
                          episode_stats, interpret)

    run.tape_shape = tape_shape
    run.n_sites = n_sites
    return run


def _triton_run(loop, names, tab_arrays, num_envs, num_steps, R, slab,
                tape_shape, rows_total, rng_tape, episode_stats, interpret):
    """The shared loop as one Pallas/Triton kernel over 1-D env tiles."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    T = _block_envs(num_envs, R)
    tile_envs = R * W
    if rng_tape and tape_shape[0] * W >= 2**31:
        raise ValueError("the tape's offsets exceed int32: use fewer steps")
    n_tabs = len(names)
    n_out = 2 + (3 if episode_stats else 0)

    def kernel(seed_ref, s_ref, *refs):
        tab_refs = refs[:n_tabs]
        rest = refs[n_tabs:]
        tape_ref = rest[0] if rng_tape else None
        outs = rest[1:] if rng_tape else rest
        base = pl.program_id(0) * T
        env_index = base + jnp.arange(T, dtype=jnp.int32)
        draw = None
        if rng_tape:
            # this block's envs are contiguous inside one tape tile, so each
            # row block of the tile's slab is one contiguous T-wide load
            start = (base // tile_envs) * (slab * W) + base % tile_envs

            def draw(block):
                x = tape_ref[pl.ds(start + block * tile_envs, T)]
                return jax.lax.bitcast_convert_type(x, jnp.uint32)

        rng = KernelRNG(seed_ref[0], env_index, num_steps, tape_draw=draw)
        res = loop(rng, dict(zip(names, tab_refs)), s_ref[...])
        for o, v in zip(outs, res):
            o[...] = v

    blk = pl.BlockSpec((T,), lambda i: (i,))
    whole = pl.BlockSpec()  # the whole array, read at computed offsets
    in_specs = (
        [whole, blk] + [whole] * n_tabs + ([whole] if rng_tape else [])
    )
    out_shape = (jax.ShapeDtypeStruct((num_envs,), jnp.int32),) + (
        jax.ShapeDtypeStruct((num_envs,), jnp.float32),
    ) * (n_out - 1)
    call = pl.pallas_call(
        kernel,
        grid=(num_envs // T,),
        in_specs=in_specs,
        out_specs=(blk,) * n_out,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="fused_taxi_rollout",
    )

    @jax.jit
    def run(seed, s, *tape):
        extra = ()
        if rng_tape:
            check_tape(tape[0], tape_shape)
            extra = (tape[0].reshape(-1),)
        res = call(seed.reshape(1), s.reshape(-1), *tab_arrays, *extra)
        return tuple(r.reshape(rows_total, W) for r in res)

    return run
