"""Per-env random bits for the fused rollouts and trainers.

Two sources behind one interface:

* **Counter mode** (the default): every draw is a hash of
  ``(seed, env index, step, draw site)`` in uint32 arithmetic.  Nothing is
  carried between steps, so the same function runs in plain ``jax.numpy``
  and inside a Pallas kernel, and two implementations that hash the same
  counters produce the same bits.
* **Tape mode**: every draw is a slice of a precomputed uint32 buffer, which
  lets a NumPy oracle replay the exact stochastic path (``tests/_tape.py``).

Tape layout
-----------
The envs are laid out ``[rows, 128]`` and split into tiles of ``R`` rows.
One ``[R, 128]`` row block per *draw site* per step per tile: tile ``g``'s
slab holds ``n_sites * num_steps * R`` rows, and row block
``(site * num_steps + step) * R .. + R`` of that slab is the draw for call
site ``site`` at loop step ``step``.  Sites are numbered in body-trace order
and restart at 0 every step (``begin_step``).  Keying the index on
``(site, step)`` — instead of a running draw counter — means a diverging
branch in an imperfect oracle cannot desynchronize the stream: every draw
has a fixed home.  ``finalize(expected_sites)`` checks at trace time that
the body consumed as many sites as the tape was sized for.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "KernelRNG", "W", "check_tape", "fused_loop", "hash_bits",
    "record_episodes", "step_key", "tiling",
]

W = 128
_GOLDEN = 0x9E3779B9


def _u32(x):
    return jnp.asarray(x).astype(jnp.uint32)


def mix32(h):
    """Bijective uint32 finalizer ("lowbias32", C. Wellons)."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x7FEB352D)
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x846CA68B)
    return h ^ (h >> 16)


def step_key(seed, step):
    """Per-(seed, step) scalar key."""
    return mix32(mix32(_u32(seed) ^ jnp.uint32(_GOLDEN)) ^ _u32(step))


def hash_bits(key, env_index, site: int):
    """uint32 bits for one draw site: ``key`` from :func:`step_key`."""
    h = mix32(key ^ _u32(env_index))
    return mix32(h + jnp.uint32((site + 1) * _GOLDEN & 0xFFFFFFFF))


def tiling(num_envs: int, rows_per_tile: int):
    """``(R, tiles)``: rows per tape tile and the number of tiles."""
    if num_envs % W:
        raise ValueError("num_envs must be a multiple of 128")
    R = min(rows_per_tile, num_envs // W)
    if num_envs % (R * W):
        raise ValueError("num_envs must divide into [rows_per_tile, 128] tiles")
    return R, num_envs // (R * W)


def check_tape(tape, shape) -> None:
    """Raise unless ``tape`` has the ``run.tape_shape`` the builder sized."""
    if tuple(tape.shape) != tuple(shape):
        raise ValueError(
            f"rng tape must have shape {tuple(shape)}, got {tuple(tape.shape)}"
        )


def fused_loop(make_body, init, seed, tape, *, num_steps: int, n_sites: int,
               R: int | None = None):
    """Run ``make_body(rng)`` for ``num_steps`` steps from carry ``init``.

    The generator is laid out like ``init[0]`` (``[rows, 128]``); ``tape``
    (or None) and ``R`` as :meth:`KernelRNG.for_layout`."""
    rng = KernelRNG.for_layout(seed, init[0].shape, num_steps, tape=tape, R=R)
    out = jax.lax.fori_loop(0, num_steps, make_body(rng), init)
    rng.finalize(n_sites)
    return out


def record_episodes(stats, rew, reset, elapsed):
    """In-loop ``RecordEpisodeStatistics``: ``stats`` is (running return,
    completed-return sum, completed-length sum, completed count)."""
    cur_ret, ep_ret, ep_len, ep_cnt = stats
    cur_ret = cur_ret + rew
    ep_ret = jnp.where(reset, ep_ret + cur_ret, ep_ret)
    ep_len = jnp.where(reset, ep_len + elapsed.astype(jnp.float32), ep_len)
    ep_cnt = jnp.where(reset, ep_cnt + 1.0, ep_cnt)
    cur_ret = jnp.where(reset, 0.0, cur_ret)
    return (cur_ret, ep_ret, ep_len, ep_cnt)


class KernelRNG:
    """Per-env randomness: counter hash or injected tape.

    Usage inside a fused loop body::

        rng = KernelRNG(seed, env_index, num_steps, tape_draw=draw_or_None)
        def body(step, carry):
            rng.begin_step(step)
            a = rng.rbits(5)
            ...
        jax.lax.fori_loop(0, num_steps, body, init)
        rng.finalize(N_SITES)

    ``env_index`` is the uint32 global index of every env in the state
    layout (its shape is the shape of every draw).  ``tape_draw(block)``
    returns the tape's row block ``site * num_steps + step`` in that layout.
    """

    def __init__(self, seed, env_index, num_steps: int, tape_draw=None):
        self.seed = seed
        self.env_index = _u32(env_index)
        self.num_steps = num_steps
        self.tape_draw = tape_draw
        self._site = 0
        self._max_sites = 0
        self._step = 0
        self._key = None

    @classmethod
    def for_layout(cls, seed, shape, num_steps: int, tape=None,
                   R: int | None = None):
        """RNG for a ``[rows, 128]`` state layout held as plain arrays.

        ``tape`` (int32 ``[tiles * n_sites * num_steps * R, 128]``) selects
        tape mode; ``R`` is the tape tile height (default: all rows)."""
        rows = shape[0]
        env_index = jax.lax.broadcasted_iota(jnp.uint32, shape, 0) * W + \
            jax.lax.broadcasted_iota(jnp.uint32, shape, 1)
        draw = None
        if tape is not None:
            R = rows if R is None else R
            tiles = rows // R
            t3 = jnp.asarray(tape).view(jnp.uint32).reshape(tiles, -1, W)

            def draw(block):
                blk = jax.lax.dynamic_slice_in_dim(t3, block * R, R, axis=1)
                return blk.reshape(rows, W)

        return cls(seed, env_index, num_steps, tape_draw=draw)

    # -- lifecycle ---------------------------------------------------------
    def begin_step(self, step) -> None:
        """Mark the start of a loop body; resets the site counter.

        Must be the first ``rng`` call in the body.  Also makes the site
        numbering immune to the body being traced more than once.
        """
        self._step = step
        self._site = 0
        if self.tape_draw is None:
            self._key = step_key(self.seed, step)

    def finalize(self, expected_sites: int) -> None:
        """Trace-time contract check: the body consumed ``expected_sites``
        draw sites per step (the number the tape was sized for)."""
        if self._max_sites != expected_sites:
            raise ValueError(
                f"body consumed {self._max_sites} draw sites per step but "
                f"the tape was sized for {expected_sites}"
            )

    @staticmethod
    def tape_rows(n_sites: int, num_steps: int, R: int) -> int:
        """Rows of one tile's tape slab."""
        return n_sites * num_steps * R

    # -- draws -------------------------------------------------------------
    def draw32(self):
        """Raw uint32 random bits, one per env."""
        site = self._site
        self._site += 1
        self._max_sites = max(self._max_sites, self._site)
        if self.tape_draw is None:
            return hash_bits(self._key, self.env_index, site)
        return self.tape_draw(site * self.num_steps + self._step)

    def rbits(self, n: int):
        """Uniform int32 in [0, n) — ``u % n`` (bias <= n/2^32, negligible)."""
        return (self.draw32() % jnp.uint32(n)).astype(jnp.int32)

    def r24(self):
        """Uniform int32 in [0, 2^24) — the trainers' epsilon comparand."""
        return (self.draw32() >> 8).astype(jnp.int32)

    def runiform(self):
        """Exact f32 in [0, 1) from the top 24 bits."""
        u = self.draw32() >> 8
        return u.astype(jnp.int32).astype(jnp.float32) * jnp.float32(2.0**-24)

    def rnormal(self):
        """Box-Muller standard normal (two uniform draws)."""
        u1 = jnp.maximum(self.runiform(), jnp.float32(1e-12))
        u2 = self.runiform()
        return jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(
            jnp.float32(2.0 * np.pi) * u2
        )
