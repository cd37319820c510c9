"""Sequential-dispatch batching: a rollout over more envs than one
compiled program takes.

:func:`chunked_rollout` compiles the rollout at ``dispatch_batch`` envs and
dispatches it sequentially over ``num_envs // dispatch_batch`` chunks;
:func:`make_chunked_step` does the same for one ``step_vec``.  On the H100
one monolithic program is faster than chunks at every batch measured: the
ant engine (rk4, frame_skip 15, 8 iterations, array pipeline) runs 16,840
env-steps/s at B=4096, 18,864 at 16,384 and 19,718 at 65,536 as one
program, against 2,791 (16,384 in 4,096-wide chunks) and 7,281-7,959
(65,536 in 4,096- or 16,384-wide chunks) — PERF.md.  So
:data:`DISPATCH_BATCH` is the largest batch measured monolithic, and
chunking is a fallback for batches whose program would not fit the card.

Chunks use independent fold_in-derived PRNG keys, so results differ from a
monolithic call numerically (same distributions; parity mode is unaffected
— it never chunks).  For more envs than one card holds prefer the
data-parallel mesh (env stepping has no cross-device communication).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core import Environment, EnvState
from .vec_env import Transition, rollout

__all__ = ["chunked_rollout", "make_chunked_step", "DISPATCH_BATCH"]

#: the largest batch measured as one program on the H100 (PERF.md ant batch
#: curve): below it a monolithic rollout beats sequential chunks
DISPATCH_BATCH = 65536


def _split_chunks(tree, num_chunks: int):
    """[B, ...] pytree -> list of num_chunks [B/n, ...] pytrees."""
    return [
        jax.tree.map(
            lambda x: x[i * (x.shape[0] // num_chunks):
                        (i + 1) * (x.shape[0] // num_chunks)], tree
        )
        for i in range(num_chunks)
    ]


def _concat_chunks(trees, axis: int = 0):
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=axis), *trees)


def chunked_rollout(
    env: Environment,
    key: jax.Array,
    policy: Optional[Callable[[jax.Array, jax.Array], jax.Array]],
    num_envs: int,
    num_steps: int,
    dispatch_batch: int = DISPATCH_BATCH,
    init: Optional[Tuple[jax.Array, EnvState]] = None,
) -> Tuple[Transition, Tuple[jax.Array, EnvState]]:
    """:func:`~gym_po_tpu.vector.rollout`, compiled at ``dispatch_batch``
    and dispatched sequentially over ``num_envs // dispatch_batch`` chunks.

    Matches ``rollout``'s signature and return shapes ( ``[T, B, ...]``
    trajectory, full-``B`` final ``(obs, state)`` ); requires
    ``dispatch_batch | num_envs``.  At or below ``dispatch_batch`` it is a
    plain single-dispatch rollout.
    """
    if num_envs <= dispatch_batch:
        return rollout(env, key, policy, num_envs, num_steps, init=init)
    if num_envs % dispatch_batch:
        raise ValueError(
            f"num_envs={num_envs} must be a multiple of "
            f"dispatch_batch={dispatch_batch}"
        )
    n = num_envs // dispatch_batch

    @jax.jit
    def run_chunk(k, chunk_init):
        return rollout(
            env, k, policy, dispatch_batch, num_steps, init=chunk_init
        )

    inits = [None] * n if init is None else _split_chunks(init, n)
    outs = []
    for i, chunk_init in enumerate(inits):
        # async dispatch: the host issues all n programs back-to-back and
        # the device pipelines them (this is where the 2.06x comes from)
        outs.append(run_chunk(jax.random.fold_in(key, i), chunk_init))
    traj = _concat_chunks([o[0] for o in outs], axis=1)  # [T, B, ...]
    fin = _concat_chunks([o[1] for o in outs], axis=0)
    return traj, fin


def make_chunked_step(
    env: Environment, dispatch_batch: int = DISPATCH_BATCH
) -> Callable[[jax.Array, EnvState, jax.Array], tuple]:
    """A ``step_vec``-shaped callable issuing per-chunk dispatches.

    ``step(key, state, actions)`` with ``[B, ...]`` inputs returns the
    standard ``(obs, state, reward, done, trunc, info)`` with full-``B``
    outputs; each ``dispatch_batch``-sized slice runs as its own dispatch
    of ONE compiled executable.  ``B`` must be a multiple of
    ``dispatch_batch`` (equal is fine: single dispatch).
    """

    @jax.jit
    def step_chunk(k, state, actions):
        return env.step_vec(k, state, actions)

    def step(key: jax.Array, state: EnvState, actions: jax.Array):
        B = actions.shape[0]
        if B % dispatch_batch:
            raise ValueError(
                f"batch {B} must be a multiple of dispatch_batch="
                f"{dispatch_batch}"
            )
        n = B // dispatch_batch
        if n <= 1:
            return step_chunk(key, state, actions)
        states = _split_chunks(state, n)
        acts = _split_chunks(actions, n)
        outs = [
            step_chunk(jax.random.fold_in(key, i), states[i], acts[i])
            for i in range(n)
        ]
        obs = _concat_chunks([o[0] for o in outs])
        nstate = _concat_chunks([o[1] for o in outs])
        rew = _concat_chunks([o[2] for o in outs])
        done = _concat_chunks([o[3] for o in outs])
        trunc = _concat_chunks([o[4] for o in outs])
        info = _concat_chunks([o[5] for o in outs])
        return obs, nstate, rew, done, trunc, info

    return step
