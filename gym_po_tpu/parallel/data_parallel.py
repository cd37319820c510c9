"""Data-parallel execution of the fused tabular trainers.

Implements the chunk-synchronous table-averaging scheme specified in
``docs/MULTIHOST.md`` — the tabular analogue of Anakin, for the fused
trainer family (:mod:`gym_po_tpu.ops.fused_qlearning`, ``fused_ac``):

1. the env batch is sharded over the mesh's ``data`` axis; each device runs
   the trainer on its shard with its OWN table copy, seeded disjointly;
2. after every chunk (one ``run`` call, K steps) the table banks are
   ``pmean``-averaged across the mesh — 16 KB per ``[32, 128]`` table;
3. the next chunk resumes from the averaged tables.

Chunk-averaged tabular Q-learning is the standard parallel-Q scheme:
consistent as ``K·lr`` stays small, and with ``average_duplicates=True``
the effective step size is invariant to the global batch size.

The harness is trainer-agnostic: any ``run_chunk`` with signature
``(seed[1], *args) -> outs`` slots in.  The trainers are plain JAX, so the
same code runs on the 8-device virtual CPU mesh of the tests and on a
multi-GPU mesh.

The reference has no counterpart for any of this (SURVEY.md §2.5: its only
parallelism is single-process batch vectorization).
"""

from __future__ import annotations

from typing import Callable, Iterable

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS, put_global, shard_map

__all__ = ["shard_fused_trainer", "chunk_seeds", "replicate"]


def replicate(mesh: Mesh, tree, axis: str = DATA_AXIS):
    """Place a host pytree fully replicated over the mesh."""
    del axis  # replicated along every axis
    return put_global(tree, NamedSharding(mesh, P()))


def chunk_seeds(seed: int, chunk_index: int, ndev: int) -> jax.Array:
    """Disjoint per-shard PRNG seeds for one chunk: ``[ndev]`` int32.

    Every (chunk, shard) pair gets a distinct seed; shard ``i`` of chunk
    ``c`` never collides with any other pair for the same base ``seed``.
    """
    base = seed + chunk_index * ndev
    return (base + np.arange(ndev)).astype(np.int32)


def shard_fused_trainer(
    run_chunk: Callable,
    mesh: Mesh,
    *,
    sharded_args: Iterable[int],
    averaged_outs: Iterable[int],
    num_outs: int,
    axis: str = DATA_AXIS,
) -> Callable:
    """Wrap a single-core chunk trainer into a data-parallel one.

    ``run_chunk(seed [1] i32, *args) -> (out_0, ..., out_{num_outs-1})`` is
    the contract of the fused trainer family (``make_fused_q_trainer`` et
    al.).  The wrapped function takes ``(seeds [ndev] i32, *args)`` where:

    - args at positions in ``sharded_args`` (0-indexed AFTER the seed) carry
      per-env state tiles ``[R, 128]`` sharded over ``axis`` rows — each
      shard must keep ``R/ndev`` a multiple of 8 (Mosaic sublane tiling);
    - all other args (scalars, table banks) are replicated;
    - outputs at positions in ``averaged_outs`` are ``pmean``-averaged over
      ``axis`` before being returned (replicated layout — feed them back in
      as-is); the rest come back sharded over ``axis``.

    ``run_chunk`` executes once per device on its shard; nothing inside it
    communicates.  The only collective is the per-chunk table ``pmean``.
    """
    sharded = frozenset(sharded_args)
    averaged = frozenset(averaged_outs)
    if not averaged:
        raise ValueError("averaged_outs is empty: tables would never sync")

    def body(seeds, *args):
        out = run_chunk(seeds, *args)
        if len(out) != num_outs:
            raise ValueError(
                f"run_chunk returned {len(out)} outputs, expected {num_outs}"
            )
        return tuple(
            jax.lax.pmean(o, axis) if j in averaged else o
            for j, o in enumerate(out)
        )

    def wrapped(seeds, *args):
        in_specs = (P(axis),) + tuple(
            P(axis) if i in sharded else P() for i in range(len(args))
        )
        out_specs = tuple(
            P() if j in averaged else P(axis) for j in range(num_outs)
        )
        return shard_map(
            body,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=out_specs,
            check_rep=False,
        )(seeds, *args)

    return jax.jit(wrapped)
