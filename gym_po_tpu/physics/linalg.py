"""Trace-time-unrolled dense linear algebra for tiny SPD systems.

XLA's batched ``lax.linalg.cholesky`` / ``triangular_solve`` run a blocked
while-loop algorithm sized for large matrices; for the ant's 14x14 systems
under ``vmap`` they pay per-op overhead on [B]-element column updates that
the loop structure prevents XLA from fusing.  Unrolling the factorization at
trace time turns it into straight-line vector code over the batch axis that
XLA fuses aggressively.

Used by :func:`gym_po_tpu.physics.dynamics.smooth_forward` (M qacc = qfrc)
and :func:`gym_po_tpu.physics.contact.solve_constraints_newton` (H dq = -g).
Replaces what MuJoCo does with ``mj_factorM`` / ``mj_solveM`` in C
(reference crossing: ``gym_po/envs/ant_tag.py:138-158`` via mujoco).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["chol_solve", "chol_solve_s", "chol_factor_s", "chol_backsub_s"]


def chol_factor_s(H):
    """Scalar-core Cholesky factor: ``H`` (n×n SPD nested list of
    [...]-shaped scalars) → lower-triangular ``L`` as a nested list
    (upper entries ``None``), fully unrolled at trace time."""
    n = len(H)
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(s)
        L[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, n):
            s = H[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    return L


def chol_backsub_s(L, g):
    """Two triangular substitutions with a precomputed factor
    (:func:`chol_factor_s`): solve ``L Lᵀ x = g``."""
    n = len(g)
    y = [None] * n
    for i in range(n):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def chol_solve_s(H, g):
    """Scalar-core solve: ``H`` is an n×n nested list and ``g`` a length-n
    list of [...]-shaped scalars; returns a list of n scalars.

    Cholesky factorization + two triangular substitutions, fully unrolled
    over ``n`` at trace time.  All intermediate values are [...]-shaped
    (batch) scalars, so under ``vmap`` the whole solve is a chain of
    elementwise vector ops — no while loops, no dynamic slices.  Intended
    for n <= ~20 (op count grows as O(n^3) in trace size).
    """
    return chol_backsub_s(chol_factor_s(H), g)


def chol_solve(H, g):
    """Solve ``H x = g`` for SPD ``H`` ([..., n, n]) and ``g`` ([..., n]):
    the array view over :func:`chol_solve_s` (scalar indexing in, stack
    out — both ends fuse away under jit)."""
    n = H.shape[-1]
    Hs = [[H[..., i, j] for j in range(n)] for i in range(n)]
    gs = [g[..., i] for i in range(n)]
    return jnp.stack(chol_solve_s(Hs, gs), axis=-1)
