"""NumPy-side mirror of the fused rollouts' tape-mode randomness.

The fused loops consume draws via
:class:`gym_po_tpu.ops.kernel_rng.KernelRNG` in tape mode: draw site ``j``
at loop step ``t`` reads tape rows ``(j * num_steps + t) * R .. + R``.  :class:`TapeOracle` reproduces that
consumption in NumPy so a per-kernel oracle can replay the exact stochastic
path on CPU.

Transcendental primitives (log/cos) are delegated to jitted element-wise
``jax.numpy`` calls: XLA-CPU libm differs from NumPy libm by up to 4 ULPs
(measured), and the point of these oracles is to independently re-derive
the *control flow, draw order, and arithmetic*, not to re-implement libm.
Everything else is plain float32/int32 NumPy.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

W = 128

_jlog = jax.jit(jnp.log)
_jcos = jax.jit(jnp.cos)


def make_tape(rng: np.random.Generator, n_sites: int, num_steps: int,
              rows: int, grid: int = 1) -> np.ndarray:
    """Random int32 tape of shape [grid * n_sites * num_steps * rows, W]."""
    n = grid * n_sites * num_steps * rows
    return (
        rng.integers(0, 2**32, size=(n, W), dtype=np.uint64)
        .astype(np.uint32)
        .view(np.int32)
    )


class TapeOracle:
    """Mirrors KernelRNG's tape-mode draw indexing for one tape tile."""

    def __init__(self, tape_i32: np.ndarray, num_steps: int, R: int):
        self.tape = np.asarray(tape_i32).view(np.uint32)
        self.num_steps = num_steps
        self.R = R
        self._site = 0
        self._step = 0

    def begin_step(self, step: int) -> None:
        self._step = step
        self._site = 0

    def draw32(self) -> np.ndarray:
        base = (self._site * self.num_steps + self._step) * self.R
        self._site += 1
        return self.tape[base : base + self.R]

    def rbits(self, n: int) -> np.ndarray:
        return (self.draw32() % np.uint32(n)).astype(np.int32)

    def r24(self) -> np.ndarray:
        return (self.draw32() >> np.uint32(8)).astype(np.int32)

    def runiform(self) -> np.ndarray:
        u = (self.draw32() >> np.uint32(8)).astype(np.int32)
        return u.astype(np.float32) * np.float32(2.0**-24)

    def rnormal(self) -> np.ndarray:
        u1 = np.maximum(self.runiform(), np.float32(1e-12))
        u2 = self.runiform()
        # kernel: sqrt(-2 ln u1) * cos(2 pi u2), all f32
        ln = np.asarray(_jlog(u1))
        c = np.asarray(_jcos(np.float32(2.0 * np.pi) * u2))
        return np.sqrt(np.float32(-2.0) * ln) * c


# --- trainer oracle pieces --------------------------------------------------
_jexp = jax.jit(jnp.exp)


def q_lookup_oracle(q: np.ndarray, idx: np.ndarray, n_act: int,
                    nsb: int = 4):
    """Mirror of ops.fused_qlearning._q_lookup on a [nb, W] bank table."""
    lo = idx & (W - 1)
    hi = idx >> 7
    vals = []
    for a in range(n_act):
        v = None
        for b in range(nsb):
            g = q[a * nsb + b][lo]
            v = g if v is None else np.where(hi == b, g, v)
        vals.append(v)
    return vals


def first_argmax_oracle(vals):
    """Mirror of ops.fused_qlearning._first_argmax (strict > = first max)."""
    best_v = vals[0]
    best_a = np.zeros(vals[0].shape, np.int32)
    for a in range(1, len(vals)):
        better = vals[a] > best_v
        best_v = np.where(better, vals[a], best_v)
        best_a = np.where(better, np.int32(a), best_a)
    return best_a, best_v


def scatter_oracle(hi: np.ndarray, lo: np.ndarray, w: np.ndarray,
                   R: int, average_duplicates: bool, nb: int):
    """Mirror of ops.fused_qlearning.scatter_update's increment: ``w``
    summed per table entry ``hi*128 + lo`` in row-major order (entries with
    ``hi < 0`` dropped), divided by the entry's count when averaging."""
    hi = np.asarray(hi)[:R].reshape(-1)
    lo = np.asarray(lo)[:R].reshape(-1)
    w = np.asarray(w, np.float32)[:R].reshape(-1)
    keep = hi >= 0
    idx = hi[keep] * W + lo[keep]
    acc_s = np.zeros((nb * W,), np.float32)
    np.add.at(acc_s, idx, w[keep])
    if average_duplicates:
        acc_n = np.zeros((nb * W,), np.float32)
        np.add.at(acc_n, idx, np.float32(1.0))
        acc_s = acc_s / np.maximum(acc_n, np.float32(1.0))
    return acc_s.reshape(nb, W)


def ac_scatter_oracle(hi: np.ndarray, lo: np.ndarray, w: np.ndarray,
                      R: int, nb: int):
    """Mirror of ops.fused_ac's averaged scatter-adds."""
    return scatter_oracle(hi, lo, w, R, True, nb)
