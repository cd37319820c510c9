"""Forward dynamics + RK4 integration — the ant simulator's outer loop.

Mirrors MuJoCo's pipeline (``mj_forward`` → ``mj_RungeKutta``), reference
substrate for ``gym_po/envs/ant_tag.py:138-158``:

* ``forward`` = smooth dynamics (:mod:`.dynamics`, scalar core) + constraint
  solve (:mod:`.contact`), returning ``qacc``.
* ``rk4_step`` = the classic 4-stage tableau on the qpos manifold: stage
  positions integrate the *averaged stage velocities* from the step's start
  via the quaternion exponential map, exactly like ``mj_RungeKutta`` +
  ``mj_integratePos``.  RK4's tableau here has one nonzero per row, so the
  four stages are expressed as a 4-iteration ``lax.scan`` whose body holds
  ONE ``forward`` — the jitted graph contains a single copy of the (large,
  fully scalarized) dynamics trace instead of four.
* ``step`` = ``frame_skip`` RK4 steps with the control held (the envs use
  frame_skip=15 → dt_env = 0.3 s), rolled with ``lax.scan``.

The constraint solve is the primal Newton method
(:func:`gym_po_tpu.physics.contact.solve_constraints_newton`) — ~8-12
iterations to MuJoCo's exact fixed point — warm-started across stages and
frames with the previous constraint correction.  Everything is single-env
and pure; batch with ``jax.vmap`` — all hot intermediates are shape-()
scalars (→ [B] lane vectors under vmap), see ``docs/PHYSICS.md``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .ant_model import AntModel
from .contact import (constraint_rows_array, constraint_rows_scalar,
                      solve_constraints_newton, solve_constraints_newton_s)
from .dynamics import smooth_forward_array, smooth_forward_s
from .spatial import quat_integrate, quat_normalize

__all__ = [
    "PhysicsState", "init_state", "forward", "rk4_step", "euler_step", "step",
]

class PhysicsState(NamedTuple):
    qpos: jnp.ndarray  # [nq]
    qvel: jnp.ndarray  # [nv]
    warm: jnp.ndarray  # [nv] warm start: previous (qacc - qacc_smooth)


def init_state(model: AntModel, qpos, qvel) -> PhysicsState:
    qpos = jnp.asarray(qpos)
    return PhysicsState(
        qpos, jnp.asarray(qvel, qpos.dtype),
        jnp.zeros((model.nv,), qpos.dtype),
    )


def forward(model: AntModel, qpos, qvel, ctrl, warm=None,
            iters: int = 10, ls_iters: int = 10,
            pipeline: str = "scalar"):
    """Constrained forward dynamics → (qacc, warm_out).

    ``warm`` is the previous step's constraint correction
    ``qacc - qacc_smooth``; Newton starts from ``qacc_smooth + warm``
    (zero warm start == the unconstrained solution, already correct for
    contact-free frames).  ``ls_iters`` = bisections per Newton line
    search (an accuracy/speed knob, see ``solve_constraints_newton_s``;
    a chord tail phase was measured strictly slower and removed —
    docs/ARCHITECTURE.md).

    ``pipeline`` selects the constraint formulation: ``"scalar"`` (static
    per-row dof sparsity, straight-line [B]-vector code under vmap) or
    ``"array"`` (same math on stacked row arrays via
    :func:`..contact.constraint_rows_array` — ~50x smaller HLO,
    for compile-time-bound settings like the XLA:CPU multichip
    dryrun).

    Every contraction is traced at ``Precision.HIGHEST``: a GPU would
    otherwise run f32 matmuls in TF32 (about three decimal digits)."""
    with jax.default_matmul_precision("highest"):
        return _forward(model, qpos, qvel, ctrl, warm, iters, ls_iters,
                        pipeline)


def _forward(model, qpos, qvel, ctrl, warm, iters, ls_iters, pipeline):
    dtype = qpos.dtype
    nv = model.nv
    if pipeline == "array":
        kin, M, qacc_smooth, _ = smooth_forward_array(model, qpos, qvel,
                                                      ctrl)
        rows = constraint_rows_array(model, kin, qpos, qvel)
        q0 = qacc_smooth if warm is None else qacc_smooth + warm
        qacc, _ = solve_constraints_newton(model, M, qacc_smooth, rows,
                                           iters=iters, ls_iters=ls_iters,
                                           qacc0=q0)
        return qacc, qacc - qacc_smooth
    if pipeline != "scalar":
        raise ValueError(f"unknown pipeline {pipeline!r}")
    skin, M_s, qacc_s, _ = smooth_forward_s(model, qpos, qvel, ctrl)
    rows = constraint_rows_scalar(model, skin, qpos, qvel)
    q0 = qacc_s if warm is None else [qacc_s[d] + warm[d] for d in range(nv)]
    qacc_l = solve_constraints_newton_s(model, M_s, qacc_s, rows,
                                        iters=iters, ls_iters=ls_iters,
                                        qacc0=q0)
    qacc = jnp.stack([jnp.asarray(x, dtype) for x in qacc_l])
    qacc_smooth = jnp.stack([jnp.asarray(x, dtype) for x in qacc_s])
    return qacc, qacc - qacc_smooth


def _integrate_pos(model: AntModel, qpos, qvel_avg, dt):
    """MuJoCo ``mj_integratePos``: linear position + local-frame quaternion
    exponential + hinge angles."""
    pos = qpos[0:3] + dt * qvel_avg[0:3]
    quat = quat_normalize(quat_integrate(qpos[3:7], qvel_avg[3:6], dt))
    hinges = qpos[7:] + dt * qvel_avg[6:]
    return jnp.concatenate([pos, quat, hinges])


# stage position/velocity coefficients and quadrature weights; the classic
# tableau's A has a single nonzero per row, so stage i only needs stage i-1
_RK_C = (0.0, 0.5, 0.5, 1.0)
_RK_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)


def rk4_step(model: AntModel, state: PhysicsState, ctrl,
             iters: int = 10, ls_iters: int = 10,
             pipeline: str = "scalar") -> PhysicsState:
    """One RK4 step of length ``model.dt`` (== ``mj_RungeKutta(m, d, 4)``).

    Rolled as a 4-stage ``lax.scan`` (one ``forward`` in the trace)."""
    dt = model.dt
    dtype = state.qpos.dtype
    qpos0, qvel0 = state.qpos, state.qvel
    zeros = jnp.zeros_like(qvel0)

    def stage(carry, cb):
        vel_prev, acc_prev, vsum, asum, w = carry
        c, b = cb
        qpos_i = _integrate_pos(model, qpos0, c * vel_prev, dt)
        qvel_i = qvel0 + (dt * c) * acc_prev
        acc_i, w = forward(model, qpos_i, qvel_i, ctrl, w, iters, ls_iters,
                           pipeline)
        return (qvel_i, acc_i, vsum + b * qvel_i, asum + b * acc_i, w), ()

    cb = (jnp.asarray(_RK_C, dtype), jnp.asarray(_RK_B, dtype))
    (_, _, vel_avg, acc_avg, w), _ = jax.lax.scan(
        stage, (qvel0, zeros, zeros, zeros, state.warm), cb)
    return PhysicsState(
        _integrate_pos(model, qpos0, vel_avg, dt),
        qvel0 + dt * acc_avg,
        w,
    )


def euler_step(model: AntModel, state: PhysicsState, ctrl,
               iters: int = 10, ls_iters: int = 10,
               pipeline: str = "scalar") -> PhysicsState:
    """One semi-implicit Euler step: ``qvel' = qvel + dt qacc``, position
    integrated with the NEW velocity.

    A speed/compile knob, not a parity path: the reference models pin
    ``integrator="RK4"`` (``assets/*.xml:3``), and MuJoCo's own Euler mode
    additionally treats joint damping implicitly — this one is the plain
    symplectic variant (one constrained ``forward`` per step instead of
    RK4's four: ~4x less compute and a 4x smaller trace)."""
    qacc, w = forward(model, state.qpos, state.qvel, ctrl, state.warm,
                      iters, ls_iters, pipeline)
    qvel = state.qvel + model.dt * qacc
    return PhysicsState(
        _integrate_pos(model, state.qpos, qvel, model.dt), qvel, w
    )


def step(model: AntModel, state: PhysicsState, ctrl, frame_skip: int = 15,
         iters: int = 10, integrator: str = "rk4",
         ls_iters: int = 10,
         unroll: int = 1, pipeline: str = "scalar") -> PhysicsState:
    """``frame_skip`` integrator steps with ``ctrl`` held
    (``MujocoEnv.do_simulation``).  ``integrator``: ``"rk4"`` (reference
    setting) or ``"euler"`` (see :func:`euler_step`).  ``unroll`` is passed
    to the substep ``lax.scan`` — a perf knob trading compile time (the
    forward trace is duplicated ``unroll``×) for cross-substep fusion."""
    if integrator == "rk4":
        substep = rk4_step
    elif integrator == "euler":
        substep = euler_step
    else:
        raise ValueError(f"unknown integrator {integrator!r}")

    def body(s, _):
        return substep(model, s, ctrl, iters, ls_iters, pipeline), ()

    out, _ = jax.lax.scan(body, state, None, length=frame_skip,
                          unroll=unroll)
    return out
