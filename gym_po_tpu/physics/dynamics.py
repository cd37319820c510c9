"""Smooth rigid-body dynamics for the ant: FK, Jacobians, CRBA, bias.

Accelerator-first formulation, second generation: every per-env intermediate is a
shape-() *scalar* (Python tuples/lists of them), so under ``jax.vmap`` the
whole smooth-dynamics pass is straight-line ``[B]``-vector code — the same
trick as :func:`gym_po_tpu.physics.linalg.chol_solve`.  It was shaped for
the previous accelerator's 128-lane vector tiles, where the array
formulation's ``[nb,nv,3]`` Jacobian tensors padded badly; on the H100 the
array formulation (:func:`smooth_forward_array`) is the faster one
(PERF.md).

The math is unchanged and still mirrors MuJoCo (the substrate under
reference ``gym_po/envs/ant_tag.py:138-158``):

* ``M[d,e] = Σ_b m_b jp_bd·jp_be + jr_bd·I_b^w jr_be + armature δ_de`` —
  algebraically CRBA (MuJoCo ``mj_crb``), with the (body,dof) sparsity of
  ``dof_mask`` applied at *trace time*: only the ~90 active pairs (free
  dofs × 13 bodies + each hinge's 1-2 descendants) emit ops.
* ``qfrc_bias`` is RNEA with q̈=0 (MuJoCo ``mj_rne`` + gravity), phrased
  over the same scalar Jacobian columns.

Free-joint conventions follow MuJoCo (verified against
``mj_objectVelocity`` / ``mj_jacBodyCom``): linear qvel is world-frame,
angular qvel is body-frame, rotation dofs are anchored at the torso frame
origin.  All functions are single-env and f32/f64-polymorphic; batch with
``jax.vmap``.  Parity: ``tests/test_physics.py`` checks xpos/xquat/Jacobians/
``mj_fullM``/``qfrc_bias``/``qacc_smooth`` against MuJoCo at random states —
the array-returning public API stacks the scalar core, so the tests pin the
exact code the perf path runs.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .ant_model import AntModel
from .linalg import chol_solve_s

__all__ = ["Kinematics", "SKin", "fk", "kinematics", "mass_matrix",
           "bias_force", "point_jacobian", "smooth_forward",
           "smooth_forward_array"]


# ---------------------------------------------------------------------------
# scalar 3-vector / quaternion / 3x3 helpers (tuples of shape-() arrays;
# Python-float zeros are dropped at trace time — free sparsity)
# ---------------------------------------------------------------------------

def _is0(x) -> bool:
    return isinstance(x, float) and x == 0.0


def v_add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def v_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def v_scale(s, a):
    return tuple(s * x for x in a)


def v_dot(a, b):
    terms = [x * y for x, y in zip(a, b) if not (_is0(x) or _is0(y))]
    if not terms:
        return 0.0
    s = terms[0]
    for t in terms[1:]:
        s = s + t
    return s


def v_cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def q_mul(q, p):
    qw, qx, qy, qz = q
    pw, px, py, pz = p
    return (
        qw * pw - qx * px - qy * py - qz * pz,
        qw * px + qx * pw + qy * pz - qz * py,
        qw * py - qx * pz + qy * pw + qz * px,
        qw * pz + qx * py - qy * px + qz * pw,
    )


def q_to_mat(q):
    """3x3 nested tuple, ``R @ v_body = v_world``."""
    w, x, y, z = q
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )


def m_vec(R, v):
    """R @ v for a 3x3 nested tuple and 3-tuple (zero entries dropped)."""
    return tuple(v_dot(row, v) for row in R)


def mt_vec(R, v):
    """R.T @ v."""
    return tuple(v_dot((R[0][i], R[1][i], R[2][i]), v) for i in range(3))


def _hinge_quat(ang, ax):
    """Quaternion of a rotation by scalar ``ang`` about static unit axis
    ``ax`` (3 Python floats): (cos(a/2), sin(a/2)·ax)."""
    c = jnp.cos(0.5 * ang)
    s = jnp.sin(0.5 * ang)
    return (c, s * ax[0], s * ax[1], s * ax[2])


# ---------------------------------------------------------------------------
# scalar kinematics
# ---------------------------------------------------------------------------

class SKin(NamedTuple):
    """Scalar kinematics: per-env quantities as tuples of shape-() scalars.

    ``jp``/``jr`` hold only the *active* (body, dof) Jacobian columns keyed
    by ``(b, d)`` — the static ``dof_mask`` sparsity applied at trace time.
    """

    xpos: list        # [nb] of 3-tuples
    xquat: list       # [nb] of 4-tuples
    xmat: list        # [nb] of 3x3 nested tuples
    com: list         # [nb] of 3-tuples
    inertia_w: list   # [nb] of 3x3 nested tuples (symmetric)
    dof_u: list       # [nv] of 3-tuples (zeros for translation dofs)
    dof_p: list       # [nv] of 3-tuples
    jp: dict          # {(b,d): 3-tuple} active linear Jacobian columns
    jr: dict          # {(b,d): 3-tuple} active angular columns (rot dofs)


class Kinematics(NamedTuple):
    """Array view of :class:`SKin` (stacked; kept for the oracle tests and
    any array consumer).  The perf path reads ``.s`` — XLA dead-code
    eliminates the stacked arrays when only scalars are consumed."""

    xpos: jnp.ndarray      # [nb,3]
    xquat: jnp.ndarray     # [nb,4]
    xmat: jnp.ndarray      # [nb,3,3]
    com: jnp.ndarray       # [nb,3]
    inertia_w: jnp.ndarray  # [nb,3,3]
    dof_u: jnp.ndarray     # [nv,3]
    dof_p: jnp.ndarray     # [nv,3]
    trans: jnp.ndarray     # [nv] 1.0 for the 3 free translation dofs
    jp: jnp.ndarray        # [nb,nv,3]
    jr: jnp.ndarray        # [nb,nv,3]
    s: Any = None          # the SKin this view was stacked from


def _fk_s(model: AntModel, qpos):
    """Scalar FK → (xpos, xquat) lists.  The 13-body depth-2 tree is
    unrolled in topological order — straight-line code under jit."""
    q = [qpos[i] for i in range(model.nq)]
    rw, rx, ry, rz = q[3], q[4], q[5], q[6]
    nrm = jnp.sqrt(rw * rw + rx * rx + ry * ry + rz * rz)
    inv = 1.0 / nrm
    root_q = (rw * inv, rx * inv, ry * inv, rz * inv)
    xpos = [(q[0], q[1], q[2])]
    xquat = [root_q]
    xmat = [q_to_mat(root_q)]
    for b in range(1, model.nb):
        p = int(model.parent[b])
        off = tuple(float(x) for x in model.body_pos[b])
        pos = v_add(xpos[p], m_vec(xmat[p], off))
        j = int(model.body_jnt[b])
        if j >= 0:
            ax = tuple(float(x) for x in model.jnt_axis[j])
            quat = q_mul(xquat[p], _hinge_quat(q[int(model.jnt_qpos[j])], ax))
        else:
            quat = xquat[p]
        xpos.append(pos)
        xquat.append(quat)
        xmat.append(q_to_mat(quat))
    return xpos, xquat, xmat


def _active_dofs(model: AntModel, b: int):
    return [d for d in range(model.nv) if model.dof_mask[b, d]]


def kinematics_s(model: AntModel, qpos) -> SKin:
    xpos, xquat, xmat = _fk_s(model, qpos)
    nb, nv = model.nb, model.nv

    com = [
        v_add(xpos[b],
              m_vec(xmat[b], tuple(float(x) for x in model.body_ipos[b])))
        for b in range(nb)
    ]
    # I^w = R I R^T (I static floats, symmetric result)
    inertia_w = []
    for b in range(nb):
        I = model.body_inertia[b]
        R = xmat[b]
        RI = tuple(
            tuple(v_dot(R[i], tuple(float(x) for x in I[:, k]))
                  for k in range(3))
            for i in range(3)
        )
        inertia_w.append(
            tuple(tuple(v_dot(RI[i], R[j]) for j in range(3))
                  for i in range(3))
        )

    # per-dof world axis u and anchor p
    dof_u: list = [(0.0, 0.0, 0.0)] * nv
    dof_p: list = [(0.0, 0.0, 0.0)] * nv
    R0 = xmat[0]
    for k in range(3):  # free rotation dofs: torso frame axes @ torso origin
        dof_u[3 + k] = (R0[0][k], R0[1][k], R0[2][k])
        dof_p[3 + k] = xpos[0]
    for j in range(8):
        child = int(model.jnt_body[j])
        ax = tuple(float(x) for x in model.jnt_axis[j])
        dof_u[int(model.jnt_dof[j])] = m_vec(xmat[child], ax)
        dof_p[int(model.jnt_dof[j])] = xpos[child]

    # active CoM-anchored Jacobian columns
    eye = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    jp: dict = {}
    jr: dict = {}
    for b in range(nb):
        for d in _active_dofs(model, b):
            if d < 3:
                jp[(b, d)] = eye[d]
            else:
                jp[(b, d)] = v_cross(dof_u[d], v_sub(com[b], dof_p[d]))
                jr[(b, d)] = dof_u[d]
    return SKin(xpos, xquat, xmat, com, inertia_w, dof_u, dof_p, jp, jr)


def _stack_vecs(vs, dtype):
    return jnp.stack([
        jnp.stack([jnp.asarray(x, dtype) for x in v]) for v in vs
    ])


def _stack_mats(ms, dtype):
    return jnp.stack([
        jnp.stack([jnp.stack([jnp.asarray(x, dtype) for x in row])
                   for row in m]) for m in ms
    ])


def kinematics(model: AntModel, qpos: jnp.ndarray) -> Kinematics:
    """Array view over :func:`kinematics_s` (same core code)."""
    dtype = qpos.dtype
    s = kinematics_s(model, qpos)
    nb, nv = model.nb, model.nv
    zero3 = (0.0, 0.0, 0.0)
    jp = [[s.jp.get((b, d), zero3) for d in range(nv)] for b in range(nb)]
    jr = [[s.jr.get((b, d), zero3) for d in range(nv)] for b in range(nb)]
    return Kinematics(
        xpos=_stack_vecs(s.xpos, dtype),
        xquat=_stack_vecs(s.xquat, dtype),
        xmat=_stack_mats(s.xmat, dtype),
        com=_stack_vecs(s.com, dtype),
        inertia_w=_stack_mats(s.inertia_w, dtype),
        dof_u=_stack_vecs(s.dof_u, dtype),
        dof_p=_stack_vecs(s.dof_p, dtype),
        trans=jnp.zeros((nv,), dtype).at[:3].set(1.0),
        jp=_stack_mats(jp, dtype),
        jr=_stack_mats(jr, dtype),
        s=s,
    )


def fk(model: AntModel, qpos: jnp.ndarray):
    """Forward kinematics → (xpos [nb,3], xquat [nb,4])."""
    xpos, xquat, _ = _fk_s(model, qpos)
    dtype = qpos.dtype
    return _stack_vecs(xpos, dtype), _stack_vecs(xquat, dtype)


# ---------------------------------------------------------------------------
# mass matrix / bias force (scalar core)
# ---------------------------------------------------------------------------

def mass_matrix_s(model: AntModel, s: SKin):
    """Joint-space inertia as a [nv][nv] nested list of scalars
    (== MuJoCo ``mj_fullM``); only active (body, dof-pair) triples emit ops."""
    nv = model.nv
    M = [[0.0] * nv for _ in range(nv)]
    for b in range(model.nb):
        m_b = float(model.body_mass[b])
        act = _active_dofs(model, b)
        iw = s.inertia_w[b]
        for ii, d in enumerate(act):
            jpd = s.jp[(b, d)]
            jrd = s.jr.get((b, d))
            iw_jrd = m_vec(iw, jrd) if jrd is not None else None
            for e in act[ii:]:
                t = m_b * v_dot(jpd, s.jp[(b, e)])
                jre = s.jr.get((b, e))
                if iw_jrd is not None and jre is not None:
                    t = t + v_dot(iw_jrd, jre)
                M[d][e] = M[d][e] + t
    for d in range(nv):
        M[d][d] = M[d][d] + float(model.armature[d])
        for e in range(d + 1, nv):
            M[e][d] = M[d][e]
    return M


def bias_force_s(model: AntModel, s: SKin, qvel):
    """Coriolis + centrifugal + gravity generalized force (``qfrc_bias``),
    scalar RNEA-with-q̈=0 over the active Jacobian columns."""
    nv, nb = model.nv, model.nb
    qv = [qvel[i] for i in range(nv)]

    # body CoM / angular velocities
    cdot = []
    omega = []
    for b in range(nb):
        acc_c = (0.0, 0.0, 0.0)
        acc_w = (0.0, 0.0, 0.0)
        for d in _active_dofs(model, b):
            acc_c = v_add(acc_c, v_scale(qv[d], s.jp[(b, d)]))
            if (b, d) in s.jr:
                acc_w = v_add(acc_w, v_scale(qv[d], s.jr[(b, d)]))
        cdot.append(acc_c)
        omega.append(acc_w)

    # frame rates of the rotation dofs (anchor body: torso for free rot,
    # hinge child otherwise)
    anchor = [0] * nv
    for j in range(8):
        anchor[int(model.jnt_dof[j])] = int(model.jnt_body[j])
    udot = [None] * nv
    pdot = [None] * nv
    for d in range(3, nv):
        a = anchor[d]
        w_a = omega[a]
        udot[d] = v_cross(w_a, s.dof_u[d])
        pdot[d] = v_add(cdot[a], v_cross(w_a, v_sub(s.dof_p[d], s.com[a])))

    # (J̇ q̇) per body with q̈ = 0  →  f = m(a - g), I α + ω×Iω
    g = (0.0, 0.0, float(model.gravity))
    f_lin = []
    f_ang = []
    for b in range(nb):
        a_lin = (0.0, 0.0, 0.0)
        a_ang = (0.0, 0.0, 0.0)
        for d in _active_dofs(model, b):
            if d < 3:
                continue
            arm = v_sub(s.com[b], s.dof_p[d])
            dcol = v_add(
                v_cross(udot[d], arm),
                v_cross(s.dof_u[d], v_sub(cdot[b], pdot[d])),
            )
            a_lin = v_add(a_lin, v_scale(qv[d], dcol))
            a_ang = v_add(a_ang, v_scale(qv[d], udot[d]))
        m_b = float(model.body_mass[b])
        f_lin.append(v_scale(m_b, v_sub(a_lin, g)))
        iw = s.inertia_w[b]
        f_ang.append(
            v_add(m_vec(iw, a_ang), v_cross(omega[b], m_vec(iw, omega[b])))
        )

    bias = [0.0] * nv
    for b in range(nb):
        for d in _active_dofs(model, b):
            t = v_dot(s.jp[(b, d)], f_lin[b])
            if (b, d) in s.jr:
                t = t + v_dot(s.jr[(b, d)], f_ang[b])
            bias[d] = bias[d] + t
    return bias


def mass_matrix(model: AntModel, kin: Kinematics) -> jnp.ndarray:
    """Array wrapper: joint-space inertia [nv,nv] (MuJoCo ``mj_fullM``)."""
    M = mass_matrix_s(model, kin.s)
    dtype = kin.com.dtype
    return jnp.stack([
        jnp.stack([jnp.asarray(x, dtype) for x in row]) for row in M
    ])


def bias_force(model: AntModel, kin: Kinematics,
               qvel: jnp.ndarray) -> jnp.ndarray:
    """Array wrapper: ``qfrc_bias`` [nv]."""
    b = bias_force_s(model, kin.s, qvel)
    return jnp.stack([jnp.asarray(x, qvel.dtype) for x in b])


def point_jacobian(model: AntModel, kin: Kinematics, body: jnp.ndarray,
                   point: jnp.ndarray):
    """Linear Jacobian [..., nv, 3] of world point(s) on given body id(s)
    (array path, dynamic body index — kept for API compatibility; the
    contact pipeline computes its rows in scalar form instead)."""
    dtype = point.dtype
    mask = jnp.asarray(model.dof_mask, dtype=dtype)[body][..., None]
    eye = jnp.concatenate(
        [jnp.eye(3, dtype=dtype), jnp.zeros((model.nv - 3, 3), dtype)]
    )
    arm = point[..., None, :] - kin.dof_p                 # [...,nv,3]
    rot_p = jnp.cross(kin.dof_u, arm)
    t = kin.trans[:, None]
    return mask * (t * eye + (1.0 - t) * rot_p)


# ---------------------------------------------------------------------------
# smooth forward
# ---------------------------------------------------------------------------

def actuation_s(model: AntModel, ctrl):
    """Generalized force from gear-15 torque motors (ctrl clamped to ±1)."""
    tau = [0.0] * model.nv
    for k in range(len(model.act_dof)):
        c = jnp.clip(ctrl[k], -1.0, 1.0)
        tau[int(model.act_dof[k])] = model.gear * c
    return tau


def smooth_forward(model: AntModel, qpos, qvel, ctrl):
    """Unconstrained dynamics → (kin, M, qacc_smooth, qfrc_smooth).

    ``qacc_smooth`` matches MuJoCo's ``mjData.qacc_smooth``.  ``kin`` is the
    array :class:`Kinematics` view carrying the scalar core in ``.s``; the
    stacked arrays are dead code on the perf path.
    """
    dtype = qpos.dtype
    kin = kinematics(model, qpos)
    M_s = mass_matrix_s(model, kin.s)
    bias = bias_force_s(model, kin.s, qvel)
    tau = actuation_s(model, ctrl)
    qv = [qvel[i] for i in range(model.nv)]
    qfrc = [
        tau[d] - float(model.damping[d]) * qv[d] - bias[d]
        for d in range(model.nv)
    ]
    qacc = chol_solve_s(M_s, qfrc)
    M = jnp.stack([
        jnp.stack([jnp.asarray(x, dtype) for x in row]) for row in M_s
    ])
    return (
        kin, M,
        jnp.stack([jnp.asarray(x, dtype) for x in qacc]),
        jnp.stack([jnp.asarray(x, dtype) for x in qfrc]),
    )


def smooth_forward_array(model: AntModel, qpos, qvel, ctrl):
    """Array (batched-einsum) smooth forward — the **compile-friendly** twin
    of :func:`smooth_forward`.

    Same math (CRBA mass matrix, RNEA-with-q̈=0 bias, MuJoCo free-joint
    conventions) expressed over ``[nb,nv,3]`` Jacobian arrays instead of
    per-(body,dof) unrolled scalars, with the 14x14 solve on
    ``jax.scipy.linalg.cho_factor`` instead of the trace-unrolled Cholesky.
    Emits ~5x less HLO than the scalar core — paired with
    :func:`..contact.constraint_rows_array` under
    ``engine.forward(pipeline="array")`` for compile-time-bound settings
    (the XLA:CPU multichip dryrun).  Runtime throughput against the scalar
    core on the GPU is measured in PERF.md; numerics agree
    with the scalar core to fp-association (parity-tested in
    ``tests/test_physics_contact.py::test_array_pipeline_matches_scalar``).

    Returns ``(kin, M, qacc_smooth, qfrc_smooth)`` with ``kin`` a
    :class:`Kinematics` whose ``s`` is ``None``.
    """
    dtype = qpos.dtype
    nb, nv = model.nb, model.nv
    xpos_s, xquat_s, xmat_s = _fk_s(model, qpos)       # scalar FK (small)
    xpos = _stack_vecs(xpos_s, dtype)                  # [nb,3]
    xquat = _stack_vecs(xquat_s, dtype)
    xmat = _stack_mats(xmat_s, dtype)                  # [nb,3,3]

    com = xpos + jnp.einsum(
        "bij,bj->bi", xmat, jnp.asarray(model.body_ipos, dtype))
    iw = jnp.einsum(
        "bij,bjk,blk->bil", xmat, jnp.asarray(model.body_inertia, dtype),
        xmat)

    # per-dof world axis u and anchor p (free rotation: torso frame @ torso
    # origin; hinges: child frame axis @ child origin)
    jb = np.asarray(model.jnt_body)
    jd = np.asarray(model.jnt_dof)
    axis_w = jnp.einsum(
        "jik,jk->ji", xmat[jb], jnp.asarray(model.jnt_axis, dtype))
    dof_u = jnp.zeros((nv, 3), dtype)
    dof_u = dof_u.at[3:6].set(xmat[0].T).at[jd].set(axis_w)
    dof_p = jnp.zeros((nv, 3), dtype)
    dof_p = dof_p.at[3:6].set(xpos[0]).at[jd].set(xpos[jb])
    trans = jnp.zeros((nv,), dtype).at[:3].set(1.0)
    rot = (1.0 - trans) * jnp.asarray(np.arange(nv) >= 3, dtype)

    # CoM-anchored Jacobians with the (body, dof) mask applied numerically
    mask = jnp.asarray(model.dof_mask, dtype)          # [nb,nv]
    eye = jnp.concatenate(
        [jnp.eye(3, dtype=dtype), jnp.zeros((nv - 3, 3), dtype)])
    arm = com[:, None, :] - dof_p[None]                # [nb,nv,3]
    jp = mask[:, :, None] * (
        trans[:, None] * eye + rot[:, None] * jnp.cross(dof_u[None], arm))
    jr = (mask * rot)[:, :, None] * dof_u[None]

    mass_b = jnp.asarray(model.body_mass, dtype)
    M = (
        jnp.einsum("b,bdi,bei->de", mass_b, jp, jp)
        + jnp.einsum("bdi,bij,bej->de", jr, iw, jr)
        + jnp.diag(jnp.asarray(model.armature, dtype))
    )

    # ---- bias: RNEA with q̈=0 (array form of bias_force_s) ----
    cdot = jnp.einsum("bdi,d->bi", jp, qvel)           # [nb,3]
    omega = jnp.einsum("bdi,d->bi", jr, qvel)
    anchor = np.zeros((nv,), np.int64)
    anchor[jd] = jb                                    # d<3 rows are masked
    w_a = omega[anchor]                                # [nv,3]
    udot = jnp.cross(w_a, dof_u)
    pdot = cdot[anchor] + jnp.cross(w_a, dof_p - com[anchor])
    dcol = (jnp.cross(udot[None], arm)
            + jnp.cross(dof_u[None], cdot[:, None] - pdot[None]))
    mrot = mask * rot
    a_lin = jnp.einsum("bd,d,bdi->bi", mrot, qvel, dcol)
    a_ang = jnp.einsum("bd,d,di->bi", mrot, qvel, udot)
    g = jnp.asarray([0.0, 0.0, model.gravity], dtype)
    f_lin = mass_b[:, None] * (a_lin - g)
    f_ang = (jnp.einsum("bij,bj->bi", iw, a_ang)
             + jnp.cross(omega, jnp.einsum("bij,bj->bi", iw, omega)))
    bias = (jnp.einsum("bdi,bi->d", jp, f_lin)
            + jnp.einsum("bdi,bi->d", jr, f_ang))

    tau = jnp.zeros((nv,), dtype).at[np.asarray(model.act_dof)].set(
        model.gear * jnp.clip(ctrl, -1.0, 1.0))
    qfrc = tau - jnp.asarray(model.damping, dtype) * qvel - bias
    qacc = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(M), qfrc)

    kin = Kinematics(xpos=xpos, xquat=xquat, xmat=xmat, com=com,
                     inertia_w=iw, dof_u=dof_u, dof_p=dof_p, trans=trans,
                     jp=jp, jr=jr, s=None)
    return kin, M, qacc, qfrc


def smooth_forward_s(model: AntModel, qpos, qvel, ctrl):
    """Scalar-core smooth forward for the perf path → (skin, M_s [nv][nv]
    lists, qacc list, qfrc list) with no stacked arrays at all."""
    skin = kinematics_s(model, qpos)
    M_s = mass_matrix_s(model, skin)
    bias = bias_force_s(model, skin, qvel)
    tau = actuation_s(model, ctrl)
    qv = [qvel[i] for i in range(model.nv)]
    qfrc = [
        tau[d] - float(model.damping[d]) * qv[d] - bias[d]
        for d in range(model.nv)
    ]
    qacc = chol_solve_s(M_s, qfrc)
    return skin, M_s, qacc, qfrc
