"""Collision detection + soft-constraint solver (MuJoCo model, JAX solve).

Replicates MuJoCo's constraint pipeline for the ant arenas (the substrate
under reference ``gym_po/envs/ant_tag.py:138-158``), reverse-engineered
against ``mjData.efc_*`` / ``mjData.contact`` and validated row-for-row in
``tests/test_physics_contact.py``:

* **Candidates** (static shapes, no dynamic contact lists):
  - floor: the torso sphere + both endpoint spheres of each leg capsule vs
    the z=0 plane — exactly MuJoCo's plane-capsule/plane-sphere contacts,
    25 candidates;
  - walls: MuJoCo's capsule-box collider, reverse-engineered from
    ``mjData.contact`` probes (see :func:`_capsule_box_slots_s`): the
    start and end of the convex segment↔box distance's minimizing set
    (one short f′ bisection each + exact closed-form refinement;
    nearest-face handling inside the box) plus, when they coincide, the
    deepest non-coincident endpoint sphere.  Plus the torso sphere vs
    each box.  3 slots per capsule×wall-slot + 1 — static shapes; mirror
    wall pairs fold into one slot (:func:`_wall_slots`).
* **All candidates become rows**: a candidate with ``dist ≥ margin`` is
  masked (force pinned to 0) — exactly MuJoCo's inclusion rule.  (An
  earlier generation kept only the top-K deepest candidates; with the
  scalar solver below the full static row set is cheaper than the gather
  it replaced, and exact.)
* **Soft constraints**: per row, impedance d(pos) from solimp, and
  ``aref = -B·vel - K·d·(pos - margin)`` with
  ``tc_eff = max(solref[0], 2·dt)``, ``B = 2/(dmax·tc_eff)``,
  ``K = 1/(dmax²·tc_eff²·dampratio²)``, ``R = (1-d)/d · diagApprox`` where
  ``diagApprox = 2μ²(1+μ²)·Σ body_invweight0`` for pyramidal contact rows
  and ``dof_invweight0`` for joint limits (all verified against efc_KBIP /
  efc_R to 1e-6).
* **Solver**: primal Newton in qacc space (MuJoCo's own solver shape) —
  the perf path is :func:`solve_constraints_newton_s`, operating on the
  scalar row structure with **static per-row dof sparsity** (a contact row
  touches ≤ 9 of the 14 dofs; a limit row exactly 1), so under ``vmap``
  every Newton iteration is straight-line [B]-vector code — no batched
  tiny matmuls and no gathers (on the H100 the array formulation is the
  faster one nonetheless: PERF.md).  :func:`solve_constraints_newton` (array) and the APGD dual
  :func:`solve_constraints` are kept for tests/back-compat.

Accelerator-first layout (third generation): every per-candidate and per-row
quantity is a shape-() *scalar* with **static** body → active-dof sparsity
(the Jacobian dot uses ``(u×(pos−p))·n = u·((pos−p)×n)`` so the three
free-rotation entries are one ``R₀ᵀ m`` product).  Nothing is stacked on
the perf path; the :class:`ConstraintRows` array view exists for the
oracle tests and the APGD solver.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .ant_model import AntModel
from .dynamics import (
    Kinematics, SKin, _is0, mt_vec, m_vec, point_jacobian, v_add, v_cross,
    v_dot, v_scale, v_sub,
)
from .linalg import chol_solve, chol_solve_s

__all__ = ["constraint_rows", "constraint_rows_scalar",
           "constraint_rows_array", "solve_constraints",
           "solve_constraints_newton", "solve_constraints_newton_s",
           "ConstraintRows"]

_MINIMP, _MAXIMP = 1e-4, 0.9999


class ConstraintRows(NamedTuple):
    jac_t: jnp.ndarray   # [nv, ne]  (transposed: dof-major, row-minor)
    aref: jnp.ndarray    # [ne]
    r: jnp.ndarray       # [ne] regularizer
    active: jnp.ndarray  # [ne] {0,1}

    @property
    def jac(self) -> jnp.ndarray:
        """[ne, nv] row-major view (tests / APGD path)."""
        return jnp.swapaxes(self.jac_t, -1, -2)


def _impedance(model: AntModel, violation: jnp.ndarray) -> jnp.ndarray:
    """MuJoCo solimp sigmoid d(x); ``violation`` = pos - margin (≤ 0 when
    the constraint is engaged deeper)."""
    d0, dmax, width, mid, power = model.solimp
    x = jnp.clip(jnp.abs(violation) / width, 0.0, 1.0)
    a = 1.0 / mid ** (power - 1.0)
    b = 1.0 / (1.0 - mid) ** (power - 1.0)
    y = jnp.where(
        x <= mid, a * x**power, 1.0 - b * (1.0 - x) ** power
    )
    return jnp.clip(d0 + y * (dmax - d0), _MINIMP, _MAXIMP)


def _kb(model: AntModel):
    dmax = model.solimp[1]
    tc = max(model.solref[0], 2.0 * model.dt)
    dr = model.solref[1]
    k = 1.0 / (dmax * dmax * tc * tc * dr * dr)
    b = 2.0 / (dmax * tc)
    return k, b


# ---------------------------------------------------------------------------
# scalar candidate geometry
# ---------------------------------------------------------------------------

def _sphere_centers_s(model: AntModel, s: SKin):
    """World centers of the 25 collision spheres (torso + 2 per capsule) →
    lists of (center 3-tuple, body id int, radius float, world axis 3-tuple,
    is_sphere bool).  Geom 0 is the torso sphere; geoms 1.. are capsules."""
    out = []
    for g in range(len(model.geom_body)):
        b = int(model.geom_body[g])
        gpos = tuple(float(x) for x in model.geom_pos[g])
        gaxis = tuple(float(x) for x in model.geom_axis[g])
        r = float(model.geom_r[g])
        h = float(model.geom_h[g])
        R = s.xmat[b]
        center = v_add(s.xpos[b], m_vec(R, gpos))
        axis_w = m_vec(R, gaxis)
        if g == 0:
            out.append((center, b, r, axis_w, True))
        else:
            out.append((v_sub(center, v_scale(h, axis_w)), b, r, axis_w,
                        False))
            out.append((v_add(center, v_scale(h, axis_w)), b, r, axis_w,
                        False))
    return out


def _make_frame_s(n):
    """MuJoCo ``mju_makeFrame``: t = ŷ if |n_y| < 0.5 else ẑ, orthogonalize.
    Scalar form; ``n`` is a unit 3-tuple of scalars."""
    ny_small = jnp.abs(n[1]) < 0.5
    t = (0.0, jnp.where(ny_small, 1.0, 0.0), jnp.where(ny_small, 0.0, 1.0))
    d = v_dot(n, t)
    t1 = v_sub(t, v_scale(d, n))
    inv = 1.0 / jnp.sqrt(v_dot(t1, t1))
    t1 = v_scale(inv, t1)
    return t1, v_cross(n, t1)


def _capsule_floor_frame(axis_w):
    """MuJoCo plane-capsule tangent for the z=0 floor: t1 = -normalize(axis
    projected onto the plane); falls back to (0,1,0) (``mju_makeFrame`` of
    ẑ) when the axis is ⟂ to the plane.  t2 = ẑ × t1."""
    px, py = axis_w[0], axis_w[1]
    nrm = jnp.sqrt(px * px + py * py)
    ok = nrm > 1e-8
    inv = -1.0 / jnp.where(ok, nrm, 1.0)
    t1 = (jnp.where(ok, px * inv, 0.0), jnp.where(ok, py * inv, 1.0), 0.0)
    return t1, (-t1[1], t1[0], 0.0)


def _hinges_of_body(model: AntModel, b: int):
    """Static list of (dof index, joint id) whose hinge moves body ``b``."""
    return [
        (int(model.jnt_dof[j]), j)
        for j in range(8)
        if model.dof_mask[b, int(model.jnt_dof[j])]
    ]


def _jrow_entries(model: AntModel, s: SKin, pos, dirs, body: int):
    """Scalar Jacobian-row entries for a contact at world point ``pos`` on
    ``body`` (static id), dotted with each direction in ``dirs``.

    Returns one length-nv list per direction.  Uses the triple-product
    identity ``(u × (pos − p))·dir = u · ((pos − p) × dir)``: the three
    free-rotation entries are one ``R₀ᵀ m`` with ``m = (pos − xpos₀) × dir``.
    """
    nv = model.nv
    R0 = s.xmat[0]
    arm0 = v_sub(pos, s.xpos[0])
    hinges = _hinges_of_body(model, body)
    rows = []
    for dr in dirs:
        col = [0.0] * nv
        for k in range(3):                    # translation dofs
            col[k] = dr[k]
        m0 = v_cross(arm0, dr)
        free = mt_vec(R0, m0)                 # u_k · m0, k = 0..2
        col[3], col[4], col[5] = free[0], free[1], free[2]
        for d, j in hinges:
            mh = v_cross(v_sub(pos, s.dof_p[d]), dr)
            col[d] = v_dot(s.dof_u[d], mh)
        rows.append(col)
    return rows


def _capsules_s(model: AntModel, s: SKin):
    """World endpoints of each capsule geom (geoms 1..) →
    list of (p0 3-tuple, p1 3-tuple, radius float, body id int)."""
    out = []
    for g in range(1, len(model.geom_body)):
        b = int(model.geom_body[g])
        gpos = tuple(float(x) for x in model.geom_pos[g])
        gaxis = tuple(float(x) for x in model.geom_axis[g])
        r = float(model.geom_r[g])
        h = float(model.geom_h[g])
        R = s.xmat[b]
        center = v_add(s.xpos[b], m_vec(R, gpos))
        axis_w = m_vec(R, gaxis)
        out.append((v_sub(center, v_scale(h, axis_w)),
                    v_add(center, v_scale(h, axis_w)), r, b))
    return out


def _sphere_box_s(c, r, lo, hi):
    """Sphere (center ``c``, radius ``r``) vs static AABB [lo, hi], scalar.

    Returns (dist, n 3-tuple, pos 3-tuple, outside bool-scalar) matching
    MuJoCo's ``mjc_SphereBox``: outside the box, the closest-point formula;
    with the center inside, the nearest face (probed against
    ``mjData.contact`` — normal = that face's outward axis, depth = face
    depth + r).  ``n`` points from the box toward the sphere (our row
    convention; MuJoCo's frame normal is the opposite geom1→geom2 sign,
    the J/aref rows agree — see tests)."""
    cp = tuple(jnp.clip(c[k], lo[k], hi[k]) for k in range(3))
    delta = v_sub(c, cp)
    dn = jnp.sqrt(v_dot(delta, delta))
    outside = dn > 1e-12
    inv = 1.0 / jnp.where(outside, dn, 1.0)

    # inside: nearest of the 6 faces (depth ≥ 0 when truly inside)
    best_d = hi[0] - c[0]
    best_n = (1.0, 0.0, 0.0)
    for k, (d_k, n_k) in enumerate(
        [(c[0] - lo[0], (-1.0, 0.0, 0.0)),
         (hi[1] - c[1], (0.0, 1.0, 0.0)),
         (c[1] - lo[1], (0.0, -1.0, 0.0)),
         (hi[2] - c[2], (0.0, 0.0, 1.0)),
         (c[2] - lo[2], (0.0, 0.0, -1.0))]
    ):
        better = d_k < best_d
        best_n = tuple(jnp.where(better, n_k[i], best_n[i]) for i in range(3))
        best_d = jnp.where(better, d_k, best_d)

    dist = jnp.where(outside, dn - r, -(best_d + r))
    n = tuple(jnp.where(outside, delta[k] * inv, best_n[k]) for k in range(3))
    pos = v_sub(c, v_scale(r + 0.5 * dist, n))
    return dist, n, pos, outside


def _capsule_box_slots_s(p0, p1, r, lo, hi, bisect_iters: int = 10):
    """Capsule segment (p0→p1, radius r) vs static AABB — MuJoCo's
    ``mjc_CapsuleBox`` behavior, reverse-engineered from ``mjData.contact``
    probes (a single free capsule vs one box swept over face / edge /
    parallel / past-the-end / under-the-box / inside configurations, plus
    the ant-vs-wall row-parity tests):

    The squared point-box distance f(t) along the segment is convex, so its
    minimizing set is a point or a flat interval.  MuJoCo's (up to two)
    contacts are reproduced by:

    * **slot 1** — the *start* of the minimizing set (bisection on the
      monotone f′ with predicate ``f′ ≥ 0``, snap ``f′(0) ≥ 0 → 0``,
      ``f′(1) < 0 → 1``), e.g. the in-extent endpoint of a capsule lying
      parallel past a wall's end;
    * **slot 2** — the *end* of the minimizing set (predicate ``f′ > 0``,
      snap ``f′(1) ≤ 0 → 1``, ``f′(0) > 0 → 0``), e.g. the box-end edge
      crossing of that same capsule; masked when it coincides with slot 1
      or its point lies inside the box (probed: inside ties → 1 contact);
    * **slot 3** — only when slots 1/2 coincide (unique minimizer): the
      deepest endpoint sphere not coincident with it, outside the box —
      this is MuJoCo's second contact for an almost-parallel capsule whose
      both ends touch, and for a capsule wedged under the box's bottom
      edge.

    Each bisection is refined to the exact minimizer by the closed-form
    quadratic solve over the active residual pattern (taken at the upper
    bracket, falling back to the lower — the union handles u_k = 0 axes on
    flat boundaries), so contact positions are exact to f64 for the parity
    tests, not 2^-iters.  Contact geometry at each point comes from
    :func:`_sphere_box_s` (inside-box points → nearest face).

    Known divergence (documented): for a capsule fully inside the box and
    parallel to a face, MuJoCo's tie-break picks the opposite endpoint;
    dist/normal agree, only the contact position (torque arm) differs.

    Returns three (dist, n, pos, valid) tuples."""
    u = v_sub(p1, p0)

    def at(t):
        return v_add(p0, v_scale(t, u))

    def resid(pt):
        return tuple(
            jnp.maximum(pt[k] - hi[k], 0.0) + jnp.minimum(pt[k] - lo[k], 0.0)
            for k in range(3)
        )

    def fprime(t):
        return v_dot(u, resid(at(t)))

    zero = jnp.zeros_like(p0[0])
    one = zero + 1.0
    fp0, fp1 = fprime(zero), fprime(one)

    def closed_form(lo_t, hi_t):
        out = []
        for t_ref in (hi_t, lo_t):
            rb = resid(at(t_ref))
            num, den = zero, zero
            for k in range(3):
                act = (rb[k] > 0.0) | (rb[k] < 0.0)
                target = jnp.where(rb[k] > 0.0, hi[k], lo[k])
                num = num + jnp.where(act, u[k] * (target - p0[k]), 0.0)
                den = den + jnp.where(act, u[k] * u[k], 0.0)
            out.append((num, den))
        (n_hi, d_hi), (n_lo, d_lo) = out
        num = jnp.where(d_hi > 1e-12, n_hi, n_lo)
        den = jnp.where(d_hi > 1e-12, d_hi, d_lo)
        t = num / jnp.maximum(den, 1e-12)
        return jnp.where(den > 1e-12, jnp.clip(t, 0.0, 1.0),
                         0.5 * (lo_t + hi_t))

    def line_t(strict):
        lo_t, hi_t = zero, one
        for _ in range(bisect_iters):
            mid = 0.5 * (lo_t + hi_t)
            up = fprime(mid) > 0.0 if strict else fprime(mid) >= 0.0
            lo_t = jnp.where(up, lo_t, mid)
            hi_t = jnp.where(up, mid, hi_t)
        t = closed_form(lo_t, hi_t)
        if strict:      # flat-end variant
            return jnp.where(fp1 <= 0.0, 1.0, jnp.where(fp0 > 0.0, 0.0, t))
        return jnp.where(fp0 >= 0.0, 0.0, jnp.where(fp1 < 0.0, 1.0, t))

    t1 = line_t(strict=False)
    t2 = line_t(strict=True)
    d_e0, n_e0, p_e0, out0 = _sphere_box_s(p0, r, lo, hi)
    d_e1, n_e1, p_e1, out1 = _sphere_box_s(p1, r, lo, hi)

    # endpoint-inside override (probed): when an endpoint's center lies
    # inside the box, MuJoCo reports THAT endpoint (nearest face) as the
    # single contact — not the segment's box-entry point
    inside = ~out0 | ~out1
    pick_in1 = jnp.where(~out0 & ~out1, d_e1 <= d_e0, ~out1)
    t1 = jnp.where(inside, jnp.where(pick_in1, 1.0, 0.0), t1)

    dist1, n1, pos1, _ = _sphere_box_s(at(t1), r, lo, hi)
    dist2, n2, pos2, outside2 = _sphere_box_s(at(t2), r, lo, hi)
    unique = jnp.abs(t2 - t1) <= 1e-6
    valid2 = outside2 & ~unique & ~inside

    # slot 3: deepest eligible endpoint when the minimizer is unique
    big = 1e9
    e0 = jnp.where(out0 & (t1 > 1e-6), d_e0, big)
    e1 = jnp.where(out1 & (t1 < 1.0 - 1e-6), d_e1, big)
    pick1 = e1 < e0
    dist3 = jnp.where(pick1, e1, e0)
    n3 = tuple(jnp.where(pick1, n_e1[k], n_e0[k]) for k in range(3))
    pos3 = tuple(jnp.where(pick1, p_e1[k], p_e0[k]) for k in range(3))
    valid3 = unique & ~inside & (dist3 < big * 0.5)
    return ((dist1, n1, pos1, jnp.asarray(True)),
            (dist2, n2, pos2, valid2),
            (dist3, n3, pos3, valid3))


def _wall_slots(walls):
    """Group static wall boxes into mirror-pair slots.

    Arena walls come in x- or y-mirror pairs separated by far more than the
    ant's reach (TAG: 10 m, HH: ≥ 4 m vs ≤ 0.8 m capsule reach), so any
    query point can be in contact with at most the nearer wall of a pair —
    folding a pair into ONE candidate slot whose AABB bounds are selected
    by the query point's sign halves the wall constraint rows at zero
    fidelity loss.  Returns a list of (bounds_pos, bounds_neg|None, axis):
    ``bounds = (lo 3-tuple, hi 3-tuple)`` static floats; for paired slots
    ``bounds_pos`` is the wall on the positive side of ``axis``."""
    walls = np.asarray(walls, dtype=np.float64)

    def bounds(w):
        return (tuple(float(x) for x in w[:3] - w[3:]),
                tuple(float(x) for x in w[:3] + w[3:]))

    used = set()
    slots = []
    for i in range(len(walls)):
        if i in used:
            continue
        paired = None
        for j in range(i + 1, len(walls)):
            if j in used:
                continue
            for ax in (0, 1):
                mirror = walls[i].copy()
                mirror[ax] = -mirror[ax]
                # pair only when the gap dwarfs the ant's ~0.8 m reach
                gap = 2.0 * (abs(walls[i][ax]) - walls[i][3 + ax])
                if np.allclose(mirror, walls[j]) and gap > 2.0:
                    paired = (j, ax)
                    break
            if paired:
                break
        if paired:
            j, ax = paired
            used.add(j)
            pos, neg = (i, j) if walls[i][ax] > 0 else (j, i)
            slots.append((bounds(walls[pos]), bounds(walls[neg]), ax))
        else:
            slots.append((bounds(walls[i]), None, None))
    return slots


def _select_bounds(slot, point):
    """Slot bounds for a query point: static floats for unpaired slots,
    sign-selected traced scalars for mirror pairs."""
    bpos, bneg, ax = slot
    if bneg is None:
        return bpos
    sel = point[ax] > 0.0
    lo = tuple(jnp.where(sel, bpos[0][k], bneg[0][k]) for k in range(3))
    hi = tuple(jnp.where(sel, bpos[1][k], bneg[1][k]) for k in range(3))
    return lo, hi


def contact_candidates_s(model: AntModel, s: SKin):
    """All candidate contacts in scalar form → list of dicts with keys
    ``dist`` (scalar), ``jn``/``jt1``/``jt2`` (length-nv scalar lists),
    ``invweight`` (static float).  nc = 25 + (3·n_capsules + 1)·n_slots,
    static order: floor spheres, then per wall slot (torso, capsule
    triples)."""
    spheres = _sphere_centers_s(model, s)
    capsules = _capsules_s(model, s)
    inv0 = _body_invweight(model)
    cands = []

    def emit(dist, n, pos, body):
        t1, t2 = _make_frame_s(n)
        jn, jt1, jt2 = _jrow_entries(model, s, pos, (n, t1, t2), body)
        cands.append(dict(dist=dist, jn=jn, jt1=jt1, jt2=jt2,
                          invweight=float(inv0[body])))

    # floor plane z=0: n = ẑ (static frame for the torso sphere)
    for c, b, r, axis_w, is_sphere in spheres:
        dist = c[2] - r
        pos = (c[0], c[1], c[2] - (r + 0.5 * dist))
        if is_sphere:
            t1, t2 = (0.0, 1.0, 0.0), (-1.0, 0.0, 0.0)
        else:
            t1, t2 = _capsule_floor_frame(axis_w)
        jn, jt1, jt2 = _jrow_entries(
            model, s, pos, ((0.0, 0.0, 1.0), t1, t2), b)
        cands.append(dict(dist=dist, jn=jn, jt1=jt1, jt2=jt2,
                          invweight=float(inv0[b])))

    # wall slots (mirror-paired AABBs): torso sphere + MuJoCo capsule-box.
    # The capsule-box slot computation is BATCHED over the capsules (tuples
    # of [n_capsules]-arrays through the shape-polymorphic geometry helpers)
    # and sliced back to per-candidate scalars: ONE traced copy of the
    # bisection/refinement code per wall slot instead of one per capsule —
    # the unrolled form measured ~45k of the forward's 168k HLO lines, and
    # XLA compile time is a first-class cost of this engine.  Geometry is
    # cold next to the solver, so batching it costs no runtime.  (Batching
    # the HOT regions the same way — class-stacked solver rows, batched
    # Jacobian rows — was measured slower on the previous accelerator and
    # reverted; see docs/ARCHITECTURE.md negative results.)
    torso_c, torso_b, torso_r, _, _ = spheres[0]
    big = 1e9
    p0s = tuple(jnp.stack([c[0][k] for c in capsules]) for k in range(3))
    p1s = tuple(jnp.stack([c[1][k] for c in capsules]) for k in range(3))
    # radii are static floats; pin the stack to the traced dtype (a bare
    # np.float64 array would promote the whole f32 pipeline under x64 mode)
    r_caps = jnp.asarray(np.array([c[2] for c in capsules]),
                         p0s[0].dtype)

    def at_i(val, i):
        """Slice candidate i out of a batched scalar (0-d statics pass
        through — e.g. the always-True valid flag of slot 1)."""
        return val if jnp.ndim(val) == 0 else val[i]

    for slot in _wall_slots(model.walls):
        lo, hi = _select_bounds(slot, torso_c)
        dist, n, pos, _ = _sphere_box_s(torso_c, torso_r, lo, hi)
        emit(dist, n, pos, torso_b)
        mids = tuple(0.5 * (p0s[k] + p1s[k]) for k in range(3))
        lo_c, hi_c = _select_bounds(slot, mids)
        slots3 = _capsule_box_slots_s(p0s, p1s, r_caps, lo_c, hi_c)
        for i, (_, _, _, b) in enumerate(capsules):
            for d_i, n_i, q_i, valid in slots3:
                emit(jnp.where(at_i(valid, i), at_i(d_i, i), big),
                     tuple(at_i(n_i[k], i) for k in range(3)),
                     tuple(at_i(q_i[k], i) for k in range(3)), b)
    return cands


# ---------------------------------------------------------------------------
# invweight precomputation (MuJoCo *_invweight0, f64 NumPy, one-time)
# ---------------------------------------------------------------------------

_INVWEIGHT_CACHE: dict = {}


def _qpos0_jacobians(model: AntModel):
    """NumPy CoM Jacobians + mass matrix at qpos0 (identity rotations), f64.

    Used only for the one-time invweight precomputation so it is exact
    regardless of the session's JAX x64 mode (MuJoCo precomputes
    ``*_invweight0`` at f64; R-parity tests compare at 1e-12)."""
    nb, nv = model.nb, model.nv
    xpos = np.zeros((nb, 3))
    for b in range(1, nb):
        xpos[b] = xpos[model.parent[b]] + model.body_pos[b]
    com = xpos + model.body_ipos
    u = np.zeros((nv, 3))
    p = np.zeros((nv, 3))
    u[3:6] = np.eye(3)
    u[model.jnt_dof] = model.jnt_axis
    p[model.jnt_dof] = xpos[model.jnt_body]
    jp = np.zeros((nb, nv, 3))
    jr = np.zeros((nb, nv, 3))
    for b in range(nb):
        for d in range(nv):
            if not model.dof_mask[b, d]:
                continue
            if d < 3:
                jp[b, d, d] = 1.0
            else:
                jp[b, d] = np.cross(u[d], com[b] - p[d])
                jr[b, d] = u[d]
    M = (
        np.einsum("b,bdi,bei->de", model.body_mass, jp, jp)
        + np.einsum("bdi,bij,bej->de", jr, model.body_inertia, jr)
        + np.diag(model.armature)
    )
    return jp, M


def _body_invweight(model: AntModel) -> np.ndarray:
    """MuJoCo ``body_invweight0``: mean translational inverse inertia of each
    body at qpos0, diag(J M⁻¹ Jᵀ)/3 at the body CoM."""
    key = id(model)
    if key not in _INVWEIGHT_CACHE:
        jp, M = _qpos0_jacobians(model)
        minv = np.linalg.inv(M)
        _INVWEIGHT_CACHE[key] = np.einsum("bdi,de,bei->b", jp, minv, jp) / 3.0
    return _INVWEIGHT_CACHE[key]


_DOF_INVWEIGHT_CACHE: dict = {}


def _dof_invweight(model: AntModel) -> np.ndarray:
    """MuJoCo ``dof_invweight0``: diag(M⁻¹) at qpos0, with the free joint's
    translation and rotation triplets each averaged."""
    key = id(model)
    if key not in _DOF_INVWEIGHT_CACHE:
        _, M = _qpos0_jacobians(model)
        w = np.diag(np.linalg.inv(M)).copy()
        w[0:3] = w[0:3].mean()
        w[3:6] = w[3:6].mean()
        _DOF_INVWEIGHT_CACHE[key] = w
    return _DOF_INVWEIGHT_CACHE[key]


# ---------------------------------------------------------------------------
# row assembly
# ---------------------------------------------------------------------------

def constraint_rows_scalar(model: AntModel, s: SKin, qpos, qvel):
    """Scalar row structure — the perf path's native form.

    Returns a list of dicts ``{"j": length-nv list (Python-float 0.0 for
    structurally-inactive dofs — static sparsity), "aref", "r", "active"}``:
    the 8 joint-limit rows, then 4 pyramid rows per contact candidate in
    candidate order (+t1, −t1, +t2, −t2).  Every value is a shape-()
    scalar; under ``vmap`` each becomes a [B] lane vector."""
    k_stiff, b_damp = _kb(model)
    margin = 2.0 * model.margin   # pair margin = sum of geom margins
    nv = model.nv
    qv = [qvel[i] for i in range(nv)]
    dof_iw = _dof_invweight(model)
    rows = []

    # ---- joint limit rows (8, one per hinge; nearer bound) ----
    for j in range(8):
        q = qpos[int(model.jnt_qpos[j])]
        lo, hi = float(model.jnt_range[j, 0]), float(model.jnt_range[j, 1])
        d_lo, d_hi = q - lo, hi - q
        lower = d_lo <= d_hi
        pos_lim = jnp.where(lower, d_lo, d_hi)
        sign = jnp.where(lower, 1.0, -1.0)
        imp = _impedance(model, pos_lim)
        dof = int(model.jnt_dof[j])
        jrow = [0.0] * nv
        jrow[dof] = sign
        rows.append(dict(
            j=jrow,
            aref=-b_damp * (sign * qv[dof]) - k_stiff * imp * pos_lim,
            r=(1.0 - imp) / imp * float(dof_iw[dof]),
            active=pos_lim < 0.0,
        ))

    # ---- contact pyramid rows (4 per candidate) ----
    mu = model.friction
    for c in contact_candidates_s(model, s):
        dist = c["dist"]
        violation = dist - margin
        active = dist < margin
        imp = _impedance(model, violation)
        vel_n = v_dot(qv, c["jn"])
        kd = k_stiff * imp * violation
        r_c = ((1.0 - imp) / imp
               * (2.0 * mu * mu * (1.0 + mu * mu) * c["invweight"]))
        for tkey in ("jt1", "jt2"):
            jt = c[tkey]
            vel_t = v_dot(qv, jt)
            for sgn in (1.0, -1.0):
                rows.append(dict(
                    j=[c["jn"][d] + sgn * mu * jt[d] for d in range(nv)],
                    aref=-b_damp * (vel_n + sgn * mu * vel_t) - kd,
                    r=r_c,
                    active=active,
                ))
    return rows


def constraint_rows_array(model: AntModel, kin: Kinematics, qpos,
                          qvel) -> ConstraintRows:
    """Batched (array) constraint rows — the **compile-friendly** pipeline.

    Same candidate set, order, and row formulas as
    :func:`constraint_rows_scalar` (asserted numerically in
    ``tests/test_physics_contact.py::test_array_pipeline_matches_scalar``),
    but built from *stacked candidate arrays*: the capsule-box and
    plane-capsule geometry runs ONCE with a leading capsule axis (the scalar
    geometry helpers are shape-polymorphic, so they are reused verbatim on
    ``[n_capsules]``-array leaves), and Jacobian rows come from the dense
    masked :func:`..dynamics.point_jacobian` instead of per-candidate
    unrolled columns.  The emitted HLO is ~50x smaller than the scalar
    pipeline's — this is what keeps the XLA:CPU multichip dryrun compile in
    budget (``__graft_entry__.dryrun_multichip``).  Which pipeline is
    faster at runtime on the GPU is measured in PERF.md (the scalar
    pipeline's static per-row dof sparsity is what
    :func:`solve_constraints_newton_s` exploits).

    ``kin`` must be the array :class:`Kinematics` view.  Pair with the array
    solver :func:`solve_constraints_newton` via
    ``engine.forward(..., pipeline="array")``.
    """
    dtype = qpos.dtype
    big = 1e9
    gb = np.asarray(model.geom_body)
    ncap = len(gb) - 1

    xpos_g = kin.xpos[gb]                                   # [ng,3]
    xmat_g = kin.xmat[gb]                                   # [ng,3,3]
    centers = xpos_g + jnp.einsum(
        "gij,gj->gi", xmat_g, jnp.asarray(model.geom_pos, dtype))
    axis_w = jnp.einsum(
        "gij,gj->gi", xmat_g, jnp.asarray(model.geom_axis, dtype))
    r_g = jnp.asarray(model.geom_r, dtype)
    p0 = centers[1:] - model.geom_h[1:, None] * axis_w[1:]  # [ncap,3]
    p1 = centers[1:] + model.geom_h[1:, None] * axis_w[1:]

    # ---- floor candidates: torso sphere + both capsule endpoints ----
    ends = jnp.stack([p0, p1], axis=1).reshape(-1, 3)       # [2*ncap,3]
    sph_c = jnp.concatenate([centers[:1], ends])
    sph_r = jnp.concatenate([r_g[:1], jnp.repeat(r_g[1:], 2)])
    dist_f = sph_c[:, 2] - sph_r
    pos_f = sph_c.at[:, 2].add(-(sph_r + 0.5 * dist_f))
    n_f = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 1.0], dtype), sph_c.shape)
    ax2 = jnp.repeat(axis_w[1:], 2, axis=0)                 # per endpoint
    t1c, t2c = _capsule_floor_frame((ax2[:, 0], ax2[:, 1], ax2[:, 2]))
    zc = jnp.zeros_like(t1c[0])
    t1_f = jnp.concatenate([
        jnp.asarray([[0.0, 1.0, 0.0]], dtype),
        jnp.stack([t1c[0], t1c[1], zc], -1),
    ])
    t2_f = jnp.concatenate([
        jnp.asarray([[-1.0, 0.0, 0.0]], dtype),
        jnp.stack([t2c[0], t2c[1], zc], -1),
    ])
    body_f = np.concatenate([gb[:1], np.repeat(gb[1:], 2)])

    # ---- wall candidates: per slot, torso sphere-box + capsule-box ----
    torso_c = (centers[0, 0], centers[0, 1], centers[0, 2])
    mid = 0.5 * (p0 + p1)
    p0t = (p0[:, 0], p0[:, 1], p0[:, 2])
    p1t = (p1[:, 0], p1[:, 1], p1[:, 2])
    dist_w, n_w, pos_w, body_w = [], [], [], []
    for slot in _wall_slots(model.walls):
        lo, hi = _select_bounds(slot, torso_c)
        d_t, n_t, q_t, _ = _sphere_box_s(torso_c, r_g[0], lo, hi)
        dist_w.append(jnp.asarray(d_t, dtype)[None])
        n_w.append(jnp.stack(n_t)[None])
        pos_w.append(jnp.stack(q_t)[None])
        body_w.append(gb[:1])

        lo_c, hi_c = _select_bounds(slot, (mid[:, 0], mid[:, 1], mid[:, 2]))
        slots3 = _capsule_box_slots_s(p0t, p1t, r_g[1:], lo_c, hi_c)
        # capsule-major interleave matches the scalar emission order
        dist_w.append(jnp.stack(
            [jnp.where(v, d, big) for d, _, _, v in slots3], 1
        ).reshape(-1))
        n_w.append(jnp.stack(
            [jnp.stack(n, -1) for _, n, _, _ in slots3], 1
        ).reshape(-1, 3))
        pos_w.append(jnp.stack(
            [jnp.stack(q, -1) for _, _, q, _ in slots3], 1
        ).reshape(-1, 3))
        body_w.append(np.repeat(gb[1:], 3))

    n_wall = jnp.concatenate(n_w)
    t1w, t2w = _make_frame_s((n_wall[:, 0], n_wall[:, 1], n_wall[:, 2]))

    # ---- assemble candidate arrays (floor first — scalar order) ----
    dist = jnp.concatenate([dist_f] + dist_w)
    pos = jnp.concatenate([pos_f] + pos_w)
    n = jnp.concatenate([n_f, n_wall])
    t1 = jnp.concatenate([t1_f, jnp.stack(t1w, -1)])
    t2 = jnp.concatenate([t2_f, jnp.stack(t2w, -1)])
    body = np.concatenate([body_f] + body_w)
    invw = jnp.asarray(_body_invweight(model)[body], dtype)

    jac3 = point_jacobian(model, kin, jnp.asarray(body), pos)  # [nc,nv,3]
    jn = jnp.einsum("cvi,ci->cv", jac3, n)
    jt1 = jnp.einsum("cvi,ci->cv", jac3, t1)
    jt2 = jnp.einsum("cvi,ci->cv", jac3, t2)

    k_stiff, b_damp = _kb(model)

    # ---- joint-limit rows (8) ----
    jd = np.asarray(model.jnt_dof)
    q_j = qpos[np.asarray(model.jnt_qpos)]
    lo_j = jnp.asarray(model.jnt_range[:, 0], dtype)
    hi_j = jnp.asarray(model.jnt_range[:, 1], dtype)
    d_lo, d_hi = q_j - lo_j, hi_j - q_j
    lower = d_lo <= d_hi
    pos_lim = jnp.where(lower, d_lo, d_hi)
    sign = jnp.where(lower, 1.0, -1.0).astype(dtype)
    imp_l = _impedance(model, pos_lim)
    sel = np.zeros((8, model.nv))
    sel[np.arange(8), jd] = 1.0
    jac_l = sign[:, None] * jnp.asarray(sel, dtype)
    aref_l = -b_damp * (sign * qvel[jd]) - k_stiff * imp_l * pos_lim
    r_l = (1.0 - imp_l) / imp_l * jnp.asarray(_dof_invweight(model)[jd],
                                              dtype)
    active_l = (pos_lim < 0.0).astype(dtype)

    # ---- contact pyramid rows (4 per candidate: +t1, -t1, +t2, -t2) ----
    margin = 2.0 * model.margin
    mu = model.friction
    violation = dist - margin
    active_c = (dist < margin).astype(dtype)
    imp_c = _impedance(model, violation)
    kd = k_stiff * imp_c * violation
    r_c = ((1.0 - imp_c) / imp_c
           * (2.0 * mu * mu * (1.0 + mu * mu)) * invw)
    vel_n = jn @ qvel
    vel_t1 = jt1 @ qvel
    vel_t2 = jt2 @ qvel
    jac_c = jnp.stack(
        [jn + mu * jt1, jn - mu * jt1, jn + mu * jt2, jn - mu * jt2], 1
    ).reshape(-1, model.nv)
    aref_c = jnp.stack(
        [-b_damp * (vel_n + mu * vel_t1) - kd,
         -b_damp * (vel_n - mu * vel_t1) - kd,
         -b_damp * (vel_n + mu * vel_t2) - kd,
         -b_damp * (vel_n - mu * vel_t2) - kd], 1
    ).reshape(-1)

    return ConstraintRows(
        jac_t=jnp.concatenate([jac_l, jac_c]).T,
        aref=jnp.concatenate([aref_l, aref_c]),
        r=jnp.concatenate([r_l, jnp.repeat(r_c, 4)]),
        active=jnp.concatenate([active_l, jnp.repeat(active_c, 4)]),
    )


def constraint_rows(model: AntModel, kin, qpos, qvel) -> ConstraintRows:
    """Array view over :func:`constraint_rows_scalar` (oracle tests + the
    APGD/array solvers): all rows stacked, ``jac_t ∈ [nv, ne]``.

    ``kin`` may be a :class:`Kinematics` (array view carrying ``.s``) or an
    :class:`SKin` directly."""
    s: SKin = kin.s if isinstance(kin, Kinematics) else kin
    dtype = qpos.dtype
    rows = constraint_rows_scalar(model, s, qpos, qvel)

    def stack(vals):
        return jnp.stack([jnp.asarray(v, dtype) for v in vals])

    return ConstraintRows(
        jac_t=jnp.stack(
            [stack([row["j"][d] for row in rows])
             for d in range(model.nv)]
        ),
        aref=stack([row["aref"] for row in rows]),
        r=stack([row["r"] for row in rows]),
        active=stack([row["active"] for row in rows]),
    )


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

def solve_constraints(model: AntModel, M, qacc_smooth, rows: ConstraintRows,
                      iters: int = 250, f0=None):
    """APGD on the dual QP → (qacc, f).

    ``min_{f≥0} ½fᵀ(A+R)f + fᵀ(J·qacc_smooth − aref)`` with
    ``A = J M⁻¹ Jᵀ``; then ``qacc = qacc_smooth + M⁻¹Jᵀf``.  Inactive rows
    are pinned to f=0 by projection.  Fixed iteration count; the step size
    uses the ∞-norm upper bound on λmax(A+R), and Nesterov momentum is
    restarted on non-monotone steps (gradient-mapping test).
    """
    # inactive rows are pinned to f=0 by projection; mask them out of the
    # matrix too, so the ∞-norm Lipschitz estimate isn't poisoned by masked
    # candidates' sentinel distances (their aref/R can be huge)
    j = rows.jac * rows.active[:, None]
    # X = M⁻¹ Jᵀ via Cholesky (M is SPD)
    chol = jax.scipy.linalg.cho_factor(M)
    x = jax.scipy.linalg.cho_solve(chol, j.T)           # [nv,ne]
    a = j @ x                                           # [ne,ne]
    b = (j @ qacc_smooth - rows.aref) * rows.active
    ar = a + jnp.diag(rows.r * rows.active)
    lip = jnp.max(jnp.sum(jnp.abs(ar), axis=1))
    step = 1.0 / lip
    mask = rows.active

    def proj(f):
        return jnp.maximum(f * mask, 0.0)

    def body(_, carry):
        f, y, t = carry
        g = ar @ y + b
        f_new = proj(y - step * g)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        # restart momentum if progress reverses (Beck-Teboulle heuristic)
        restart = jnp.sum((y - f_new) * (f_new - f)) > 0.0
        t_new = jnp.where(restart, 1.0, t_new)
        y_new = f_new + ((t - 1.0) / t_new) * (f_new - f)
        y_new = jnp.where(restart, f_new, y_new)
        return f_new, y_new, t_new

    f0 = proj(jnp.zeros_like(b) if f0 is None else f0)
    f, _, _ = jax.lax.fori_loop(0, iters, body, (f0, f0, jnp.ones((), b.dtype)))
    qacc = qacc_smooth + x @ f
    return qacc, f


def solve_constraints_newton(model: AntModel, M, qacc_smooth,
                             rows: ConstraintRows, iters: int = 8,
                             ls_iters: int = 10, qacc0=None):
    """Primal Newton solve — MuJoCo's own solver shape, batch-sized.

    Minimizes the piecewise-quadratic primal cost
    ``φ(q) = ½(q−qs)ᵀM(q−qs) + ½ Σ_i D_i · min(J_i q − aref_i, 0)²``
    (D = 1/R; one-sided rows).  Its optimum satisfies exactly the same KKT
    system as the dual QP in :func:`solve_constraints` — forces recover as
    ``f_i = −D_i · min(J_i q − aref_i, 0)``.

    Why this beats APGD: the iteration count drops from O(100) to
    ~8 (quadratic convergence), so the sequential chain per dynamics eval
    is ~8 batched 14×14 Cholesky solves + J matvecs instead of hundreds of
    [ne,ne] matvecs.  The exact line search along each Newton direction is
    a fixed ``ls_iters``-step bisection on the monotone derivative φ'(α)
    (φ is convex piecewise-quadratic along any ray).  All matvecs ride the
    ``jac_t`` [nv,ne] layout — contraction over the packed ne axis.
    """
    dtype = qacc_smooth.dtype
    jt = rows.jac_t                                     # [nv, ne]
    d = rows.active / jnp.maximum(rows.r, 1e-12)        # D_i, masked

    q0 = qacc_smooth if qacc0 is None else qacc0

    def force(jq):
        return -d * jnp.minimum(jq - rows.aref, 0.0)

    def body(_, q):
        jq = q @ jt                                     # [ne]
        f = force(jq)
        grad = M @ (q - qacc_smooth) - jt @ f
        act = d * (jq - rows.aref < 0.0)
        h = M + (jt * act) @ jt.T                       # [nv,nv]
        dq = -chol_solve(h, grad)
        # exact line search: bisect φ'(α) on [0, 2]
        jdq = dq @ jt
        mdq = M @ dq
        g0 = jnp.dot(dq, M @ (q - qacc_smooth))
        gq = jnp.dot(dq, mdq)

        def dphi(alpha):
            slack = jq + alpha * jdq - rows.aref
            return (g0 + alpha * gq
                    + jnp.dot(jdq, d * jnp.minimum(slack, 0.0)))

        def bisect(_, ab):
            lo, hi = ab
            mid = 0.5 * (lo + hi)
            pos = dphi(mid) > 0.0
            return jnp.where(pos, lo, mid), jnp.where(pos, mid, hi)

        lo, hi = jax.lax.fori_loop(
            0, ls_iters, bisect,
            (jnp.zeros((), dtype), jnp.asarray(2.0, dtype)),
        )
        alpha = 0.5 * (lo + hi)
        return q + alpha * dq

    q = jax.lax.fori_loop(0, iters, body, q0)
    return q, force(q @ jt)


def solve_constraints_newton_s(model: AntModel, M_s, qacc_smooth, rows,
                               iters: int = 8, ls_iters: int = 10,
                               qacc0=None):
    """Primal Newton solve on the scalar row structure — the perf path.

    Same math as :func:`solve_constraints_newton` (piecewise-quadratic
    primal cost, exact bisection line search), but every quantity is a
    shape-() scalar and every row keeps its **static** dof support (≤ 9
    entries for contacts, 1 for limits; Python-0.0 entries are dropped at
    trace time).  Under ``vmap`` each Newton iteration is straight-line
    [B]-vector code — the array formulation's batched 14×ne×14 matmuls
    measured 95% of total forward time at B=4096 on the previous
    accelerator (they lower to tiny padded matrix-unit dots); this one is
    pure elementwise work.

    ``M_s`` is the nested-list mass matrix from
    :func:`..dynamics.mass_matrix_s` (its per-leg block sparsity is also
    applied at trace time), ``qacc_smooth``/``qacc0`` are length-nv scalar
    lists, ``rows`` comes from :func:`constraint_rows_scalar`.  Returns a
    length-nv scalar list.

    A chord (frozen-Hessian) tail phase was measured and REMOVED: every
    mix lost to pure full Newton on the previous accelerator (the frozen
    factor's 105 [B]-arrays stay live across a second loop and the exact
    line search, the real per-iteration cost, is kept), see
    docs/ARCHITECTURE.md negative results."""

    nv = model.nv
    supports = [
        [(d, row["j"][d]) for d in range(nv) if not _is0(row["j"][d])]
        for row in rows
    ]
    dcoef = [
        jnp.where(row["active"], 1.0 / jnp.maximum(row["r"], 1e-12), 0.0)
        for row in rows
    ]
    aref = [row["aref"] for row in rows]
    nr = len(rows)
    qs = qacc_smooth
    q0 = qs if qacc0 is None else qacc0

    def m_mul(x):
        out = []
        for d in range(nv):
            acc = 0.0
            for e in range(nv):
                if not _is0(M_s[d][e]):
                    acc = acc + M_s[d][e] * x[e]
            out.append(acc)
        return out

    def jdot(sup, x):
        acc = 0.0
        for d, cf in sup:
            acc = acc + cf * x[d]
        return acc

    def grad_slack(q):
        mq = m_mul([q[d] - qs[d] for d in range(nv)])
        slack = [jdot(supports[rx], q) - aref[rx] for rx in range(nr)]
        grad = list(mq)
        for rx in range(nr):
            f_r = -dcoef[rx] * jnp.minimum(slack[rx], 0.0)
            for d, cf in supports[rx]:
                grad[d] = grad[d] - cf * f_r
        return mq, slack, grad

    def assemble_h(slack):
        # Hessian: M + Σ_r act_r J_r J_rᵀ over each row's static support
        h = [[M_s[d][e] for e in range(nv)] for d in range(nv)]
        for rx in range(nr):
            act = jnp.where(slack[rx] < 0.0, dcoef[rx], 0.0)
            sup = supports[rx]
            for i, (d, cd) in enumerate(sup):
                acd = act * cd
                for e, ce in sup[i:]:
                    h[d][e] = h[d][e] + acd * ce
        for d in range(nv):
            for e in range(d + 1, nv):
                h[e][d] = h[d][e]
        return h

    def ls_update(q, mq, slack, dq):
        # Exact bisection line search on the true (piecewise-quadratic) cost
        jdq = [jdot(supports[rx], dq) for rx in range(nr)]
        mdq = m_mul(dq)
        g0 = sum(dq[d] * mq[d] for d in range(nv))
        gq = sum(dq[d] * mdq[d] for d in range(nv))

        def dphi(alpha):
            acc = g0 + alpha * gq
            for rx in range(nr):
                acc = acc + jdq[rx] * dcoef[rx] * jnp.minimum(
                    slack[rx] + alpha * jdq[rx], 0.0)
            return acc

        def bisect(_, ab):
            lo, hi = ab
            mid = 0.5 * (lo + hi)
            pos = dphi(mid) > 0.0
            return jnp.where(pos, lo, mid), jnp.where(pos, mid, hi)

        zero = jnp.zeros_like(g0)
        lo, hi = jax.lax.fori_loop(0, ls_iters, bisect, (zero, zero + 2.0))
        alpha = 0.5 * (lo + hi)
        return tuple(q[d] + alpha * dq[d] for d in range(nv))

    def body(_, q):
        q = list(q)
        mq, slack, grad = grad_slack(q)
        dq = chol_solve_s(assemble_h(slack), [-g for g in grad])
        return ls_update(q, mq, slack, dq)

    q = jax.lax.fori_loop(0, iters, body, tuple(q0))

    return list(q)
