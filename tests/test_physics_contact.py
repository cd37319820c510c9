"""Oracle tests for the constraint layer + integrator vs MuJoCo.

The soft-constraint model (impedance, K/B, R regularizers, pyramidal rows)
was reverse-engineered from ``mjData.efc_*``; these tests pin every piece
row-for-row, then check the full fixed point (qacc) and multi-step RK4
trajectories against ``mj_step``.  Reference substrate:
``gym_po/envs/ant_tag.py:138-158`` (MuJoCo C driving the same MJCF).
"""

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

import jax
import jax.numpy as jnp

from gym_po_tpu.envs.mjcf import ant_tag_xml
from gym_po_tpu.physics import ant_model as am
from gym_po_tpu.physics import contact as con
from gym_po_tpu.physics import dynamics as dyn
from gym_po_tpu.physics import engine as eng

STAND = np.zeros(15)
STAND[2] = 0.55
STAND[3] = 1.0
STAND[7:] = [0.0, 1.0, 0.0, -1.0, 0.0, -1.0, 0.0, 1.0]


@pytest.fixture(scope="module")
def oracle():
    m = mujoco.MjModel.from_xml_string(ant_tag_xml())
    return m, mujoco.MjData(m), am.make_ant_model(am.TAG_WALLS)


def test_invweights_match_mujoco(oracle):
    m, _, mdl = oracle
    np.testing.assert_allclose(
        con._body_invweight(mdl), m.body_invweight0[1:14, 0], atol=1e-12
    )
    np.testing.assert_allclose(
        con._dof_invweight(mdl), m.dof_invweight0, atol=1e-12
    )


def _active_rows(rows):
    act = np.asarray(rows.active).astype(bool)
    return (np.asarray(rows.jac)[act], np.asarray(rows.aref)[act],
            np.asarray(rows.r)[act], act)


def _match_rows(my_j, mj_j):
    """Permutation aligning my active rows with MuJoCo's efc rows."""
    perm = []
    for i in range(mj_j.shape[0]):
        perm.append(int(np.argmin(np.abs(my_j - mj_j[i]).max(axis=1))))
    assert len(set(perm)) == mj_j.shape[0], "rows not 1:1"
    return np.asarray(perm)


def test_contact_rows_exact(oracle):
    """Standing pose, 4 foot contacts: J / aref / R match efc_* to 1e-10."""
    m, d, mdl = oracle
    with jax.enable_x64(True):
        d.qpos[:] = STAND
        d.qvel[:] = 0.1 * np.arange(14)
        d.ctrl[:] = 0.3
        mujoco.mj_forward(m, d)
        assert d.nefc == 16

        kin, M, qacc_s, _ = dyn.smooth_forward(
            mdl, jnp.array(d.qpos), jnp.array(d.qvel), jnp.array(d.ctrl)
        )
        rows = con.constraint_rows(mdl, kin, jnp.array(d.qpos),
                                   jnp.array(d.qvel))
        my_j, my_aref, my_r, act = _active_rows(rows)
        assert act.sum() == d.nefc
        mj_j = d.efc_J.reshape(d.nefc, 14)
        perm = _match_rows(my_j, mj_j)
        np.testing.assert_allclose(my_j[perm], mj_j, atol=1e-12)
        np.testing.assert_allclose(my_aref[perm], d.efc_aref[: d.nefc],
                                   atol=1e-10)
        np.testing.assert_allclose(my_r[perm], d.efc_R[: d.nefc], atol=1e-12)

        qacc, f = con.solve_constraints(mdl, M, qacc_s, rows, iters=1000)
        np.testing.assert_allclose(np.asarray(qacc), d.qacc, atol=1e-8)
        np.testing.assert_allclose(
            np.asarray(f)[act][perm], d.efc_force[: d.nefc], atol=1e-6
        )


def test_limit_rows_exact(oracle):
    """Ankle bent past its 70° bound → one limit row matching efc."""
    m, d, mdl = oracle
    with jax.enable_x64(True):
        qpos = STAND.copy()
        qpos[2] = 2.0          # airborne: the limit is the only constraint
        qpos[8] = 1.25         # ankle_1 beyond 1.2217
        d.qpos[:] = qpos
        d.qvel[:] = 0.05 * np.arange(14)
        d.ctrl[:] = 0.0
        mujoco.mj_forward(m, d)
        assert d.nefc == 1 and d.efc_type[0] == mujoco.mjtConstraint.mjCNSTR_LIMIT_JOINT

        kin, M, qacc_s, _ = dyn.smooth_forward(
            mdl, jnp.array(d.qpos), jnp.array(d.qvel), jnp.array(d.ctrl)
        )
        rows = con.constraint_rows(mdl, kin, jnp.array(d.qpos),
                                   jnp.array(d.qvel))
        my_j, my_aref, my_r, act = _active_rows(rows)
        assert act.sum() == 1
        np.testing.assert_allclose(my_j[0], d.efc_J.reshape(1, 14)[0],
                                   atol=1e-12)
        np.testing.assert_allclose(my_aref[0], d.efc_aref[0], atol=1e-10)
        np.testing.assert_allclose(my_r[0], d.efc_R[0], atol=1e-12)
        qacc, _ = con.solve_constraints(mdl, M, qacc_s, rows, iters=500)
        np.testing.assert_allclose(np.asarray(qacc), d.qacc, atol=1e-8)


@pytest.mark.parametrize(
    "place",
    [
        # side-on ankle scrape against the east wall (capsule-box face case)
        {"x": 4.4, "y": 0.0},
        # corner pocket: simultaneous east + north wall contacts
        {"x": 4.4, "y": 4.4},
    ],
    ids=["east-scrape", "corner"],
)
def test_wall_contact_rows_exact(oracle, place):
    """Wall (capsule-box) contacts match efc_J/aref/R row-for-row, like the
    floor rows — the reference's MuJoCo collider vs our reverse-engineered
    one (contact._capsule_box_slots_s + _sphere_box_s + mirror slots)."""
    from scipy.optimize import linear_sum_assignment

    m, d, mdl = oracle
    with jax.enable_x64(True):
        qpos = STAND.copy()
        qpos[0], qpos[1] = place["x"], place["y"]
        d.qpos[:] = qpos
        d.qvel[:] = 0.1 * np.arange(14)
        d.ctrl[:] = 0.1
        mujoco.mj_forward(m, d)
        assert d.ncon > 4  # floor contacts PLUS wall contacts engaged

        kin = dyn.kinematics(mdl, jnp.array(d.qpos))
        rows = con.constraint_rows(mdl, kin, jnp.array(d.qpos),
                                   jnp.array(d.qvel))
        my_j, my_aref, my_r, act = _active_rows(rows)
        assert act.sum() == d.nefc
        mj_j = d.efc_J.reshape(d.nefc, 14)
        # optimal assignment (greedy matching is ambiguous for similar rows)
        cost = np.abs(my_j[None, :, :] - mj_j[:, None, :]).max(-1)
        ri, ci = linear_sum_assignment(cost)
        np.testing.assert_allclose(my_j[ci], mj_j[ri], atol=1e-10)
        np.testing.assert_allclose(my_aref[ci], d.efc_aref[: d.nefc][ri],
                                   atol=1e-9)
        np.testing.assert_allclose(my_r[ci], d.efc_R[: d.nefc][ri],
                                   atol=1e-12)


@pytest.mark.slow
def test_rk4_trajectory_parity(oracle):
    """20 RK4 steps of contact-rich random flailing track mj_step ≤ 1e-6."""
    m, _, mdl = oracle
    d = mujoco.MjData(m)
    with jax.enable_x64(True):
        d.qpos[:] = STAND
        rng = np.random.default_rng(5)
        ctrls = rng.uniform(-1, 1, (20, 8))
        state = eng.init_state(mdl, jnp.array(STAND), jnp.zeros(14))
        step = jax.jit(lambda s, c: eng.rk4_step(mdl, s, c, iters=15))
        for t in range(20):
            d.ctrl[:] = ctrls[t]
            mujoco.mj_step(m, d)
            state = step(state, jnp.array(ctrls[t]))
        np.testing.assert_allclose(np.asarray(state.qpos), d.qpos, atol=1e-6)
        np.testing.assert_allclose(np.asarray(state.qvel), d.qvel, atol=1e-5)


@pytest.mark.slow
def test_f32_default_config_tracks_f64_parity_config(oracle):
    """Validates the envs' f32/iters=8 default (envs/ant_physics.py accuracy
    knobs) against the f64/iters=15 MuJoCo-parity configuration over an
    episode-length contact-rich horizon (120 RK4 steps of random flailing,
    feet in persistent contact).  Measured on this trajectory family
    (benchmark probe, 200 steps): position divergence < 5e-5 m, penetration
    ≤ 3.7 mm in BOTH configs, |qvel| ≤ 2.1, all finite.  Tolerances below
    are 100x the measured drift — failures mean a real numerics regression
    (solver no longer converging in 8 iters at f32), not noise."""
    _, _, mdl = oracle
    with jax.enable_x64(True):
        rng = np.random.default_rng(0)
        ctrls = rng.uniform(-1, 1, (120, 8))

        def traj(dtype, iters):
            st = eng.init_state(mdl, jnp.asarray(STAND, dtype),
                                jnp.zeros(14, dtype))

            @jax.jit
            def run(st, ctrl):
                def body(s, c):
                    s = eng.rk4_step(mdl, s, c, iters=iters)
                    return s, (s.qpos, s.qvel)
                return jax.lax.scan(body, st, ctrl)[1]

            qp, qv = run(st, jnp.asarray(ctrls, dtype))
            return np.asarray(qp, np.float64), np.asarray(qv, np.float64)

        qp64, qv64 = traj(jnp.float64, 15)
        qp32, qv32 = traj(jnp.float32, 8)
        assert np.isfinite(qp32).all() and np.isfinite(qv32).all()
        # position drift bound (measured < 5e-5 over 200 steps)
        assert np.abs(qp32[:, :3] - qp64[:, :3]).max() < 5e-3
        np.testing.assert_allclose(qv32, qv64, atol=5e-2)
        # no penetration blow-up: deepest floor-contact sphere stays within
        # MuJoCo-typical soft-contact depth (measured -3.7 mm)
        def deepest(qp):
            def one(q):
                s = dyn.kinematics(mdl, jnp.asarray(q, jnp.float64)).s
                ds = [c[2] - r for c, b, r, _, _ in
                      con._sphere_centers_s(mdl, s)]
                return jnp.stack([jnp.asarray(x) for x in ds]).min()
            return float(jax.vmap(one)(jnp.asarray(qp)).min())
        assert deepest(qp32) > -0.02
        # bounded energy: the flailing ant stays on its feet, velocities sane
        assert np.abs(qv32).max() < 10.0
        assert 0.2 < qp32[:, 2].min() and qp32[:, 2].max() < 1.0


@pytest.mark.slow
def test_wall_containment(oracle):
    """Driving into the east wall: the ant stays inside the cage (sphere-
    endpoint wall approximation — behavioral test, not bit parity)."""
    _, _, mdl = oracle
    qpos = STAND.copy()
    qpos[0] = 4.4
    state = eng.init_state(mdl, jnp.array(qpos), jnp.zeros(14))
    push = jnp.zeros(14).at[0].set(3.0)   # shove it eastward
    state = state._replace(qvel=push)
    step = jax.jit(lambda s: eng.step(mdl, s, jnp.zeros(8), frame_skip=5,
                                      iters=8))
    for _ in range(6):
        state = step(state)
    assert float(state.qpos[0]) < 5.0 + 0.25
    assert np.isfinite(np.asarray(state.qpos)).all()


@pytest.mark.slow
def test_euler_integrator_stable_and_consistent(oracle):
    """The Euler speed knob: stays on its feet under random flailing and
    tracks the RK4 trajectory loosely over a short horizon (it is a
    different integrator, not a parity path — engine.euler_step)."""
    _, _, mdl = oracle
    rng = np.random.default_rng(7)
    ctrls = rng.uniform(-1, 1, (10, 8))
    s_rk = eng.init_state(mdl, jnp.array(STAND, dtype=jnp.float32),
                          jnp.zeros(14, jnp.float32))
    s_eu = s_rk
    rk = jax.jit(lambda s, c: eng.step(mdl, s, c, frame_skip=1, iters=8,
                                       integrator="rk4"))
    eu = jax.jit(lambda s, c: eng.step(mdl, s, c, frame_skip=1, iters=8,
                                       integrator="euler"))
    for t in range(10):
        c = jnp.array(ctrls[t], jnp.float32)
        s_rk = rk(s_rk, c)
        s_eu = eu(s_eu, c)
    q_rk, q_eu = np.asarray(s_rk.qpos), np.asarray(s_eu.qpos)
    assert np.isfinite(q_eu).all()
    assert 0.1 < q_eu[2] < 1.5                       # on its feet
    np.testing.assert_allclose(q_eu, q_rk, atol=0.05)  # same trajectory shape

    with pytest.raises(ValueError):
        eng.step(mdl, s_eu, jnp.zeros(8), integrator="verlet")


# The chord (frozen-Hessian) solver phase and its fixed-point test were
# REMOVED: every chord mix measured strictly slower than pure full Newton
# on the previous accelerator — the frozen factor's 105 [B]-arrays stay
# live across a second loop and the exact line search, the dominant
# per-iteration cost, is kept.  See docs/ARCHITECTURE.md negative results.


def _random_states(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        qpos = np.concatenate([
            rng.uniform(-4.5, 4.5, 2), [rng.uniform(0.1, 0.6)],
            rng.normal(size=4), rng.uniform(-0.5, 0.5, 8)])
        qpos[3:7] /= np.linalg.norm(qpos[3:7])
        out.append((qpos, rng.normal(size=14), rng.uniform(-1, 1, 8)))
    return out


@pytest.mark.parametrize("walls", ["tag", "hh"])
def test_array_pipeline_matches_scalar(walls):
    """The compile-friendly array pipeline (constraint_rows_array +
    smooth_forward_array, used by engine.forward(pipeline="array") for the
    multichip dryrun) is numerically the SAME model as the scalar perf
    path: identical candidate set/order and row values to fp roundoff, and
    identical smooth dynamics."""
    mdl = am.make_ant_model(
        am.TAG_WALLS if walls == "tag" else am.HEAVEN_HELL_WALLS)
    with jax.enable_x64(True):
        for qpos, qvel, ctrl in _random_states(3, seed=42):
            qpos, qvel, ctrl = (jnp.asarray(qpos), jnp.asarray(qvel),
                                jnp.asarray(ctrl))
            k1, M1, qa1, qf1 = dyn.smooth_forward(mdl, qpos, qvel, ctrl)
            k2, M2, qa2, qf2 = dyn.smooth_forward_array(mdl, qpos, qvel,
                                                        ctrl)
            np.testing.assert_allclose(M1, M2, rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(qa1, qa2, rtol=1e-8, atol=1e-10)
            np.testing.assert_allclose(qf1, qf2, rtol=1e-9, atol=1e-11)

            r1 = con.constraint_rows(mdl, k1, qpos, qvel)
            r2 = con.constraint_rows_array(mdl, k2, qpos, qvel)
            assert r1.jac_t.shape == r2.jac_t.shape
            np.testing.assert_allclose(r1.jac_t, r2.jac_t, atol=1e-10)
            np.testing.assert_allclose(r1.aref, r2.aref, rtol=1e-8,
                                       atol=1e-8)
            np.testing.assert_allclose(r1.r, r2.r, rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(r1.active, r2.active, atol=0)


@pytest.mark.parametrize("x", [0.0, 4.4], ids=["floor", "wall"])
def test_array_pipeline_qacc_matches_mujoco(oracle, x):
    """End-to-end constrained forward through the ARRAY pipeline
    (engine.forward(pipeline="array"): smooth_forward_array +
    constraint_rows_array + the array Newton solver) reproduces MuJoCo's
    qacc fixed point — the same oracle the scalar perf path is pinned to,
    at a floor-contact and a wall-contact state."""
    m, _, mdl = oracle
    d = mujoco.MjData(m)
    with jax.enable_x64(True):
        qpos = STAND.copy()
        qpos[0] = x
        d.qpos[:] = qpos
        d.qvel[:] = 0.1 * np.arange(14)
        d.ctrl[:] = 0.3
        mujoco.mj_forward(m, d)
        qacc, _ = eng.forward(
            mdl, jnp.asarray(d.qpos), jnp.asarray(d.qvel),
            jnp.asarray(d.ctrl), iters=15, pipeline="array")
        np.testing.assert_allclose(np.asarray(qacc), d.qacc, atol=1e-8)
