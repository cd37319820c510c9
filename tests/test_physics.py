"""Oracle tests: the JAX ant engine vs the installed MuJoCo.

Every layer of :mod:`gym_po_tpu.physics` is compared head-to-head against
MuJoCo compiling the same generated MJCF (the reference's physics substrate,
reference ``gym_po/envs/ant_tag.py:138-158``).  Smooth dynamics must agree to
machine precision at f64; constraint-layer tolerances are documented at each
test.
"""

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

import jax
import jax.numpy as jnp

from gym_po_tpu.envs.mjcf import ant_tag_xml
from gym_po_tpu.physics import ant_model as am
from gym_po_tpu.physics import dynamics as dyn
from gym_po_tpu.physics import spatial


@pytest.fixture(scope="module")
def oracle():
    m = mujoco.MjModel.from_xml_string(ant_tag_xml())
    return m, mujoco.MjData(m), am.make_ant_model(am.TAG_WALLS)


def _quat_to_mat_np(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _random_free_state(m, rng, z=3.0):
    """Random articulated pose floating above the floor (no contacts)."""
    qpos = m.qpos0.copy()
    qpos[:3] = rng.uniform(-1, 1, 3) + [0, 0, z]
    q = rng.normal(size=4)
    qpos[3:7] = q / np.linalg.norm(q)
    qpos[7:] = rng.uniform(-0.5, 0.5, 8)
    return qpos, rng.normal(size=14), rng.uniform(-1, 1, 8)


def test_model_matches_mujoco_compilation(oracle):
    """Masses, CoMs, full inertia tensors, tree, joints, actuator map."""
    m, _, mdl = oracle
    for b in range(13):
        mb = b + 1
        assert abs(m.body_mass[mb] - mdl.body_mass[b]) < 1e-12
        np.testing.assert_allclose(m.body_ipos[mb], mdl.body_ipos[b], atol=1e-12)
        ri = _quat_to_mat_np(m.body_iquat[mb])
        i_mj = ri @ np.diag(m.body_inertia[mb]) @ ri.T
        np.testing.assert_allclose(i_mj, mdl.body_inertia[b], atol=1e-12)
        assert m.body_parentid[mb] - 1 == mdl.parent[b]
    for j in range(8):
        mj = j + 1
        assert m.jnt_bodyid[mj] - 1 == mdl.jnt_body[j]
        np.testing.assert_allclose(m.jnt_axis[mj], mdl.jnt_axis[j], atol=1e-12)
        np.testing.assert_allclose(m.jnt_range[mj], mdl.jnt_range[j], atol=1e-12)
        assert m.jnt_dofadr[mj] == mdl.jnt_dof[j]
        assert m.jnt_qposadr[mj] == mdl.jnt_qpos[j]
    for a in range(8):
        assert m.jnt_dofadr[m.actuator_trnid[a][0]] == mdl.act_dof[a]
    np.testing.assert_array_equal(m.dof_armature, mdl.armature)
    np.testing.assert_array_equal(m.dof_damping, mdl.damping)


def test_quat_algebra_roundtrip():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(32, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(32, 3))
    r = np.asarray(spatial.quat_to_mat(jnp.asarray(q)))
    np.testing.assert_allclose(
        np.asarray(spatial.quat_rotate(jnp.asarray(q), jnp.asarray(v))),
        np.einsum("bij,bj->bi", r, v),
        atol=1e-6,
    )
    back = spatial.quat_rotate_inv(
        jnp.asarray(q), spatial.quat_rotate(jnp.asarray(q), jnp.asarray(v))
    )
    np.testing.assert_allclose(np.asarray(back), v, atol=1e-6)


def test_smooth_dynamics_machine_precision(oracle):
    """FK, CoM Jacobians, mass matrix, bias force, and qacc_smooth agree
    with MuJoCo to ~1e-12 at f64 (same model, same conventions)."""
    m, d, mdl = oracle
    rng = np.random.default_rng(7)
    with jax.enable_x64(True):
        for _ in range(3):
            qpos, qvel, ctrl = _random_free_state(m, rng)
            d.qpos[:] = qpos
            d.qvel[:] = qvel
            d.ctrl[:] = ctrl
            mujoco.mj_forward(m, d)
            assert d.ncon == 0

            kin, mass, qacc, _ = dyn.smooth_forward(
                mdl, jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(ctrl)
            )
            np.testing.assert_allclose(
                np.asarray(kin.xpos), d.xpos[1:14], atol=1e-12
            )
            for b in range(13):
                jacp = np.zeros((3, 14))
                jacr = np.zeros((3, 14))
                mujoco.mj_jacBodyCom(m, d, jacp, jacr, b + 1)
                np.testing.assert_allclose(
                    np.asarray(kin.jp[b]).T, jacp, atol=1e-12
                )
                np.testing.assert_allclose(
                    np.asarray(kin.jr[b]).T, jacr, atol=1e-12
                )
            mfull = np.zeros((14, 14))
            mujoco.mj_fullM(m, d, mfull)
            np.testing.assert_allclose(np.asarray(mass), mfull, atol=1e-12)
            bias = dyn.bias_force(mdl, kin, jnp.asarray(qvel))
            np.testing.assert_allclose(
                np.asarray(bias), d.qfrc_bias, atol=1e-11
            )
            np.testing.assert_allclose(
                np.asarray(qacc), d.qacc_smooth, atol=1e-10
            )
