"""Head-to-head ant oracle tests vs the reference MuJoCo envs.

Loads the reference's ``AntTagEnv`` / ``AntHeavenHellEnv`` (reference
``gym_po/envs/ant_tag.py:77-123``, ``ant_heaven_hell.py:88-137``) with their
shipped XMLs and compares against :mod:`gym_po_tpu.envs.ant` +
:mod:`gym_po_tpu.envs.mjcf`:

* model signature — nq/nv/nu, joint order, actuator→joint mapping, masses,
  damping/armature/gear (the physics-relevant compiled arrays);
* full trajectories under a mirrored RNG — both sides consume the seeded
  ``np_random`` identically, so obs/reward/done must agree step for step
  (MuJoCo f64 physics is deterministic given an identical model; the repo
  only casts obs to f32 at the end);
* forced-state semantics — rewards/termination at hand-placed tag /
  heaven / hell / priest configurations.

Known capability-irrelevant diffs (asserted AROUND, documented here): the
reference XML carries two unused ``subgoal_*`` mocap bodies (slots 3-4) and
cosmetic texture/material assets; body/geom names differ; the HH torso's
``qpos0`` xy differs (reset overrides it via ``set_state``).
"""

import importlib.util
import sys

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

from gym_po_tpu.envs.ant import AntHeavenHellEnv, AntTagEnv  # noqa: E402
from gym_po_tpu.envs.mjcf import ant_heaven_hell_xml, ant_tag_xml  # noqa: E402

REF_ENVS = "/root/reference/gym_po/envs"


def _require_reference():
    import os

    if not os.path.isdir(REF_ENVS):
        pytest.skip(f"reference oracle not present at {REF_ENVS}")


def _load_ref(modname, filename):
    """Import a reference env module straight from its file (no package
    side effects; the reference is a test-only oracle, never vendored)."""
    name = f"_ref_{modname}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, f"{REF_ENVS}/{filename}"
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_tag():
    _require_reference()
    return _load_ref("ant_tag", "ant_tag.py").AntTagEnv()


@pytest.fixture(scope="module")
def ref_hh():
    _require_reference()
    return _load_ref("ant_heaven_hell", "ant_heaven_hell.py").AntHeavenHellEnv()


@pytest.fixture(scope="module")
def tag():
    return AntTagEnv()


@pytest.fixture(scope="module")
def hh():
    return AntHeavenHellEnv()


# ------------------------------------------------------------ model signature


def _signature_checks(model, ref_model):
    assert model.nq == ref_model.nq
    assert model.nv == ref_model.nv
    assert model.nu == ref_model.nu

    def joint_names(m):
        return [m.joint(j).name for j in range(m.njnt)]

    assert joint_names(model) == joint_names(ref_model)

    def actuator_joints(m):
        return [m.joint(m.actuator_trnid[u, 0]).name for u in range(m.nu)]

    assert actuator_joints(model) == actuator_joints(ref_model)
    np.testing.assert_allclose(model.actuator_gear, ref_model.actuator_gear)
    np.testing.assert_allclose(
        model.actuator_ctrlrange, ref_model.actuator_ctrlrange
    )
    np.testing.assert_allclose(model.dof_armature, ref_model.dof_armature)
    np.testing.assert_allclose(model.dof_damping, ref_model.dof_damping)
    np.testing.assert_allclose(model.jnt_range, ref_model.jnt_range)
    # per-dof masses (body order may differ in the arena; dof order may not)
    np.testing.assert_allclose(
        model.dof_M0, ref_model.dof_M0, rtol=1e-10
    )
    np.testing.assert_allclose(
        model.body_mass.sum(), ref_model.body_mass.sum(), rtol=1e-10
    )
    assert model.opt.timestep == ref_model.opt.timestep
    assert model.opt.integrator == ref_model.opt.integrator


def test_tag_model_signature(tag, ref_tag):
    _signature_checks(tag.model, ref_tag.model)
    # the three mocap slots the env drives must exist in the same order
    for i, name in enumerate(["target", "visible_area", "tag_area"]):
        b = tag.model.body(name)
        rb = ref_tag.model.body(name)
        assert b.mocapid[0] == rb.mocapid[0] == i


def test_hh_model_signature(hh, ref_hh):
    _signature_checks(hh.model, ref_hh.model)
    for name in ("left_area", "right_area"):
        assert hh.model.site(name) is not None
        assert ref_hh.model.site(name) is not None


# --------------------------------------------------------- trajectory parity


def _mirror_rollout(env, ref, seed, steps, act_seed=0, check_mocap=False):
    """Reset both with the same seed, drive with identical actions, compare
    obs (f32 cast tolerance), reward, and termination step for step.

    ``check_mocap``: tag only — its slots 0-2 (target/visible/tag) align;
    the HH env never drives mocap and the reference XML carries an extra
    unused ``subgoal`` mocap body there, so slots don't correspond."""
    obs, _ = env.reset(seed=seed)
    ref_obs, _ = ref.reset(seed=seed)
    np.testing.assert_allclose(obs, ref_obs, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(env.data.qpos, ref.data.qpos)
    if check_mocap:
        np.testing.assert_array_equal(
            env.data.mocap_pos[:3], ref.data.mocap_pos[:3]
        )
    rng = np.random.default_rng(act_seed)
    for t in range(steps):
        a = rng.uniform(-1.0, 1.0, env.action_space.shape).astype(np.float32)
        obs, r, d, tr, _ = env.step(a)
        ref_obs, ref_r, ref_d, ref_tr, _ = ref.step(a)
        np.testing.assert_array_equal(
            env.data.qpos, ref.data.qpos, err_msg=f"qpos diverged at t={t}"
        )
        np.testing.assert_allclose(
            obs, ref_obs, rtol=1e-6, atol=1e-6, err_msg=f"obs t={t}"
        )
        assert float(r) == float(ref_r), t
        assert bool(d) == bool(ref_d), t
        if d or ref_d:
            obs, _ = env.reset(seed=seed + 1000 + t)
            ref_obs, _ = ref.reset(seed=seed + 1000 + t)
            np.testing.assert_allclose(obs, ref_obs, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7])
def test_tag_trajectory_parity(tag, ref_tag, seed):
    _mirror_rollout(tag, ref_tag, seed, steps=40, act_seed=seed,
                    check_mocap=True)


@pytest.mark.parametrize("seed", [1, 11])
def test_hh_trajectory_parity(hh, ref_hh, seed):
    _mirror_rollout(hh, ref_hh, seed, steps=40, act_seed=seed)


def test_tag_target_motion_parity(tag, ref_tag):
    """Target-motion geometry: from an identical forced configuration and a
    re-seeded RNG, the 0.5-step {away, orthogonal x2, stay} moves (and cage
    cancellation) must land the target at identical positions."""
    tag.reset(seed=3)
    ref_tag.reset(seed=3)
    for trial in range(24):
        # force identical ant/target placement, near a wall every 3rd trial
        base = np.array([4.2, 0.0]) if trial % 3 == 0 else np.array([1.0, -2.0])
        for e in (tag, ref_tag):
            qpos = e.data.qpos.copy()
            qpos[:2] = base - np.array([3.0, 0.0])
            e.set_state(qpos, np.zeros_like(e.data.qvel))
            e.data.mocap_pos[0, :2] = base
        tag.np_random.__setstate__(ref_tag.np_random.__getstate__())
        tag._move_target(tag.data.qpos[:2].copy())
        ref_tag._move_target(
            ref_tag.data.qpos[:2], ref_tag.data.mocap_pos[0, :2]
        )
        np.testing.assert_allclose(
            tag.data.mocap_pos[0, :2], ref_tag.data.mocap_pos[0, :2],
            err_msg=f"trial {trial}",
        )


# ------------------------------------------------------- forced-state parity


def _force_xy(env, xy):
    qpos = env.data.qpos.copy()
    qpos[:2] = xy
    env.set_state(qpos, np.zeros_like(env.data.qvel))


@pytest.mark.parametrize(
    "xy",
    [(-6.25, 6.0), (6.25, 6.0), (-5.0, 6.0), (0.0, 6.0), (0.0, 0.0),
     (0.0, 4.6)],
)
def test_hh_forced_state_semantics_match(hh, ref_hh, xy):
    """Reward/done/obs-tail at hand-placed heaven/hell/priest/neutral spots
    (identical heaven side forced on both)."""
    hh.reset(seed=5)
    ref_hh.reset(seed=5)
    assert hh.heaven_direction == ref_hh.heaven_direction
    _force_xy(hh, xy)
    _force_xy(ref_hh, xy)
    o, r, d, *_ = hh.step(np.zeros(8))
    ro, rr, rd, *_ = ref_hh.step(np.zeros(8))
    assert float(r) == float(rr)
    assert bool(d) == bool(rd)
    np.testing.assert_allclose(o[-1], ro[-1])  # heaven-direction reveal bit


@pytest.mark.parametrize("offset,expect_tag", [(0.4, True), (4.0, False)])
def test_tag_forced_state_semantics_match(tag, ref_tag, offset, expect_tag):
    tag.reset(seed=6)
    ref_tag.reset(seed=6)
    for e in (tag, ref_tag):
        _force_xy(e, (0.0, 0.0))
        e.data.mocap_pos[0, :2] = (offset, 0.0)
    # identical RNG for the in-step target move
    tag.np_random.__setstate__(ref_tag.np_random.__getstate__())
    o, r, d, *_ = tag.step(np.zeros(8))
    ro, rr, rd, *_ = ref_tag.step(np.zeros(8))
    assert float(r) == float(rr)
    assert bool(d) == bool(rd)
    np.testing.assert_allclose(o[-2:], ro[-2:], atol=1e-6)
    if expect_tag:
        assert d  # 0.4 + <=0.5 move stays within the 1.5 tag radius
