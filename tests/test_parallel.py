"""parallel/ layer: mesh + shard_map rollout on the 8-device CPU mesh.

SURVEY.md §4 item 5: the same shard_map code paths as a multi-GPU host,
validated by shard-invariance (N-device result == 1-device result).
"""

import numpy as np
import pytest

import jax

import gym_po_tpu as gpt
from gym_po_tpu.parallel import make_mesh, shard_batch, sharded_rollout


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(devices=devs[:8])


def test_mesh_shape(mesh8):
    assert mesh8.shape == {"data": 8}


def test_sharded_rollout_runs(mesh8):
    env = gpt.make("HansenTaxi-v4")
    traj, (obs, state) = sharded_rollout(
        env, mesh8, jax.random.PRNGKey(0), None, num_envs=64, num_steps=16
    )
    assert traj.obs.shape == (16, 64)
    assert obs.shape == (64,)
    # the batch axis is actually sharded over the mesh
    assert len(obs.sharding.device_set) == 8


def test_sharded_rollout_rejects_indivisible(mesh8):
    env = gpt.make("Taxi-v4")
    with pytest.raises(ValueError):
        sharded_rollout(env, mesh8, jax.random.PRNGKey(0), None, 10, 4)


def test_shard_invariance(mesh8):
    """Each shard runs the same single-chip rollout: the 8-device result for
    a shard's keys equals a 1-device rollout with that shard's key."""
    from gym_po_tpu.vector import rollout

    env = gpt.make("Taxi-v4")
    key = jax.random.PRNGKey(7)
    traj, _ = sharded_rollout(env, mesh8, key, None, num_envs=16, num_steps=12)
    # device 0's shard = envs [0:2) driven by split(key, 8)[0]
    k0 = jax.random.split(key, 8)[0]
    traj0, _ = rollout(env, k0, None, 2, 12)
    np.testing.assert_array_equal(
        np.asarray(traj.obs)[:, :2], np.asarray(traj0.obs)
    )
    np.testing.assert_array_equal(
        np.asarray(traj.reward)[:, :2], np.asarray(traj0.reward)
    )


def test_shard_batch_placement(mesh8):
    x = np.arange(32.0)
    y = shard_batch(mesh8, x)
    assert len(y.sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(y), x)
