"""Chunk-synchronous data-parallel fused trainers (docs/MULTIHOST.md).

Validated on the virtual 8-device CPU mesh two ways:
- a dummy chunk trainer exercises the bare orchestration (per-shard seeds,
  sharded state arrays, per-chunk table ``pmean``) with hand-checkable
  numerics;
- the fused trainers run inside ``shard_map``, proving the full
  ``fused_q_learning(mesh=...)`` / ``fused_actor_critic(mesh=...)`` drivers
  end-to-end (a 1-device mesh is bit-identical to no mesh) and the
  trainer-side contract (state shapes, bank replication).

The reference has no distributed machinery at all (SURVEY.md §2.5).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gym_po_tpu as gpt
from gym_po_tpu.parallel import (
    chunk_seeds,
    make_mesh,
    replicate,
    shard_batch,
    shard_fused_trainer,
)



@pytest.fixture(scope="module")
def mesh():
    return make_mesh()  # all 8 virtual CPU devices


def test_chunk_seeds_disjoint_across_chunks_and_shards():
    seen = set()
    for chunk in range(1, 50):
        s = np.asarray(chunk_seeds(7, chunk, 8))
        assert s.shape == (8,) and s.dtype == np.int32
        seen.update(s.tolist())
    assert len(seen) == 49 * 8  # every (chunk, shard) pair distinct


def test_shard_fused_trainer_orchestration(mesh):
    """Hand-checkable dummy trainer: seeds land per-shard, state tiles stay
    sharded, the table output comes back pmean-averaged and replicated."""

    def fake_chunk(seed, lr, s, q):
        # per-shard work: state advances, "table" absorbs this shard's seed
        return s + 1, q + lr * seed[0].astype(jnp.float32), s * 0

    run = shard_fused_trainer(
        fake_chunk, mesh, sharded_args=(1,), averaged_outs=(1,), num_outs=3
    )
    s0 = jnp.arange(8 * 128, dtype=jnp.int32).reshape(8, 128)
    q0 = jnp.ones((4, 128), jnp.float32)
    seeds = chunk_seeds(100, 1, 8)  # 108..115, mean 111.5
    s1, q1, _ = run(seeds, jnp.float32(2.0), shard_batch(mesh, s0),
                    replicate(mesh, q0))
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s0) + 1)
    np.testing.assert_allclose(np.asarray(q1), 1.0 + 2.0 * 111.5)
    # table is replicated (feed-back-ready), state stays sharded
    assert q1.sharding.is_fully_replicated
    assert not s1.sharding.is_fully_replicated


def test_shard_fused_trainer_requires_averaged_out(mesh):
    with pytest.raises(ValueError, match="averaged_outs"):
        shard_fused_trainer(
            lambda seed, s: (s,), mesh, sharded_args=(0,),
            averaged_outs=(), num_outs=1,
        )


def test_fused_q_learning_mesh1_bit_identical_to_no_mesh():
    """A 1-device mesh must be a pure refactor: same seeds, same numerics."""
    from gym_po_tpu.agents import fused_q_learning

    env = gpt.make("Taxi-v4")
    kw = dict(seed=3, schedule=[(0.2, 0.3, 32)], num_envs=1024,
              chunk_steps=16)
    q_a, h_a = fused_q_learning(env, **kw)
    mesh1 = make_mesh(shape=(1,), devices=jax.devices()[:1])
    q_b, h_b = fused_q_learning(env, mesh=mesh1, **kw)
    np.testing.assert_array_equal(q_a, q_b)
    assert h_a == h_b


def test_fused_q_learning_mesh8_xla_trainer_learns():
    """Full driver on the 8-device mesh: the pmean-averaged table must pick up signal (dropoff value > pickup-free
    baseline) and reward must improve chunk over chunk."""
    from gym_po_tpu.agents import fused_q_learning

    env = gpt.make("Taxi-v4")
    mesh = make_mesh()
    q, hist = fused_q_learning(
        env, seed=0, schedule=[(0.25, 0.5, 128), (0.25, 0.1, 128)],
        num_envs=2048, chunk_steps=64, mesh=mesh,
    )
    assert q.shape == (500, 5)
    assert np.isfinite(q).all()
    assert all(np.isfinite(h) for h in hist)
    # negative step rewards must propagate into the table via every shard
    assert (q < 0).any()
    # later chunks should not be worse than the first exploratory chunk
    assert hist[-1] >= hist[0] - 0.02, hist


def test_fused_q_learning_mesh8_pallas_interpret():
    """The taxi trainer under the sharded launcher: 1024 envs per shard,
    per-shard [8, 128] state arrays, replicated banks."""
    from gym_po_tpu.agents import fused_q_learning

    env = gpt.make("Taxi-v4")
    mesh = make_mesh()
    q, hist = fused_q_learning(
        env, seed=0, schedule=[(0.1, 0.0, 16)], num_envs=8192,
        chunk_steps=8, mesh=mesh,
    )
    assert q.shape == (500, 5)
    assert np.isfinite(q).all()
    assert len(hist) == 2


def test_fused_actor_critic_mesh8_pallas_interpret():
    from gym_po_tpu.agents import fused_actor_critic

    env = gpt.make("Rooms-v0")
    mesh = make_mesh()
    logits, v, hist = fused_actor_critic(
        env, seed=0, schedule=[(0.05, 0.05, 16)], num_envs=8192,
        chunk_steps=8, mesh=mesh,
    )
    assert logits.shape == (int(env.observation_space.n), 8)
    assert np.isfinite(logits).all() and np.isfinite(v).all()


def test_fused_q_learning_mesh_rejects_indivisible_batch():
    from gym_po_tpu.agents import fused_q_learning

    env = gpt.make("Taxi-v4")
    mesh = make_mesh()
    with pytest.raises(ValueError, match="not divisible"):
        fused_q_learning(env, 0, [(0.1, 0.1, 8)], num_envs=1025, mesh=mesh)


def test_xla_chunk_trainer_matches_fused_contract_shapes():
    """The chunk trainer's contract: state and bank shapes and dtypes."""
    from gym_po_tpu.ops.fused_qlearning import make_fused_q_trainer, q_to_banks

    env = gpt.make("Taxi-v4")
    run = make_fused_q_trainer(env, 256, 4, average_duplicates=True)
    _, st = env.reset_vec(jax.random.PRNGKey(0), 256)
    s = jnp.asarray(np.asarray(st.s).reshape(-1, 128), jnp.int32)
    qb = jnp.asarray(q_to_banks(np.zeros((512, 5), np.float32)))
    s1, qb1, rew = run(jnp.asarray([1], jnp.int32), 0.1, 0.2, s, qb)
    assert s1.shape == (2, 128) and s1.dtype == jnp.int32
    assert qb1.shape == (32, 128) and qb1.dtype == jnp.float32
    assert rew.shape == (2, 128)
    # unused bank rows (rows 20..31 hold no Q entries) stay zero
    np.testing.assert_array_equal(np.asarray(qb1)[20:], 0.0)
