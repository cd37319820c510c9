"""Checks that need a CUDA card (``gpu`` marker; skipped elsewhere), plus
the CPU-side rules of the compile cache.

On the card: ``python chip_smoke.py`` runs this file in-process, or
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py -m gpu``.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gym_po_tpu as gpt
from gym_po_tpu.ops.fused_taxi import make_fused_taxi_rollout
from gym_po_tpu.utils import compilation_cache_dir, enable_compilation_cache


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["Taxi-v4", "ExtendedHansenTaxi-v4"])
def test_triton_taxi_kernel_matches_twin_on_card(name):
    """The kernel compiled for the card equals the XLA twin bit for bit."""
    env = gpt.make(name)
    B, K = 65536, 16
    _, st = env.reset_vec(jax.random.PRNGKey(0), B)
    s = st.s.reshape(-1, 128)
    seed = jnp.asarray([1], jnp.int32)
    for tape in (False, True):
        kw = dict(rng_tape=tape, episode_stats=True)
        run_x = make_fused_taxi_rollout(env, B, K, **kw)
        run_t = make_fused_taxi_rollout(env, B, K, impl="triton", **kw)
        args = [seed, s]
        if tape:
            args.append(jax.random.bits(jax.random.PRNGKey(2),
                                        run_x.tape_shape,
                                        jnp.uint32).view(jnp.int32))
        for a, b in zip(run_x(*args), run_t(*args)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.gpu
def test_fused_q_trainer_on_card_matches_cpu():
    """Scatter-add order differs on the card: tables agree to 1e-6 of
    their scale.  Exploring with probability 1, the tape fixes every
    action, so states and rewards agree exactly (greedy actions would
    break last-bit ties differently and the batch would diverge)."""
    from gym_po_tpu.ops import make_fused_q_trainer, q_to_banks

    env = gpt.make("Taxi-v4")
    B, K = 4096, 32
    run = make_fused_q_trainer(env, B, K, average_duplicates=True,
                               rng_tape=True)
    _, st = env.reset_vec(jax.random.PRNGKey(0), B)
    args = (
        np.asarray([3], np.int32), 0.1, 1.0,
        np.asarray(st.s, np.int32).reshape(-1, 128),
        q_to_banks(np.zeros((500, 5), np.float32)),
        np.asarray(jax.random.bits(jax.random.PRNGKey(1), run.tape_shape,
                                   jnp.uint32)).view(np.int32),
    )
    s_g, q_g, r_g = jax.device_get(run(*args))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        s_c, q_c, r_c = jax.device_get(run(*jax.device_put(args, cpu)))
    np.testing.assert_array_equal(s_g, s_c)
    np.testing.assert_array_equal(r_g, r_c)
    np.testing.assert_allclose(q_g, q_c, rtol=0,
                               atol=1e-6 * np.abs(q_c).max())


@pytest.mark.gpu
def test_compilation_cache_enabled_on_card():
    path = enable_compilation_cache()
    assert path == compilation_cache_dir() and os.path.isdir(path)


def test_compilation_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert compilation_cache_dir() == str(tmp_path / "cc")


def test_compilation_cache_dir_default_is_fixed(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compilation_cache_dir()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")


def test_no_compilation_cache_on_cpu(monkeypatch, tmp_path):
    """The CPU backend gets no persistent cache (its executables embed the
    compiling host's instruction set)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    before = jax.config.jax_compilation_cache_dir
    assert jax.default_backend() == "cpu"
    assert enable_compilation_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "cc").exists()
