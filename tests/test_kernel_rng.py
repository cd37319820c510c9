"""The counter-based generator behind the fused rollouts and trainers."""

import numpy as np
import pytest

import jax.numpy as jnp

from gym_po_tpu.ops.kernel_rng import (
    KernelRNG, hash_bits, mix32, step_key, tiling,
)


def _bits(seed, step, site, shape=(8, 128)):
    rng = KernelRNG.for_layout(jnp.int32(seed), shape, 4)
    rng.begin_step(jnp.int32(step))
    for _ in range(site):
        rng.draw32()
    return np.asarray(rng.draw32())


def test_mix32_is_a_bijection_on_a_sample():
    x = jnp.arange(1 << 16, dtype=jnp.uint32) * jnp.uint32(65537)
    y = np.asarray(mix32(x))
    assert np.unique(y).size == y.size


def test_counter_bits_are_deterministic():
    np.testing.assert_array_equal(_bits(7, 3, 2), _bits(7, 3, 2))


@pytest.mark.parametrize("other", [(8, 3, 2), (7, 4, 2), (7, 3, 1)])
def test_counter_bits_differ_per_seed_step_and_site(other):
    a, b = _bits(7, 3, 2), _bits(*other)
    assert (a != b).mean() > 0.99


def test_counter_bits_distinct_across_envs():
    a = _bits(1, 0, 0, shape=(64, 128))
    assert np.unique(a).size == a.size  # a bijection of the env index


@pytest.mark.parametrize("n", [2, 5, 7, 24])
def test_rbits_uniform(n):
    rng = KernelRNG.for_layout(jnp.int32(3), (512, 128), 1)
    rng.begin_step(jnp.int32(0))
    draws = np.asarray(rng.rbits(n)).reshape(-1)
    counts = np.bincount(draws, minlength=n)
    expected = draws.size / n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    # generous bound: 99.99th percentile of chi2 with n-1 dof is < 60 here
    assert counts.size == n and chi2 < 60.0, (counts, chi2)


def test_runiform_and_rnormal_moments():
    rng = KernelRNG.for_layout(jnp.int32(5), (512, 128), 1)
    rng.begin_step(jnp.int32(0))
    u = np.asarray(rng.runiform()).reshape(-1)
    z = np.asarray(rng.rnormal()).reshape(-1)
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.01
    assert abs(z.mean()) < 0.02 and abs(z.std() - 1.0) < 0.02


def test_flat_layout_hashes_like_the_2d_layout():
    """A 1-D block of env indices (the Triton kernel's layout) draws the
    same bits as the [rows, 128] layout at the same global index."""
    two_d = _bits(11, 5, 3, shape=(4, 128)).reshape(-1)
    key = step_key(jnp.int32(11), jnp.int32(5))
    flat = hash_bits(key, jnp.arange(512, dtype=jnp.int32), 3)
    np.testing.assert_array_equal(two_d, np.asarray(flat))


def test_tape_mode_reads_site_step_blocks():
    R, K, n_sites, tiles = 2, 3, 2, 2
    tape = np.arange(tiles * n_sites * K * R * 128, dtype=np.int32).reshape(
        -1, 128
    )
    rng = KernelRNG.for_layout(jnp.int32(0), (tiles * R, 128), K,
                               tape=jnp.asarray(tape), R=R)
    rng.begin_step(jnp.int32(1))
    rng.draw32()
    got = np.asarray(rng.draw32())  # site 1, step 1
    slab = n_sites * K * R
    for g in range(tiles):
        base = g * slab + (1 * K + 1) * R
        np.testing.assert_array_equal(got[g * R:(g + 1) * R],
                                      tape[base:base + R])
    rng.finalize(2)
    with pytest.raises(ValueError):
        rng.finalize(3)


def test_tiling_rules():
    assert tiling(65536, 128) == (128, 4)
    assert tiling(256, 128) == (2, 1)
    with pytest.raises(ValueError):
        tiling(100, 128)
    with pytest.raises(ValueError):
        tiling(384, 2)  # 3 rows do not split into 2-row tiles
