"""Test configuration.

Tests run on the CPU backend, on a virtual 8-device mesh (SURVEY.md §4.5):
the same shard_map/pjit code paths as a multi-GPU host.  Environment
variables must be set before JAX initializes a backend.

Tests marked ``gpu`` need a CUDA card: they skip with a reason on any other
backend.  The decision is made when the test runs (a fixture), never while
modules are collected, so every pytest-xdist worker collects the same tests.
"""

import os

# Headless MuJoCo rendering (render_ant_scene): the GL backend is chosen at
# the FIRST `import mujoco` anywhere in the process, so the choice must be
# pinned before any test (or importorskip) pulls mujoco in.
os.environ.setdefault("MUJOCO_GL", "egl")

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
# Pin the CPU codegen to a pre-FMA ISA for parity tests: with AVX2+FMA the
# LLVM backend contracts f32 `a*b + c` chains into fused multiply-adds inside
# XLA loop fusions (no HLO-level control, optimization_barrier doesn't reach
# codegen), which breaks bit-exact equality with NumPy's two-rounding result
# under cancellation (car_flag velocity, SURVEY.md §7 hard-part 1).
if "xla_cpu_max_isa" not in flags:
    flags += " --xla_cpu_max_isa=SSE4_2"
os.environ["XLA_FLAGS"] = flags.strip()

# The CPU backend unless the caller chose one (`pytest -m gpu` on the card
# runs with JAX_PLATFORMS=cuda,cpu).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's default backend is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a CUDA GPU (backend is {jax.default_backend()})")


@pytest.fixture()
def x64():
    """Enable float64 for bit-exact continuous-env parity tests.

    Function-scoped so the flag never leaks into perf-mode tests that
    assume default f32/i32 dtypes.
    """
    import jax

    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)
