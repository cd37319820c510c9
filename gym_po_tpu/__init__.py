"""gym-po-tpu: vectorized partially-observable RL environment suite in JAX.

A from-scratch JAX/XLA re-design of the capabilities of ``gym_po``
(DavidSlayback/gym-po-taxi): pure-functional envs with in-graph autoreset,
counter-based PRNG, jit+vmap batching, shard_map multi-host scaling, and a
Podracer-style learner — plus a bit-exact NumPy-parity harness for validation
against the reference under fixed seeds.
"""

__version__ = "0.1.0"

from .core import Box, Discrete, Environment, EnvState, Space
from .registry import make, register, registered_envs

# gymnasium ids for the MuJoCo ant envs (reference envs/__init__.py:9-19);
# gated on the host mujoco runtime being importable.
try:  # pragma: no cover - exercised when mujoco is present
    from .envs.ant import register_gymnasium_envs as _reg_ants

    _reg_ants()
except ImportError:  # mujoco absent: the JAX env suite works regardless
    pass

__all__ = [
    "Environment",
    "EnvState",
    "Space",
    "Discrete",
    "Box",
    "make",
    "register",
    "registered_envs",
    "__version__",
]
