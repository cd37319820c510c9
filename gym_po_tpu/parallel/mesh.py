"""Device mesh construction and sharded rollout execution.

The reference has no distributed machinery at all (no NCCL/MPI/Gloo imports,
SURVEY.md §2.5) — this subsystem is new: a ``jax.sharding.Mesh`` spans the
devices, the env batch is sharded over the ``data`` axis with
``shard_map``, XLA routes any cross-device traffic (NCCL over NVLink between
the cards of a GPU host), and learner gradient reduction is a single
``psum`` over the same axis (:mod:`gym_po_tpu.agents.ppo`).

Env stepping itself needs **zero communication**: every env instance is
independent, so an N-device rollout is N single-device rollouts running in
lockstep — near-linear scaling by construction.  Collectives appear only in
the learner (gradient ``psum``) and in metric reductions (``pmean``).
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import Environment
from ..vector import Transition, rollout

try:  # jax >= 0.8: public API, `check_rep` renamed to `check_vma`
    from jax import shard_map as _jax_shard_map

    _CHECK_KW = "check_vma"
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map as _jax_shard_map

    _CHECK_KW = "check_rep"


def shard_map(f=None, **kwargs):
    """``jax.shard_map`` across jax versions (check_rep/check_vma rename)."""
    if "check_rep" in kwargs:
        kwargs[_CHECK_KW] = kwargs.pop("check_rep")
    if f is None:
        return functools.partial(shard_map, **kwargs)
    return _jax_shard_map(f, **kwargs)

__all__ = [
    "make_mesh",
    "distributed_init",
    "sharded_rollout",
    "shard_batch",
]

DATA_AXIS = "data"


def distributed_init(allow_fallback: Optional[bool] = None, **kwargs) -> None:
    """Multi-host bring-up: call once per host before any JAX computation.

    Thin wrapper over ``jax.distributed.initialize`` so user code has a single
    entry point; on a single host it is a no-op.

    ``allow_fallback``: when True, an initialization failure degrades to
    single-process execution with a ``RuntimeWarning``; when False it
    re-raises.  Default: True for a bare call (env auto-detection — running
    locally is the expected outcome off-cluster), False when explicit
    coordinator kwargs are given (a misconfigured multi-host launch must NOT
    silently train on 1/N of the fleet).
    """
    # NB: check via the distributed service, NOT jax.process_count() — the
    # latter initializes the XLA backend, after which initialize() refuses
    # to run.
    if jax.distributed.is_initialized():
        return
    if allow_fallback is None:
        allow_fallback = not kwargs
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError) as e:
        if not allow_fallback:
            raise
        warnings.warn(
            f"jax.distributed.initialize failed ({e!r}); continuing "
            "single-process. Pass allow_fallback=False to make this fatal.",
            RuntimeWarning,
        )


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (DATA_AXIS,),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a device mesh.

    Defaults to a 1-D ``('data',)`` mesh over every addressable device —
    the right layout for an embarrassingly-parallel env batch.  The devices
    are laid out in the given order: NVLink joins every card of a host to
    every other at the same rate, so no ordering is better than another.
    """
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    dev_array = np.asarray(list(devices), dtype=object).reshape(tuple(shape))
    return Mesh(dev_array, tuple(axis_names))


def put_global(tree, sharding: NamedSharding):
    """Lay out a host pytree (replicated on every process) as a global array.

    Single-process: plain ``device_put``.  Multi-process: each process holds
    the FULL host value (e.g. from a seed-identical ``init``), so
    ``make_array_from_callback`` slices out the locally-addressable shards —
    ``device_put`` cannot target non-addressable devices there.
    """
    if jax.process_count() == 1:
        return jax.device_put(tree, sharding)

    def put(x):
        x = np.asarray(x)
        return jax.make_array_from_callback(
            x.shape, sharding, lambda idx: x[idx]
        )

    return jax.tree.map(put, tree)


def shard_batch(mesh: Mesh, tree, axis: str = DATA_AXIS):
    """Place a host pytree with a leading batch axis sharded over ``axis``."""
    return put_global(tree, NamedSharding(mesh, P(axis)))


def sharded_rollout(
    env: Environment,
    mesh: Mesh,
    key: jax.Array,
    policy: Optional[Callable],
    num_envs: int,
    num_steps: int,
    axis: str = DATA_AXIS,
) -> Tuple[Transition, Tuple[jax.Array, object]]:
    """Run ``num_envs`` environments for ``num_steps``, sharded over ``axis``.

    Each device owns ``num_envs / axis_size`` independent envs and runs the
    same single-device ``lax.scan`` rollout (:func:`gym_po_tpu.vector.rollout`);
    there is no cross-device traffic in the env loop.  Returned arrays are
    global (sharded) jax.Arrays: time axis replicated-layout, batch axis
    sharded over ``axis``.
    """
    n = int(np.prod([mesh.shape[a] for a in (axis,)]))
    if num_envs % n:
        raise ValueError(f"num_envs={num_envs} not divisible by mesh axis {n}")
    local_envs = num_envs // n

    keys = jax.random.split(key, n)  # one key per shard

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=(P(None, axis), (P(axis), P(axis))),
        check_rep=False,
    )
    def run(shard_keys):
        traj, (obs, state) = rollout(
            env, shard_keys[0], policy, local_envs, num_steps
        )
        return traj, (obs, state)

    return jax.jit(run)(keys)
