"""Default-suite canary for the multichip-dryrun compile budget.

``tests/test_dryrun_budget.py`` guards the REAL driver artifact but is
slow-marked, so the default ~12-min suite never exercised the path that
regressed in round 3 (the ant train step's XLA:CPU compile silently growing
to ~20 minutes).  This canary compiles just that component — the
array-pipeline ant PPO train step, shard_mapped over the 8-device virtual
CPU mesh, the exact configuration ``__graft_entry__.dryrun_multichip``
uses — in-process under a hard trace-size + compile-time bound, so a
trace-size regression fails the default suite the day it lands.

Bounds: the array pipeline lowers this program to ~66k StableHLO lines and
compiles in ~11 s on this machine; the scalar pipeline it guards against is
~16x larger (123k HLO lines for step_vec alone) and minutes-to-tens-of-
minutes to compile.  200k lines / 240 s keep
~3x headroom for loaded machines while still failing fast on a return to
scalar-class traces.
"""

import time

import jax
import pytest

import gym_po_tpu as gpt
from gym_po_tpu.agents import PPOConfig, init_train_state, shard_train_state
from gym_po_tpu.agents.ppo import _build_update
from gym_po_tpu.parallel import make_mesh


@pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU mesh"
)
def test_ant_sharded_train_step_compiles_within_budget():
    n = 8
    mesh = make_mesh(shape=(n,), devices=jax.devices()[:n])
    # identical to the dryrun's ant stage (__graft_entry__.dryrun_multichip)
    ant = gpt.make(
        "AntTagPhysics-v0", frame_skip=1, solver_iters=1, integrator="euler",
        pipeline="array",
    )
    cfg = PPOConfig(
        num_envs=2 * n, rollout_steps=4, epochs=1, minibatches=2,
        hidden=(16, 16),
    )
    net, ts = init_train_state(ant, cfg, jax.random.PRNGKey(1))
    ts = shard_train_state(ts, mesh)

    t0 = time.monotonic()
    lowered = jax.jit(_build_update(ant, net, cfg, mesh)).lower(ts)
    n_lines = lowered.as_text().count("\n")
    assert n_lines < 200_000, (
        f"ant sharded train step lowered to {n_lines} StableHLO lines "
        "(~66k expected) — a trace-size regression of the r03 kind; the "
        "driver's dryrun_multichip artifact would blow its budget"
    )
    lowered.compile()
    dt = time.monotonic() - t0
    assert dt < 240, (
        f"ant sharded train step took {dt:.0f}s to trace+compile "
        "(~11s expected) — the dryrun artifact would time out"
    )
