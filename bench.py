"""Headline benchmark: env-steps/s of the fused taxi rollout, the
articulated-ant engine and ant PPO through the full update, on one GPU.

Prints ONE JSON line with each number, the device it ran on, and the
settings.  Everything runs in this one process.  Without a GPU it exits
with an error: a CPU number is not a device number.

Usage: python bench.py [--env HansenTaxi-v4] [--batch 1048576] [--no-ant]
"""

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp

import gym_po_tpu as gpt
from gym_po_tpu.utils import enable_compilation_cache
from gym_po_tpu.vector import rollout


def _median_rate(run_once, work: int, windows: int) -> float:
    """Median over ``windows`` of ``work / seconds`` for ``run_once()``,
    which must return a device value to wait for."""
    jax.block_until_ready(run_once())  # compile + warm up
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        jax.block_until_ready(run_once())
        rates.append(work / (time.perf_counter() - t0))
    rates.sort()
    return rates[len(rates) // 2]


def bench_env(name: str, batch: int, steps: int, iters: int = 4,
              windows: int = 5) -> float:
    """``vector.rollout`` (one jitted ``lax.scan``, in-graph autoreset and
    uniform-random actions) plus a reward sum."""
    env = gpt.make(name)

    @jax.jit
    def run(k, init):
        traj, (obs, state) = rollout(env, k, None, batch, steps, init=init)
        return (obs, state), traj.reward.sum()

    carry = {"init": jax.jit(lambda k: env.reset_vec(k, batch))(
        jax.random.PRNGKey(1)), "i": 0}

    def once():
        for _ in range(iters):
            carry["i"] += 1
            carry["init"], s = run(jax.random.PRNGKey(carry["i"]),
                                   carry["init"])
        return s

    return _median_rate(once, batch * steps * iters, windows)


def bench_fused(name: str, batch: int, steps: int, iters: int = 4,
                windows: int = 5) -> float:
    """The fused taxi rollout (ops/fused_taxi.py; its Triton kernel on the
    GPU)."""
    from gym_po_tpu.ops import make_fused_taxi_rollout

    env = gpt.make(name)
    run = make_fused_taxi_rollout(env, batch, steps)
    _, st = env.reset_vec(jax.random.PRNGKey(0), batch)
    carry = {"s": st.s.reshape(-1, 128), "i": 0}

    def once():
        for _ in range(iters):
            carry["i"] += 1
            carry["s"], rew = run(jnp.asarray([carry["i"]], jnp.int32),
                                  carry["s"])
        return rew

    return _median_rate(once, batch * steps * iters, windows)


def ant_batch(batch: int, seed: int = 0):
    """Random near-standing ant states: (model, qpos, qvel, warm, ctrl)."""
    from gym_po_tpu.physics import TAG_WALLS, make_ant_model

    model = make_ant_model(TAG_WALLS)
    stand = jnp.asarray(
        [0.0, 0.0, 0.55, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, -1.0, 0.0,
         -1.0, 0.0, 1.0], jnp.float32)
    kq, kv, ka = jax.random.split(jax.random.PRNGKey(seed), 3)
    qpos = stand[None] + 0.01 * jax.random.normal(kq, (batch, 15))
    qvel = 0.1 * jax.random.normal(kv, (batch, 14))
    warm = jnp.zeros((batch, 14), jnp.float32)
    ctrl = jax.random.uniform(ka, (batch, 8), jnp.float32, -1.0, 1.0)
    return model, qpos, qvel, warm, ctrl


# The ant numbers run the array constraint pipeline: on the H100 it steps
# 5.4x faster than the scalar pipeline and compiles in 46 s against 506 s
# (PERF.md); which one becomes the env's default is a separate decision.
ANT_PIPELINE = "array"


def make_ant_engine_run(batch: int, steps: int,
                        pipeline: str = ANT_PIPELINE):
    """Jitted ``steps`` env steps of the engine at the reference physics
    config (rk4 × frame_skip 15, solver_iters 8) -> (run, args)."""
    from gym_po_tpu.physics.engine import PhysicsState, step as phys_step

    model, qpos, qvel, warm, ctrl = ant_batch(batch)
    one = jax.vmap(lambda q, v, w, c: phys_step(
        model, PhysicsState(q, v, w), c, frame_skip=15, iters=8,
        integrator="rk4", pipeline=pipeline))

    @jax.jit
    def run(qpos, qvel, warm, ctrl):
        def body(carry, _):
            s = one(*carry, ctrl)
            return (s.qpos, s.qvel, s.warm), ()

        (q, v, w), _ = jax.lax.scan(body, (qpos, qvel, warm), None,
                                    length=steps)
        return q, v, w

    return run, (qpos, qvel, warm, ctrl)


def bench_ant_engine(batch: int = 4096, steps: int = 8, windows: int = 5,
                     pipeline: str = ANT_PIPELINE) -> float:
    """Articulated-ant rigid-body engine at the reference physics config."""
    run, args = make_ant_engine_run(batch, steps, pipeline)
    return _median_rate(lambda: run(*args), batch * steps, windows)


def bench_ant_ppo(num_envs: int = 4096, rollout_steps: int = 16,
                  updates: int = 2, windows: int = 4,
                  pipeline: str = ANT_PIPELINE) -> float:
    """env-steps/s through the complete PPO update (rollout + GAE + 4x4
    minibatch epochs) on AntTagPhysics-v0 at the reference physics config."""
    from gym_po_tpu.agents import PPOConfig, init_train_state, make_train_step

    env = gpt.make("AntTagPhysics-v0", pipeline=pipeline)
    cfg = PPOConfig(num_envs=num_envs, rollout_steps=rollout_steps,
                    hidden=(64, 64))
    net, ts = init_train_state(env, cfg, jax.random.PRNGKey(0))
    step = make_train_step(env, net, cfg)
    carry = {"ts": ts}

    def once():
        for _ in range(updates):
            carry["ts"], m = step(carry["ts"])
        return m["loss"]

    return _median_rate(once, num_envs * rollout_steps * updates, windows)


def require_gpu() -> jax.Device:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    return dev


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="HansenTaxi-v4")
    p.add_argument("--batch", type=int, default=1048576)
    p.add_argument("--steps", type=int, default=256)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--no-ant", action="store_true",
                   help="skip the articulated-ant engine and ant-PPO numbers")
    args = p.parse_args()

    dev = require_gpu()
    enable_compilation_cache()
    sps = bench_fused(args.env, args.batch, args.steps, args.iters)
    record = {
        "metric": f"env_steps_per_s ({args.env}, B={args.batch}, "
                  f"fused-triton)",
        "value": round(sps),
        "unit": "steps/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if not args.no_ant:
        record["ant_rk4_env_steps_per_s (B=4096, fs=15, iters=8, array)"] = (
            round(bench_ant_engine()))
        record["ant_ppo_env_steps_per_s (B=4096, T=16, full update, array)"] = (
            round(bench_ant_ppo()))
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
