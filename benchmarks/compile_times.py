"""XLA compile time as a first-class measured quantity (VERDICT r3 #2).

The round-3 engine rewrite regressed the multichip dryrun from ~1 min to
~20 min of XLA:CPU compile without any test noticing — compile time is a
first-class liability of the scalarized engine design, so this script
measures it per configuration (on the H100: PERF.md).

For each config we time ``jax.jit(...).lower()`` (trace + StableHLO
emission — pure Python/JAX cost) and ``.compile()`` (XLA optimization +
codegen) separately, and report HLO line count as the trace-size proxy.

Run on CPU (the dryrun's environment) or on the GPU:

    python benchmarks/compile_times.py [--backend cpu|gpu] \
        [--configs env_scalar_euler,env_array_euler,...]

Run it without ``JAX_COMPILATION_CACHE_DIR``: a cache hit is not a compile.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def _time_compile(make_fn_and_args):
    import jax

    fn, args = make_fn_and_args()
    jfn = jax.jit(fn)
    t0 = time.perf_counter()
    lowered = jfn.lower(*args)
    t_lower = time.perf_counter() - t0
    hlo_lines = lowered.as_text().count("\n")
    t0 = time.perf_counter()
    lowered.compile()
    t_compile = time.perf_counter() - t0
    return dict(lower_s=round(t_lower, 1), compile_s=round(t_compile, 1),
                hlo_lines=hlo_lines)


def _env_step(pipeline: str, integrator: str, frame_skip: int, iters: int,
              batch: int = 16):
    def make():
        import jax
        import jax.numpy as jnp

        import gym_po_tpu as gpt

        env = gpt.make("AntTagPhysics-v0", frame_skip=frame_skip,
                       solver_iters=iters, integrator=integrator,
                       pipeline=pipeline)
        key = jax.random.PRNGKey(0)
        _, state = env.reset_vec(key, batch)
        act = jnp.zeros((batch, 8), jnp.float32)
        return env.step_vec, (key, state, act)

    return make


def _ppo_update(pipeline: str, integrator: str, frame_skip: int,
                iters: int, batch: int = 16):
    def make():
        import jax

        import gym_po_tpu as gpt
        from gym_po_tpu.agents import PPOConfig, init_train_state
        from gym_po_tpu.agents.ppo import _build_update

        env = gpt.make("AntTagPhysics-v0", frame_skip=frame_skip,
                       solver_iters=iters, integrator=integrator,
                       pipeline=pipeline)
        cfg = PPOConfig(num_envs=batch, rollout_steps=4, epochs=1,
                        minibatches=2, hidden=(16, 16))
        net, ts = init_train_state(env, cfg, jax.random.PRNGKey(0))
        return _build_update(env, net, cfg), (ts,)

    return make


CONFIGS = {
    # the dryrun's ant stage, both pipelines (the r03 regression vs the fix)
    "env_scalar_euler_fs1_it1": _env_step("scalar", "euler", 1, 1),
    "env_array_euler_fs1_it1": _env_step("array", "euler", 1, 1),
    # the full reference physics config
    "env_scalar_rk4_fs15_it8": _env_step("scalar", "rk4", 15, 8),
    "env_array_rk4_fs15_it8": _env_step("array", "rk4", 15, 8),
    # the PPO update wrapping each (rollout scan + GAE + minibatch epochs)
    "ppo_scalar_euler_fs1_it1": _ppo_update("scalar", "euler", 1, 1),
    "ppo_array_euler_fs1_it1": _ppo_update("array", "euler", 1, 1),
    "ppo_scalar_rk4_fs15_it8": _ppo_update("scalar", "rk4", 15, 8),
}

DEFAULT = ("env_array_euler_fs1_it1,env_array_rk4_fs15_it8,"
           "ppo_array_euler_fs1_it1")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument(
        "--configs", default=DEFAULT,
        help=f"comma list from {sorted(CONFIGS)}; 'all' for everything "
        "(WARNING: scalar CPU configs compile for many minutes each)")
    args = ap.parse_args()

    import jax

    if args.backend == "cpu":
        jax.config.update("jax_platforms", "cpu")

    names = (sorted(CONFIGS) if args.configs == "all"
             else args.configs.split(","))
    out = {"backend": args.backend,
           "device": jax.devices()[0].platform}
    for name in names:
        out[name] = _time_compile(CONFIGS[name])
        print(json.dumps({name: out[name]}), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
