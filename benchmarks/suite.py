"""Throughput sweep across the env suite.

Prints one JSON line per (env, batch) config: env-steps/s via a single
jitted ``lax.scan`` rollout (in-graph autoreset + uniform-random actions).
Runs on whatever backend JAX selects (the GPU by default; CPU with
``JAX_PLATFORMS=cpu``).

Usage: python benchmarks/suite.py [--batches 4096 65536] [--steps 256]
"""

import argparse
import json
import sys
import time

import jax

sys.path.insert(0, ".")  # repo root
import gym_po_tpu as gpt  # noqa: E402
from gym_po_tpu.vector import rollout  # noqa: E402

CONFIGS = [
    ("Taxi-v4", {}),
    ("HansenTaxi-v4", {}),
    ("ExtendedHansenTaxi-v4", {}),
    ("Rooms-v0", {"layout": "4", "obs_type": "hansen", "goal_xy": None}),
    ("Rooms-v0", {"layout": "16", "obs_type": "mdp", "goal_xy": None}),
    ("CRooms-v0", {"layout": "4", "obs_type": "mdp", "use_velocity": True,
                   "goal_xy": None}),
    ("MultistoryFourRooms-v0", {"grid_z": 3, "obs_type": "hansen",
                                "goal_xyz": None}),
    ("DiscreteCarFlag-v0", {"num_actions": 5}),
    ("RockSample-v0", {"map_size": (7, 7), "num_rocks": 8}),
    ("TagContinuous-v0", {}),
    ("HeavenHellContinuous-v0", {}),
    # articulated ant on the rigid-body engine (reference config:
    # rk4 x frame_skip 15 = 60 constrained solves per env step).  Orders
    # of magnitude heavier than the tabular envs: the sweep overrides
    # steps/batches for it (see main) so the suite stays runnable.
    ("AntTagPhysics-v0", {}),
]

# env-step count override for the heavyweight configs (one ant env step is
# ~60 constrained forward solves; 256-step windows would take minutes)
STEPS_OVERRIDE = {"AntTagPhysics-v0": 4}
BATCH_CAP = {"AntTagPhysics-v0": 4096}


def bench(name, kw, batch, steps, iters=3, windows=5):
    """Median over timing windows."""
    env = gpt.make(name, **kw)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def run(k, init):
        traj, (obs, st) = rollout(env, k, None, batch, steps, init=init)
        return (obs, st), traj.reward.sum()

    init = jax.jit(lambda k: env.reset_vec(k, batch))(key)
    init, s = run(key, init)  # compile + warmup
    jax.block_until_ready(s)
    rates = []
    for w in range(windows):
        t0 = time.perf_counter()
        for i in range(iters):
            init, s = run(jax.random.fold_in(key, w * iters + i), init)
        jax.block_until_ready(s)
        rates.append(batch * steps * iters / (time.perf_counter() - t0))
    rates.sort()
    return rates[len(rates) // 2]


def bench_fused(name, kw, batch, steps, iters=3, windows=5, policy_eval=False):
    """Fused rollouts (taxi/rooms/msrooms/crooms/rocksample/tag families)."""
    import numpy as np

    import jax.numpy as jnp

    from gym_po_tpu import ops

    env = gpt.make(name, **kw)
    key = jax.random.PRNGKey(0)
    _, st = env.reset_vec(key, batch)
    if "Taxi" in name:
        pol = None
        if policy_eval:  # greedy per-state action table
            pol = np.random.default_rng(0).integers(
                0, 5, env.tables.ns, dtype=np.int32
            )
        run = ops.make_fused_taxi_rollout(env, batch, steps, policy=pol)
        args0 = (st.s.reshape(-1, 128),)
    elif policy_eval:
        raise ValueError(f"no fused policy-eval kernel for {name}")
    elif name == "Rooms-v0":
        GW = env.grid_np.shape[1]
        run = ops.make_fused_rooms_rollout(env, batch, steps)
        args0 = (
            (st.agent_yx[:, 0] * GW + st.agent_yx[:, 1]).reshape(-1, 128).astype(jnp.int32),
            (st.goal_yx[:, 0] * GW + st.goal_yx[:, 1]).reshape(-1, 128).astype(jnp.int32),
        )
    elif name == "MultistoryFourRooms-v0":
        Z, H, GW = env.grid_np.shape
        HW = H * GW
        run = ops.make_fused_msrooms_rollout(env, batch, steps)
        args0 = (
            (st.agent_zyx[:, 0] * HW + st.agent_zyx[:, 1] * GW + st.agent_zyx[:, 2])
            .reshape(-1, 128).astype(jnp.int32),
            (st.goal_zyx[:, 0] * HW + st.goal_zyx[:, 1] * GW + st.goal_zyx[:, 2])
            .reshape(-1, 128).astype(jnp.int32),
        )
    elif name == "CRooms-v0":
        run = ops.make_fused_crooms_rollout(env, batch, steps)
        args0 = (
            st.agent_yx[:, 0].reshape(-1, 128), st.agent_yx[:, 1].reshape(-1, 128),
            st.vel_yx[:, 0].reshape(-1, 128), st.vel_yx[:, 1].reshape(-1, 128),
            st.goal_yx[:, 0].reshape(-1, 128), st.goal_yx[:, 1].reshape(-1, 128),
        )
    elif name == "RockSample-v0":
        run = ops.make_fused_rocksample_rollout(env, batch, steps)
        args0 = (
            (st.pos_yx[:, 0] * env.cols + st.pos_yx[:, 1])
            .reshape(-1, 128).astype(jnp.int32),
            (st.rock_good.astype(jnp.int32) * (2 ** jnp.arange(env.k)))
            .sum(-1).reshape(-1, 128).astype(jnp.int32),
        )
    elif name == "TagContinuous-v0":
        run = ops.make_fused_tag_rollout(env, batch, steps)
        args0 = (
            st.agent_xy[:, 0].reshape(-1, 128), st.agent_xy[:, 1].reshape(-1, 128),
            st.target_xy[:, 0].reshape(-1, 128), st.target_xy[:, 1].reshape(-1, 128),
        )
    elif name == "HeavenHellContinuous-v0":
        run = ops.make_fused_heavenhell_rollout(env, batch, steps)
        args0 = (
            st.agent_xy[:, 0].reshape(-1, 128), st.agent_xy[:, 1].reshape(-1, 128),
            st.heaven_right.astype(jnp.int32).reshape(-1, 128),
        )
    else:
        raise ValueError(f"no fused kernel for {name}")
    seed = jnp.asarray([7], jnp.int32)
    out = run(seed, *args0)
    jax.block_until_ready(out)
    state = out[:-1]
    rates = []
    for w in range(windows):
        t0 = time.perf_counter()
        for i in range(iters):
            out = run(seed + w * iters + i, *state)
            state = out[:-1]
        jax.block_until_ready(out)
        rates.append(batch * steps * iters / (time.perf_counter() - t0))
    rates.sort()
    return rates[len(rates) // 2]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batches", type=int, nargs="+", default=[4096, 65536])
    p.add_argument("--steps", type=int, default=256)
    p.add_argument("--fused", action="store_true",
                   help="measure the fused rollouts where available")
    p.add_argument("--only", nargs="+", default=None,
                   help="restrict to envs whose name contains any substring")
    p.add_argument("--policy-eval", action="store_true",
                   help="fused greedy tabular-policy evaluation (taxi family)")
    args = p.parse_args()
    d0 = jax.devices()[0]
    dev = {"platform": d0.platform, "kind": d0.device_kind,
           "count": len(jax.devices())}
    seen = set()
    for name, kw in CONFIGS:
        if args.only and not any(s in name for s in args.only):
            continue
        for batch in args.batches:
            batch = min(batch, BATCH_CAP.get(name, batch))
            steps = STEPS_OVERRIDE.get(name, args.steps)
            if (name, str(kw), batch) in seen:
                continue  # batch cap collapsed this config
            seen.add((name, str(kw), batch))
            if args.fused or args.policy_eval:
                try:
                    sps = bench_fused(name, kw, batch, steps,
                                      policy_eval=args.policy_eval)
                    mode = "fused-policy" if args.policy_eval else "fused"
                except ValueError:
                    continue  # no fused kernel for this env
            else:
                sps = bench(name, kw, batch, steps)
                mode = "scan"
            print(
                json.dumps(
                    {
                        "env": name,
                        "kwargs": kw,
                        "batch": batch,
                        "mode": mode,
                        "steps_per_s": round(sps),
                        "device": dev,
                    }
                ),
                flush=True,
            )


if __name__ == "__main__":
    main()
