"""PPO learner throughput: env-steps/s through the FULL Anakin update.

One update = rollout_steps × num_envs env transitions + GAE + epochs ×
minibatch gradient steps, all in one jitted program.  Prints one JSON line.

Usage: python benchmarks/learner.py [--num-envs 32768] [--rollout 128]
"""

import argparse
import json
import sys
import time

import jax

sys.path.insert(0, ".")
import gym_po_tpu as gpt  # noqa: E402
from gym_po_tpu.utils import enable_compilation_cache  # noqa: E402

enable_compilation_cache()
from gym_po_tpu.agents import (  # noqa: E402
    PPOConfig,
    init_train_state,
    make_multi_train_step,
    make_train_step,
)


def bench_fused_q(args):
    """Fused tabular Q-learning (ops/fused_qlearning.py): taxi family,
    or rooms when --env names a Rooms config."""
    import numpy as np

    import jax.numpy as jnp

    from gym_po_tpu.ops import (
        make_fused_q_trainer,
        make_fused_q_trainer_rooms,
        q_to_banks,
    )

    B, K = args.num_envs, 256
    if "Rooms" in args.env:
        env = gpt.make(args.env)
        run = make_fused_q_trainer_rooms(env, B, K, average_duplicates=True)
        GW = env.grid_np.shape[1]
        _, st = env.reset_vec(jax.random.PRNGKey(0), B)
        s = jnp.asarray(
            np.asarray(st.agent_yx[:, 0] * GW + st.agent_yx[:, 1])
            .reshape(-1, 128), jnp.int32,
        )
        q = jnp.asarray(q_to_banks(np.zeros((512, env.num_actions),
                                            np.float32)))
        bench_name = args.env
    else:
        env = gpt.make("Taxi-v4")
        run = make_fused_q_trainer(env, B, K)
        _, st = env.reset_vec(jax.random.PRNGKey(0), B)
        s = jnp.asarray(np.asarray(st.s).reshape(-1, 128), jnp.int32)
        q = jnp.asarray(q_to_banks(np.zeros((512, 5), np.float32)))
        bench_name = "Taxi-v4"
    s, q, rew = run(jnp.asarray([1], jnp.int32), 0.1, 0.1, s, q)
    jax.block_until_ready(rew)
    rates = []
    for w in range(args.windows):
        t0 = time.perf_counter()
        for i in range(args.updates):
            s, q, rew = run(
                jnp.asarray([2 + w * 100 + i], jnp.int32), 0.1, 0.1, s, q
            )
        jax.block_until_ready(rew)
        rates.append(B * K * args.updates / (time.perf_counter() - t0))
    rates.sort()
    print(
        json.dumps(
            {
                "metric": f"fused_q_train_steps_per_s ({bench_name}, B={B}, "
                f"K={K})",
                "value": round(rates[len(rates) // 2]),
                "unit": "steps/s",
                "device": {"platform": jax.devices()[0].platform,
                           "kind": jax.devices()[0].device_kind,
                           "count": len(jax.devices())},
            }
        )
    )


def bench_fused_ac(args):
    """Fused softmax actor-critic (ops/fused_ac.py), Rooms."""
    import numpy as np

    import jax.numpy as jnp

    from gym_po_tpu.ops import make_fused_ac_trainer_rooms
    from gym_po_tpu.ops.fused_qlearning import q_to_banks

    env = gpt.make("Rooms-v0")
    B, K = args.num_envs, 256
    GW = env.grid_np.shape[1]
    A = int(env.num_actions)
    run = make_fused_ac_trainer_rooms(env, B, K)
    _, st = env.reset_vec(jax.random.PRNGKey(0), B)
    a = jnp.asarray(
        np.asarray(st.agent_yx[:, 0] * GW + st.agent_yx[:, 1]).reshape(-1, 128),
        jnp.int32,
    )
    th = jnp.asarray(q_to_banks(np.zeros((512, A), np.float32)))
    v = jnp.asarray(q_to_banks(np.zeros((512, 1), np.float32)))
    th, v, a, rew = run(jnp.asarray([1], jnp.int32), 0.1, 0.2, th, v, a)
    jax.block_until_ready(rew)
    rates = []
    for w in range(args.windows):
        t0 = time.perf_counter()
        for i in range(args.updates):
            th, v, a, rew = run(
                jnp.asarray([2 + w * 100 + i], jnp.int32), 0.1, 0.2, th, v, a
            )
        jax.block_until_ready(rew)
        rates.append(B * K * args.updates / (time.perf_counter() - t0))
    rates.sort()
    print(
        json.dumps(
            {
                "metric": f"fused_ac_train_steps_per_s (Rooms-v0, B={B}, "
                f"K={K})",
                "value": round(rates[len(rates) // 2]),
                "unit": "steps/s",
                "device": {"platform": jax.devices()[0].platform,
                           "kind": jax.devices()[0].device_kind,
                           "count": len(jax.devices())},
            }
        )
    )


def bench_rnn(args):
    """Recurrent (GRU) PPO: sequence replay inside the update."""
    from gym_po_tpu.agents import PPOConfig, init_rnn_state, make_rnn_train_step

    env = gpt.make(args.env)
    cfg = PPOConfig(
        num_envs=args.num_envs,
        rollout_steps=args.rollout,
        hidden=tuple(args.hidden),
        shuffle="none",  # rnn minibatches split the env axis
    )
    net, ts = init_rnn_state(env, cfg, jax.random.PRNGKey(0))
    step = make_rnn_train_step(env, net, cfg)
    ts, m = step(ts)
    jax.block_until_ready(m)
    steps_per_update = cfg.num_envs * cfg.rollout_steps
    rates = []
    for _ in range(args.windows):
        t0 = time.perf_counter()
        for _ in range(args.updates):
            ts, m = step(ts)
        jax.block_until_ready(m)
        rates.append(steps_per_update * args.updates / (time.perf_counter() - t0))
    rates.sort()
    print(
        json.dumps(
            {
                "metric": f"ppo_rnn_env_steps_per_s ({args.env}, "
                f"B={args.num_envs}, T={args.rollout})",
                "value": round(rates[len(rates) // 2]),
                "unit": "steps/s",
                "device": {"platform": jax.devices()[0].platform,
                           "kind": jax.devices()[0].device_kind,
                           "count": len(jax.devices())},
            }
        )
    )


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="ExtendedHansenTaxi-v4")
    p.add_argument("--num-envs", type=int, default=32768)
    p.add_argument("--rollout", type=int, default=128)
    p.add_argument("--hidden", type=int, nargs="+", default=[64, 64])
    p.add_argument("--updates", type=int, default=3)
    p.add_argument("--windows", type=int, default=4)
    p.add_argument("--shuffle", default="permute", choices=["permute", "roll", "none"])
    p.add_argument("--multi", action="store_true",
                   help="scan all --updates into one dispatch per window")
    p.add_argument("--fused-q", action="store_true",
                   help="benchmark the fused tabular Q-learning trainer "
                        "(classic Taxi) instead of PPO")
    p.add_argument("--rnn", action="store_true",
                   help="benchmark the recurrent (GRU) PPO learner")
    p.add_argument("--fused-ac", action="store_true",
                   help="benchmark the fused tabular actor-critic (Rooms)")
    args = p.parse_args()

    if args.fused_q:
        return bench_fused_q(args)
    if args.fused_ac:
        return bench_fused_ac(args)
    if args.rnn:
        return bench_rnn(args)

    env = gpt.make(args.env)
    cfg = PPOConfig(
        num_envs=args.num_envs,
        rollout_steps=args.rollout,
        hidden=tuple(args.hidden),
        shuffle=args.shuffle,
    )
    net, ts = init_train_state(env, cfg, jax.random.PRNGKey(0))
    if args.multi:
        multi = make_multi_train_step(env, net, cfg, args.updates)
        ts, m = multi(ts)  # compile + warmup
        jax.block_until_ready(m)
    else:
        step = make_train_step(env, net, cfg)
        ts, m = step(ts)  # compile + warmup
        jax.block_until_ready(m)

    steps_per_update = cfg.num_envs * cfg.rollout_steps
    rates = []
    for _ in range(args.windows):
        t0 = time.perf_counter()
        if args.multi:
            ts, m = multi(ts)
            jax.block_until_ready(m)
        else:
            for _ in range(args.updates):
                ts, m = step(ts)
            jax.block_until_ready(m)
        rates.append(steps_per_update * args.updates / (time.perf_counter() - t0))
    rates.sort()
    print(
        json.dumps(
            {
                "metric": f"ppo_env_steps_per_s ({args.env}, B={args.num_envs}, "
                f"T={args.rollout}, shuffle={args.shuffle})",
                "value": round(rates[len(rates) // 2]),
                "unit": "steps/s",
                "device": {"platform": jax.devices()[0].platform,
                           "kind": jax.devices()[0].device_kind,
                           "count": len(jax.devices())},
            }
        )
    )


if __name__ == "__main__":
    main()
