"""Train PPO on any registered env — the working equivalent of the
reference's broken smoke driver (reference ``gym_po/tester.py``).

Single chip:
    python examples/train_ppo.py --env ExtendedHansenTaxi-v4 --updates 200

All local devices (Anakin data-parallel, e.g. a pod slice or
XLA_FLAGS=--xla_force_host_platform_device_count=8 on CPU):
    python examples/train_ppo.py --mesh --num-envs 4096

Multi-host: call gym_po_tpu.parallel.distributed_init() first on every host;
the mesh then spans the slice and the same script runs unchanged.
"""

import argparse
import sys
import time

import jax

sys.path.insert(0, ".")
import gym_po_tpu as gpt  # noqa: E402

from gym_po_tpu.agents import (  # noqa: E402
    PPOConfig,
    init_train_state,
    make_train_step,
    shard_train_state,
)
from gym_po_tpu.utils import save_checkpoint  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--env", default="ExtendedHansenTaxi-v4")
    p.add_argument("--num-envs", type=int, default=2048)
    p.add_argument("--rollout", type=int, default=128)
    p.add_argument("--updates", type=int, default=100)
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", action="store_true", help="shard over all devices")
    p.add_argument("--shuffle", default="roll", choices=["permute", "roll", "none"])
    p.add_argument("--recurrent", action="store_true",
                   help="GRU policy (memory for partially-observable tasks)")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--log-every", type=int, default=10)
    args = p.parse_args()

    env = gpt.make(args.env)
    cfg = PPOConfig(
        num_envs=args.num_envs,
        rollout_steps=args.rollout,
        learning_rate=args.lr,
        shuffle=args.shuffle,
    )
    mesh = None
    if args.mesh:
        from gym_po_tpu.parallel import make_mesh

        mesh = make_mesh()
        print(f"mesh: {mesh}")

    if args.recurrent:
        from gym_po_tpu.agents import init_rnn_state, make_rnn_train_step
        from gym_po_tpu.agents.ppo_rnn import shard_rnn_state

        net, ts = init_rnn_state(env, cfg, jax.random.PRNGKey(args.seed))
        if mesh is not None:
            ts = shard_rnn_state(ts, mesh)
        step = make_rnn_train_step(env, net, cfg, mesh)
    else:
        net, ts = init_train_state(env, cfg, jax.random.PRNGKey(args.seed))
        if mesh is not None:
            ts = shard_train_state(ts, mesh)
        step = make_train_step(env, net, cfg, mesh)

    steps_per_update = cfg.num_envs * cfg.rollout_steps
    t0 = time.perf_counter()
    for i in range(1, args.updates + 1):
        ts, metrics = step(ts)
        if i % args.log_every == 0:
            jax.block_until_ready(metrics)
            dt = time.perf_counter() - t0
            sps = steps_per_update * args.log_every / dt
            m = {k: round(float(v), 4) for k, v in metrics.items()}
            print(f"update {i:5d}  {sps/1e6:7.2f}M steps/s  {m}")
            t0 = time.perf_counter()
        if args.checkpoint_dir and i % (args.log_every * 10) == 0:
            save_checkpoint(args.checkpoint_dir, i, ts)
            print(f"checkpointed update {i}")


if __name__ == "__main__":
    main()
