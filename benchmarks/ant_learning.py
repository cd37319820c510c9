"""PPO / GRU-PPO learning demonstrations on the ant POMDPs (VERDICT r3 #3,
r4 #1-2).

Trains on the ARTICULATED envs themselves (``AntTagPhysics-v0`` /
``AntHeavenHellPhysics-v0``, not the point-mass surrogates — though the
surrogates are accepted via ``--env`` for cheap recipe search) and reports
the success-rate trend:

* **tag**: ``pos_rate`` is tags per env-step (the env's only reward is +1
  at the tag, reference ``gym_po/envs/ant_tag.py:147-150``).
* **heaven-hell**: ``pos_rate``/``neg_rate`` are heaven/hell arrivals per
  env-step (±1 terminal, reference ``gym_po/envs/ant_heaven_hell.py:
  121-137``); ``heaven_frac = pos/(pos+neg)`` is the memory metric — a
  memoryless policy is pinned at ~0.5 by construction (the heaven side is
  observable only within the priest radius, ``:88-97``).

Metrics are fetched only at chunk boundaries.
Defaults use the euler integrator (the documented speed knob — ~4x the rk4
throughput at the same contact model; pass ``--integrator rk4`` for the
exact reference physics at 4x the wall clock).

    python benchmarks/ant_learning.py [--env AntTagPhysics-v0] [--rnn]
        [--updates 600] [--num-envs 2048] [--rollout 32] [--chunk 50]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import numpy as np

sys.path.insert(0, ".")
import gym_po_tpu as gpt  # noqa: E402
from gym_po_tpu.utils import enable_compilation_cache  # noqa: E402
from gym_po_tpu.utils.platform import pin_platform_from_env  # noqa: E402

pin_platform_from_env()  # honor JAX_PLATFORMS=cpu for recipe-search runs
enable_compilation_cache()
from gym_po_tpu.agents import (  # noqa: E402
    PPOConfig,
    init_rnn_state,
    init_train_state,
    make_rnn_train_step,
    make_train_step,
)

PHYSICS_ENVS = ("AntTagPhysics-v0", "AntHeavenHellPhysics-v0")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="AntTagPhysics-v0",
                    choices=PHYSICS_ENVS + ("TagContinuous-v0",
                                            "HeavenHellContinuous-v0"))
    ap.add_argument("--updates", type=int, default=600)
    ap.add_argument("--num-envs", type=int, default=2048)
    ap.add_argument("--rollout", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=50,
                    help="updates per metrics fetch")
    ap.add_argument("--integrator", default="euler",
                    choices=["euler", "rk4"],
                    help="physics envs only; euler = the speed knob, "
                    "rk4 = the exact reference setting")
    ap.add_argument("--entropy-coef", type=float, default=0.001,
                    help="0.001 is the calibrated ant setting: at the "
                    "PPO-default 0.01 the Gaussian std grows without bound "
                    "(nothing opposes the entropy bonus on these sparse "
                    "rewards) and learning collapses")
    ap.add_argument("--lr", type=float, default=2.5e-4)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--minibatches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shaped", action="store_true",
                    help="potential-based reward shaping (exact PBRS, "
                    "policy-invariant, envs/shaping.py): the exploration "
                    "aid for the heaven-hell tasks, whose ±1-terminal "
                    "reward defeats naive exploration; pos/neg rates "
                    "still count real terminals only")
    ap.add_argument("--shaping-coef", type=float, default=0.1)
    ap.add_argument("--shaping-gamma", type=float, default=1.0,
                    help="discount inside the PBRS term.  1.0 (default) = "
                    "within-episode telescoping: loitering pays exactly 0. "
                    "The learner-gamma value gives EXACT policy invariance "
                    "but pays (1-gamma)*|phi| per step for loitering far "
                    "from the goal — measured to trap PPO in a "
                    "zero-terminal loiter policy on heaven-hell")
    ap.add_argument("--gamma", type=float, default=0.99)
    ap.add_argument("--rnn", action="store_true",
                    help="GRU-PPO (the POMDP-proper learner: carries "
                    "last-seen target position / the priest's reveal)")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint dir for segmented runs: restores the "
                    "latest TrainState, saves after every chunk (rerunning "
                    "the same command resumes)")
    args = ap.parse_args()

    kw = {"integrator": args.integrator} if args.env in PHYSICS_ENVS else {}
    env = gpt.make(args.env, **kw)
    if args.shaped:
        from gym_po_tpu.envs.shaping import (PotentialShaped,
                                             heaven_hell_potential,
                                             tag_potential)
        pot = (heaven_hell_potential(args.shaping_coef)
               if "HeavenHell" in args.env else
               tag_potential(args.shaping_coef))
        env = PotentialShaped(env, pot, gamma=args.shaping_gamma)
    cfg = PPOConfig(
        num_envs=args.num_envs,
        rollout_steps=args.rollout,
        epochs=args.epochs,
        minibatches=args.minibatches,
        gamma=args.gamma,
        entropy_coef=args.entropy_coef,
        learning_rate=args.lr,
        hidden=(args.hidden, args.hidden),
    )
    if args.rnn:
        cfg = cfg._replace(shuffle="none")  # rnn minibatches split env axis
        net, ts = init_rnn_state(env, cfg, jax.random.PRNGKey(args.seed),
                                 hidden=args.hidden)
    else:
        net, ts = init_train_state(env, cfg, jax.random.PRNGKey(args.seed))
    start = 0
    if args.ckpt:
        from gym_po_tpu.utils.checkpoint import (latest_step,
                                                 restore_checkpoint,
                                                 save_checkpoint)
        import os
        if os.path.isdir(args.ckpt) and latest_step(args.ckpt) is not None:
            start = latest_step(args.ckpt)
            ts = restore_checkpoint(args.ckpt, ts)
            print(json.dumps({"resumed_at_update": start}), flush=True)
    # one dispatch per update; metrics are fetched only at chunk
    # boundaries.
    step = (make_rnn_train_step if args.rnn else make_train_step)(
        env, net, cfg)

    steps_per_update = args.num_envs * args.rollout
    history = []
    t_start = time.time()
    done = start
    while done < args.updates:
        t0 = time.time()
        chunk_m = []
        for _ in range(args.chunk):
            ts, m = step(ts)
            chunk_m.append(m)
        pos = np.asarray([m["pos_reward_rate"] for m in chunk_m])
        neg = np.asarray([m["neg_reward_rate"] for m in chunk_m])
        m = {k: np.asarray(chunk_m[-1][k]) for k in chunk_m[-1]}
        dt = time.time() - t0
        done += args.chunk
        rec = {
            "update": done,
            "pos_rate_per_step": float(pos.mean()),
            "neg_rate_per_step": float(neg.mean()),
            "heaven_frac": float(pos.mean() / max(pos.mean() + neg.mean(),
                                                  1e-12)),
            "entropy": float(np.asarray(m["entropy"])),
            "env_steps": done * steps_per_update,
            "sps": round(args.chunk * steps_per_update / dt),
        }
        history.append(rec)
        print(json.dumps(rec), flush=True)
        if args.ckpt:
            save_checkpoint(args.ckpt, done, ts)

    first = history[0]["pos_rate_per_step"]
    last = history[-1]["pos_rate_per_step"]
    print(json.dumps({
        "metric": f"{args.env}_{'gru_' if args.rnn else ''}ppo_learning "
        f"({args.integrator if args.env in PHYSICS_ENVS else 'pointmass'}, "
        f"B={args.num_envs}, T={args.rollout}, {args.updates} updates)",
        "pos_rate_first_chunk": first,
        "pos_rate_last_chunk": last,
        "heaven_frac_last_chunk": history[-1]["heaven_frac"],
        "improvement": last / max(first, 1e-9),
        "total_env_steps": args.updates * steps_per_update,
        "wall_s": round(time.time() - t_start),
    }))


if __name__ == "__main__":
    main()
