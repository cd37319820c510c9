"""Solve Taxi to the optimal policy with in-graph tabular Q-learning, then
evaluate and render the greedy policy.

Usage: python examples/solve_taxi.py [--envs 4096] [--render]
"""

import argparse
import sys

import jax
import numpy as np

sys.path.insert(0, ".")
import gym_po_tpu as gpt  # noqa: E402

from gym_po_tpu.agents import QConfig, greedy_policy, q_learning  # noqa: E402
from gym_po_tpu.vector import rollout  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--envs", type=int, default=4096)
    p.add_argument("--render", action="store_true")
    p.add_argument("--fused", action="store_true",
                   help="train with the fused chunk trainer "
                        "(ops/fused_qlearning.py)")
    args = p.parse_args()

    env = gpt.make("Taxi-v4")
    key = jax.random.PRNGKey(0)
    phases = [  # (epsilon, learning_rate, updates-of-128-steps)
        (0.30, 0.05, 150),
        (0.05, 0.02, 150),
        (0.01, 0.01, 100),
    ]
    if args.fused:
        import jax.numpy as jnp

        from gym_po_tpu.agents import fused_q_learning

        q, hist = fused_q_learning(
            env, seed=0,
            schedule=[(lr, eps, 128 * updates) for eps, lr, updates in phases],
            num_envs=args.envs, chunk_steps=128 * 50,
            average_duplicates=False,  # the schedule's lr is tuned for sums
        )
        print(f"fused: train mean_r/step {hist[-1]:+.4f}")
        q = jnp.asarray(q)
    else:
        q = None
        for eps, lr, updates in phases:
            cfg = QConfig(num_envs=args.envs, learning_rate=lr, epsilon=eps)
            q, hist = q_learning(env, cfg, key, num_updates=updates, q_init=q)
            print(f"eps={eps}: train mean_r/step {hist[-1][0]:+.4f}")

    traj, (obs, state) = jax.jit(
        lambda k: rollout(env, k, greedy_policy(q), args.envs, 256)
    )(jax.random.PRNGKey(9))
    r = np.asarray(traj.reward)
    print(
        f"greedy: mean_r/step {r.mean():+.4f}  "
        f"dropoffs/env/256 {(r > 0.5).sum() / args.envs:.2f}  "
        f"bad moves {(r < -0.4).mean():.5f}"
    )
    if args.render:
        from gym_po_tpu.render import render

        img = render(env, state, idx=range(9))
        path = "/tmp/taxi_solved.png"
        import cv2

        cv2.imwrite(path, img[:, :, ::-1])
        print("frame:", path)


if __name__ == "__main__":
    main()
