"""Render every env family to PNG montages (host-side pure functions).

Usage: python examples/render_demo.py [--out /tmp/frames] [--steps 30]
"""

import argparse
import os
import sys

import jax
import numpy as np

sys.path.insert(0, ".")
import gym_po_tpu as gpt  # noqa: E402

from gym_po_tpu.render import render  # noqa: E402

CONFIGS = [
    ("ExtendedHansenTaxi-v4", {}),
    ("Rooms-v0", {"layout": "8", "obs_type": "hansen", "goal_xy": None}),
    ("CRooms-v0", {"layout": "4", "obs_type": "mdp", "goal_xy": None}),
    ("MultistoryFourRooms-v0", {"grid_z": 3, "obs_type": "mdp"}),
    ("CarFlag-v0", {"time_limit": 60}),
    # euler/fs=1/iters=1 + the ARRAY constraint pipeline keep the CPU
    # compile to seconds (the scalar pipeline's graph takes minutes of
    # XLA:CPU compile even at this reduced config — same compile-budget
    # trick as __graft_entry__.dryrun_multichip); the renderer is
    # physics-agnostic
    ("AntTagPhysics-v0",
     {"frame_skip": 1, "solver_iters": 1, "integrator": "euler",
      "pipeline": "array"}),
    ("AntHeavenHellPhysics-v0",
     {"frame_skip": 1, "solver_iters": 1, "integrator": "euler",
      "pipeline": "array"}),
]


def save_png(path: str, img: np.ndarray) -> None:
    try:
        import cv2

        cv2.imwrite(path, img[:, :, ::-1])  # RGB -> BGR
    except ImportError:  # minimal PNG writer via pygame
        import pygame

        pygame.image.save(
            pygame.surfarray.make_surface(img.swapaxes(0, 1)), path
        )


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="/tmp/gym_po_tpu_frames")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--envs", type=int, default=9)
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)

    for name, kw in CONFIGS:
        env = gpt.make(name, **kw)
        key = jax.random.PRNGKey(0)
        obs, state = env.reset_vec(key, args.envs)
        step = jax.jit(env.step_vec)
        for t in range(args.steps):
            key, ka, ks = jax.random.split(key, 3)
            a = env.action_space.sample_vec(ka, args.envs)
            obs, state, *_ = step(ks, state, a)
        img = render(env, state, idx=range(args.envs))
        path = os.path.join(args.out, f"{name.replace('/', '_')}.png")
        save_png(path, img)
        print(f"{name}: {img.shape} -> {path}")
        if name.startswith("Ant"):
            # full MuJoCo 3-D scene (the reference's own render path);
            # falls back silently on machines without mujoco+EGL
            try:
                from gym_po_tpu.render import render_ant_scene

                img3d = render_ant_scene(env, state,
                                         idx=range(min(args.envs, 4)))
                p3d = os.path.join(args.out, f"{name}_scene.png")
                save_png(p3d, img3d)
                print(f"{name}: 3-D scene {img3d.shape} -> {p3d}")
            except Exception as e:
                print(f"{name}: 3-D scene unavailable ({e})")


if __name__ == "__main__":
    main()
