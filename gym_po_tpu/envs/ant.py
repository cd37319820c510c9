"""AntTag / AntHeavenHell — MuJoCo ant POMDPs (host-side, single env).

Same capability as the reference's two MuJoCo envs (reference
``gym_po/envs/ant_tag.py``, ``ant_heaven_hell.py``): continuous-control ant
robots with partially-observable goals, driven through gymnasium's
``MujocoEnv``.  Models are generated programmatically
(:mod:`gym_po_tpu.envs.mjcf`) instead of shipped XML assets.

These are the only envs in the suite whose physics runs on the host CPU —
MuJoCo's C pipeline, exactly like the reference.  A JAX-native (MJX) variant
is gated behind ``mujoco.mjx`` availability, which this image does not
provide; the observation/reward/target logic below is already pure NumPy on
fetched state, so an MJX port swaps only the physics substrate.

Semantics (matching the reference):

* **AntTag** (ant_tag.py:27-158): closed ±5 cage.  A target moves 0.5/step
  {away from ant, 2 orthogonals, stay} uniformly, clamped to ±4.5; the move
  is cancelled (stays put) if it would leave the cage.  Ant spawns uniform
  in ±4.5²; the target re-samples until > 5.0 away.  Obs (29-D) = qpos[2:] +
  qvel + target-xy-if-within-3.0-else-zeros.  Tag within 1.5 → reward 1,
  terminal.
* **AntHeavenHell** (ant_heaven_hell.py:29-137): T-maze; heaven/hell at
  (±6.25, 6.0) (side coin-flipped each episode), priest at (0, 6.0).  Obs
  (28-D) = qpos[2:] + qvel + heaven-direction(±1)-iff-within-2.0-of-priest
  -else-0.  Entering radius 2.0 of heaven/hell → reward ±1, terminal.
  Heaven/hell area sites recolor green/red on reset.
"""

from __future__ import annotations

import os
import tempfile
from typing import Tuple

import numpy as np

import gymnasium
from gymnasium.envs.mujoco import MujocoEnv
from gymnasium.utils import EzPickle

from .mjcf import ant_heaven_hell_xml, ant_tag_xml

__all__ = ["AntTagEnv", "AntHeavenHellEnv"]

_GREEN = [0, 1, 0, 0.5]
_RED = [1, 0, 0, 0.5]

# nominal standing pose: free-joint (x y z quat) + 8 leg joints
_STAND_POSE = np.array(
    [0.0, 0.0, 0.55, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, -1.0, 0.0, -1.0, 0.0, 1.0]
)
_NQ, _NV = 15, 14


def _write_model(xml: str, name: str) -> str:
    path = os.path.join(tempfile.gettempdir(), f"gym_po_tpu_{name}.xml")
    with open(path, "w") as f:
        f.write(xml)
    return path


class _AntBase(MujocoEnv, EzPickle):
    metadata = {
        "render_modes": ["human", "rgb_array", "depth_array"],
        "render_fps": 3,
    }

    def __init__(self, xml: str, model_name: str, obs_dim: int,
                 frame_skip: int, spawn_max_xy: np.ndarray, **kwargs):
        EzPickle.__init__(self, **kwargs)
        obs_space = gymnasium.spaces.Box(
            -np.inf, np.inf, shape=(obs_dim,), dtype=np.float32
        )
        # per-coordinate uniform spawn ranges: xy box, fixed pose, zero vel
        lo = np.concatenate([_STAND_POSE, np.zeros(_NV)])
        hi = lo.copy()
        lo[:2], hi[:2] = -spawn_max_xy, spawn_max_xy
        self._spawn_lo, self._spawn_hi = lo, hi
        MujocoEnv.__init__(
            self,
            _write_model(xml, model_name),
            frame_skip,
            obs_space,
            **kwargs,
        )

    def _sample_spawn(self) -> np.ndarray:
        return self.np_random.uniform(self._spawn_lo, self._spawn_hi)

    def _ant_core_obs(self) -> np.ndarray:
        """qpos without the (hidden) xy position, plus qvel.

        Cast to the declared f32 obs dtype (the reference returns f64 from a
        f32-declared Box, tripping gymnasium's env checker — fixed here).
        """
        return np.concatenate(
            [self.data.qpos.flat[2:], self.data.qvel.flat]
        ).astype(np.float32)


class AntTagEnv(_AntBase):
    """Tag a fleeing target; target visible only within a radius."""

    def __init__(self, frame_skip: int = 15, **kwargs):
        self.cage_max_xy = np.full(2, 4.5)
        self.visible_radius = 3.0
        self.tag_radius = 1.5
        self.min_distance = 5.0
        self.target_step = 0.5
        super().__init__(
            ant_tag_xml(),
            "ant_tag",
            obs_dim=29,
            frame_skip=frame_skip,
            spawn_max_xy=np.full(2, 4.5),
            **kwargs,
        )

    # mocap slots: 0 = target, 1 = visible_area, 2 = tag_area (mjcf.py)
    @property
    def target_pos(self) -> np.ndarray:
        return self.data.mocap_pos[0, :2]

    def _get_obs(self, target_visible: bool) -> np.ndarray:
        tail = self.target_pos if target_visible else np.zeros(2)
        return np.concatenate([self._ant_core_obs(), tail]).astype(np.float32)

    def reset_model(self):
        qpqv = self._sample_spawn()
        self.set_state(qpqv[:_NQ], qpqv[_NQ:])
        ant_xy = qpqv[:2]
        while True:
            tpos = self.np_random.uniform(-self.cage_max_xy, self.cage_max_xy)
            if np.linalg.norm(ant_xy - tpos) > self.min_distance:
                break
        self.data.mocap_pos[0, :2] = tpos
        self.data.mocap_pos[1:3, :2] = ant_xy
        return self._get_obs(False)

    def _move_target(self, ant_xy: np.ndarray) -> None:
        """0.5 step {away, orthogonal-left, orthogonal-right, stay}, cancelled
        at the cage boundary (reference ant_tag.py:105-123)."""
        tpos = self.target_pos.copy()
        away = ant_xy - tpos
        nrm = np.linalg.norm(away)
        if nrm < 1e-9:  # ant exactly on target: no well-defined direction
            self.np_random.integers(4)  # keep the RNG stream consistent
            return
        away = away / nrm
        mode = self.np_random.integers(4)
        step = np.zeros(2)
        if mode == 0:
            step = -away
        elif mode == 1:
            step = np.array([away[1], -away[0]])
        elif mode == 2:
            step = np.array([-away[1], away[0]])
        new = tpos + step * self.target_step
        if (np.abs(new) > self.cage_max_xy).any():
            new = tpos
        self.data.mocap_pos[0, :2] = new

    def step(self, action):
        self.do_simulation(action, self.frame_skip)
        ant_xy = self.data.qpos[:2].copy()
        self._move_target(ant_xy)
        self.data.mocap_pos[1:3, :2] = ant_xy  # indicator spheres track ant
        dist = np.linalg.norm(ant_xy - self.target_pos)
        tagged = dist <= self.tag_radius
        reward = 1.0 if tagged else 0.0
        return (
            self._get_obs(dist < self.visible_radius),
            reward,
            bool(tagged),
            False,
            {},
        )


class AntHeavenHellEnv(_AntBase):
    """T-maze: the priest reveals which arm is heaven."""

    def __init__(
        self,
        frame_skip: int = 15,
        heaven_hell: Tuple[Tuple[float, float], Tuple[float, float]] = (
            (-6.25, 6.0),
            (6.25, 6.0),
        ),
        priest_pos: Tuple[float, float] = (0.0, 6.0),
        termination_radius: float = 2.0,
        **kwargs,
    ):
        self._sites = np.stack(
            [np.asarray(heaven_hell[0]), np.asarray(heaven_hell[1]),
             np.asarray(priest_pos)]
        )
        self._radius = float(termination_radius)
        self.heaven_pos = self._sites[0]
        self.heaven_direction = float(np.sign(self.heaven_pos[0]))
        super().__init__(
            ant_heaven_hell_xml(),
            "ant_heaven_hell",
            obs_dim=28,
            frame_skip=frame_skip,
            spawn_max_xy=np.array([1.0, 1.0]),
            **kwargs,
        )
        # reference spawns x in [-1, 1], y in [0, 1] (ant_heaven_hell.py:50-75)
        self._spawn_lo[1] = 0.0

    def _get_obs(self, reveal: bool) -> np.ndarray:
        tail = np.array([self.heaven_direction if reveal else 0.0])
        return np.concatenate([self._ant_core_obs(), tail]).astype(np.float32)

    def reset_model(self):
        qpqv = self._sample_spawn()
        self.set_state(qpqv[:_NQ], qpqv[_NQ:])
        flip = int(self.np_random.uniform() >= 0.5)
        self.heaven_pos = self._sites[flip]
        self.heaven_direction = float(np.sign(self.heaven_pos[0]))
        right_is_heaven = self.heaven_direction > 0
        self.model.site("right_area").rgba = _GREEN if right_is_heaven else _RED
        self.model.site("left_area").rgba = _RED if right_is_heaven else _GREEN
        return self._get_obs(False)

    def step(self, action):
        self.do_simulation(action, self.frame_skip)
        dists = np.linalg.norm(self.data.qpos[:2] - self._sites, axis=-1)
        done = bool((dists[:2] <= self._radius).any())
        reveal = dists[2] <= self._radius
        heaven_dist = dists[int(max(self.heaven_direction, 0))]
        reward = (1.0 if heaven_dist <= self._radius else -1.0) if done else 0.0
        return self._get_obs(reveal), reward, done, False, {}


def register_gymnasium_envs() -> None:
    """Register the ant envs under the reference's gymnasium ids
    (reference envs/__init__.py:9-19) and this package's own ids."""
    from gymnasium.envs.registration import register, registry

    specs = [
        ("pdomains-ant-tag-v1", "gym_po_tpu.envs.ant:AntTagEnv"),
        ("pdomains-ant-heaven-hell-v1", "gym_po_tpu.envs.ant:AntHeavenHellEnv"),
        ("AntTag-v1", "gym_po_tpu.envs.ant:AntTagEnv"),
        ("AntHeavenHell-v1", "gym_po_tpu.envs.ant:AntHeavenHellEnv"),
    ]
    for env_id, entry in specs:
        if env_id not in registry:
            register(id=env_id, entry_point=entry, max_episode_steps=500)
