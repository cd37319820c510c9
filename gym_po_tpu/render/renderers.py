"""Host-side rendering: pure functions of fetched env state.

The reference renders from mutable env internals with cv2/pygame (reference
``gym_po/envs/render_utils.py``, ``extended_taxi.py:289-342``,
``car_flag.py:146-278``).  Here rendering is a *pure host function* of a
state pytree pulled off the device — the jitted hot path never knows
rendering exists.  NumPy-only; an optional pygame window is provided by
:func:`human_view`.

Each ``render_*`` takes the environment (for its compiled tables) and a
*batched* state, returns a tiled uint8 RGB montage of the selected instances.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "CELL_PX",
    "COLORS",
    "tile_images",
    "render_taxi",
    "render_rooms",
    "render_crooms",
    "render_msrooms",
    "render_car",
    "render_tag",
    "render_heavenhell",
    "render_rocksample",
    "render_ant",
    "render_ant_scene",
    "render",
    "human_view",
]

CELL_PX = 16

COLORS = {
    "wall": (40, 40, 40),
    "floor": (220, 220, 220),
    "pseudo_wall": (140, 140, 160),
    "agent": (200, 40, 40),
    "goal": (40, 170, 40),
    "taxi": (230, 200, 30),
    "taxi_full": (60, 190, 60),
    "passenger": (60, 90, 220),
    "destination": (190, 60, 190),
    "stairs_up": (230, 140, 40),
    "stairs_down": (100, 70, 160),
    "priest": (190, 60, 190),
    "heaven": (40, 170, 40),
    "hell": (200, 40, 40),
    "car": (230, 200, 30),
}


def _blank(rows: int, cols: int, color=(0, 0, 0)) -> np.ndarray:
    img = np.zeros((rows, cols, 3), np.uint8)
    img[:] = color
    return img


def _fill_cell(img: np.ndarray, y: int, x: int, color, px: int = CELL_PX, pad=1):
    img[y * px + pad : (y + 1) * px - pad, x * px + pad : (x + 1) * px - pad] = color


def _dot(img: np.ndarray, y: int, x: int, color, px: int = CELL_PX):
    q = px // 4
    img[y * px + q : (y + 1) * px - q, x * px + q : (x + 1) * px - q] = color


def tile_images(frames: Sequence[np.ndarray]) -> np.ndarray:
    """Tile B same-shaped frames into a near-square montage (capability of
    reference ``render_utils.py:63-88``, new layout algorithm)."""
    n = len(frames)
    cols = math.ceil(math.sqrt(n))
    rows = math.ceil(n / cols)
    h, w, c = frames[0].shape
    out = np.zeros((rows * h, cols * w, c), np.uint8)
    for i, f in enumerate(frames):
        r, cl = divmod(i, cols)
        out[r * h : (r + 1) * h, cl * w : (cl + 1) * w] = f
    return out


def _select(state_field, idx) -> np.ndarray:
    arr = np.asarray(state_field)
    return arr[idx]


def _indices(idx: Optional[Sequence[int]], default_n: int = 1) -> np.ndarray:
    return np.arange(default_n) if idx is None else np.asarray(idx)


# ------------------------------------------------------------------- taxi
def render_taxi(env, state, idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """PO-Taxi frame: walls from the bordered map, landmarks, taxi, passenger.

    Semantics match the reference's character overlay (extended_taxi.py:
    289-342: D destination, T taxi, P passenger, F full taxi), drawn both as
    colors and as text glyphs (reference render_utils.py:36-61 capability:
    landmark letters from the map string, T/F taxi status, P passenger,
    D destination).
    """
    from ..maps.taxi_maps import decode_state_np
    from .glyphs import draw_text_at

    t = env.tables
    idx = _indices(idx)
    s = _select(state.s, idx)
    r, c, p, d = decode_state_np(np.asarray(s, np.int64), t.cols, t.nlocs)
    frames = []
    px = CELL_PX

    def _cell_text(img, yy, xx, ch, color):
        # 5x7 glyph centered in the 16px cell
        draw_text_at(img, ch, (xx * px + (px - 5) // 2, yy * px + (px - 7) // 2),
                     color)

    for k in range(len(idx)):
        img = _blank(t.rows * px, t.cols * px, COLORS["wall"])
        for yy in range(t.rows):
            for xx in range(t.cols):
                _fill_cell(img, yy, xx, COLORS["floor"])
                code = t.hansen_grid[yy, xx]
                # paint thin wall edges from the 4-bit code (N=1,S=2,W=4,E=8)
                if code & 1:
                    img[yy * px : yy * px + 2, xx * px : (xx + 1) * px] = COLORS["wall"]
                if code & 2:
                    img[(yy + 1) * px - 2 : (yy + 1) * px, xx * px : (xx + 1) * px] = COLORS["wall"]
                if code & 4:
                    img[yy * px : (yy + 1) * px, xx * px : xx * px + 2] = COLORS["wall"]
                if code & 8:
                    img[yy * px : (yy + 1) * px, (xx + 1) * px - 2 : (xx + 1) * px] = COLORS["wall"]
        # landmark letters straight from the map string (R/G/Y/B...)
        for li in range(t.nlocs):
            ly, lx = t.np_locs[li]
            _cell_text(img, ly, lx, str(t.tgrid[ly, lx]), (120, 120, 130))
        dy, dx = t.np_locs[d[k]]
        _dot(img, dy, dx, COLORS["destination"])
        _cell_text(img, dy, dx, "D", (255, 255, 255))
        in_taxi = p[k] == t.nlocs
        _fill_cell(img, r[k], c[k], COLORS["taxi_full" if in_taxi else "taxi"], pad=3)
        if not in_taxi:
            py, pxx = t.np_locs[p[k]]
            _dot(img, py, pxx, COLORS["passenger"])
            _cell_text(img, py, pxx, "P", (255, 255, 255))
        # taxi status glyph last so it stays legible on the taxi cell
        _cell_text(img, r[k], c[k], "F" if in_taxi else "T", (0, 0, 0))
        frames.append(img)
    return tile_images(frames)


# ------------------------------------------------------------------ rooms
def _grid_frame(grid: np.ndarray) -> np.ndarray:
    """Base frame for a rooms-style int grid (-1 = wall, >=0 = room id)."""
    rows, cols = grid.shape
    img = _blank(rows * CELL_PX, cols * CELL_PX, COLORS["wall"])
    nroom = int(grid.max()) + 1 if grid.max() >= 0 else 1
    for yy in range(rows):
        for xx in range(cols):
            v = grid[yy, xx]
            if v >= 0:
                shade = 200 + int(40 * (v / max(nroom, 1)))
                _fill_cell(img, yy, xx, (shade, shade, min(shade + 10, 255)), pad=0)
    return img


def render_rooms(env, state, idx: Optional[Sequence[int]] = None) -> np.ndarray:
    idx = _indices(idx)
    base = _grid_frame(env.grid_np)
    agents = _select(state.agent_yx, idx)
    goals = _select(state.goal_yx, idx)
    frames = []
    for k in range(len(idx)):
        img = base.copy()
        _dot(img, int(goals[k, 0]), int(goals[k, 1]), COLORS["goal"])
        _fill_cell(img, int(agents[k, 0]), int(agents[k, 1]), COLORS["agent"], pad=4)
        frames.append(img)
    return tile_images(frames)


def render_crooms(env, state, idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """Continuous rooms: positions are float coords in grid units."""
    idx = _indices(idx)
    base = _grid_frame(env.grid_np)
    scale = CELL_PX / env.cell_size
    agents = _select(state.agent_yx, idx)
    goals = _select(state.goal_yx, idx)
    rad = max(CELL_PX // 4, 2)
    frames = []
    for k in range(len(idx)):
        img = base.copy()
        for pos, color in ((goals[k], COLORS["goal"]), (agents[k], COLORS["agent"])):
            cy, cx = (float(pos[0]) * scale, float(pos[1]) * scale)
            y0, y1 = int(max(cy - rad, 0)), int(min(cy + rad, img.shape[0]))
            x0, x1 = int(max(cx - rad, 0)), int(min(cx + rad, img.shape[1]))
            img[y0:y1, x0:x1] = color
        frames.append(img)
    return tile_images(frames)


def render_msrooms(env, state, idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """Multistory FourRooms: floors side by side, stairs marked.

    The reference's msrooms render raises NotImplementedError
    (msrooms.py:430-432); this provides the capability.
    """
    from ..envs.msrooms import STAIR_DOWN, STAIR_UP, WALL

    idx = _indices(idx)
    grid = env.grid_np  # [Z, H, W]
    Z, H, W = grid.shape
    agents = _select(state.agent_zyx, idx)
    goals = _select(state.goal_zyx, idx)
    frames = []
    for k in range(len(idx)):
        floors = []
        for z in range(Z):
            img = _blank(H * CELL_PX, W * CELL_PX, COLORS["wall"])
            for yy in range(H):
                for xx in range(W):
                    v = grid[z, yy, xx]
                    if v == WALL:
                        continue
                    _fill_cell(img, yy, xx, COLORS["floor"], pad=0)
                    if v == STAIR_UP:
                        _dot(img, yy, xx, COLORS["stairs_up"])
                    elif v == STAIR_DOWN:
                        _dot(img, yy, xx, COLORS["stairs_down"])
            if goals[k, 0] == z:
                _dot(img, int(goals[k, 1]), int(goals[k, 2]), COLORS["goal"])
            if agents[k, 0] == z:
                _fill_cell(img, int(agents[k, 1]), int(agents[k, 2]), COLORS["agent"], pad=4)
            floors.append(img)
        frames.append(np.concatenate(floors, axis=1))
    return tile_images(frames)


# -------------------------------------------------------------------- car
def render_car(env, state, idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """Car-Flag number line: car, heaven/hell flags, priest window
    (capability of reference car_flag.py:146-278, new minimal layout)."""
    idx = _indices(idx)
    W, H = 320, 48
    lo, hi = -1.2, 1.2

    def to_px(x: float) -> int:
        return int((x - lo) / (hi - lo) * (W - 1))

    pos = _select(state.pos, idx)
    heaven = _select(state.heaven, idx)
    priest = _select(state.priest, idx)
    frames = []
    for k in range(len(idx)):
        img = _blank(H, W, (15, 15, 20))
        img[H // 2 : H // 2 + 2, to_px(-1.1) : to_px(1.1)] = (120, 120, 120)
        # priest window
        img[H // 2 - 2 : H // 2 + 4, to_px(float(priest[k]) - 0.2) : to_px(float(priest[k]) + 0.2)] = COLORS["priest"]
        # heaven / hell flags
        hx = to_px(float(heaven[k]))
        img[H // 4 : 3 * H // 4, hx - 2 : hx + 2] = COLORS["heaven"]
        ex = to_px(-float(heaven[k]))
        img[H // 4 : 3 * H // 4, ex - 2 : ex + 2] = COLORS["hell"]
        cx = to_px(float(pos[k]))
        img[H // 2 - 6 : H // 2 + 6, max(cx - 4, 0) : cx + 4] = COLORS["car"]
        frames.append(img)
    return tile_images(frames)


# ------------------------------------------------------------- tag arenas
def render_tag(env, state, idx=None) -> np.ndarray:
    """TagContinuous arena: cage, visibility ring, agent, target."""
    idx = _indices(idx)
    SCALE, HALF = 24, 5.0
    size = int(2 * HALF * SCALE)

    def to_px(v):
        return int((float(v) + HALF) * SCALE)

    agents = _select(state.agent_xy, idx)
    targets = _select(state.target_xy, idx)
    frames = []
    for k in range(len(idx)):
        img = _blank(size, size, (15, 15, 20))
        c = to_px(-4.5), to_px(4.5)
        img[c[0]:c[1], c[0]:c[0]+2] = COLORS["wall"]
        img[c[0]:c[1], c[1]-2:c[1]] = COLORS["wall"]
        img[c[0]:c[0]+2, c[0]:c[1]] = COLORS["wall"]
        img[c[1]-2:c[1], c[0]:c[1]] = COLORS["wall"]
        ay, ax = to_px(agents[k, 1]), to_px(agents[k, 0])
        ty, tx = to_px(targets[k, 1]), to_px(targets[k, 0])
        img[max(ty-4,0):ty+4, max(tx-4,0):tx+4] = COLORS["goal"]
        img[max(ay-5,0):ay+5, max(ax-5,0):ax+5] = COLORS["agent"]
        frames.append(img)
    return tile_images(frames)


def render_heavenhell(env, state, idx=None) -> np.ndarray:
    """HeavenHellContinuous T-maze: free space, sites, agent."""
    from ..envs.tag_jax import BAR, HH_SITES, STEM

    idx = _indices(idx)
    SCALE = 16
    X0, X1, Y0, Y1 = -9.0, 9.0, -2.5, 9.0
    wpx, hpx = int((X1 - X0) * SCALE), int((Y1 - Y0) * SCALE)

    def to_px(x, y):
        return int((y - Y0) * SCALE), int((x - X0) * SCALE)

    agents = _select(state.agent_xy, idx)
    heaven_right = _select(state.heaven_right, idx)
    frames = []
    for k in range(len(idx)):
        img = _blank(hpx, wpx, COLORS["wall"])
        for (xl, xh, yl, yh) in (STEM, BAR):
            r0, c0 = to_px(xl, yl)
            r1, c1 = to_px(xh, yh)
            img[r0:r1, c0:c1] = COLORS["floor"]
        for i, site in enumerate(HH_SITES):
            r, c = to_px(site[0], site[1])
            right_is_heaven = bool(heaven_right[k])
            color = (
                COLORS["priest"] if i == 2
                else COLORS["heaven"] if (i == 1) == right_is_heaven
                else COLORS["hell"]
            )
            img[max(r-5,0):r+5, max(c-5,0):c+5] = color
        r, c = to_px(agents[k, 0], agents[k, 1])
        img[max(r-4,0):r+4, max(c-4,0):c+4] = COLORS["agent"]
        frames.append(img)
    return tile_images(frames)


# ------------------------------------------------------------ ant physics
def _np_quat_mat(q: np.ndarray) -> np.ndarray:
    """Rotation matrix of a unit quaternion [w,x,y,z] (NumPy)."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _np_fk(model, qpos: np.ndarray):
    """NumPy forward kinematics (mirror of physics.dynamics.fk) so the
    renderer never dispatches to a device."""
    nb = model.nb
    xpos = np.zeros((nb, 3))
    xmat = np.zeros((nb, 3, 3))
    xpos[0] = qpos[0:3]
    q0 = qpos[3:7]
    q0 = q0 / np.linalg.norm(q0)
    xmat[0] = _np_quat_mat(q0)
    for b in range(1, nb):
        p = int(model.parent[b])
        xpos[b] = xpos[p] + xmat[p] @ model.body_pos[b]
        j = int(model.body_jnt[b])
        if j >= 0:
            ax = model.jnt_axis[j]
            ang = float(qpos[int(model.jnt_qpos[j])])
            c, s = math.cos(ang / 2), math.sin(ang / 2)
            R = _np_quat_mat(np.array([c, s * ax[0], s * ax[1], s * ax[2]]))
            xmat[b] = xmat[p] @ R
        else:
            xmat[b] = xmat[p]
    return xpos, xmat


def _draw_seg(img, p0, p1, color, width=2):
    """Rasterize a thick 2-D segment (pixel coords) by dense sampling."""
    n = max(2, int(np.hypot(p1[0] - p0[0], p1[1] - p0[1])) * 2)
    rows, cols = img.shape[:2]
    for t in np.linspace(0.0, 1.0, n):
        r = int(round(p0[0] + t * (p1[0] - p0[0])))
        c = int(round(p0[1] + t * (p1[1] - p0[1])))
        r0, r1 = max(r - width, 0), min(r + width, rows)
        c0, c1 = max(c - width, 0), min(c + width, cols)
        img[r0:r1, c0:c1] = color


def render_ant(env, state, idx=None) -> np.ndarray:
    """Top-down view of the articulated ant POMDPs: walls, leg skeleton
    from forward kinematics, torso, and the task overlay (flee target +
    visibility ring for AntTag; heaven/hell/priest sites for HeavenHell).

    Capability match for the reference's MuJoCo viewer (mocap indicator
    spheres, ``ant_tag.py:141-145``) as a pure host function of fetched
    state."""
    from ..envs.ant_physics import (
        HH_SITES,
        VISIBLE_RADIUS,
        AntHeavenHellPhysics,
        AntTagPhysics,
    )

    idx = _indices(idx)
    model = env.model
    walls = np.asarray(model.walls)
    half_x = float(np.max(np.abs(walls[:, 0]) + walls[:, 3])) + 0.5
    ylo = float(np.min(walls[:, 1] - walls[:, 4])) - 0.5
    yhi = float(np.max(walls[:, 1] + walls[:, 4])) + 0.5
    SCALE = 20
    wpx = int(2 * half_x * SCALE)
    hpx = int((yhi - ylo) * SCALE)

    def to_px(x, y):
        # row = flipped y (image origin top-left), col = x
        return int((yhi - float(y)) * SCALE), int((float(x) + half_x) * SCALE)

    qpos = _select(state.qpos, idx)
    is_tag = isinstance(env, AntTagPhysics)
    targets = _select(state.target_xy, idx) if is_tag else None
    heaven_right = (
        _select(state.heaven_right, idx)
        if isinstance(env, AntHeavenHellPhysics) else None
    )

    frames = []
    for k in range(len(idx)):
        img = _blank(hpx, wpx, (15, 15, 20))
        for (cx, cy, _cz, hx, hy, _hz) in walls:
            r0, c0 = to_px(cx - hx, cy + hy)
            r1, c1 = to_px(cx + hx, cy - hy)
            img[max(r0, 0):r1, max(c0, 0):c1] = COLORS["wall"]
        if heaven_right is not None:
            right = bool(heaven_right[k])
            for i, site in enumerate(HH_SITES):
                color = (
                    COLORS["priest"] if i == 2
                    else COLORS["heaven"] if (i == 1) == right
                    else COLORS["hell"]
                )
                r, c = to_px(site[0], site[1])
                img[max(r - 5, 0):r + 5, max(c - 5, 0):c + 5] = color
        xpos, xmat = _np_fk(model, np.asarray(qpos[k], np.float64))
        if is_tag:
            ar, ac = to_px(xpos[0, 0], xpos[0, 1])
            rad = int(VISIBLE_RADIUS * SCALE)
            yy, xx = np.ogrid[:hpx, :wpx]
            ring = np.abs(
                np.sqrt((yy - ar) ** 2 + (xx - ac) ** 2) - rad
            ) < 1.0
            img[ring] = (60, 60, 90)
            tr, tc = to_px(targets[k, 0], targets[k, 1])
            img[max(tr - 4, 0):tr + 4, max(tc - 4, 0):tc + 4] = COLORS["goal"]
        # leg skeleton: each capsule geom as a world-frame segment
        for g in range(len(model.geom_body)):
            b = int(model.geom_body[g])
            h = float(model.geom_h[g])
            if h == 0.0:
                continue  # torso sphere drawn below
            center = xpos[b] + xmat[b] @ model.geom_pos[g]
            axis_w = xmat[b] @ model.geom_axis[g]
            p0 = center - h * axis_w
            p1 = center + h * axis_w
            _draw_seg(img, to_px(p0[0], p0[1]), to_px(p1[0], p1[1]),
                      (150, 110, 60), width=2)
        ar, ac = to_px(xpos[0, 0], xpos[0, 1])
        tors = int(0.25 * SCALE)
        img[max(ar - tors, 0):ar + tors, max(ac - tors, 0):ac + tors] = (
            COLORS["agent"]
        )
        frames.append(img)
    return tile_images(frames)


_MJ_SCENE_CACHE: dict = {}


def render_ant_scene(env, state, idx=None, width: int = 320,
                     height: int = 240) -> np.ndarray:
    """Full MuJoCo-scene rendering of the ant physics envs — the reference's
    own render path (``gym_po/envs/ant_tag.py:27-75`` renders the MuJoCo
    scene via gymnasium; the mocap spheres at ``:141-145`` exist to be
    seen).  Host-side: drives a headless ``mujoco.Renderer`` (EGL) from
    fetched ``qpos``; the JAX engine simulates the SAME compiled model
    (``envs/mjcf.py``, signature parity ``tests/test_ant_parity.py``), so
    the scene is the true simulator state, not an approximation.

    Mirrors the reference's scene dressing: AntTag moves mocap slot 0 to
    the target and slots 1/2 (visibility ring, tag ring) with the ant;
    AntHeavenHell recolors the left/right area sites by the episode's
    heaven side (``ant_heaven_hell.py:110-118``).

    Requires ``mujoco`` and a GL backend (sets ``MUJOCO_GL=egl`` if unset);
    raises on headless machines without EGL — callers fall back to
    :func:`render_ant` (the top-down schematic, always available)."""
    import os

    os.environ.setdefault("MUJOCO_GL", "egl")
    import mujoco

    from ..envs.ant_physics import AntTagPhysics
    from ..envs.mjcf import ant_heaven_hell_xml, ant_tag_xml

    idx = _indices(idx)
    is_tag = isinstance(env, AntTagPhysics)
    key = ("tag" if is_tag else "hh", width, height)
    if key not in _MJ_SCENE_CACHE:
        xml = ant_tag_xml() if is_tag else ant_heaven_hell_xml()
        m = mujoco.MjModel.from_xml_string(xml)
        _MJ_SCENE_CACHE[key] = (m, mujoco.MjData(m),
                                mujoco.Renderer(m, height, width))
    m, d, renderer = _MJ_SCENE_CACHE[key]

    qpos = np.atleast_2d(_select(state.qpos, idx))
    targets = np.atleast_2d(_select(state.target_xy, idx)) if is_tag else None
    heaven_right = (
        np.atleast_1d(_select(state.heaven_right, idx))
        if not is_tag else None
    )
    cam = mujoco.MjvCamera()
    cam.type = mujoco.mjtCamera.mjCAMERA_FREE
    cam.distance, cam.elevation, cam.azimuth = 9.0, -40.0, 90.0

    frames = []
    for k in range(len(idx)):
        d.qpos[:] = np.asarray(qpos[k], np.float64)
        d.qvel[:] = 0.0
        if is_tag:
            d.mocap_pos[0, :2] = np.asarray(targets[k], np.float64)
            d.mocap_pos[1:3, :2] = d.qpos[:2]  # indicator rings track ant
        else:
            right = bool(heaven_right[k])
            green, red = (0, 1, 0, 0.5), (1, 0, 0, 0.5)
            m.site_rgba[mujoco.mj_name2id(
                m, mujoco.mjtObj.mjOBJ_SITE, "left_area")] = (
                red if right else green)
            m.site_rgba[mujoco.mj_name2id(
                m, mujoco.mjtObj.mjOBJ_SITE, "right_area")] = (
                green if right else red)
        mujoco.mj_forward(m, d)
        cam.lookat[:] = (float(d.qpos[0]), float(d.qpos[1]), 0.5)
        renderer.update_scene(d, camera=cam)
        frames.append(np.asarray(renderer.render(), np.uint8))
    return tile_images(frames)


# --------------------------------------------------------------- dispatch
def render_rocksample(env, state, idx=None) -> np.ndarray:
    """RockSample(n,k) frame: grid, rocks colored by latent quality, rover,
    exit column on the east edge (sample-and-exit task, Smith & Simmons)."""
    idx = _indices(idx)
    pos = _select(state.pos_yx, idx)
    good = _select(state.rock_good, idx)
    frames = []
    for k in range(len(idx)):
        img = _blank(env.rows * CELL_PX, (env.cols + 1) * CELL_PX,
                     COLORS["wall"])
        for yy in range(env.rows):
            for xx in range(env.cols):
                _fill_cell(img, yy, xx, COLORS["floor"], pad=1)
            _fill_cell(img, yy, env.cols, COLORS["goal"], pad=1)  # exit strip
        for j, (ry, rx) in enumerate(np.asarray(env.rock_positions_np)):
            color = COLORS["goal"] if bool(good[k, j]) else COLORS["hell"]
            _dot(img, int(ry), int(rx), color)
        _fill_cell(img, int(pos[k, 0]), int(pos[k, 1]), COLORS["agent"], pad=4)
        frames.append(img)
    return tile_images(frames)


def render(env, state, idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """Dispatch on env type."""
    from ..envs.car_flag import CarFlag
    from ..envs.crooms import CRooms
    from ..envs.msrooms import MultistoryFourRooms
    from ..envs.rooms import Rooms
    from ..envs.tag_jax import HeavenHellContinuous, TagContinuous
    from ..envs.taxi import Taxi

    if isinstance(env, Taxi):
        return render_taxi(env, state, idx)
    if isinstance(env, Rooms):
        return render_rooms(env, state, idx)
    if isinstance(env, CRooms):
        return render_crooms(env, state, idx)
    if isinstance(env, MultistoryFourRooms):
        return render_msrooms(env, state, idx)
    if isinstance(env, CarFlag):
        return render_car(env, state, idx)
    if isinstance(env, TagContinuous):
        return render_tag(env, state, idx)
    if isinstance(env, HeavenHellContinuous):
        return render_heavenhell(env, state, idx)
    from ..envs.rocksample import RockSample

    if isinstance(env, RockSample):
        return render_rocksample(env, state, idx)
    from ..envs.ant_physics import _AntPhysicsBase

    if isinstance(env, _AntPhysicsBase):
        return render_ant(env, state, idx)
    raise TypeError(f"No renderer for {type(env).__name__}")


def human_view(img: np.ndarray, window=None):
    """Blit a frame to a pygame window (reference 'human' mode capability)."""
    import pygame

    if window is None:
        pygame.init()
        window = pygame.display.set_mode((img.shape[1], img.shape[0]))
    sfc = pygame.surfarray.make_surface(img.swapaxes(0, 1))
    window.blit(sfc, (0, 0))
    pygame.display.update()
    return window
