"""MiniGrid as batched tensors: the Empty-* and DoorKey-* families.

Port of ``clip_ppo_tpu/envs/minigrid/core.py`` for the families this slice
runs. The state of all N environments lives in tensors with a leading env
axis, and ``reset``/``step``/``observe`` are batched functions of them, so
the rollout never leaves the device. Semantics mirror MiniGrid exactly, as
the JAX package does: the integer encodings, the 7×7 egocentric view with
the agent at view cell (3, 6) facing up, out-of-bounds cells read as grey
walls, shadow-casting visibility where walls are opaque, the action set,
the goal reward ``1 - 0.9 * step_count / max_steps``, truncation at
``max_steps``, and DoorKey's door-row quirk of sampling with ``width``.

Random draws come from an explicit ``torch.Generator``; the env state holds
no key. The other MiniGrid/BabyAI families come with later slices and are
rejected by :func:`parse_env_id`.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

# --- Integer encodings (MiniGrid-compatible) -------------------------------

UNSEEN, EMPTY, WALL, FLOOR, DOOR, KEY, BALL, BOX, GOAL, LAVA, AGENT = range(11)
RED, GREEN, BLUE, PURPLE, YELLOW, GREY = range(6)
OPEN, CLOSED, LOCKED = range(3)

IDX_TO_OBJECT = {
    UNSEEN: "unseen", EMPTY: "empty", WALL: "wall", FLOOR: "floor",
    DOOR: "door", KEY: "key", BALL: "ball", BOX: "box", GOAL: "goal",
    LAVA: "lava", AGENT: "agent",
}

# dir 0=right(+x), 1=down(+y), 2=left, 3=up
DIR_TO_VEC = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], dtype=np.int64)
DIR_NAMES = ("right", "down", "left", "up")

VIEW_SIZE = 7
_AGENT_VIEW_POS = (VIEW_SIZE // 2, VIEW_SIZE - 1)  # (3, 6)

A_LEFT, A_RIGHT, A_FORWARD, A_PICKUP, A_DROP, A_TOGGLE, A_DONE = range(7)
NUM_ACTIONS = 7


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Static environment configuration."""

    kind: str  # "empty" | "doorkey"
    width: int
    height: int
    max_steps: int
    see_through_walls: bool
    random_start: bool = False  # Empty-Random variants
    num_actions: int = NUM_ACTIONS


@dataclasses.dataclass
class EnvState:
    """Dynamic state of N environments (leading axis = env)."""

    grid: torch.Tensor        # [N, W, H, 3] int8: (object, color, state) per cell
    agent_pos: torch.Tensor   # [N, 2] int64 (x, y)
    agent_dir: torch.Tensor   # [N] int64
    carrying: torch.Tensor    # [N, 3] int8; object == 0 → nothing
    step_count: torch.Tensor  # [N] int32


def parse_env_id(env_id: str) -> EnvParams:
    """Map a MiniGrid env id to EnvParams (Empty[-Random]-NxN, DoorKey-NxN)."""
    m = re.match(r"MiniGrid-(Empty|DoorKey)(-Random)?-(\d+)x(\d+)(-v\d+)?$", env_id)
    if not m:
        raise ValueError(
            f"unsupported MiniGrid env id: {env_id!r}. This slice of the port "
            "runs MiniGrid-Empty[-Random]-NxN and MiniGrid-DoorKey-NxN; the "
            "other MiniGrid/BabyAI families come with a later slice."
        )
    kind = m.group(1).lower()
    size = int(m.group(3))
    if size != int(m.group(4)):
        raise ValueError("only square grids are supported")
    if kind == "empty":
        # EmptyEnv: max_steps = 4 * size**2, see_through_walls=True.
        return EnvParams("empty", size, size, 4 * size * size, True, m.group(2) is not None)
    # DoorKeyEnv: max_steps = 10 * size**2, see_through_walls=False.
    return EnvParams("doorkey", size, size, 10 * size * size, False)


# ---------------------------------------------------------------------------
# Reset
# ---------------------------------------------------------------------------


def _base_grid(params: EnvParams, n: int, device) -> torch.Tensor:
    """[N, W, H, 3] bordered empty grids with the goal in the bottom-right
    interior cell."""
    w, h = params.width, params.height
    grid = np.zeros((w, h, 3), dtype=np.int8)
    grid[..., 0] = EMPTY
    grid[0, :, :] = [WALL, GREY, 0]
    grid[w - 1, :, :] = [WALL, GREY, 0]
    grid[:, 0, :] = [WALL, GREY, 0]
    grid[:, h - 1, :] = [WALL, GREY, 0]
    grid[w - 2, h - 2, :] = [GOAL, GREEN, 0]
    return torch.as_tensor(grid, device=device).expand(n, w, h, 3).clone()


def _sample_free_cell(free: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One uniform cell among ``free`` [N, W, H] per env → [N, 2] (x, y)."""
    n, _, h = free.shape
    idx = torch.multinomial(free.reshape(n, -1).float(), 1, generator=gen)[:, 0]
    return torch.stack([idx // h, idx % h], dim=-1)


def _randint(lo: int, hi: int, n: int, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randint(lo, hi, (n,), generator=gen, device=device)


def _reset_empty(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    grid = _base_grid(params, n, device)
    if params.random_start:
        pos = _sample_free_cell(grid[..., 0] == EMPTY, gen)
        agent_dir = _randint(0, 4, n, gen, device)
    else:
        pos = torch.tensor([[1, 1]], device=device).expand(n, 2).clone()
        agent_dir = torch.zeros(n, dtype=torch.int64, device=device)
    return EnvState(grid, pos, agent_dir, torch.zeros((n, 3), dtype=torch.int8, device=device),
                    torch.zeros(n, dtype=torch.int32, device=device))


def _reset_doorkey(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    w, h = params.width, params.height
    grid = _base_grid(params, n, device)
    xs = torch.arange(w, device=device).reshape(1, w, 1)
    ys = torch.arange(h, device=device).reshape(1, 1, h)

    # Splitting wall column: rand in [2, width-3].
    split = _randint(2, w - 2, n, gen, device).reshape(n, 1, 1)
    wall = torch.tensor([WALL, GREY, 0], dtype=torch.int8, device=device)
    grid = torch.where((xs == split)[..., None], wall, grid)

    # Agent: uniform over empty cells strictly left of the wall.
    agent_pos = _sample_free_cell((grid[..., 0] == EMPTY) & (xs < split), gen)
    agent_dir = _randint(0, 4, n, gen, device)

    # Locked yellow door in the wall; row sampled in [1, width-3]
    # (MiniGrid's DoorKey uses `width` here — replicated for parity).
    door_y = _randint(1, w - 2, n, gen, device)
    env = torch.arange(n, device=device)
    grid[env, split.reshape(n), door_y] = torch.tensor([DOOR, YELLOW, LOCKED], dtype=torch.int8,
                                                        device=device)

    # Yellow key: empty cell left of the wall, not the agent's cell.
    on_agent = (xs == agent_pos[:, 0].reshape(n, 1, 1)) & (ys == agent_pos[:, 1].reshape(n, 1, 1))
    key_pos = _sample_free_cell((grid[..., 0] == EMPTY) & (xs < split) & ~on_agent, gen)
    grid[env, key_pos[:, 0], key_pos[:, 1]] = torch.tensor([KEY, YELLOW, 0], dtype=torch.int8,
                                                           device=device)
    return EnvState(grid, agent_pos, agent_dir, torch.zeros((n, 3), dtype=torch.int8, device=device),
                    torch.zeros(n, dtype=torch.int32, device=device))


def reset(params: EnvParams, n: int, gen: torch.Generator, device) -> EnvState:
    """Fresh states for ``n`` environments."""
    if params.kind == "empty":
        return _reset_empty(params, n, gen, device)
    if params.kind == "doorkey":
        return _reset_doorkey(params, n, gen, device)
    raise ValueError(params.kind)


def select(mask: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per env: ``a`` where ``mask`` [N] is true, else ``b``."""
    def pick(x, y):
        return torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 1)), x, y)

    return EnvState(*(pick(getattr(a, f.name), getattr(b, f.name))
                      for f in dataclasses.fields(EnvState)))


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------


def _can_overlap(cell: torch.Tensor) -> torch.Tensor:
    obj, state = cell[..., 0], cell[..., 2]
    return ((obj == EMPTY) | (obj == FLOOR) | (obj == GOAL) | (obj == LAVA)
            | ((obj == DOOR) & (state == OPEN)))


def step(params: EnvParams, state: EnvState, action: torch.Tensor):
    """One transition of every env. Returns (state, reward f32 [N],
    terminated bool [N], truncated bool [N])."""
    device = state.grid.device
    n = state.grid.shape[0]
    env = torch.arange(n, device=device)
    action = action.long()
    step_count = state.step_count + 1

    dir_vec = torch.as_tensor(DIR_TO_VEC, device=device)
    agent_dir = state.agent_dir
    fwd = state.agent_pos + dir_vec[agent_dir]
    fx = fwd[:, 0].clamp(0, params.width - 1)
    fy = fwd[:, 1].clamp(0, params.height - 1)
    fwd_cell = state.grid[env, fx, fy]                  # [N, 3] int8
    fobj, fcol, fstate = fwd_cell[:, 0], fwd_cell[:, 1], fwd_cell[:, 2]

    # -- turn
    new_dir = torch.where(action == A_LEFT, (agent_dir - 1) % 4,
                          torch.where(action == A_RIGHT, (agent_dir + 1) % 4, agent_dir))

    # -- forward
    moves = (action == A_FORWARD) & _can_overlap(fwd_cell)
    new_pos = torch.where(moves[:, None], fwd, state.agent_pos)
    reached_goal = (action == A_FORWARD) & (fobj == GOAL)
    hit_lava = (action == A_FORWARD) & (fobj == LAVA)
    terminated = reached_goal | hit_lava
    time_reward = 1.0 - 0.9 * (step_count.float() / params.max_steps)
    reward = torch.where(reached_goal, time_reward, torch.zeros_like(time_reward))

    # -- pickup / drop
    carrying_none = state.carrying[:, 0] == 0
    can_pickup = (fobj == KEY) | (fobj == BALL) | (fobj == BOX)
    does_pickup = (action == A_PICKUP) & can_pickup & carrying_none
    does_drop = (action == A_DROP) & (fobj == EMPTY) & ~carrying_none
    # -- toggle: doors open/close/unlock; a box is replaced by its contents
    # (a hidden key is 1 + key_color in the box's state channel)
    is_door = fobj == DOOR
    has_matching_key = (state.carrying[:, 0] == KEY) & (state.carrying[:, 1] == fcol)
    unlocks = is_door & (fstate == LOCKED) & has_matching_key
    opens = is_door & (fstate == CLOSED)
    closes = is_door & (fstate == OPEN)
    new_door_state = torch.where(
        unlocks | opens, torch.full_like(fstate, OPEN),
        torch.where(closes, torch.full_like(fstate, CLOSED), fstate))
    does_toggle = (action == A_TOGGLE) & is_door
    does_toggle_box = (action == A_TOGGLE) & (fobj == BOX)

    empty_cell = torch.zeros_like(fwd_cell)
    empty_cell[:, 0] = EMPTY
    toggled_cell = torch.stack([fobj, fcol, new_door_state], dim=-1)
    key_cell = torch.stack([torch.full_like(fobj, KEY), fstate - 1, torch.zeros_like(fobj)], dim=-1)
    box_contents = torch.where((fstate > 0)[:, None], key_cell, empty_cell)
    new_fwd_cell = torch.where(
        does_pickup[:, None], empty_cell,
        torch.where(does_drop[:, None], state.carrying,
                    torch.where(does_toggle[:, None], toggled_cell,
                                torch.where(does_toggle_box[:, None], box_contents, fwd_cell))))
    grid = state.grid.clone()
    grid[env, fx, fy] = new_fwd_cell

    carrying = torch.where(does_pickup[:, None], fwd_cell,
                           torch.where(does_drop[:, None], torch.zeros_like(fwd_cell),
                                       state.carrying))
    truncated = step_count >= params.max_steps
    new_state = EnvState(grid, new_pos, new_dir, carrying, step_count)
    return new_state, reward, terminated, truncated


# ---------------------------------------------------------------------------
# Observation (7×7×3 egocentric partial view)
# ---------------------------------------------------------------------------


def _process_vis(view: torch.Tensor) -> torch.Tensor:
    """MiniGrid's shadow-casting visibility over the rotated [N, 7, 7] view:
    a cell lets light through unless it is a wall or a non-open door."""
    obj, st = view[..., 0], view[..., 2]
    clear = ~((obj == WALL) | ((obj == DOOR) & (st != OPEN)))
    mask = torch.zeros(obj.shape, dtype=torch.bool, device=view.device)
    mask[:, _AGENT_VIEW_POS[0], _AGENT_VIEW_POS[1]] = True
    for j in reversed(range(VIEW_SIZE)):
        for i in range(VIEW_SIZE - 1):
            vis = mask[:, i, j] & clear[:, i, j]
            mask[:, i + 1, j] |= vis
            if j > 0:
                mask[:, i + 1, j - 1] |= vis
                mask[:, i, j - 1] |= vis
        for i in reversed(range(1, VIEW_SIZE)):
            vis = mask[:, i, j] & clear[:, i, j]
            mask[:, i - 1, j] |= vis
            if j > 0:
                mask[:, i - 1, j - 1] |= vis
                mask[:, i, j - 1] |= vis
    return mask


def observe(params: EnvParams, state: EnvState) -> torch.Tensor:
    """Egocentric ``[N, 7, 7, 3]`` uint8 observations, axis 1 = view x
    (MiniGrid ``gen_obs()['image']`` through ImgObsWrapper)."""
    device = state.grid.device
    n = state.grid.shape[0]
    dir_vec = torch.as_tensor(DIR_TO_VEC, device=device)
    f = dir_vec[state.agent_dir]                 # [N, 2] forward
    r = dir_vec[(state.agent_dir + 1) % 4]       # [N, 2] right
    vx = torch.arange(VIEW_SIZE, device=device).reshape(1, VIEW_SIZE, 1)
    vy = torch.arange(VIEW_SIZE, device=device).reshape(1, 1, VIEW_SIZE)
    steps_fwd = _AGENT_VIEW_POS[1] - vy
    steps_right = vx - _AGENT_VIEW_POS[0]
    wx = state.agent_pos[:, 0, None, None] + f[:, 0, None, None] * steps_fwd + r[:, 0, None, None] * steps_right
    wy = state.agent_pos[:, 1, None, None] + f[:, 1, None, None] * steps_fwd + r[:, 1, None, None] * steps_right
    in_bounds = (wx >= 0) & (wx < params.width) & (wy >= 0) & (wy < params.height)
    env = torch.arange(n, device=device).reshape(n, 1, 1)
    cells = state.grid[env, wx.clamp(0, params.width - 1), wy.clamp(0, params.height - 1)]
    wall_cell = torch.tensor([WALL, GREY, 0], dtype=torch.int8, device=device)
    view = torch.where(in_bounds[..., None], cells, wall_cell)
    if not params.see_through_walls:
        vis = _process_vis(view)
        view = torch.where(vis[..., None], view, torch.zeros_like(view))
    # Agent cell shows the carried object (or empty if hands are free).
    empty = torch.tensor([EMPTY, 0, 0], dtype=torch.int8, device=device)
    carried = torch.where((state.carrying[:, 0] != 0)[:, None], state.carrying, empty)
    view[:, _AGENT_VIEW_POS[0], _AGENT_VIEW_POS[1]] = carried
    return view.to(torch.uint8)


# RGB palette matching MiniGrid's COLORS map (minigrid rendering).
_COLOR_RGB = np.array(
    [
        [255, 0, 0],     # red
        [0, 255, 0],     # green
        [0, 0, 255],     # blue
        [112, 39, 195],  # purple
        [255, 255, 0],   # yellow
        [100, 100, 100], # grey
    ],
    dtype=np.uint8,
)


def render_rgb(params: EnvParams, grid: torch.Tensor, agent_pos: torch.Tensor,
               agent_dir: torch.Tensor, tile_px: int = 6) -> torch.Tensor:
    """Top-down RGB render of ONE env's full grid ([W, H, 3] grid, [2] pos,
    [] dir) → [H·tile, W·tile, 3] uint8: colored tiles per object, grid
    lines, and a red directional agent marker."""
    device = grid.device
    w, h = params.width, params.height
    px = torch.arange(w * tile_px, device=device).reshape(1, -1)
    py = torch.arange(h * tile_px, device=device).reshape(-1, 1)
    cx, cy = px // tile_px, py // tile_px
    ix, iy = px % tile_px, py % tile_px
    obj = grid[..., 0][cx, cy]
    col = grid[..., 1][cx, cy]
    st = grid[..., 2][cx, cy]

    colors = torch.as_tensor(_COLOR_RGB, device=device)
    base = colors[col.long().clamp(0, 5)]
    img = torch.where((obj == WALL)[..., None], base, torch.zeros_like(base))
    img = torch.where((obj == GOAL)[..., None], colors[GREEN], img)
    img = torch.where((obj == LAVA)[..., None], torch.tensor([255, 128, 0], dtype=torch.uint8,
                                                             device=device), img)
    inset = (ix >= 1) & (ix < tile_px - 1) & (iy >= 1) & (iy < tile_px - 1)
    small = (obj == KEY) | (obj == BALL) | (obj == BOX)
    img = torch.where((small & inset)[..., None], base, img)
    door = obj == DOOR
    frame_px = (ix == 0) | (ix == tile_px - 1) | (iy == 0) | (iy == tile_px - 1)
    img = torch.where((door & (st != OPEN))[..., None], base, img)
    img = torch.where((door & (st == OPEN) & frame_px)[..., None], base, img)

    on_agent = (cx == agent_pos[0]) & (cy == agent_pos[1])
    t = tile_px
    tris = torch.stack([
        ix >= (2 * iy - (t - 1)).abs(),            # right
        iy >= (2 * ix - (t - 1)).abs(),            # down
        (t - 1 - ix) >= (2 * iy - (t - 1)).abs(),  # left
        (t - 1 - iy) >= (2 * ix - (t - 1)).abs(),  # up
    ])
    tri = tris[agent_dir]
    img = torch.where((on_agent & tri)[..., None], colors[RED], img)
    line = (ix == 0) | (iy == 0)
    img = torch.where((line & (obj == EMPTY))[..., None],
                      torch.tensor([40, 40, 40], dtype=torch.uint8, device=device), img)
    return img.to(torch.uint8)


def _objects_suffix(grid: np.ndarray, max_objects: int = 3) -> str:
    """", objects: ..." suffix from one grid's first non-empty cells."""
    objs = []
    w, h = grid.shape[:2]
    for x in range(w):
        for y in range(h):
            o = int(grid[x, y, 0])
            if o not in (UNSEEN, EMPTY):
                objs.append(f"{IDX_TO_OBJECT[o]} at ({x},{y})")
                if len(objs) >= max_objects:
                    return f", objects: {', '.join(objs)}"
    return f", objects: {', '.join(objs)}" if objs else ""
