"""Atari-family games as batched tensors: Breakout and Pong.

Port of ``clip_ppo_tpu/envs/atari/core.py``. The games are native
reimplementations, not emulator ports: dynamics run in ALE screen
coordinates (160×210), so the state-based text descriptions keep the
reference's RAM-derived coordinate semantics (`clip_ppo_atari.py:302-442`),
and the renderer draws the 84×84 grayscale frame the reference's wrapper
stack produces. One agent step integrates 4 physics frames (frame-skip 4),
life loss surfaces as ``terminated`` (EpisodicLife), the serve launches by
itself after a reset or a lost life (FireReset), and rewards are raw scores
(the vector env clips them).

The state of all N games lives in tensors with a leading env axis, and
``reset``/``step``/``render`` are batched functions of it, where the JAX
package vmaps per-game functions. The float32 physics keeps the JAX
package's order of operations, so frames and transitions agree exactly.
Divisions by a constant divide by a 0-d tensor on the state's device: CUDA
turns a division by a Python scalar into a product with its reciprocal,
which can differ from the quotient in the last bit.

The state holds no random key. The draws a step makes (Breakout's serve x
and direction, Pong's serve direction and vertical speed, Seaquest's
spawns) are an explicit optional input of :func:`step`, drawn from a
``torch.Generator`` when not given; resets draw nothing.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import NamedTuple, Optional

import numpy as np
import torch

# ALE screen coordinates.
SCREEN_W, SCREEN_H = 160, 210
OBS_SIZE = 84
SUBSTEPS = 4  # physics frames per agent step (frame-skip 4)

# --- Breakout constants (160×210 screen) -----------------------------------

BK_WALL_TOP = 32
BK_SIDE = 8
BK_BRICK_Y0 = 57
BK_BRICK_H = 6
BK_BRICK_W = 8
BK_ROWS, BK_COLS = 6, 18
BK_PADDLE_Y = 189
BK_PADDLE_H = 4
BK_PADDLE_W = 16
BK_PADDLE_SPEED = 3  # px per physics frame
BK_BALL_W, BK_BALL_H = 2, 4
BK_DEATH_Y = 200
BK_LIVES = 5
# Row point values, top→bottom (red,red,orange/yellow...): 7,7,4,4,1,1.
BK_ROW_VALUES = np.array([7, 7, 4, 4, 1, 1], dtype=np.int32)
# Grayscale lumas of the classic row colors (red,orange,yellow,green,aqua,blue).
BK_ROW_GRAY = np.array([106, 122, 156, 140, 148, 92], dtype=np.uint8)
BK_WALL_GRAY = 142
BK_PADDLE_GRAY = 110  # red paddle/ball luma
BK_SERVE_X = (BK_SIDE + 10.0, SCREEN_W - BK_SIDE - 10.0)  # uniform serve x range
NUM_ACTIONS_BREAKOUT = 4  # NOOP, FIRE, RIGHT, LEFT

# --- Pong constants ---------------------------------------------------------

PG_TOP = 34
PG_BOTTOM = 194
PG_PADDLE_H = 16
PG_PADDLE_W = 4
PG_PLAYER_X = 140  # right paddle (the agent)
PG_ENEMY_X = 16
PG_PADDLE_SPEED = 2  # px per physics frame
PG_ENEMY_SPEED = 1   # slower tracker → beatable
PG_BALL_W, PG_BALL_H = 2, 4
PG_WIN_SCORE = 21
PG_BG_GRAY = 87      # Pong's dark background luma
PG_FG_GRAY = 236
PG_SERVE_DY = (-1.5, 1.5)  # uniform serve vertical speed range
NUM_ACTIONS_PONG = 6  # NOOP, FIRE, RIGHT(up), LEFT(down), RIGHTFIRE, LEFTFIRE


@dataclasses.dataclass(frozen=True)
class AtariParams:
    """Static configuration."""

    game: str  # "breakout" | "pong" | "seaquest"

    @property
    def num_actions(self) -> int:
        if self.game == "breakout":
            return NUM_ACTIONS_BREAKOUT
        if self.game == "pong":
            return NUM_ACTIONS_PONG
        from clip_ppo_tpu_torch.envs.atari.seaquest import NUM_ACTIONS_SEAQUEST

        return NUM_ACTIONS_SEAQUEST


def parse_atari_id(env_id: str) -> AtariParams:
    """Map ALE env-id strings (``ALE/Breakout-v5``, ``BreakoutNoFrameskip-v4``,
    ``ALE/Pong-v5``…) to AtariParams."""
    m = re.match(r"(ALE/)?(Breakout|Pong|Seaquest)(NoFrameskip)?(-v\d+)?$", env_id)
    if not m:
        raise ValueError(
            f"unsupported Atari env id: {env_id!r} (the native backend implements "
            "Breakout, Pong and Seaquest, the reference grid's games; the host/ALE "
            "backend for others comes with a later slice of the port)"
        )
    return AtariParams(m.group(2).lower())


@dataclasses.dataclass
class BreakoutState:
    """N Breakout games (leading axis = env)."""

    paddle_x: torch.Tensor      # [N] f32, left edge
    ball_x: torch.Tensor        # [N] f32
    ball_y: torch.Tensor        # [N] f32
    ball_vx: torch.Tensor       # [N] f32 px/frame
    ball_vy: torch.Tensor       # [N] f32 px/frame
    bricks: torch.Tensor        # [N, 6, 18] bool
    lives: torch.Tensor         # [N] i32
    score: torch.Tensor         # [N] i32
    in_play: torch.Tensor       # [N] bool (ball launched)
    auto_fire: torch.Tensor     # [N] bool (serve on next step — FireReset)
    paddle_hits: torch.Tensor   # [N] i32 (speed-up counter)
    step_count: torch.Tensor    # [N] i32


@dataclasses.dataclass
class PongState:
    """N Pong games (leading axis = env)."""

    player_y: torch.Tensor      # [N] f32 paddle top (right/agent)
    enemy_y: torch.Tensor       # [N] f32 paddle top (left/computer)
    ball_x: torch.Tensor        # [N] f32
    ball_y: torch.Tensor        # [N] f32
    ball_vx: torch.Tensor       # [N] f32 px/frame
    ball_vy: torch.Tensor       # [N] f32 px/frame
    player_score: torch.Tensor  # [N] i32
    enemy_score: torch.Tensor   # [N] i32
    serve_wait: torch.Tensor    # [N] i32 frames until serve
    step_count: torch.Tensor    # [N] i32


class BreakoutDraws(NamedTuple):
    """One agent step's draws: the serve's x ([N] f32 in ``BK_SERVE_X``) and
    direction ([N] bool, right); used where the step serves."""

    serve_x: torch.Tensor
    serve_right: torch.Tensor


class PongDraws(NamedTuple):
    """One agent step's draws: the serve's direction ([N] bool, toward the
    player) and vertical speed ([N] f32 in ``PG_SERVE_DY``)."""

    serve_right: torch.Tensor
    serve_dy: torch.Tensor


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _const(value: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def fdiv(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d`` in float32, the quotient correctly rounded on every device."""
    return a / _const(float(d), a.device)


@functools.lru_cache(maxsize=None)
def screen_grid(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(X [1, 1, 84], Y [1, 84, 1]): the screen x and y at each output pixel's
    center, ``(arange + 0.5) / (84 / 160)`` and ``/ (84 / 210)`` in float32
    (computed by numpy, whose float32 division is correctly rounded as
    XLA's is)."""
    px = np.arange(OBS_SIZE, dtype=np.float32) + np.float32(0.5)
    xs = px / np.float32(OBS_SIZE / SCREEN_W)
    ys = px / np.float32(OBS_SIZE / SCREEN_H)
    return (torch.as_tensor(xs, device=device).reshape(1, 1, OBS_SIZE),
            torch.as_tensor(ys, device=device).reshape(1, OBS_SIZE, 1))


def _col(t: torch.Tensor) -> torch.Tensor:
    """[N] → [N, 1, 1], to broadcast against the screen grid."""
    return t.reshape(-1, 1, 1)


def select(mask: torch.Tensor, a, b):
    """Per env: state ``a`` where ``mask`` [N] is true, else ``b`` (same class)."""
    def pick(x, y):
        return torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 1)), x, y)

    return type(a)(**{f.name: pick(getattr(a, f.name), getattr(b, f.name))
                      for f in dataclasses.fields(a)})


def _full(n: int, value, dtype, device) -> torch.Tensor:
    return torch.full((n,), value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Breakout
# ---------------------------------------------------------------------------


def breakout_reset(n: int, device) -> BreakoutState:
    f32, i32 = torch.float32, torch.int32
    return BreakoutState(
        paddle_x=_full(n, (SCREEN_W - BK_PADDLE_W) / 2, f32, device),
        ball_x=_full(n, SCREEN_W / 2, f32, device),
        ball_y=_full(n, BK_PADDLE_Y - 40, f32, device),
        ball_vx=_full(n, 0.0, f32, device),
        ball_vy=_full(n, 0.0, f32, device),
        bricks=torch.ones((n, BK_ROWS, BK_COLS), dtype=torch.bool, device=device),
        lives=_full(n, BK_LIVES, i32, device),
        score=_full(n, 0, i32, device),
        in_play=_full(n, False, torch.bool, device),
        auto_fire=_full(n, True, torch.bool, device),  # FireReset fires on reset
        paddle_hits=_full(n, 0, i32, device),
        step_count=_full(n, 0, i32, device),
    )


def breakout_draw(n: int, gen: torch.Generator, device) -> BreakoutDraws:
    lo, hi = BK_SERVE_X
    x = torch.rand(n, generator=gen, device=device) * (hi - lo) + lo
    return BreakoutDraws(x, torch.rand(n, generator=gen, device=device) < 0.5)


@functools.lru_cache(maxsize=None)
def _bk_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(BK_ROW_VALUES, device=device),
            torch.as_tensor(BK_ROW_GRAY, device=device))


def _bk_substep(s: BreakoutState) -> tuple[BreakoutState, torch.Tensor, torch.Tensor]:
    """One physics frame. Returns (state, reward f32 [N], life_lost [N])."""
    x = s.ball_x + s.ball_vx
    y = s.ball_y + s.ball_vy
    vx, vy = s.ball_vx, s.ball_vy

    # Side walls.
    hit_left = x < BK_SIDE
    hit_right = x > SCREEN_W - BK_SIDE - BK_BALL_W
    vx = torch.where(hit_left | hit_right, -vx, vx)
    x = x.clamp(BK_SIDE, SCREEN_W - BK_SIDE - BK_BALL_W)
    # Ceiling.
    hit_top = y < BK_WALL_TOP
    vy = torch.where(hit_top, vy.abs(), vy)
    y = y.clamp_min(BK_WALL_TOP)

    # Bricks: test the cell under the ball center.
    cx = x + BK_BALL_W / 2
    cy = y + BK_BALL_H / 2
    row = torch.floor(fdiv(cy - BK_BRICK_Y0, BK_BRICK_H)).long()
    col = torch.floor(fdiv(cx - BK_SIDE, BK_BRICK_W)).long()
    in_wall = (row >= 0) & (row < BK_ROWS) & (col >= 0) & (col < BK_COLS)
    rc = row.clamp(0, BK_ROWS - 1)
    cc = col.clamp(0, BK_COLS - 1)
    env = torch.arange(x.shape[0], device=x.device)
    cell = s.bricks[env, rc, cc]
    brick_alive = cell & in_wall & s.in_play
    bricks = s.bricks.clone()
    bricks[env, rc, cc] = cell & ~brick_alive
    values, _ = _bk_tables(x.device)
    reward = torch.where(brick_alive, values[rc], 0)
    vy = torch.where(brick_alive, -vy, vy)

    # Paddle.
    ball_bottom = y + BK_BALL_H
    over_paddle = (cx >= s.paddle_x) & (cx < s.paddle_x + BK_PADDLE_W)
    hit_paddle = (
        s.in_play & (vy > 0) & over_paddle
        & (ball_bottom >= BK_PADDLE_Y) & (ball_bottom < BK_PADDLE_Y + BK_PADDLE_H + 2)
    )
    # Bounce angle from hit offset (classic Breakout control).
    offset = cx - (s.paddle_x + BK_PADDLE_W / 2)
    new_vx = torch.where(offset.abs() < 4.0, torch.sign(offset + 1e-3) * 1.0,
                         torch.sign(offset) * 2.0)
    paddle_hits = s.paddle_hits + hit_paddle.int()
    speed = torch.where(paddle_hits >= 4, 2.0, 1.0)
    vx = torch.where(hit_paddle, new_vx, vx)
    vy = torch.where(hit_paddle, -speed, vy)
    y = torch.where(hit_paddle, float(BK_PADDLE_Y - BK_BALL_H), y)

    # Life loss.
    lost = s.in_play & (y >= BK_DEATH_Y)
    new_s = dataclasses.replace(
        s,
        ball_x=x, ball_y=y, ball_vx=vx, ball_vy=vy,
        bricks=bricks, lives=s.lives - lost.int(), score=s.score + reward,
        paddle_hits=paddle_hits,
        in_play=s.in_play & ~lost,
        auto_fire=s.auto_fire | lost,  # EpisodicLife+FireReset re-serve
    )
    return new_s, reward.float(), lost


def breakout_step(s: BreakoutState, action: torch.Tensor, draws: BreakoutDraws):
    """One agent step (4 physics frames). Returns (state, raw_reward,
    episodic_terminated, game_over)."""
    action = action.int()
    s = dataclasses.replace(s, step_count=s.step_count + 1)

    # Paddle motion (RIGHT=2 → +x, LEFT=3 → -x), applied per agent step.
    step = BK_PADDLE_SPEED * SUBSTEPS
    dx = torch.where(action == 2, step, torch.where(action == 3, -step, 0))
    paddle_x = (s.paddle_x + dx).clamp(BK_SIDE, SCREEN_W - BK_SIDE - BK_PADDLE_W)

    # Serve on FIRE or auto-fire (FireReset semantics).
    want_fire = (action == 1) | s.auto_fire
    do_launch = want_fire & ~s.in_play & (s.lives > 0)
    s = dataclasses.replace(
        s,
        paddle_x=paddle_x,
        ball_x=torch.where(do_launch, draws.serve_x, s.ball_x),
        ball_y=torch.where(do_launch, float(BK_BRICK_Y0 + BK_ROWS * BK_BRICK_H + 8), s.ball_y),
        ball_vx=torch.where(do_launch, torch.where(draws.serve_right, 1.0, -1.0), s.ball_vx),
        ball_vy=torch.where(do_launch, 1.0, s.ball_vy),
        in_play=s.in_play | do_launch,
        auto_fire=s.auto_fire & ~do_launch,
    )

    reward = torch.zeros_like(s.ball_x)
    life_lost = torch.zeros_like(s.in_play)
    for _ in range(SUBSTEPS):
        s, r, lost = _bk_substep(s)
        reward = reward + r
        life_lost = life_lost | lost

    # Second wall: respawn bricks once cleared (real-game behavior).
    cleared = ~s.bricks.flatten(1).any(-1)
    s = dataclasses.replace(s, bricks=s.bricks | cleared.reshape(-1, 1, 1))

    game_over = s.lives <= 0
    return s, reward, life_lost | game_over, game_over


@functools.lru_cache(maxsize=None)
def _bk_static(device: torch.device):
    """The parts of Breakout's frame that depend on the grid alone: the
    walls, and each pixel's brick row and column and whether it lies in
    the wall of bricks."""
    X, Y = screen_grid(device)
    wall = (X < BK_SIDE) | (X >= SCREEN_W - BK_SIDE) | ((Y >= 17) & (Y < BK_WALL_TOP))
    row = torch.floor(fdiv(Y - BK_BRICK_Y0, BK_BRICK_H)).long()[0]   # [84, 1]
    col = torch.floor(fdiv(X - BK_SIDE, BK_BRICK_W)).long()[0]      # [1, 84]
    in_wall = (row >= 0) & (row < BK_ROWS) & (col >= 0) & (col < BK_COLS)
    rc, cc = row.clamp(0, BK_ROWS - 1), col.clamp(0, BK_COLS - 1)
    _, gray = _bk_tables(device)
    return wall, rc, cc, in_wall, gray[rc]


def breakout_render(s: BreakoutState) -> torch.Tensor:
    """[N, 84, 84] grayscale uint8 frames (WarpFrame-equivalent output)."""
    device = s.ball_x.device
    X, Y = screen_grid(device)
    wall, rc, cc, in_wall, row_gray = _bk_static(device)
    n = s.ball_x.shape[0]
    img = torch.zeros((n, OBS_SIZE, OBS_SIZE), dtype=torch.uint8, device=device)
    img = torch.where(wall, BK_WALL_GRAY, img)
    alive = s.bricks[:, rc, cc] & in_wall
    img = torch.where(alive, row_gray, img)
    px = _col(s.paddle_x)
    pad = (X >= px) & (X < px + BK_PADDLE_W) & (Y >= BK_PADDLE_Y) & (Y < BK_PADDLE_Y + BK_PADDLE_H)
    img = torch.where(pad, BK_PADDLE_GRAY, img)
    bx, by = _col(s.ball_x), _col(s.ball_y)
    ball = (_col(s.in_play) & (X >= bx) & (X < bx + BK_BALL_W)
            & (Y >= by) & (Y < by + BK_BALL_H))
    return torch.where(ball, BK_PADDLE_GRAY + 60, img)


# ---------------------------------------------------------------------------
# Pong
# ---------------------------------------------------------------------------


def pong_reset(n: int, device) -> PongState:
    f32, i32 = torch.float32, torch.int32
    mid = (PG_TOP + PG_BOTTOM - PG_PADDLE_H) / 2
    return PongState(
        player_y=_full(n, mid, f32, device),
        enemy_y=_full(n, mid, f32, device),
        ball_x=_full(n, SCREEN_W / 2, f32, device),
        ball_y=_full(n, (PG_TOP + PG_BOTTOM) / 2, f32, device),
        ball_vx=_full(n, 0.0, f32, device),
        ball_vy=_full(n, 0.0, f32, device),
        player_score=_full(n, 0, i32, device),
        enemy_score=_full(n, 0, i32, device),
        serve_wait=_full(n, 8, i32, device),  # brief pause before first serve
        step_count=_full(n, 0, i32, device),
    )


def pong_draw(n: int, gen: torch.Generator, device) -> PongDraws:
    lo, hi = PG_SERVE_DY
    right = torch.rand(n, generator=gen, device=device) < 0.5
    return PongDraws(right, torch.rand(n, generator=gen, device=device) * (hi - lo) + lo)


def _pg_substep(s: PongState) -> tuple[PongState, torch.Tensor]:
    """One physics frame. Returns (state, reward) — +1 player point,
    -1 enemy point."""
    in_play = s.serve_wait <= 0
    x = s.ball_x + torch.where(in_play, s.ball_vx, 0.0)
    y = s.ball_y + torch.where(in_play, s.ball_vy, 0.0)
    vx, vy = s.ball_vx, s.ball_vy

    # Enemy paddle tracks the ball (capped speed, dead zone).
    target = y + PG_BALL_H / 2 - PG_PADDLE_H / 2
    delta = target - s.enemy_y
    enemy_y = s.enemy_y + torch.where(delta.abs() > 4.0, delta, 0.0).clamp(
        -PG_ENEMY_SPEED, PG_ENEMY_SPEED)
    enemy_y = enemy_y.clamp(PG_TOP, PG_BOTTOM - PG_PADDLE_H)

    # Top/bottom walls.
    hit_top = y < PG_TOP
    hit_bot = y > PG_BOTTOM - PG_BALL_H
    vy = torch.where(hit_top, vy.abs(), torch.where(hit_bot, -vy.abs(), vy))
    y = y.clamp(PG_TOP, PG_BOTTOM - PG_BALL_H)

    # Player paddle (right).
    cy = y + PG_BALL_H / 2
    hit_player = (
        in_play & (vx > 0)
        & (x + PG_BALL_W >= PG_PLAYER_X) & (x < PG_PLAYER_X + PG_PADDLE_W + 2)
        & (cy >= s.player_y - 1) & (cy <= s.player_y + PG_PADDLE_H + 1)
    )
    off_p = fdiv(cy - (s.player_y + PG_PADDLE_H / 2), PG_PADDLE_H / 2)
    vx = torch.where(hit_player, -vx.abs(), vx)
    vy = torch.where(hit_player, (off_p * 2.5).clamp(-2.5, 2.5), vy)
    x = torch.where(hit_player, float(PG_PLAYER_X - PG_BALL_W), x)

    # Enemy paddle (left).
    hit_enemy = (
        in_play & (vx < 0)
        & (x <= PG_ENEMY_X + PG_PADDLE_W) & (x + PG_BALL_W > PG_ENEMY_X - 2)
        & (cy >= enemy_y - 1) & (cy <= enemy_y + PG_PADDLE_H + 1)
    )
    off_e = fdiv(cy - (enemy_y + PG_PADDLE_H / 2), PG_PADDLE_H / 2)
    vx = torch.where(hit_enemy, vx.abs(), vx)
    vy = torch.where(hit_enemy, (off_e * 2.5).clamp(-2.5, 2.5), vy)
    x = torch.where(hit_enemy, float(PG_ENEMY_X + PG_PADDLE_W), x)

    # Points.
    player_point = in_play & (x < 0)
    enemy_point = in_play & (x > SCREEN_W - PG_BALL_W)
    reward = torch.where(player_point, 1.0, torch.where(enemy_point, -1.0, 0.0))

    scored = player_point | enemy_point
    new_s = dataclasses.replace(
        s,
        ball_x=x, ball_y=y, ball_vx=vx, ball_vy=vy,
        enemy_y=enemy_y,
        player_score=s.player_score + player_point.int(),
        enemy_score=s.enemy_score + enemy_point.int(),
        serve_wait=torch.where(scored, 30, (s.serve_wait - 1).clamp_min(0)).int(),
    )
    return new_s, reward


def pong_step(s: PongState, action: torch.Tensor, draws: PongDraws):
    """One agent step (4 physics frames). Returns (state, raw_reward,
    episodic_terminated, game_over); Pong has one life, so
    episodic_terminated == game_over."""
    action = action.int()
    s = dataclasses.replace(s, step_count=s.step_count + 1)

    # RIGHT(2)/RIGHTFIRE(4) → up; LEFT(3)/LEFTFIRE(5) → down (ALE mapping).
    up = (action == 2) | (action == 4)
    down = (action == 3) | (action == 5)
    step = PG_PADDLE_SPEED * SUBSTEPS
    dy = torch.where(up, -step, torch.where(down, step, 0))
    player_y = (s.player_y + dy).clamp(PG_TOP, PG_BOTTOM - PG_PADDLE_H)

    # Serve when the pause expires (within this step's frame budget).
    do_serve = (s.serve_wait > 0) & (s.serve_wait <= SUBSTEPS)
    s = dataclasses.replace(
        s,
        player_y=player_y,
        ball_x=torch.where(do_serve, SCREEN_W / 2, s.ball_x),
        ball_y=torch.where(do_serve, (PG_TOP + PG_BOTTOM) / 2, s.ball_y),
        ball_vx=torch.where(do_serve, torch.where(draws.serve_right, 2.0, -2.0), s.ball_vx),
        ball_vy=torch.where(do_serve, draws.serve_dy, s.ball_vy),
        serve_wait=torch.where(do_serve, 0, s.serve_wait).int(),
    )

    reward = torch.zeros_like(s.ball_x)
    for _ in range(SUBSTEPS):
        s, r = _pg_substep(s)
        reward = reward + r

    game_over = (s.player_score >= PG_WIN_SCORE) | (s.enemy_score >= PG_WIN_SCORE)
    return s, reward, game_over, game_over


@functools.lru_cache(maxsize=None)
def _pg_background(device: torch.device) -> torch.Tensor:
    _, Y = screen_grid(device)
    band = ((Y >= 24) & (Y < PG_TOP)) | ((Y >= PG_BOTTOM) & (Y < PG_BOTTOM + 10))
    return torch.where(band, PG_FG_GRAY, torch.full((1, OBS_SIZE, OBS_SIZE), PG_BG_GRAY,
                                                    dtype=torch.uint8, device=device))


def pong_render(s: PongState) -> torch.Tensor:
    device = s.ball_x.device
    X, Y = screen_grid(device)
    py, ey = _col(s.player_y), _col(s.enemy_y)
    bx, by = _col(s.ball_x), _col(s.ball_y)
    player = ((X >= PG_PLAYER_X) & (X < PG_PLAYER_X + PG_PADDLE_W)
              & (Y >= py) & (Y < py + PG_PADDLE_H))
    enemy = ((X >= PG_ENEMY_X) & (X < PG_ENEMY_X + PG_PADDLE_W)
             & (Y >= ey) & (Y < ey + PG_PADDLE_H))
    ball = (_col(s.serve_wait <= 0) & (X >= bx) & (X < bx + PG_BALL_W)
            & (Y >= by) & (Y < by + PG_BALL_H))
    return torch.where(player | enemy | ball, PG_FG_GRAY, _pg_background(device))


# ---------------------------------------------------------------------------
# Dispatch + state-based text descriptions
# ---------------------------------------------------------------------------


def reset(params: AtariParams, n: int, device):
    """N fresh games (a reset draws nothing)."""
    if params.game == "breakout":
        return breakout_reset(n, device)
    if params.game == "pong":
        return pong_reset(n, device)
    from clip_ppo_tpu_torch.envs.atari import seaquest

    return seaquest.seaquest_reset(n, device)


def draw(params: AtariParams, n: int, gen: torch.Generator, device):
    """One agent step's draws for N games, from ``gen``."""
    if params.game == "breakout":
        return breakout_draw(n, gen, device)
    if params.game == "pong":
        return pong_draw(n, gen, device)
    from clip_ppo_tpu_torch.envs.atari import seaquest

    return seaquest.seaquest_draw(n, gen, device)


def step(params: AtariParams, state, action: torch.Tensor, draws=None,
         gen: Optional[torch.Generator] = None):
    """One agent step of every game, with ``draws`` (else drawn from
    ``gen``). Returns (state, raw_reward f32 [N], episodic_terminated [N],
    game_over [N])."""
    if draws is None:
        draws = draw(params, action.shape[0], gen, action.device)
    if params.game == "breakout":
        return breakout_step(state, action, draws)
    if params.game == "pong":
        return pong_step(state, action, draws)
    from clip_ppo_tpu_torch.envs.atari import seaquest

    return seaquest.seaquest_step(state, action, draws)


def render(params: AtariParams, state) -> torch.Tensor:
    """[N, 84, 84] uint8 grayscale frames."""
    if params.game == "breakout":
        return breakout_render(state)
    if params.game == "pong":
        return pong_render(state)
    from clip_ppo_tpu_torch.envs.atari import seaquest

    return seaquest.seaquest_render(state)


def describe_breakout(
    score: np.ndarray, ball_x: np.ndarray, ball_y: np.ndarray,
    paddle_x: np.ndarray, lives: np.ndarray,
) -> list[str]:
    """Breakout descriptions with the reference's exact format and
    contextual-phrase logic (`clip_ppo_atari.py:302-367`), sourced from
    true game state instead of RAM addresses (same screen coordinates)."""
    out = []
    for i in range(len(score)):
        bx, by = int(ball_x[i]), int(ball_y[i])
        px = int(paddle_x[i])
        d = abs(bx - px)
        desc = (
            f"Breakout score {int(score[i])}, ball ({bx},{by}), "
            f"paddle ({px}), lives {int(lives[i])}"
        )
        if d < 15 and by > 180:
            desc += ", near paddle danger zone"
        elif d < 15:
            desc += ", near paddle safe"
        elif by > 180:
            desc += ", ball danger zone"
        else:
            desc += ", ball hitting bricks"
        out.append(desc)
    return out


def describe_pong(
    player_score: np.ndarray, enemy_score: np.ndarray,
    ball_x: np.ndarray, ball_y: np.ndarray,
    player_y: np.ndarray, enemy_y: np.ndarray,
) -> list[str]:
    """Pong descriptions matching `clip_ppo_atari.py:370-442`."""
    out = []
    for i in range(len(player_score)):
        bx, by = int(ball_x[i]), int(ball_y[i])
        py, ey = int(player_y[i]), int(enemy_y[i])
        desc = (
            f"Pong score {int(player_score[i])}-{int(enemy_score[i])}, "
            f"ball ({bx},{by}), player paddle ({py}), computer paddle ({ey})"
        )
        d_player = abs(by - py)
        d_enemy = abs(by - ey)
        if bx > 140:
            desc += ", near player paddle" if d_player < 10 else ", ball approaching player"
        elif bx < 20:
            desc += ", near computer paddle" if d_enemy < 10 else ", ball approaching computer"
        else:
            desc += ", ball moving toward player" if bx > 80 else ", ball moving toward computer"
        out.append(desc)
    return out


def describe_states(params: AtariParams, state) -> list[str]:
    """Batched state → per-env text (dispatcher mirroring
    `generate_atari_descriptions`, `clip_ppo_atari.py:445-462`; like the
    reference, Seaquest has no description generator and raises)."""
    if params.game == "seaquest":
        raise ValueError("Seaquest not supported for CLIP PPO")
    host = lambda t: t.cpu().numpy()  # noqa: E731
    if params.game == "breakout":
        return describe_breakout(host(state.score), host(state.ball_x), host(state.ball_y),
                                 host(state.paddle_x), host(state.lives))
    return describe_pong(host(state.player_score), host(state.enemy_score),
                         host(state.ball_x), host(state.ball_y),
                         host(state.player_y), host(state.enemy_y))
