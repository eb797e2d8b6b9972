"""Seaquest as batched tensors: the third game of the reference's grid.

Port of ``clip_ppo_tpu/envs/atari/seaquest.py``. `run_experiments.py:100-104`
sweeps ALE/Breakout-v5, ALE/Pong-v5 and ALE/Seaquest-v5 with the image
modality, so Seaquest needs no text descriptions: ``describe_states`` raises
for it, as the reference's ``generate_atari_descriptions`` does. A native
reimplementation of the game in ALE screen coordinates with an 84×84
grayscale renderer and frame-skip 4 folded in:

* the player submarine moves in 8 directions within the water and fires
  one torpedo at a time in its facing direction;
* enemies stream in horizontally from either side in four depth lanes;
  contact kills, a torpedo hit scores 20;
* divers drift across the lanes and are collected on contact (up to 6);
* oxygen drains while submerged; surfacing refills it, banking one diver
  (50 points; all 6 add a full-rescue bonus), and surfacing with none, or
  running out of air, costs a life (EpisodicLife's ``terminated``);
* the game ends when the lives run out.

Each physics frame may spawn an enemy or a diver into each free slot; the
draws of an agent step's four frames are :class:`SeaquestDraws`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from clip_ppo_tpu_torch.envs.atari.core import OBS_SIZE, SCREEN_W, SUBSTEPS, fdiv, screen_grid

SURFACE_Y = 46          # water starts below this
WATER_BOTTOM = 186
SUB_W, SUB_H = 16, 8
SUB_SPEED = 2           # px per physics frame
TORPEDO_SPEED = 5
N_ENEMIES = 8
N_DIVERS = 4
ENEMY_W, ENEMY_H = 10, 6
DIVER_W, DIVER_H = 6, 8
ENEMY_SPEED = 1.0
DIVER_SPEED = 0.5
ENEMY_SPAWN_P, DIVER_SPAWN_P = 0.02, 0.01  # per free slot per physics frame
LANES = np.array([70, 104, 138, 172], dtype=np.float32)  # lane center y
OXYGEN_MAX = 64.0
OXYGEN_RATE = 64.0 / (32.0 * 60.0)  # ~32 seconds of air at 60 fps
LIVES = 4
MAX_DIVERS = 6
NUM_ACTIONS_SEAQUEST = 18  # full ALE action set

# Grayscale palette.
SKY_GRAY = 60
WATER_GRAY = 35
SUB_GRAY = 200
ENEMY_GRAY = 120
DIVER_GRAY = 170
OXY_GRAY = 230


@dataclasses.dataclass
class SeaquestState:
    """N Seaquest games (leading axis = env)."""

    sub_x: torch.Tensor          # [N] f32 left edge
    sub_y: torch.Tensor          # [N] f32 top edge
    facing: torch.Tensor         # [N] i32: 0 right, 1 left
    oxygen: torch.Tensor         # [N] f32 in [0, OXYGEN_MAX]
    lives: torch.Tensor          # [N] i32
    score: torch.Tensor          # [N] i32
    divers_held: torch.Tensor    # [N] i32
    surfaced_once: torch.Tensor  # [N] bool (first surfacing is always safe)
    torp_x: torch.Tensor         # [N] f32
    torp_y: torch.Tensor         # [N] f32
    torp_dir: torch.Tensor       # [N] f32 (+1 right / -1 left)
    torp_active: torch.Tensor    # [N] bool
    enemy_x: torch.Tensor        # [N, N_ENEMIES] f32
    enemy_y: torch.Tensor        # [N, N_ENEMIES] f32
    enemy_dir: torch.Tensor      # [N, N_ENEMIES] f32 (±ENEMY_SPEED)
    enemy_active: torch.Tensor   # [N, N_ENEMIES] bool
    diver_x: torch.Tensor        # [N, N_DIVERS] f32
    diver_y: torch.Tensor        # [N, N_DIVERS] f32
    diver_dir: torch.Tensor      # [N, N_DIVERS] f32 (±DIVER_SPEED)
    diver_active: torch.Tensor   # [N, N_DIVERS] bool
    step_count: torch.Tensor     # [N] i32


class SeaquestDraws(NamedTuple):
    """One agent step's spawn draws, for each of its 4 physics frames and
    each slot: whether a free slot spawns (bool), its lane (int64 in [0, 4))
    and whether it enters from the left (bool). Enemies [N, 4, 8], divers
    [N, 4, 4]."""

    enemy_spawn: torch.Tensor
    enemy_lane: torch.Tensor
    enemy_left: torch.Tensor
    diver_spawn: torch.Tensor
    diver_lane: torch.Tensor
    diver_left: torch.Tensor


# Full ALE action decomposition: (dy, dx, fire) per action id.
#               NOOP FIRE  UP  RT  LT  DN  UR  UL  DR  DL UF  RF  LF  DF URF ULF DRF DLF
_AY = np.array([0,   0,   -1,  0,  0,  1, -1, -1,  1,  1, -1,  0,  0,  1, -1, -1,  1,  1], np.float32)
_AX = np.array([0,   0,    0,  1, -1,  0,  1, -1,  1, -1,  0,  1, -1,  0,  1, -1,  1, -1], np.float32)
_AF = np.array([0,   1,    0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  1,  1], np.bool_)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    return tuple(torch.as_tensor(a, device=device) for a in (_AY, _AX, _AF, LANES))


def _full(shape, value, dtype, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=device)


def seaquest_reset(n: int, device) -> SeaquestState:
    f32, i32, b = torch.float32, torch.int32, torch.bool
    return SeaquestState(
        sub_x=_full((n,), (SCREEN_W - SUB_W) / 2, f32, device),
        sub_y=_full((n,), SURFACE_Y + 20, f32, device),
        facing=_full((n,), 0, i32, device),
        oxygen=_full((n,), OXYGEN_MAX, f32, device),
        lives=_full((n,), LIVES, i32, device),
        score=_full((n,), 0, i32, device),
        divers_held=_full((n,), 0, i32, device),
        surfaced_once=_full((n,), False, b, device),
        torp_x=_full((n,), 0.0, f32, device),
        torp_y=_full((n,), 0.0, f32, device),
        torp_dir=_full((n,), 1.0, f32, device),
        torp_active=_full((n,), False, b, device),
        enemy_x=_full((n, N_ENEMIES), 0.0, f32, device),
        enemy_y=_full((n, N_ENEMIES), 0.0, f32, device),
        enemy_dir=_full((n, N_ENEMIES), 1.0, f32, device),
        enemy_active=_full((n, N_ENEMIES), False, b, device),
        diver_x=_full((n, N_DIVERS), 0.0, f32, device),
        diver_y=_full((n, N_DIVERS), 0.0, f32, device),
        diver_dir=_full((n, N_DIVERS), 1.0, f32, device),
        diver_active=_full((n, N_DIVERS), False, b, device),
        step_count=_full((n,), 0, i32, device),
    )


def seaquest_draw(n: int, gen: torch.Generator, device) -> SeaquestDraws:
    def slots(k: int, p: float):
        shape = (n, SUBSTEPS, k)
        return (torch.rand(shape, generator=gen, device=device) < p,
                torch.randint(0, len(LANES), shape, generator=gen, device=device),
                torch.rand(shape, generator=gen, device=device) < 0.5)

    return SeaquestDraws(*slots(N_ENEMIES, ENEMY_SPAWN_P), *slots(N_DIVERS, DIVER_SPAWN_P))


def _overlap(ax, ay, aw, ah, bx, by, bw, bh):
    return (ax < bx + bw) & (ax + aw > bx) & (ay < by + bh) & (ay + ah > by)


def _spawn_entities(spawn, lane, from_left, x, y, direction, active, speed_abs: float, w: int):
    """Respawn inactive slots where ``spawn`` is drawn: the drawn lane, the
    drawn side (entering moving inward)."""
    do = spawn & ~active
    new_x = torch.where(from_left, -float(w), float(SCREEN_W))
    new_dir = torch.where(from_left, speed_abs, -speed_abs)
    lanes = _tables(x.device)[3]
    x = torch.where(do, new_x, x)
    y = torch.where(do, lanes[lane] - 4.0, y)
    direction = torch.where(do, new_dir, direction)
    return x, y, direction, active | do


def _sq_substep(s: SeaquestState, d: SeaquestDraws, f: int):
    """Physics frame ``f`` of the step. Returns (state, reward, life_lost)."""
    # -- entity motion + respawn ---------------------------------------------
    ex = s.enemy_x + s.enemy_dir * torch.where(s.enemy_active, 1.0, 0.0)
    e_off = (ex < -ENEMY_W - 1) | (ex > SCREEN_W + 1)
    e_active = s.enemy_active & ~e_off
    ex, ey, edir, e_active = _spawn_entities(
        d.enemy_spawn[:, f], d.enemy_lane[:, f], d.enemy_left[:, f], ex, s.enemy_y,
        s.enemy_dir, e_active, ENEMY_SPEED, ENEMY_W)

    # diver_dir already encodes ±DIVER_SPEED (set by _spawn_entities).
    dx_ = s.diver_x + s.diver_dir * torch.where(s.diver_active, 1.0, 0.0)
    d_off = (dx_ < -DIVER_W - 1) | (dx_ > SCREEN_W + 1)
    d_active = s.diver_active & ~d_off
    dx_, dy_, ddir, d_active = _spawn_entities(
        d.diver_spawn[:, f], d.diver_lane[:, f], d.diver_left[:, f], dx_, s.diver_y,
        s.diver_dir, d_active, DIVER_SPEED, DIVER_W)

    # -- torpedo --------------------------------------------------------------
    tx = s.torp_x + s.torp_dir * TORPEDO_SPEED
    t_active = s.torp_active & (tx > -4) & (tx < SCREEN_W + 4)
    hit = t_active[:, None] & e_active & _overlap(
        tx[:, None], s.torp_y[:, None], 4, 2, ex, ey, ENEMY_W, ENEMY_H)
    any_hit = hit.any(-1)
    e_active = e_active & ~hit
    t_active = t_active & ~any_hit
    reward = torch.where(any_hit, 20.0, 0.0)

    # -- sub collisions --------------------------------------------------------
    sx, sy = s.sub_x[:, None], s.sub_y[:, None]
    sub_hit = (e_active & _overlap(sx, sy, SUB_W, SUB_H, ex, ey, ENEMY_W, ENEMY_H)).any(-1)
    pickup = d_active & _overlap(sx, sy, SUB_W, SUB_H, dx_, dy_, DIVER_W, DIVER_H)
    can_take = s.divers_held < MAX_DIVERS
    n_pickup = torch.where(can_take, pickup.sum(-1).int(), 0)
    d_active = torch.where(can_take[:, None], d_active & ~pickup, d_active)
    divers = (s.divers_held + n_pickup).clamp_max(MAX_DIVERS).int()

    # -- oxygen ------------------------------------------------------------------
    # Drains while submerged, frozen at the surface; banking and penalties
    # are decided once per agent step in seaquest_step.
    at_surface = s.sub_y <= SURFACE_Y
    oxygen = torch.where(at_surface, s.oxygen, s.oxygen - OXYGEN_RATE)
    out_of_air = oxygen <= 0.0
    life_lost = sub_hit | out_of_air

    # Respawn sub mid-water after a death; keep oxygen full.
    new_s = dataclasses.replace(
        s,
        sub_x=torch.where(life_lost, (SCREEN_W - SUB_W) / 2.0, s.sub_x),
        sub_y=torch.where(life_lost, SURFACE_Y + 20.0, s.sub_y),
        oxygen=torch.where(life_lost, OXYGEN_MAX, oxygen),
        lives=s.lives - life_lost.int(),
        score=s.score + reward.int(),
        divers_held=divers,
        torp_x=tx, torp_active=t_active,
        enemy_x=ex, enemy_y=ey, enemy_dir=edir, enemy_active=e_active,
        diver_x=dx_, diver_y=dy_, diver_dir=ddir, diver_active=d_active,
    )
    return new_s, reward, life_lost


def seaquest_step(s: SeaquestState, action: torch.Tensor, draws: SeaquestDraws):
    """One agent step (4 physics frames). Returns (state, raw_reward,
    episodic_terminated, game_over)."""
    action = action.long().clamp(0, NUM_ACTIONS_SEAQUEST - 1)
    ay, ax, af, _ = _tables(s.sub_x.device)
    dy = ay[action] * SUB_SPEED * SUBSTEPS
    dx = ax[action] * SUB_SPEED * SUBSTEPS
    fire = af[action]
    facing = torch.where(dx > 0, 0, torch.where(dx < 0, 1, s.facing)).int()
    sub_x = (s.sub_x + dx).clamp(0.0, SCREEN_W - SUB_W)
    sub_y = (s.sub_y + dy).clamp(SURFACE_Y - 2.0, WATER_BOTTOM - SUB_H)
    # Fire a torpedo if none in flight.
    do_fire = fire & ~s.torp_active
    tdir = torch.where(facing == 0, 1.0, -1.0)
    s = dataclasses.replace(
        s,
        step_count=s.step_count + 1,
        sub_x=sub_x, sub_y=sub_y, facing=facing,
        torp_x=torch.where(do_fire, sub_x + SUB_W / 2, s.torp_x),
        torp_y=torch.where(do_fire, sub_y + SUB_H / 2, s.torp_y),
        torp_dir=torch.where(do_fire, tdir, s.torp_dir),
        torp_active=s.torp_active | do_fire,
    )

    # -- surface logic (once per agent step) -----------------------------------
    # Arrival step (oxygen not yet full): refill + bank one diver; the first
    # arrival of the episode is free even with no divers. Every further step
    # at the surface keeps banking one diver, and with none left costs a life.
    at_surface = s.sub_y <= SURFACE_Y
    arrival = at_surface & (s.oxygen < OXYGEN_MAX)
    lingering = at_surface & ~arrival
    bank = at_surface & (s.divers_held > 0)
    full_rescue = bank & (s.divers_held == MAX_DIVERS)
    reward = torch.where(bank, 50.0, 0.0) + torch.where(full_rescue, 250.0, 0.0)
    divers = torch.where(full_rescue, 0, torch.where(bank, s.divers_held - 1, s.divers_held))
    empty_surface = (arrival & ~bank & s.surfaced_once) | (lingering & ~bank)
    s = dataclasses.replace(
        s,
        oxygen=torch.where(at_surface, OXYGEN_MAX, s.oxygen),
        divers_held=divers.int(),
        surfaced_once=s.surfaced_once | at_surface,
        lives=s.lives - empty_surface.int(),
        # Death pushes the sub back to mid-water like the in-frame deaths.
        sub_y=torch.where(empty_surface, SURFACE_Y + 20.0, s.sub_y),
        sub_x=torch.where(empty_surface, (SCREEN_W - SUB_W) / 2.0, s.sub_x),
    )

    life_lost = empty_surface
    for f in range(SUBSTEPS):
        s, r, lost = _sq_substep(s, draws, f)
        reward = reward + r
        life_lost = life_lost | lost

    game_over = s.lives <= 0
    return s, reward, life_lost | game_over, game_over


def seaquest_render(s: SeaquestState) -> torch.Tensor:
    device = s.sub_x.device
    X, Y = screen_grid(device)
    n = s.sub_x.shape[0]
    img = torch.where(Y < SURFACE_Y, SKY_GRAY, WATER_GRAY).to(torch.uint8)
    img = img.expand(n, OBS_SIZE, OBS_SIZE)

    def rect(img, x0, y0, w, h, gray, cond=None):
        m = (X >= x0) & (X < x0 + w) & (Y >= y0) & (Y < y0 + h)
        if cond is not None:
            m = m & cond
        return torch.where(m, gray, img)

    col = lambda t: t.reshape(-1, 1, 1)  # noqa: E731
    for i in range(N_ENEMIES):
        img = rect(img, col(s.enemy_x[:, i]), col(s.enemy_y[:, i]), ENEMY_W, ENEMY_H,
                   ENEMY_GRAY, col(s.enemy_active[:, i]))
    for i in range(N_DIVERS):
        img = rect(img, col(s.diver_x[:, i]), col(s.diver_y[:, i]), DIVER_W, DIVER_H,
                   DIVER_GRAY, col(s.diver_active[:, i]))
    # Torpedo + sub.
    img = rect(img, col(s.torp_x), col(s.torp_y), 4, 2, 255, col(s.torp_active))
    img = rect(img, col(s.sub_x), col(s.sub_y), SUB_W, SUB_H, SUB_GRAY)
    # Oxygen bar (bottom): width proportional to air left.
    bar_w = fdiv(s.oxygen, OXYGEN_MAX) * 120.0
    img = rect(img, 20.0, 198.0, col(bar_w), 6, OXY_GRAY)
    # Held divers as ticks above the bar.
    for i in range(MAX_DIVERS):
        img = rect(img, 20.0 + 12.0 * i, 190.0, 8, 4, DIVER_GRAY, col(s.divers_held > i))
    return img
