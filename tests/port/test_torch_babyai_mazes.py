"""The port's BabyAI mazes against the JAX package's: the maze tier
(GoTo[Open], GoToObjMaze*, Pickup, UnblockPickup, Open, Unlock,
GoToImpUnlock, FindObjS{n}, PickupAbove), UnlockLocal[Dist], KeyInBox,
UnlockToUnlock, GoToDoor, GoToObjDoor and the BabyAI ids of the Unlock
layout (UnlockPickup[Dist], BlockedUnlockPickup).

Each of their 27 ids parses to the JAX package's ``EnvParams`` on every
field the port has. The port's resets are held to the invariants that
``tests/test_babyai_maze.py``, ``test_babyai_unlock_tier.py`` and the
non-seq cases of ``test_babyai_seq.py`` pin: the RoomGrid lattice,
``connect_all``'s connectivity, the reachability rejection (inverted for
UnblockPickup), the unlock tier's locked room and key, and the mission
``target``. Transitions are held for equality against the JAX package as
``test_torch_babyai_rooms`` holds them, with crafted states for every
success mode (a locked door with and without its key, KeyInBox's box, the
type-only pickups).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_ppo_tpu.envs.minigrid import core as jmg
from clip_ppo_tpu_torch.envs.minigrid import core as tmg
from test_torch_babyai_rooms import (all_reachable, check_modes, doors, flood, objects, pair,
                                     resets, step_and_compare)
from test_torch_minigrid_families import _check_unlock

MAZE_IDS = [
    "BabyAI-GoTo-v0", "BabyAI-GoToOpen-v0",
    "BabyAI-GoToObjMaze-v0", "BabyAI-GoToObjMazeOpen-v0", "BabyAI-GoToObjMazeS4R2-v0",
    "BabyAI-GoToObjMazeS4-v0", "BabyAI-GoToObjMazeS5-v0", "BabyAI-GoToObjMazeS6-v0",
    "BabyAI-GoToObjMazeS7-v0",
    "BabyAI-Pickup-v0", "BabyAI-UnblockPickup-v0", "BabyAI-Open-v0",
    "BabyAI-Unlock-v0", "BabyAI-GoToImpUnlock-v0",
    "BabyAI-FindObjS5-v0", "BabyAI-FindObjS6-v0", "BabyAI-FindObjS7-v0",
    "BabyAI-PickupAbove-v0",
    "BabyAI-UnlockLocal-v0", "BabyAI-UnlockLocalDist-v0", "BabyAI-KeyInBox-v0",
    "BabyAI-UnlockToUnlock-v0",
    "BabyAI-GoToDoor-v0", "BabyAI-GoToObjDoor-v0",
    "BabyAI-UnlockPickup-v0", "BabyAI-UnlockPickupDist-v0", "BabyAI-BlockedUnlockPickup-v0",
]
STEP_CASES = [
    "BabyAI-GoTo-v0", "BabyAI-UnblockPickup-v0", "BabyAI-FindObjS5-v0", "BabyAI-Open-v0",
    "BabyAI-Unlock-v0", "BabyAI-GoToImpUnlock-v0", "BabyAI-KeyInBox-v0",
    "BabyAI-UnlockToUnlock-v0", "BabyAI-GoToObjDoor-v0", "BabyAI-UnlockPickupDist-v0",
]


@pytest.mark.parametrize("env_id", MAZE_IDS)
def test_parse_matches_jax(env_id):
    tp, jp = tmg.parse_env_id(env_id), jmg.parse_env_id(env_id)
    for f in dataclasses.fields(tp):
        assert getattr(tp, f.name) == getattr(jp, f.name), f.name


# ---------------------------------------------------------------------------
# Reset invariants
# ---------------------------------------------------------------------------


def _room(p, c, pitch):
    return (c[0] // pitch, c[1] // pitch)


def _lattice_ok(obj, pitch):
    """RoomGrid lines hold only walls and doors, interiors neither, and the
    outer border no door."""
    line = np.zeros(obj.shape, bool)
    line[::pitch, :] = line[:, ::pitch] = True
    assert np.isin(obj[line], (jmg.WALL, jmg.DOOR)).all()
    assert not np.isin(obj[~line], (jmg.WALL, jmg.DOOR)).any()
    for edge in (obj[0], obj[-1], obj[:, 0], obj[:, -1]):
        assert (edge == jmg.WALL).all()


def _check_gotomaze(p, g, pos, d, t):
    s, r, c = p.max_room_size, p.min_rooms, p.max_rooms
    pitch, obj = s - 1, g[..., 0]
    _lattice_ok(obj, pitch)
    ds, objs = doors(g), objects(g)
    locked = [x for x in ds if g[x][2] == jmg.LOCKED]
    assert len(locked) == int(p.locked_room)
    rest = {int(g[x][2]) for x in ds if x not in locked}
    assert rest <= ({jmg.OPEN} if p.doors_open else {jmg.CLOSED})
    assert len(ds) >= r * c - 1
    # connect_all: every room is reached from the agent's through doors
    filled = flood(np.where(obj == jmg.WALL, jmg.WALL, jmg.EMPTY), pos)
    assert all(any(_room(p, x, pitch) == (i, j) for x in filled)
               for i in range(c) for j in range(r))
    assert obj[pos] == jmg.EMPTY
    assert all_reachable(obj, pos) != p.invert_reach
    rooms = [_room(p, x, pitch) for x in objs]
    extra = int(p.locked_room) + int(p.target_in_locked)
    assert len(objs) == p.num_objs + extra
    if p.locked_room:
        lcolor = int(g[locked[0]][1])
        assert any(pair(g, x) == (jmg.KEY, lcolor) for x in objs)
    if p.target_in_locked:
        # the locked room: the one room holding a single object, the
        # target, beside the locked door; every other holds 2 distractors
        # (and one of them the key)
        counts = {rm: rooms.count(rm) for rm in set(rooms)}
        (lr,) = [rm for rm, k in counts.items() if k == 1]
        assert len(counts) == r * c and sorted(counts.values()) == [1] + [2] * 7 + [3]
        lx, ly = locked[0]
        assert lr in {_room(p, (lx - 1, ly - 1), pitch), _room(p, (lx, ly), pitch)}
        (tx,) = [x for x, rm in zip(objs, rooms) if rm == lr]
        assert pair(g, tx) == (t[0], t[1]) and _room(p, pos, pitch) != lr
    elif p.locked_room:
        assert (t[0], t[1]) == (jmg.DOOR, lcolor)
    elif p.success == "babyai_open_color":
        assert t[0] == jmg.DOOR and int(t[1]) in {int(g[x][1]) for x in ds}
    elif p.type_only:
        assert t[1] == -1 and int(t[0]) in {pair(g, x)[0] for x in objs}
    else:
        assert (int(t[0]), int(t[1])) in {pair(g, x) for x in objs}
    assert not t[2:].any()
    if p.fixed_agent_room:
        assert _room(p, pos, pitch) == p.agent_room
    if p.obj_room[0] >= 0:  # PickupAbove: the object above, a door on the top wall
        assert rooms == [p.obj_room] and (t[0], t[1]) == (pair(g, objs[0])[0], -1)
        assert any(x[1] == pitch and pitch < x[0] < 2 * pitch for x in ds)


def _check_unlocklocal(p, g, pos, d, t):
    _lattice_ok(g[..., 0], 7)
    (door,) = doors(g)
    assert g[door][2] == jmg.LOCKED
    assert (door[0] in (7, 14) and 7 < door[1] < 14) or (door[1] in (7, 14) and 7 < door[0] < 14)
    color, objs = int(g[door][1]), objects(g)
    assert all(7 < x[0] < 14 and 7 < x[1] < 14 for x in objs + [pos])
    if p.key_in_box:
        (box,) = objs
        assert g[box][0] == jmg.BOX and g[box][2] == color + 1
    else:
        assert len(objs) == 1 + p.num_objs and (jmg.KEY, color) in {pair(g, x) for x in objs}
        assert len({pair(g, x) for x in objs}) == len(objs)  # distinct, the key included
    assert (t[0], t[1]) == (jmg.DOOR, -1) and not t[2:].any()


def _check_u2u(p, g, pos, d, t):
    ds = sorted(doors(g))
    assert [x[0] for x in ds] == [5, 10] and all(g[x][2] == jmg.LOCKED for x in ds)
    ca, cb = int(g[ds[0]][1]), int(g[ds[1]][1])
    assert ca != cb
    keys = {int(g[x][1]): x[0] for x in objects(g) if g[x][0] == jmg.KEY}
    assert keys[ca] > 10 and 5 < keys[cb] < 10
    balls = [x for x in objects(g) if g[x][0] == jmg.BALL]
    assert len(balls) == 1 and balls[0][0] < 5 and len(objects(g)) == 3
    assert 5 < pos[0] < 10 and (t[0], t[1]) == (jmg.BALL, -1) and not t[2:].any()


def _check_objdoor(p, g, pos, d, t):
    pitch = p.max_room_size - 1
    _lattice_ok(g[..., 0], pitch)
    ds = doors(g)
    walls = {(x if x in (pitch, 2 * pitch) else None, y if y in (pitch, 2 * pitch) else None)
             for x, y in ds}
    assert len(ds) == 4 and walls == {(2 * pitch, None), (None, 2 * pitch), (pitch, None),
                                      (None, pitch)}
    objs = objects(g)
    assert len(objs) == p.num_objs
    assert all(pitch < x[0] < 2 * pitch and pitch < x[1] < 2 * pitch for x in objs + [pos])
    assert (int(t[0]), int(t[1])) in {pair(g, x) for x in objs + ds} and not t[2:].any()


def _check_unlock_babyai(p, g, pos, d, t):
    if not p.num_objs:
        _check_unlock(p, g, pos, d)
        assert not t.any()
        return
    (door,) = doors(g)
    objs = objects(g)
    pairs = [pair(g, x) for x in objs]
    assert len(pairs) == len(set(pairs)) == 2 + p.num_objs  # key, box and the distractors
    assert (jmg.KEY, int(g[door][1])) in pairs
    assert t[0] == jmg.BOX and any(pair(g, x) == (jmg.BOX, t[1]) and x[0] > 5 for x in objs)
    assert not t[2:].any() and 1 <= pos[0] <= 4 and g[pos][0] == jmg.EMPTY


CHECKS = {
    "babyai_gotomaze": _check_gotomaze, "babyai_unlocklocal": _check_unlocklocal,
    "babyai_u2u": _check_u2u, "babyai_objdoor": _check_objdoor, "unlock": _check_unlock_babyai,
}


@pytest.mark.parametrize("env_id", MAZE_IDS)
def test_reset_invariants(env_id):
    p, st = resets(env_id, n=32)
    grids, targets = st.grid.numpy(), st.target.numpy()
    for i in range(grids.shape[0]):
        pos, d = tuple(int(v) for v in st.agent_pos[i]), int(st.agent_dir[i])
        assert not st.carrying[i].any()
        CHECKS[p.kind](p, grids[i], pos, d, targets[i])
    assert len({g.tobytes() for g in grids}) > 1 and len(set(st.agent_dir.tolist())) == 4
    if p.kind in ("babyai_gotomaze", "babyai_objdoor") and not p.type_only:
        assert len({tuple(r) for r in targets.tolist()}) > 1  # the mission varies


def test_objs_reachable_matches_a_flood_on_crafted_grids():
    """The batched check against the JAX package's ``_objs_reachable`` under
    ``vmap`` and against the Python flood, on reset grids and three crafted
    ones: a ball walled in by boxes, and a ball behind a wall with and
    without a locked door in it (doors pass)."""
    p = tmg.parse_env_id("BabyAI-GoToLocalS8N7-v0")
    gen = torch.Generator()
    gen.manual_seed(2)
    st = tmg.reset(p, 16, gen, "cpu")
    g, pos = st.grid.clone(), st.agent_pos.clone()
    cell = lambda *v: torch.tensor(v, dtype=torch.int8)  # noqa: E731
    g[:3, 1:7, 1:7] = cell(jmg.EMPTY, 0, 0)
    pos[:3] = torch.tensor([6, 6])
    g[:3, 1, 1] = cell(jmg.BALL, jmg.RED, 0)
    g[0, 2, 1] = g[0, 1, 2] = g[0, 2, 2] = cell(jmg.BOX, jmg.BLUE, 0)
    g[1:3, 3, 1:7] = cell(jmg.WALL, jmg.GREY, 0)
    g[1, 3, 3] = cell(jmg.DOOR, jmg.YELLOW, jmg.LOCKED)
    got = tmg._objs_reachable(g, pos).tolist()
    want = [all_reachable(g[i, ..., 0].numpy(), tuple(pos[i].tolist())) for i in range(16)]
    jax_got = jax.vmap(jmg._objs_reachable, in_axes=(None, 0, 0))(
        jmg.parse_env_id("BabyAI-GoToLocalS8N7-v0"), jnp.asarray(g.numpy()),
        jnp.asarray(pos.numpy()))
    assert np.asarray(jax_got).tolist() == got
    assert got == want and got[:3] == [False, True, False] and all(got[3:])


def test_unblock_pickup_keeps_only_blocked_layouts_and_the_bound_raises(monkeypatch):
    """UnblockPickup's inverted rejection keeps only layouts with a blocked
    object; a rejection loop that runs out of attempts raises rather than
    keep a rejected layout."""
    p, st = resets("BabyAI-UnblockPickup-v0", n=16, seed=4)
    for i in range(16):
        assert not all_reachable(st.grid[i, ..., 0].numpy(), tuple(st.agent_pos[i].tolist()))
    monkeypatch.setattr(tmg, "BABYAI_ATTEMPTS", 1)
    with pytest.raises(RuntimeError, match="rejected layouts"):
        gen = torch.Generator()
        gen.manual_seed(0)
        tmg.reset(tmg.parse_env_id("BabyAI-GoTo-v0"), 512, gen, "cpu")


# ---------------------------------------------------------------------------
# Transitions against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env_id", STEP_CASES)
def test_step_and_observe_equal(env_id):
    check_modes(env_id, *step_and_compare(env_id))
