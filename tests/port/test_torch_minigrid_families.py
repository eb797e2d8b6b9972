"""The port's classic MiniGrid families against the JAX package's.

The 39 ids of FourRooms, LavaGap, DistShift, MultiRoom, {Simple,Lava}Crossing,
Dynamic-Obstacles, Unlock, UnlockPickup, BlockedUnlockPickup,
ObstructedMaze-1Dl{,h,hb}, KeyCorridor, LockedRoom and RedBlueDoors parse to
the JAX package's ``EnvParams`` on every field the port has; BabyAI's
levels of composite instructions, which a later slice brings, are refused
by name.

Resets draw from different generators in the two packages, so the port's
resets are held to the structural invariants the JAX package's family tests
pin (``tests/test_fourrooms.py``, ``test_lavagap.py``,
``test_multiroom_crossing.py``, ``test_dynamic_obstacles.py``,
``test_keycorridor.py``, ``test_unlock.py``, ``test_lockedroom_memory.py``,
``test_distshift_redblue.py``). Transitions are held for equality: states from
the port's resets, with crafted mid-episode states appended (each success
mode, the blocked door, the key in a box, a non-target ball, lava, a ball
collision), are carried into the JAX package, and both step them 24 times
with the same actions; observations, rewards, terminated/truncated flags and
next states must be EQUAL. Dynamic-Obstacles' ball moves are the port's
explicit Gumbel draws, recomputed from each JAX state's key as its step
splits it. One JAX step and one JAX observe compile per case, and no JAX
reset, to keep the clock.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.envs.minigrid import core as jmg
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.envs.minigrid import core as tmg
from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv

FAMILY_IDS = [
    "MiniGrid-FourRooms-v0",
    "MiniGrid-LavaGapS5-v0", "MiniGrid-LavaGapS6-v0", "MiniGrid-LavaGapS7-v0",
    "MiniGrid-DistShift1-v0", "MiniGrid-DistShift2-v0",
    "MiniGrid-MultiRoom-N2-S4-v0", "MiniGrid-MultiRoom-N4-S5-v0", "MiniGrid-MultiRoom-N6-v0",
    "MiniGrid-SimpleCrossingS9N1-v0", "MiniGrid-SimpleCrossingS9N2-v0",
    "MiniGrid-SimpleCrossingS9N3-v0", "MiniGrid-SimpleCrossingS11N5-v0",
    "MiniGrid-LavaCrossingS9N1-v0", "MiniGrid-LavaCrossingS9N2-v0",
    "MiniGrid-LavaCrossingS9N3-v0", "MiniGrid-LavaCrossingS11N5-v0",
    "MiniGrid-Dynamic-Obstacles-5x5-v0", "MiniGrid-Dynamic-Obstacles-Random-5x5-v0",
    "MiniGrid-Dynamic-Obstacles-6x6-v0", "MiniGrid-Dynamic-Obstacles-Random-6x6-v0",
    "MiniGrid-Dynamic-Obstacles-8x8-v0", "MiniGrid-Dynamic-Obstacles-16x16-v0",
    "MiniGrid-Unlock-v0", "MiniGrid-UnlockPickup-v0", "MiniGrid-BlockedUnlockPickup-v0",
    "MiniGrid-ObstructedMaze-1Dl-v0", "MiniGrid-ObstructedMaze-1Dlh-v0",
    "MiniGrid-ObstructedMaze-1Dlhb-v0", "MiniGrid-ObstructedMaze-1Dlhb-v1",
    "MiniGrid-KeyCorridorS3R1-v0", "MiniGrid-KeyCorridorS3R2-v0", "MiniGrid-KeyCorridorS3R3-v0",
    "MiniGrid-KeyCorridorS4R3-v0", "MiniGrid-KeyCorridorS5R3-v0", "MiniGrid-KeyCorridorS6R3-v0",
    "MiniGrid-LockedRoom-v0",
    "MiniGrid-RedBlueDoors-6x6-v0", "MiniGrid-RedBlueDoors-8x8-v0",
]
STEPS = 24
DIRS = jmg.DIR_TO_VEC


def test_forty_nine_ids_parse():
    """The 39 ids of these families beside Empty's 6 and DoorKey's 4 (49),
    the mission families, Memory, Playground and the full ObstructedMaze
    (27 more, ``test_torch_minigrid_missions``) and the 89 BabyAI levels
    (``test_torch_babyai_rooms``, ``test_torch_babyai_mazes``,
    ``test_torch_babyai_seq``): all 165 of the registry parse."""
    assert len(set(FAMILY_IDS)) == 39
    from tests.test_registry_matrix import REGISTERED

    ported = [i for i in REGISTERED if _parses(i)]
    assert len(REGISTERED) == 165 and len(ported) == 165
    assert set(FAMILY_IDS) <= set(ported)
    assert sum(jmg.parse_env_id(i).success == "babyai_seq" for i in ported) == 19


def _parses(env_id):
    try:
        tmg.parse_env_id(env_id)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("env_id", FAMILY_IDS)
def test_parse_matches_jax(env_id):
    tp, jp = tmg.parse_env_id(env_id), jmg.parse_env_id(env_id)
    for f in dataclasses.fields(tp):
        assert getattr(tp, f.name) == getattr(jp, f.name), f.name


@pytest.mark.parametrize("env_id,slice_name", [
    ("BabyAI-GoToSeqS5R2-v0", "BabyAI instruction slice"),
    ("BabyAI-SynthLoc-v0", "BabyAI instruction slice"),
    ("BabyAI-MoveTwoAcrossS8N9-v0", "BabyAI instruction slice"),
    ("BabyAI-OpenRedBlueDoorsDebug-v0", "BabyAI instruction slice"),
    ("BabyAI-OpenDoorsOrderN4-v0", "BabyAI instruction slice"),
    ("BabyAI-PickupLoc-v0", "BabyAI instruction slice"),
    ("BabyAI-MiniBossLevel-v0", "BabyAI instruction slice"),
    ("BabyAI-BossLevel-v0", "BabyAI instruction slice"),
])
def test_later_ids_are_refused_by_slice(env_id, slice_name):
    """Ids that were refused until ``slice_name`` brought them (hence the
    name): each parses as the JAX package parses it and resets."""
    assert slice_name == "BabyAI instruction slice"
    tp, jp = tmg.parse_env_id(env_id), jmg.parse_env_id(env_id)
    assert (tp.kind, tp.success, tp.width, tp.height) == (jp.kind, jp.success, jp.width, jp.height)
    gen = torch.Generator()
    gen.manual_seed(0)
    st = tmg.reset(tp, 2, gen, "cpu")
    assert st.grid.shape == (2, tp.width, tp.height, 3) and st.instr.any()


# ---------------------------------------------------------------------------
# Reset invariants
# ---------------------------------------------------------------------------


def _resets(env_id, n=48, seed=0):
    p = tmg.parse_env_id(env_id)
    gen = torch.Generator()
    gen.manual_seed(seed)
    st = tmg.reset(p, n, gen, "cpu")
    return p, st.grid.numpy(), st.agent_pos.numpy(), st.agent_dir.numpy()


def _reach(g, start, passable):
    """Cells 4-connected to ``start`` through objects in ``passable``."""
    ok = np.isin(g[..., 0], list(passable))
    seen = np.zeros(ok.shape, bool)
    stack = [tuple(start)]
    seen[tuple(start)] = True
    while stack:
        x, y = stack.pop()
        for dx, dy in DIRS:
            nx, ny = x + dx, y + dy
            if 0 <= nx < ok.shape[0] and 0 <= ny < ok.shape[1] and ok[nx, ny] and not seen[nx, ny]:
                seen[nx, ny] = True
                stack.append((nx, ny))
    return seen


def _one(g, obj):
    cells = np.argwhere(g[..., 0] == obj)
    assert len(cells) == 1, (obj, cells)
    return tuple(int(v) for v in cells[0])


def _check_fourrooms(p, g, pos, d):
    w, h = p.width, p.height
    mx, my = w // 2, h // 2
    # one opening per half of each central wall (the goal may sit in one)
    for half in (g[mx, 1:my], g[mx, my + 1:-1], g[1:mx, my], g[mx + 1:-1, my]):
        assert (half[:, 0] != jmg.WALL).sum() == 1
    goal = _one(g, jmg.GOAL)
    assert g[pos[0], pos[1], 0] == jmg.EMPTY and tuple(pos) != goal
    passable = _reach(g, pos, {jmg.EMPTY, jmg.GOAL})
    assert passable.sum() == np.isin(g[..., 0], [jmg.EMPTY, jmg.GOAL]).sum()  # one component


def _check_lavagap(p, g, pos, d):
    w, h = p.width, p.height
    cols = [x for x in range(w) if (g[x, :, 0] == jmg.LAVA).any()]
    assert len(cols) == 1 and 2 <= cols[0] <= w - 3
    col = g[cols[0], 1:h - 1, 0]
    assert (col == jmg.LAVA).sum() == h - 3 and (col == jmg.EMPTY).sum() == 1
    assert tuple(pos) == (1, 1) and d == 0 and g[w - 2, h - 2, 0] == jmg.GOAL


def _check_distshift(p, g, pos, d):
    obj = g[..., 0]
    assert _one(g, jmg.GOAL) == (7, 1)
    assert sorted(map(tuple, np.argwhere(obj == jmg.LAVA).tolist())) == [
        (3, p.strip_row), (4, p.strip_row), (5, p.strip_row)]
    interior = obj[1:-1, 1:-1]
    assert ((interior == jmg.EMPTY) | (interior == jmg.GOAL) | (interior == jmg.LAVA)).all()
    assert tuple(pos) == (1, 1) and d == 0


def _check_multiroom(p, g, pos, d):
    obj = g[..., 0]
    doors = np.argwhere(obj == jmg.DOOR)
    assert len(doors) == p.max_rooms - 1
    assert (g[doors[:, 0], doors[:, 1], 2] == jmg.CLOSED).all()
    assert obj[pos[0], pos[1]] == jmg.EMPTY
    reach = _reach(g, pos, {jmg.EMPTY, jmg.DOOR, jmg.GOAL})
    assert reach[_one(g, jmg.GOAL)]
    assert not reach[0, :].any() and not reach[:, 0].any()  # the rooms enclose the agent
    # doors in chain order along the path: consecutive ones differ in color
    dist = _bfs_order(g, pos)
    colors = [int(g[x, y, 1]) for x, y in sorted(map(tuple, doors.tolist()), key=dist.get)]
    assert all(a != b for a, b in zip(colors, colors[1:]))


def _bfs_order(g, start):
    """BFS distance of each reachable cell from ``start`` (doors passable)."""
    ok = np.isin(g[..., 0], [jmg.EMPTY, jmg.DOOR, jmg.GOAL])
    dist, frontier = {tuple(start): 0}, [tuple(start)]
    while frontier:
        nxt = []
        for x, y in frontier:
            for dx, dy in DIRS:
                c = (x + dx, y + dy)
                if 0 <= c[0] < ok.shape[0] and 0 <= c[1] < ok.shape[1] and ok[c] and c not in dist:
                    dist[c] = dist[(x, y)] + 1
                    nxt.append(c)
        frontier = nxt
    return dist


def _check_crossing(p, g, pos, d):
    size, n, obstacle = p.width, p.num_crossings, p.obstacle
    obj = g[..., 0]
    assert tuple(pos) == (1, 1) and d == 0 and obj[size - 2, size - 2] == jmg.GOAL
    river_lines = 0
    for c in range(2, size - 2, 2):
        for line in (obj[c, 1:size - 1], obj[1:size - 1, c]):
            hits = (line == obstacle).sum()
            if hits == size - 3:
                river_lines += 1
            else:
                assert hits <= n
    assert river_lines == n
    assert _reach(g, (1, 1), {jmg.EMPTY, jmg.GOAL})[size - 2, size - 2]


def _check_dynobs(p, g, pos, d):
    balls = np.argwhere(g[..., 0] == jmg.BALL)
    assert len(balls) == p.n_obstacles
    assert (balls >= 1).all() and (balls <= p.width - 2).all()
    assert (g[balls[:, 0], balls[:, 1], 1] == jmg.BLUE).all()
    assert g[p.width - 2, p.height - 2, 0] == jmg.GOAL
    assert not any(tuple(b) == tuple(pos) for b in balls.tolist())
    if not p.random_start:
        assert tuple(pos) == (1, 1) and d == 0
    else:
        assert g[pos[0], pos[1], 0] == jmg.EMPTY


def _check_unlock(p, g, pos, d):
    obj = g[..., 0]
    doors = np.argwhere(obj == jmg.DOOR)
    assert len(doors) == 1 and doors[0][0] == 5 and 1 <= doors[0][1] <= p.height - 2
    dy = int(doors[0][1])
    assert g[5, dy, 2] == jmg.LOCKED
    assert all(obj[5, y] == jmg.WALL for y in range(p.height) if y != dy)
    color = g[5, dy, 1]
    if p.key_in_box:
        boxes = [tuple(b) for b in np.argwhere(obj == jmg.BOX).tolist() if b[0] < 5]
        assert len(boxes) == 1 and g[boxes[0]][2] == color + 1
        kx, ky = boxes[0]
        assert not (obj == jmg.KEY).any()
    else:
        kx, ky = _one(g, jmg.KEY)
        assert g[kx, ky, 1] == color
    assert 1 <= kx <= 4 and 1 <= ky <= 4
    assert 1 <= pos[0] <= 4 and 1 <= pos[1] <= 4 and obj[pos[0], pos[1]] == jmg.EMPTY
    assert not (obj == jmg.GOAL).any()
    right = obj[6:10, 1:5]
    if p.success == "pickup_box":
        assert (right == jmg.BOX).sum() == 1
    if p.success == "pickup_ball":
        bx, by = np.argwhere(right == jmg.BALL)[0] + [6, 1]
        assert (right == jmg.BALL).sum() == 1 and g[bx, by, 1] == jmg.BLUE
    if p.blocked_door:
        assert obj[4, dy] == jmg.BALL
        if p.target_color >= 0:
            assert g[4, dy, 1] != p.target_color
    else:
        assert not (obj[:5] == jmg.BALL).any()


def _check_keycorridor(p, g, pos, d):
    s, r = p.max_room_size, p.min_rooms
    room_of = lambda c: (int(c[0]) // (s - 1), int(c[1]) // (s - 1))  # noqa: E731
    locked = (g[..., 0] == jmg.DOOR) & (g[..., 2] == jmg.LOCKED)
    assert locked.sum() == 1
    dx, dy = map(int, np.argwhere(locked)[0])
    assert dx == 2 * (s - 1)
    ball = _one(g, jmg.BALL)
    assert room_of(ball) == (2, dy // (s - 1))
    key = _one(g, jmg.KEY)
    assert room_of(key)[0] == 0 and g[key][1] == g[dx, dy, 1]
    assert room_of(pos) == (1, r // 2) and g[pos[0], pos[1], 0] == jmg.EMPTY
    for j in range(1, r):
        assert (g[s:2 * (s - 1), j * (s - 1), 0] == jmg.EMPTY).all()
    reach = _reach(g, pos, {jmg.EMPTY, jmg.DOOR, jmg.KEY, jmg.BALL})
    assert reach[ball] and reach[key]
    # connect_all: every room is reachable through its doors; the locked
    # room has no door but the locked one
    for i in range(3):
        for j in range(r):
            assert reach[i * (s - 1) + 1:(i + 1) * (s - 1), j * (s - 1) + 1:(j + 1) * (s - 1)].all()
    rr = dy // (s - 1)
    x0, x1, y0, y1 = 2 * (s - 1), 3 * (s - 1), rr * (s - 1), (rr + 1) * (s - 1)
    on_border = [tuple(c) for c in np.argwhere(g[..., 0] == jmg.DOOR).tolist()
                 if x0 <= c[0] <= x1 and y0 <= c[1] <= y1
                 and (c[0] in (x0, x1) or c[1] in (y0, y1))]
    assert on_border == [(dx, dy)]


def _check_lockedroom(p, g, pos, d):
    obj = g[..., 0]
    doors = {tuple(map(int, c)) for c in np.argwhere(obj == jmg.DOOR)}
    assert doors == {(7, 3), (7, 9), (7, 15), (11, 3), (11, 9), (11, 15)}
    locked = [c for c in doors if g[c][2] == jmg.LOCKED]
    assert len(locked) == 1 and len({int(g[c][1]) for c in doors}) == 6
    goal, key = _one(g, jmg.GOAL), _one(g, jmg.KEY)
    assert g[key][1] == g[locked[0]][1]
    room_of = lambda x, y: (0 if x < 7 else 1, (y - 1) // 6)  # noqa: E731
    lx, ly = locked[0]
    locked_room = (0 if lx == 7 else 1, (ly - 3) // 6)
    assert room_of(*goal) == locked_room and room_of(*key) != locked_room
    assert 7 < pos[0] < 11 and 0 < pos[1] < 18 and obj[pos[0], pos[1]] == jmg.EMPTY


def _check_redblue(p, g, pos, d):
    size = p.height
    lx, rx = size // 2, size // 2 + size - 1
    obj = g[..., 0]
    doors = np.argwhere(obj == jmg.DOOR)
    assert len(doors) == 2 and {int(x) for x, _ in doors} == {lx, rx}
    red = tuple(int(v) for v in doors[doors[:, 0] == lx][0])
    blue = tuple(int(v) for v in doors[doors[:, 0] == rx][0])
    assert tuple(g[red]) == (jmg.DOOR, jmg.RED, jmg.CLOSED)
    assert tuple(g[blue]) == (jmg.DOOR, jmg.BLUE, jmg.CLOSED)
    for x, (_, dy) in ((lx, red), (rx, blue)):
        assert ((obj[x] == jmg.WALL) | (np.arange(size) == dy)).all()
    assert lx < pos[0] < rx and 1 <= pos[1] <= size - 2 and obj[pos[0], pos[1]] == jmg.EMPTY


CHECKS = {
    "fourrooms": _check_fourrooms, "lavagap": _check_lavagap, "distshift": _check_distshift,
    "multiroom": _check_multiroom, "crossing": _check_crossing, "dynobs": _check_dynobs,
    "unlock": _check_unlock, "keycorridor": _check_keycorridor,
    "lockedroom": _check_lockedroom, "redblue": _check_redblue,
}


@pytest.mark.parametrize("env_id", FAMILY_IDS)
def test_reset_invariants(env_id):
    p, grids, pos, dirs = _resets(env_id)
    for i in range(grids.shape[0]):
        CHECKS[p.kind](p, grids[i], pos[i], int(dirs[i]))
    assert set(dirs.tolist()) <= {0, 1, 2, 3}
    if p.kind in ("fourrooms", "multiroom", "redblue", "lockedroom", "unlock", "keycorridor"):
        assert len(set(dirs.tolist())) == 4  # random start directions
    if p.kind != "distshift":  # the only deterministic layout
        assert len({g.tobytes() for g in grids}) > 1


def test_reset_bank_is_a_rollout_of_fresh_states():
    """``prepare_resets`` makes T·N fresh states; step t takes its N by a
    view, the bank is dropped after the last, and a step without a bank
    draws its own. Both keep same-step autoreset."""
    env = TorchVectorEnv("MiniGrid-KeyCorridorS3R1-v0", 3, "cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    vs, _ = env.reset_fn(gen)
    vs = env.prepare_resets(vs, 4, gen)
    bank = vs.reset_bank
    assert bank.grid.shape == (12, 7, 3, 3)
    for t in range(4):
        # pickup facing nothing: nobody terminates, except by truncation
        vs.env.step_count[:] = env.params.max_steps - 1 if t == 2 else 0
        nxt, *_, info = env.step_fn(vs, torch.full((3,), jmg.A_DONE), gen)
        if t == 2:
            assert info["done_mask"].all()
            np.testing.assert_array_equal(nxt.env.grid.numpy(), bank.grid[6:9].numpy())
            np.testing.assert_array_equal(nxt.env.agent_pos.numpy(), bank.agent_pos[6:9].numpy())
        else:
            assert not info["done_mask"].any()
        assert (nxt.reset_bank is None) == (t == 3) and nxt.reset_step == (t + 1) % 4
        vs = nxt
    vs.env.step_count[:] = env.params.max_steps - 1
    nxt, *_, info = env.step_fn(vs, torch.full((3,), jmg.A_DONE), gen)
    assert info["done_mask"].all() and nxt.reset_bank is None
    assert (nxt.env.step_count == 0).all()


# ---------------------------------------------------------------------------
# Transitions against the JAX package
# ---------------------------------------------------------------------------


def _face(g, target, allow=(jmg.EMPTY,)):
    """(pos, dir) of a cell from which the agent faces ``target``, or None."""
    for d, (dx, dy) in enumerate(DIRS):
        x, y = target[0] - dx, target[1] - dy
        if 0 <= x < g.shape[0] and 0 <= y < g.shape[1] and g[x, y, 0] in allow:
            return np.array([x, y]), d
    return None


def _find(g, obj, color=None):
    cells = [tuple(c) for c in np.argwhere(g[..., 0] == obj).tolist()
             if color is None or g[c[0], c[1], 1] == color]
    return cells[0] if cells else None


def _craft(kind, p, g):
    """Crafted mid-episode states of one reset grid ``g``: a list of
    (grid, pos, dir, carrying, scripted actions)."""
    out = []
    none = np.zeros(3, np.int8)

    def facing(grid, target, actions, carrying=none):
        f = _face(grid, target)
        if f is not None:
            out.append((grid, f[0], f[1], np.asarray(carrying, np.int8), actions))

    goal = _find(g, jmg.GOAL)
    if goal is not None:
        facing(g.copy(), goal, [jmg.A_FORWARD])
    lava = _find(g, jmg.LAVA)
    if lava is not None:
        facing(g.copy(), lava, [jmg.A_FORWARD])
    if kind == "dynobs":
        facing(g.copy(), _find(g, jmg.BALL), [jmg.A_FORWARD])  # a ball collision
    if kind in ("unlock", "keycorridor", "lockedroom"):
        door = tuple(np.argwhere((g[..., 0] == jmg.DOOR) & (g[..., 2] == jmg.LOCKED))[0])
        key = _find(g, jmg.KEY)
        gk = g.copy()
        if key is not None:
            gk[key] = [jmg.EMPTY, 0, 0]
        facing(gk, door, [jmg.A_TOGGLE, jmg.A_TOGGLE, jmg.A_TOGGLE],
               [jmg.KEY, g[door][1], 0])  # unlock, close, open
        if key is not None:
            facing(g.copy(), key, [jmg.A_PICKUP])
    if kind == "unlock":
        if p.blocked_door:
            facing(g.copy(), (4, int(np.argwhere(g[5, :, 0] == jmg.DOOR)[0][0])),
                   [jmg.A_PICKUP])  # lift the blocker (not the target)
        box = _find(g, jmg.BOX)
        if box is not None:
            # pickup_box: lift the box; key_in_box: toggle it open first
            facing(g.copy(), box, [jmg.A_TOGGLE, jmg.A_PICKUP] if p.key_in_box
                   else [jmg.A_PICKUP])
        target = _find(g, jmg.BALL, jmg.BLUE)
        if target is not None and p.success == "pickup_ball":
            facing(g.copy(), target, [jmg.A_PICKUP])
    if kind == "keycorridor":
        # the locked door open, the agent in its doorway (S3's rooms are
        # one cell) facing the ball
        go = g.copy()
        go[door][2] = jmg.OPEN
        f = _face(go, _find(g, jmg.BALL), allow=(jmg.EMPTY, jmg.DOOR))
        out.append((go, f[0], f[1], none, [jmg.A_PICKUP]))
    if kind == "redblue":
        red, blue = _find(g, jmg.DOOR, jmg.RED), _find(g, jmg.DOOR, jmg.BLUE)
        facing(g.copy(), blue, [jmg.A_TOGGLE])             # blue first: fails
        gr = g.copy()
        gr[red][2] = jmg.OPEN
        facing(gr, blue, [jmg.A_TOGGLE])                   # red open, then blue: wins
        gb = g.copy()
        gb[blue][2] = jmg.OPEN
        facing(gb, red, [jmg.A_TOGGLE])                    # blue already open: ends
        facing(g.copy(), red, [jmg.A_TOGGLE, jmg.A_TOGGLE])  # red alone: open, close
    return out


STEP_CASES = [  # one compile of the JAX step and observe each
    "MiniGrid-FourRooms-v0", "MiniGrid-LavaGapS5-v0", "MiniGrid-DistShift2-v0",
    "MiniGrid-MultiRoom-N4-S5-v0", "MiniGrid-LavaCrossingS9N2-v0",
    "MiniGrid-Dynamic-Obstacles-6x6-v0", "MiniGrid-Unlock-v0", "MiniGrid-BlockedUnlockPickup-v0",
    "MiniGrid-ObstructedMaze-1Dlhb-v1", "MiniGrid-KeyCorridorS3R2-v0",
    "MiniGrid-LockedRoom-v0", "MiniGrid-RedBlueDoors-6x6-v0",
]


def _jax_states(grid, pos, dirs, carrying, step_count, seed):
    n = grid.shape[0]
    return jmg.EnvState(
        grid=jnp.asarray(grid), agent_pos=jnp.asarray(pos, jnp.int32),
        agent_dir=jnp.asarray(dirs, jnp.int32), carrying=jnp.asarray(carrying),
        step_count=jnp.asarray(step_count, jnp.int32),
        rng=jax.random.split(jax.random.PRNGKey(seed), n),
        target=jnp.zeros((n, 8), jnp.int32), instr=jnp.zeros((n, 4, 12), jnp.int32),
        instr_state=jnp.zeros((n, 4, 2), jnp.int32))


def _jax_gumbels(n_obstacles):
    """The [N, n_obstacles, 9] Gumbel draws of the JAX step's ball moves:
    ``rng, k_all = split(state.rng)``, one key of ``split(k_all, n)`` per
    ball, ``jax.random.categorical``'s gumbel over its 9 cells."""
    def one(key):
        _, k_all = jax.random.split(key)
        return jnp.stack([jax.random.gumbel(k, (9,), jnp.float32)
                          for k in jax.random.split(k_all, n_obstacles)])

    return jax.jit(jax.vmap(one))


def _assert_state_equal(ts, js, t):
    js = jax.tree_util.tree_map(np.asarray, js)
    for name in ("grid", "agent_pos", "agent_dir", "carrying", "step_count"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), getattr(js, name),
                                      err_msg=f"{name} after step {t}")


def _assert_rewards_equal(got, want, t):
    """Rewards 0 and −1 equal; the time-scaled ``1 - 0.9·c/max_steps``
    within 2^-23, one float32 ulp of 1.0. The port rounds ``1 - c·k``
    once (exact in float64, the same on the CPU and the GPU); the JAX
    package's compiled step rounds it once where XLA contracts the
    multiply-subtract into a fused one, and twice, the product ``c·k``
    first, where it does not, which varies by family."""
    fixed = want <= 0
    np.testing.assert_array_equal(got[fixed], want[fixed], err_msg=f"reward {t}")
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -23, err_msg=f"reward {t}")


@pytest.mark.parametrize("env_id", STEP_CASES)
def test_step_and_observe_equal(env_id):
    tp, jp = tmg.parse_env_id(env_id), jmg.parse_env_id(env_id)
    gen = torch.Generator()
    gen.manual_seed(5)
    fresh = tmg.reset(tp, 6, gen, "cpu")
    grids, pos = list(fresh.grid.numpy()), list(fresh.agent_pos.numpy())
    dirs, carry = list(fresh.agent_dir.numpy()), [np.zeros(3, np.int8)] * 6
    steps, scripted = [0] * 6, {}
    crafted = [c for g in grids[:3] for c in _craft(tp.kind, tp, g)]
    assert crafted, env_id
    for k, (cg, cp, cd, cc, actions) in enumerate(crafted):
        scripted[len(grids)] = actions
        grids.append(cg), pos.append(cp), dirs.append(cd), carry.append(cc)
        steps.append(tp.max_steps - 3 if k == 0 else tp.max_steps // 2)  # one truncates
    n = len(grids)
    js = _jax_states(np.stack(grids), np.stack(pos), np.array(dirs), np.stack(carry),
                     np.array(steps), seed=1)
    ts = convert.env_state(jax.tree_util.tree_map(np.asarray, js))  # carried across
    rng = np.random.RandomState(0)
    actions = rng.randint(0, jp.num_actions + (jp.kind == "dynobs"), size=(STEPS, n))
    for i, seq in scripted.items():
        actions[:len(seq), i] = seq
    jstep = jax.jit(jax.vmap(jmg.step, in_axes=(None, 0, 0)), static_argnums=0)
    jobs = jax.jit(jax.vmap(jmg.observe, in_axes=(None, 0)), static_argnums=0)
    gumbels = _jax_gumbels(tp.n_obstacles) if tp.kind == "dynobs" else None
    won = terminated_any = False
    for t in range(STEPS):
        np.testing.assert_array_equal(tmg.observe(tp, ts).numpy(), np.asarray(jobs(jp, js)),
                                      err_msg=f"view before step {t}")
        a = actions[t]
        draws = None if gumbels is None else torch.as_tensor(np.array(gumbels(js.rng)))
        js, jr, jterm, jtrunc = jstep(jp, js, jnp.asarray(a, jnp.int32))
        ts, tr, tterm, ttrunc = tmg.step(tp, ts, torch.as_tensor(a), gumbels=draws)
        _assert_rewards_equal(tr.numpy(), np.asarray(jr), t)
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm), err_msg=f"term {t}")
        np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc), err_msg=f"trunc {t}")
        _assert_state_equal(ts, js, t)
        won |= bool((tr.numpy() > 0).any())
        terminated_any |= bool(tterm.numpy().any())
    np.testing.assert_array_equal(tmg.observe(tp, ts).numpy(), np.asarray(jobs(jp, js)))
    jax.clear_caches()  # each case's executables hold ~500 memory maps until freed
    assert terminated_any and won  # a crafted state reached the family's success


def test_dynobs_moves_see_the_post_move_grid():
    """The view after a Dynamic-Obstacles step is of the grid after the
    balls moved (the rollout's view trunk reads it), and the balls do move."""
    p = tmg.parse_env_id("MiniGrid-Dynamic-Obstacles-8x8-v0")
    gen = torch.Generator()
    gen.manual_seed(2)
    st = tmg.reset(p, 16, gen, "cpu")
    nxt, *_ = tmg.step(p, st, torch.zeros(16, dtype=torch.long), gen=gen)
    assert not torch.equal(nxt.grid, st.grid)
    assert ((nxt.grid[..., 0] == tmg.BALL).sum((1, 2)) == p.n_obstacles).all()
    env = TorchVectorEnv("MiniGrid-Dynamic-Obstacles-8x8-v0", 16, "cpu")
    assert env.num_actions == 3
    from clip_ppo_tpu_torch.envs.vector import VecState

    vs = VecState(st, torch.zeros(16), torch.zeros(16, dtype=torch.int32))
    draws = tmg.obstacle_gumbels(p, 16, gen, "cpu")
    new, view, *_ = env.step_fn(vs, torch.zeros(16, dtype=torch.long), gen, small_obs=True,
                                draws=draws)
    moved, *_ = tmg.step(p, st, torch.zeros(16, dtype=torch.long), gumbels=draws)
    np.testing.assert_array_equal(view.numpy(), tmg.observe(p, moved).numpy())
