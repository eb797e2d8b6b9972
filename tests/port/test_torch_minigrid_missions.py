"""The port's mission families, Memory, Playground and the full
ObstructedMaze against the JAX package's.

The 27 ids of ObstructedMaze-2Dl{,h,hb}/1Q/2Q/Full, Memory, Playground,
GoToDoor, Fetch, GoToObject and PutNear parse to the JAX package's
``EnvParams`` on every field the port has. Resets draw from different
generators in the two packages, so the port's resets are held to the
invariants the JAX package's tests pin (``tests/test_mission_envs.py``,
``test_lockedroom_memory.py``, ``test_obstructedmaze_full.py``), the mission
``target`` included. Transitions are held for equality, id by id: states
from the port's resets, with crafted states appended for each success and
failure mode (``done`` next to the target door and elsewhere, a toggle,
Fetch's right and wrong pickups, PutNear's near, far and failed drops and
its wrong pickup, Memory's two fork cells and its pickup remap,
ObstructedMaze's target and non-target balls), are carried into the JAX
package, and both step them 24 times with the same actions; observations,
rewards, flags and next states, ``target`` included, must be EQUAL, the
time-scaled rewards within 2^-23. The JAX step and observe run eagerly
under ``vmap``: their primitives compile once per shape, which costs less
than a whole-graph compile per id, and no JAX reset runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.envs.minigrid import core as jmg
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.cli import ppo_minigrid as tcli
from clip_ppo_tpu_torch.envs.minigrid import core as tmg
from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
from clip_ppo_tpu_torch.utils import flags
from test_torch_minigrid_families import _face, _find

MISSION_IDS = [
    "MiniGrid-ObstructedMaze-2Dl-v0", "MiniGrid-ObstructedMaze-2Dlh-v0",
    "MiniGrid-ObstructedMaze-2Dlhb-v0", "MiniGrid-ObstructedMaze-2Dlhb-v1",
    "MiniGrid-ObstructedMaze-1Q-v0", "MiniGrid-ObstructedMaze-1Q-v1",
    "MiniGrid-ObstructedMaze-2Q-v0", "MiniGrid-ObstructedMaze-2Q-v1",
    "MiniGrid-ObstructedMaze-Full-v0", "MiniGrid-ObstructedMaze-Full-v1",
    "MiniGrid-MemoryS7-v0", "MiniGrid-MemoryS9-v0", "MiniGrid-MemoryS11-v0",
    "MiniGrid-MemoryS13-v0", "MiniGrid-MemoryS13Random-v0", "MiniGrid-MemoryS17Random-v0",
    "MiniGrid-Playground-v0",
    "MiniGrid-GoToDoor-5x5-v0", "MiniGrid-GoToDoor-6x6-v0", "MiniGrid-GoToDoor-8x8-v0",
    "MiniGrid-Fetch-5x5-N2-v0", "MiniGrid-Fetch-6x6-N2-v0", "MiniGrid-Fetch-8x8-N3-v0",
    "MiniGrid-GoToObject-6x6-N2-v0", "MiniGrid-GoToObject-8x8-N2-v0",
    "MiniGrid-PutNear-6x6-N2-v0", "MiniGrid-PutNear-8x8-N3-v0",
]
STEPS = 24
DIRS = jmg.DIR_TO_VEC
SIDE = ((2, 1), (1, 2), (0, 1), (1, 0))
CORNER = ((2, 0), (2, 2), (0, 2), (0, 0))
NONE = np.zeros(3, np.int8)


def test_mission_ids_are_registered_and_parse():
    from tests.test_registry_matrix import REGISTERED

    assert len(set(MISSION_IDS)) == 27 and set(MISSION_IDS) <= set(REGISTERED)
    for env_id in MISSION_IDS:
        tmg.parse_env_id(env_id)


@pytest.mark.parametrize("env_id", MISSION_IDS)
def test_parse_matches_jax(env_id):
    tp, jp = tmg.parse_env_id(env_id), jmg.parse_env_id(env_id)
    for f in dataclasses.fields(tp):
        assert getattr(tp, f.name) == getattr(jp, f.name), f.name


# ---------------------------------------------------------------------------
# Reset invariants
# ---------------------------------------------------------------------------


def _room_of(x, y):
    return (x // 5, y // 5)


def _check_obstructedfull(p, g, pos, d, t):
    q = p.min_rooms
    obj = g[..., 0]
    doors = [tuple(map(int, c)) for c in np.argwhere(obj == jmg.DOOR)]
    locked = [c for c in doors if g[c][2] == jmg.LOCKED]
    assert len(doors) == 3 * q and len(locked) == 2 * q
    # the middle room's doors: wall i of room (1, 1), CLOSED, distinct colors
    middle = {}
    for c in doors:
        if g[c][2] != jmg.LOCKED:
            x, y = c
            wall = (0 if x == 10 else 2 if x == 5 else 1 if y == 10 else 3)
            assert 5 <= x <= 10 and 5 <= y <= 10 and g[c][2] == jmg.CLOSED
            middle[wall] = int(g[c][1])
    assert sorted(middle) == list(range(q)) and len(set(middle.values())) == q
    # side room i's locked doors on walls (i ± 1) % 4, colored (i ± 1) % 6
    # of the permutation whose first q entries color the middle doors
    for i in range(q):
        si, sj = SIDE[i]
        for k in (-1, 1):
            wall = (i + k) % 4
            x0, y0 = si * 5, sj * 5
            on_wall = [c for c in locked if (
                (wall == 0 and c[0] == x0 + 5 and y0 < c[1] < y0 + 5)
                or (wall == 2 and c[0] == x0 and y0 < c[1] < y0 + 5)
                or (wall == 1 and c[1] == y0 + 5 and x0 < c[0] < x0 + 5)
                or (wall == 3 and c[1] == y0 and x0 < c[0] < x0 + 5))]
            assert len(on_wall) == 1, (i, wall)
            color = int(g[on_wall[0]][1])
            j = (i + k) % 6
            if j < q:
                assert color == middle[j]
            else:
                assert color not in middle.values()
            if p.blocked_door:
                bx, by = on_wall[0][0] - DIRS[wall][0], on_wall[0][1] - DIRS[wall][1]
                assert obj[bx, by] == jmg.BALL and g[bx, by, 1] != jmg.BLUE
                assert _room_of(bx, by) == (si, sj)
    blue = np.argwhere((obj == jmg.BALL) & (g[..., 1] == jmg.BLUE))
    assert len(blue) == 1 and _room_of(*map(int, blue[0])) in CORNER[:q]
    locked_colors = {int(g[c][1]) for c in locked}
    keys = np.argwhere(obj == (jmg.BOX if p.key_in_box else jmg.KEY))
    assert len(keys) == 2 * q and not (obj == (jmg.KEY if p.key_in_box else jmg.BOX)).any()
    for kx, ky in keys:
        assert _room_of(int(kx), int(ky)) in SIDE[:q]
        color = int(g[kx, ky, 2]) - 1 if p.key_in_box else int(g[kx, ky, 1])
        assert color in locked_colors
    if not p.blocked_door:
        assert (obj == jmg.BALL).sum() == 1
    assert _room_of(*pos) == p.agent_room and obj[pos[0], pos[1]] == jmg.EMPTY
    assert not t.any()


def _check_playground(p, g, pos, d, t):
    obj = g[..., 0]
    doors = np.argwhere(obj == jmg.DOOR)
    assert len(doors) == 12 and (g[obj == jmg.DOOR, 2] == jmg.CLOSED).all()
    segments = set()
    for x, y in doors:
        assert (int(x) in (6, 12)) != (int(y) in (6, 12))
        segments.add((int(x), int(y) // 6) if int(x) in (6, 12) else (int(x) // 6, int(y)))
    assert len(segments) == 12  # one door a wall segment
    assert np.isin(obj, [jmg.KEY, jmg.BALL, jmg.BOX]).sum() == 12
    assert obj[pos[0], pos[1]] == jmg.EMPTY and not t.any()


def _check_memory(p, g, pos, d, t):
    obj = g[..., 0]
    mid = p.height // 2
    sx, sy, fx, fy = map(int, t[:4])
    assert not t[4:].any()
    hallway_end = sx - 1
    if p.random_length:
        assert 4 <= hallway_end <= p.width - 3
    else:
        assert hallway_end == p.width - 3
    assert obj[1, mid - 1] in (jmg.KEY, jmg.BALL)
    top, bot = obj[sx, mid - 2], obj[sx, mid + 2]
    assert {int(top), int(bot)} == {jmg.KEY, jmg.BALL}
    assert (g[[1, sx, sx], [mid - 1, mid - 2, mid + 2], 1] == jmg.GREEN).all()
    assert fx == sx and {sy, fy} == {mid - 1, mid + 1}
    match_y = mid - 2 if obj[1, mid - 1] == top else mid + 2
    assert abs(sy - match_y) == 1
    # the vertical wall at hallway_end, open only on the middle row
    assert all((obj[hallway_end, y] == jmg.WALL) == (y != mid) for y in range(p.height))
    assert pos[1] == mid and 1 <= pos[0] <= hallway_end and d == 0


def _check_gotodoor(p, g, pos, d, t):
    obj = g[..., 0]
    rw = 1 + max(x for x in range(p.width) if obj[x, 0] in (jmg.WALL, jmg.DOOR))
    rh = 1 + max(y for y in range(p.height) if obj[0, y] in (jmg.WALL, jmg.DOOR))
    assert 5 <= rw <= p.width and 5 <= rh <= p.height
    doors = [tuple(map(int, c)) for c in np.argwhere(obj == jmg.DOOR)]
    assert len(doors) == 4 and len({int(g[c][1]) for c in doors}) == 4
    sides = set()
    for x, y in doors:
        assert g[x, y, 2] == jmg.CLOSED
        if y in (0, rh - 1):
            assert 2 <= x <= rw - 3
            sides.add("top" if y == 0 else "bottom")
        else:
            assert x in (0, rw - 1) and 2 <= y <= rh - 3
            sides.add("left" if x == 0 else "right")
    assert sides == {"top", "bottom", "left", "right"}
    assert t[0] == jmg.DOOR and obj[t[2], t[3]] == jmg.DOOR and g[t[2], t[3], 1] == t[1]
    assert not t[4:].any()
    assert 1 <= pos[0] <= rw - 2 and 1 <= pos[1] <= rh - 2
    assert (obj[rw:, :] == jmg.EMPTY).all() and (obj[:, rh:] == jmg.EMPTY).all()


def _objects(g):
    return [tuple(map(int, c)) for c in np.argwhere(np.isin(g[..., 0], [jmg.KEY, jmg.BALL,
                                                                           jmg.BOX]))]


def _check_fetch(p, g, pos, d, t):
    objs = _objects(g)
    assert len(objs) == p.num_objs and all(g[c][0] in (jmg.KEY, jmg.BALL) for c in objs)
    assert t[0] in (jmg.KEY, jmg.BALL) and 0 <= t[1] < 6 and not t[2:].any()
    assert any((g[c][0], g[c][1]) == (t[0], t[1]) for c in objs)
    assert g[pos[0], pos[1], 0] == jmg.EMPTY


def _check_gotoobject(p, g, pos, d, t):
    objs = _objects(g)
    assert len(objs) == p.num_objs
    assert len({(int(g[c][0]), int(g[c][1])) for c in objs}) == p.num_objs  # distinct pairs
    assert g[t[2], t[3], 0] == t[0] and g[t[2], t[3], 1] == t[1] and not t[4:].any()
    assert g[pos[0], pos[1], 0] == jmg.EMPTY


def _check_putnear(p, g, pos, d, t):
    objs = _objects(g)
    assert len(objs) == p.num_objs
    assert len({(int(g[c][0]), int(g[c][1])) for c in objs}) == p.num_objs
    for a in objs:
        for b in objs:
            if a != b:
                assert max(abs(a[0] - b[0]), abs(a[1] - b[1])) > 1
    assert g[t[4], t[5], 0] == t[2] and g[t[4], t[5], 1] == t[3] and not t[6:].any()
    assert any((g[c][0], g[c][1]) == (t[0], t[1]) for c in objs)
    assert (t[0], t[1]) != (t[2], t[3])
    assert g[pos[0], pos[1], 0] == jmg.EMPTY


CHECKS = {
    "obstructedfull": _check_obstructedfull, "playground": _check_playground,
    "memory": _check_memory, "gotodoor": _check_gotodoor, "fetch": _check_fetch,
    "gotoobject": _check_gotoobject, "putnear": _check_putnear,
}


@pytest.mark.parametrize("env_id", MISSION_IDS)
def test_reset_invariants(env_id):
    p = tmg.parse_env_id(env_id)
    gen = torch.Generator()
    gen.manual_seed(0)
    st = tmg.reset(p, 48, gen, "cpu")
    grids, pos, dirs, targets = (st.grid.numpy(), st.agent_pos.numpy(), st.agent_dir.numpy(),
                                 st.target.numpy())
    assert st.target.dtype == torch.int32 and st.target.shape == (48, 8)
    for i in range(grids.shape[0]):
        CHECKS[p.kind](p, grids[i], tuple(int(v) for v in pos[i]), int(dirs[i]), targets[i])
    assert len({g.tobytes() for g in grids}) > 1
    if p.kind != "memory":
        assert len(set(dirs.tolist())) == 4  # random start directions
    if p.kind in ("gotodoor", "fetch", "gotoobject", "putnear") or p.random_length:
        assert len({tuple(r) for r in targets.tolist()}) > 1  # the mission varies
    if p.kind == "gotodoor" and p.width > 5:
        # the room's width and height are drawn per episode
        assert len({int((grids[i][:, 0, 0] != jmg.EMPTY).sum()) for i in range(48)}) > 1


def test_earlier_families_hold_zero_targets():
    for env_id in ("MiniGrid-Empty-5x5-v0", "MiniGrid-KeyCorridorS3R1-v0",
                   "MiniGrid-ObstructedMaze-1Dlhb-v1"):
        gen = torch.Generator()
        gen.manual_seed(0)
        st = tmg.reset(tmg.parse_env_id(env_id), 4, gen, "cpu")
        assert st.target.shape == (4, 8) and not st.target.any()


def test_autoreset_carries_the_fresh_target():
    """A done env takes its fresh state's ``target`` from the rollout's
    reset bank (``select``/``take`` run over every field); the others keep
    theirs."""
    env = TorchVectorEnv("MiniGrid-Fetch-8x8-N3-v0", 4, "cpu")
    gen = torch.Generator()
    gen.manual_seed(1)
    vs, _ = env.reset_fn(gen)
    vs = env.prepare_resets(vs, 3, gen)
    bank = vs.reset_bank
    vs.env.step_count[:] = torch.tensor([env.params.max_steps - 1, 0, env.params.max_steps - 1, 0],
                                        dtype=torch.int32)
    before = vs.env.target.clone()
    nxt, *_, info = env.step_fn(vs, torch.full((4,), jmg.A_LEFT), gen)
    assert info["done_mask"].tolist() == [True, False, True, False]
    np.testing.assert_array_equal(nxt.env.target[[0, 2]].numpy(), bank.target[[0, 2]].numpy())
    np.testing.assert_array_equal(nxt.env.target[[1, 3]].numpy(), before[[1, 3]].numpy())


# ---------------------------------------------------------------------------
# Transitions against the JAX package
# ---------------------------------------------------------------------------


def _face_from(g, cell, avoid=None):
    """(pos, dir) of an EMPTY cell facing ``cell``, other than ``avoid``."""
    for d, (dx, dy) in enumerate(DIRS):
        x, y = cell[0] - dx, cell[1] - dy
        if (0 <= x < g.shape[0] and 0 <= y < g.shape[1] and g[x, y, 0] == jmg.EMPTY
                and (x, y) != avoid):
            return np.array([x, y]), d
    return None


def _craft(p, g, t):
    """Crafted states of one reset grid ``g`` and target ``t``: a list of
    (grid, pos, dir, carrying, target, scripted actions)."""
    out = []

    def facing(grid, cell, actions, carrying=NONE, target=t):
        f = _face(grid, cell)
        if f is not None:
            out.append((grid, f[0], f[1], np.asarray(carrying, np.int8), target, actions))

    kind = p.kind
    if kind == "gotodoor":
        obj = g[..., 0]
        rw = 1 + max(x for x in range(p.width) if obj[x, 0] in (jmg.WALL, jmg.DOOR))
        rh = 1 + max(y for y in range(p.height) if obj[0, y] in (jmg.WALL, jmg.DOOR))
        tx, ty = int(t[2]), int(t[3])
        facing(g.copy(), (tx, ty), [jmg.A_DONE])      # done next to the target door
        facing(g.copy(), (tx, ty), [jmg.A_TOGGLE])    # a toggle ends it with 0
        far = max(((x, y) for x in range(1, rw - 1) for y in range(1, rh - 1)),
                  key=lambda c: abs(c[0] - tx) + abs(c[1] - ty))
        out.append((g.copy(), np.array(far), 0, NONE, t, [jmg.A_DONE]))  # done elsewhere
        other = [tuple(map(int, c)) for c in np.argwhere(obj == jmg.DOOR)
                 if tuple(map(int, c)) != (tx, ty)]
        facing(g.copy(), other[0], [jmg.A_DONE])      # done next to another door
    if kind == "fetch":
        objs = _objects(g)
        right = [c for c in objs if (g[c][0], g[c][1]) == (t[0], t[1])]
        facing(g.copy(), right[0], [jmg.A_PICKUP])    # the mission's object
        wrong_t = t.copy()
        wrong_t[0] = jmg.BALL if g[objs[0]][0] == jmg.KEY else jmg.KEY
        facing(g.copy(), objs[0], [jmg.A_PICKUP], target=wrong_t)  # another object
    if kind == "gotoobject":
        tpos = (int(t[2]), int(t[3]))
        facing(g.copy(), tpos, [jmg.A_DONE])          # done next to the target
        facing(g.copy(), tpos, [jmg.A_TOGGLE])        # a toggle ends it with 0
        free = [tuple(map(int, c)) for c in np.argwhere(g[..., 0] == jmg.EMPTY)
                if max(abs(c[0] - tpos[0]), abs(c[1] - tpos[1])) > 1]
        out.append((g.copy(), np.array(free[0]), 0, NONE, t, [jmg.A_DONE]))  # done far away
    if kind == "putnear":
        near = (int(t[4]), int(t[5]))
        move = next(c for c in _objects(g) if (g[c][0], g[c][1]) == (t[0], t[1]))
        facing(g.copy(), move, [jmg.A_PICKUP])        # the move object: no termination
        facing(g.copy(), near, [jmg.A_PICKUP])        # the wrong object: ends with 0
        held = g.copy()
        held[move] = [jmg.EMPTY, 0, 0]
        carry = np.array([t[0], t[1], 0], np.int8)
        empty = [tuple(map(int, c)) for c in np.argwhere(held[..., 0] == jmg.EMPTY)]
        cheb = lambda c: max(abs(c[0] - near[0]), abs(c[1] - near[1]))  # noqa: E731
        for cells in ([c for c in empty if cheb(c) <= 1], [c for c in empty if cheb(c) > 1]):
            for c in cells:  # the near drop, then a far one
                f = _face_from(held, c)
                if f is not None:
                    out.append((held.copy(), f[0], f[1], carry, t, [jmg.A_DROP]))
                    break
        f = next(f for f in (_face_from(held, (0, y)) for y in range(1, p.height - 1))
                 if f is not None)                    # a drop onto the wall fails
        out.append((held.copy(), f[0], f[1], carry, t, [jmg.A_DROP]))
    if kind == "memory":
        mid = p.height // 2
        sx, sy, fy = int(t[0]), int(t[1]), int(t[3])
        for y in (sy, fy):                            # the success cell, the failure cell
            out.append((g.copy(), np.array([sx, mid]), 3 if y < mid else 1, NONE, t,
                        [jmg.A_FORWARD]))
        # pickup facing the start room's object is a toggle: nothing lifted
        out.append((g.copy(), np.array([1, mid]), 3, NONE, t, [jmg.A_PICKUP, jmg.A_PICKUP]))
        # pickup at the failure cell facing its object
        out.append((g.copy(), np.array([sx, fy]), 3 if fy < mid else 1, NONE, t,
                    [jmg.A_PICKUP]))
    if kind == "obstructedfull":
        blue = _find(g, jmg.BALL, jmg.BLUE)
        facing(g.copy(), blue, [jmg.A_PICKUP])        # the target ball
        others = [c for c in np.argwhere(g[..., 0] == jmg.BALL).tolist()
                  if g[c[0], c[1], 1] != jmg.BLUE]
        for c in others[:2]:                          # a blocker: lifted, no termination
            facing(g.copy(), tuple(c), [jmg.A_PICKUP, jmg.A_DROP])
        box = _find(g, jmg.BOX)
        if box is not None:
            facing(g.copy(), box, [jmg.A_TOGGLE, jmg.A_PICKUP])  # the box reveals its key
        key = _find(g, jmg.KEY)
        if key is not None:
            facing(g.copy(), key, [jmg.A_PICKUP])
        door = tuple(np.argwhere((g[..., 0] == jmg.DOOR) & (g[..., 2] == jmg.LOCKED))[0])
        gd = g.copy()
        facing(gd, door, [jmg.A_TOGGLE, jmg.A_TOGGLE], [jmg.KEY, g[door][1], 0])  # unlock, close
    if kind == "playground":
        door = _find(g, jmg.DOOR)
        facing(g.copy(), door, [jmg.A_TOGGLE, jmg.A_FORWARD])
        for c in _objects(g)[:2]:
            facing(g.copy(), c, [jmg.A_PICKUP, jmg.A_LEFT, jmg.A_DROP])
    return out


def _load(path):
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)


def _jax_states(grid, pos, dirs, carrying, step_count, target):
    n = grid.shape[0]
    return jmg.EnvState(
        grid=jnp.asarray(grid), agent_pos=jnp.asarray(pos, jnp.int32),
        agent_dir=jnp.asarray(dirs, jnp.int32), carrying=jnp.asarray(carrying),
        step_count=jnp.asarray(step_count, jnp.int32),
        rng=jax.random.split(jax.random.PRNGKey(0), n), target=jnp.asarray(target, jnp.int32),
        instr=jnp.zeros((n, 4, 12), jnp.int32), instr_state=jnp.zeros((n, 4, 2), jnp.int32))


def release_jax_executables():
    """Drop the JAX executables a case compiled: each id's step and observe
    compile anew, and an XLA CPU executable holds ~500 memory maps until it
    is freed, so a test worker that kept them all would near the kernel's
    per-process limit (``vm.max_map_count``, 65,530), where a later compile
    of the JAX package's own tests fails."""
    jax.clear_caches()


def _assert_rewards_equal(got, want, t):
    """Rewards of 0 equal; the time-scaled ``1 - 0.9·c/max_steps`` within
    2^-23 (see ``test_torch_minigrid_families._assert_rewards_equal``).
    Stepped on past its end without a reset, a state that keeps meeting its
    success (Fetch's carried object) earns the time-scaled reward with
    ``c`` above ``max_steps``, below 0."""
    zero = want == 0
    np.testing.assert_array_equal(got[zero], want[zero], err_msg=f"reward {t}")
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -23, err_msg=f"reward {t}")


def _assert_state_equal(ts, js, t):
    for name in ("grid", "agent_pos", "agent_dir", "carrying", "step_count", "target"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=f"{name} after step {t}")


@pytest.mark.parametrize("env_id", MISSION_IDS)
def test_step_and_observe_equal(env_id):
    tp, jp = tmg.parse_env_id(env_id), jmg.parse_env_id(env_id)
    gen = torch.Generator()
    gen.manual_seed(5)
    fresh = tmg.reset(tp, 6, gen, "cpu")
    grids, pos = list(fresh.grid.numpy()), list(fresh.agent_pos.numpy())
    dirs, carry = list(fresh.agent_dir.numpy()), [NONE] * 6
    targets, steps, scripted = list(fresh.target.numpy()), [0] * 6, {}
    crafted = [c for i in range(3) for c in _craft(tp, grids[i], targets[i])]
    assert crafted, env_id
    for k, (cg, cp, cd, cc, ct, actions) in enumerate(crafted):
        scripted[len(grids)] = actions
        grids.append(cg), pos.append(np.asarray(cp)), dirs.append(cd), carry.append(cc)
        targets.append(ct)
        steps.append(tp.max_steps - 3 if k == 0 else tp.max_steps // 2)  # one truncates
    n = len(grids)
    js = _jax_states(np.stack(grids), np.stack(pos), np.array(dirs), np.stack(carry),
                     np.array(steps), np.stack(targets))
    ts = convert.env_state(jax.tree_util.tree_map(np.asarray, js))  # carried across
    rng = np.random.RandomState(0)
    actions = rng.randint(0, jp.num_actions, size=(STEPS, n))
    for i, seq in scripted.items():
        actions[:len(seq), i] = seq
    jstep = jax.vmap(jmg.step, in_axes=(None, 0, 0))
    jobs = jax.vmap(jmg.observe, in_axes=(None, 0))
    won = terminated_any = False
    for t in range(STEPS):
        np.testing.assert_array_equal(tmg.observe(tp, ts).numpy(), np.asarray(jobs(jp, js)),
                                      err_msg=f"view before step {t}")
        a = actions[t]
        js, jr, jterm, jtrunc = jstep(jp, js, jnp.asarray(a, jnp.int32))
        ts, tr, tterm, ttrunc = tmg.step(tp, ts, torch.as_tensor(a))
        _assert_rewards_equal(tr.numpy(), np.asarray(jr), t)
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm), err_msg=f"term {t}")
        np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc), err_msg=f"trunc {t}")
        _assert_state_equal(ts, js, t)
        won |= bool((tr.numpy() > 0).any())
        terminated_any |= bool(tterm.numpy().any())
        if t == 0:
            first = (tr.numpy()[6:], tterm.numpy()[6:], ts.carrying.numpy()[6:])
    np.testing.assert_array_equal(tmg.observe(tp, ts).numpy(), np.asarray(jobs(jp, js)))
    release_jax_executables()
    if tp.kind == "playground":
        assert not terminated_any and not won  # no reward source, only truncation
    else:
        assert terminated_any and won  # a crafted state reached the family's success
    _check_first_step(tp, crafted, *first)


def _check_first_step(p, crafted, reward, term, carrying):
    """Each crafted mode's first transition did what its mode says."""
    for i, (g, pos, d, c, t, actions) in enumerate(crafted):
        a = actions[0]
        if p.kind == "gotodoor" and a == jmg.A_TOGGLE:
            assert term[i] and reward[i] == 0
        if p.kind == "memory" and a == jmg.A_PICKUP:
            assert carrying[i, 0] == 0  # remapped to toggle: nothing lifted
        if p.kind == "putnear" and a == jmg.A_DROP:
            assert term[i]  # any drop while carrying ends the episode
            if g[pos[0] + DIRS[d][0], pos[1] + DIRS[d][1], 0] == jmg.WALL:
                assert reward[i] == 0 and carrying[i, 0] == t[0]  # the failed drop
        if p.kind == "putnear" and a == jmg.A_PICKUP:
            move = (g[pos[0] + DIRS[d][0], pos[1] + DIRS[d][1], 0],
                    g[pos[0] + DIRS[d][0], pos[1] + DIRS[d][1], 1])
            assert term[i] == (tuple(move) != (t[0], t[1]))
        if p.kind == "obstructedfull" and a == jmg.A_PICKUP:
            fx, fy = pos[0] + DIRS[d][0], pos[1] + DIRS[d][1]
            if g[fx, fy, 0] == jmg.BALL:
                assert term[i] == (g[fx, fy, 1] == jmg.BLUE) and carrying[i, 0] == jmg.BALL


# ---------------------------------------------------------------------------
# State carried across and checkpoints
# ---------------------------------------------------------------------------


def test_convert_carries_target_and_fills_zeros_without_one():
    p = tmg.parse_env_id("MiniGrid-PutNear-8x8-N3-v0")
    gen = torch.Generator()
    gen.manual_seed(3)
    st = tmg.reset(p, 5, gen, "cpu")
    js = _jax_states(st.grid.numpy(), st.agent_pos.numpy(), st.agent_dir.numpy(),
                     st.carrying.numpy(), st.step_count.numpy(), st.target.numpy())
    back = convert.env_state(jax.tree_util.tree_map(np.asarray, js))
    assert back.target.dtype == torch.int32
    np.testing.assert_array_equal(back.target.numpy(), st.target.numpy())

    class Old:  # a state written before the target was carried
        pass

    old = Old()
    for name in ("grid", "agent_pos", "agent_dir", "carrying", "step_count"):
        setattr(old, name, getattr(st, name).numpy())
    filled = convert.env_state(old)
    assert filled.target.shape == (5, 8) and not filled.target.any()


def test_checkpoint_without_target_restores_zeros(tmp_path, monkeypatch):
    """A ``torch_loop_state`` written before the env state carried
    ``target`` resumes with the zeros of every earlier family; the loop
    state of this package carries it."""
    import pickle

    monkeypatch.chdir(tmp_path)
    base = ["--no-cuda", "--num-envs", "2", "--num-steps", "16", "--num-minibatches", "2",
            "--update-epochs", "1", "--total-timesteps", "64", "--save-freq", "32",
            "--no-capture-video", "--model-path", str(tmp_path / "ck")]
    tcli.train(flags.parse(tcli.Args, base + ["--env-id", "MiniGrid-GoToObject-6x6-N2-v0"]),
               run_name="g")
    ck = _load(tmp_path / "ck" / "g_step_32.ckpt")
    assert ck["torch_loop_state"]["vec_state"]["env"]["target"].shape == (2, 8)
    assert ck["torch_loop_state"]["vec_state"]["env"]["target"][:, 0].all()  # a mission
    # an Empty run's checkpoint with the target taken out, as before
    tcli.train(flags.parse(tcli.Args, base + ["--env-id", "MiniGrid-Empty-5x5-v0"]),
               run_name="e")
    ck = _load(tmp_path / "ck" / "e_step_32.ckpt")
    del ck["torch_loop_state"]["vec_state"]["env"]["target"]
    with open(tmp_path / "old.ckpt", "wb") as f:
        pickle.dump(ck, f)
    seen = {}
    real = tcli._with_loop

    def spy(state, loop):
        out = real(state, loop)
        seen["target"] = out.vec_state.env.target.clone()
        return out

    monkeypatch.setattr(tcli, "_with_loop", spy)
    out = tcli.train(flags.parse(tcli.Args, base + ["--env-id", "MiniGrid-Empty-5x5-v0",
                                                    "--resume-checkpoint",
                                                    str(tmp_path / "old.ckpt"),
                                                    "--no-save-model"]), run_name="r")
    assert out["global_step"] == 64
    assert seen["target"].shape == (2, 8) and not seen["target"].any()
