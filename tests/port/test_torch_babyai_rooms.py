"""The port's BabyAI rooms against the JAX package's: the single-room
levels (GoToRedBall{,Grey,NoDists}, GoToRedBlueBall, GoToObj, GoToLocal,
OneRoom, PutNextLocal, PickupDist), the door levels (OpenRedDoor,
OpenDoor[Color|Loc][Debug], ActionObjDoor) and PutNextS{s}N{n}[Carrying].

Each of their 43 ids parses to the JAX package's ``EnvParams`` on every
field the port has, and so do the 27 maze ids of
``test_torch_babyai_mazes`` and the 19 levels of composite instructions
(``test_torch_babyai_seq`` holds their resets and transitions). Resets draw from different generators in
the two packages, so the port's resets are held to the invariants that
``tests/test_babyai_goto.py``, ``test_babyai_open.py`` and the non-seq cases
of ``test_babyai_seq.py`` pin, the mission ``target`` included.
Transitions are held for equality, as in ``test_torch_minigrid_missions``:
states from the port's resets, with crafted states appended for every
success and strict-failure mode, are carried into the JAX package, and both
step them 24 times with the same actions; views, rewards, flags and next
states, ``target`` included, must be EQUAL, the time-scaled rewards within
2^-23. Each crafted state's first transition is also held to what its mode
says (terminated, rewarded), so every mode is reached. The JAX step and
observe run eagerly under ``vmap``, and no JAX reset runs.
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
from test_torch_minigrid_missions import (_assert_rewards_equal, _assert_state_equal, _jax_states,
                                         release_jax_executables)

ROOM_IDS = [
    "BabyAI-GoToRedBallGrey-v0", "BabyAI-GoToRedBall-v0", "BabyAI-GoToRedBallNoDists-v0",
    "BabyAI-GoToRedBlueBall-v0",
    "BabyAI-GoToObjS4-v0", "BabyAI-GoToObjS6-v0", "BabyAI-GoToObj-v0",
    "BabyAI-GoToLocalS5N2-v0", "BabyAI-GoToLocalS6N2-v0", "BabyAI-GoToLocalS6N3-v0",
    "BabyAI-GoToLocalS6N4-v0", "BabyAI-GoToLocalS7N4-v0", "BabyAI-GoToLocalS7N5-v0",
    "BabyAI-GoToLocalS8N2-v0", "BabyAI-GoToLocalS8N3-v0", "BabyAI-GoToLocalS8N4-v0",
    "BabyAI-GoToLocalS8N5-v0", "BabyAI-GoToLocalS8N6-v0", "BabyAI-GoToLocalS8N7-v0",
    "BabyAI-GoToLocal-v0",
    "BabyAI-OneRoomS8-v0", "BabyAI-OneRoomS12-v0", "BabyAI-OneRoomS16-v0",
    "BabyAI-OneRoomS20-v0",
    "BabyAI-PutNextLocalS5N3-v0", "BabyAI-PutNextLocalS6N4-v0", "BabyAI-PutNextLocal-v0",
    "BabyAI-PickupDist-v0", "BabyAI-PickupDistDebug-v0",
    "BabyAI-OpenRedDoor-v0", "BabyAI-OpenDoor-v0", "BabyAI-OpenDoorDebug-v0",
    "BabyAI-OpenDoorColor-v0", "BabyAI-OpenDoorLoc-v0",
    "BabyAI-ActionObjDoor-v0",
    "BabyAI-PutNextS4N1-v0", "BabyAI-PutNextS5N1-v0", "BabyAI-PutNextS5N2-v0",
    "BabyAI-PutNextS6N3-v0", "BabyAI-PutNextS7N4-v0", "BabyAI-PutNextS5N2Carrying-v0",
    "BabyAI-PutNextS6N3Carrying-v0", "BabyAI-PutNextS7N4Carrying-v0",
]
INSTRUCTION_IDS = [
    "BabyAI-GoToSeq-v0", "BabyAI-GoToSeqS5R2-v0", "BabyAI-Synth-v0", "BabyAI-SynthS5R2-v0",
    "BabyAI-SynthLoc-v0", "BabyAI-SynthSeq-v0", "BabyAI-MiniBossLevel-v0",
    "BabyAI-BossLevel-v0", "BabyAI-BossLevelNoUnlock-v0", "BabyAI-MoveTwoAcrossS5N2-v0",
    "BabyAI-MoveTwoAcrossS8N9-v0", "BabyAI-OpenTwoDoors-v0", "BabyAI-OpenRedBlueDoors-v0",
    "BabyAI-OpenRedBlueDoorsDebug-v0", "BabyAI-OpenDoorsOrderN2-v0",
    "BabyAI-OpenDoorsOrderN4-v0", "BabyAI-OpenDoorsOrderN2Debug-v0",
    "BabyAI-OpenDoorsOrderN4Debug-v0", "BabyAI-PickupLoc-v0",
]
STEP_CASES = [
    "BabyAI-GoToLocalS8N7-v0", "BabyAI-GoToRedBallGrey-v0", "BabyAI-GoToRedBlueBall-v0",
    "BabyAI-OneRoomS8-v0", "BabyAI-PutNextLocal-v0", "BabyAI-PickupDist-v0",
    "BabyAI-PickupDistDebug-v0", "BabyAI-OpenRedDoor-v0", "BabyAI-OpenDoorLoc-v0",
    "BabyAI-OpenDoorDebug-v0", "BabyAI-ActionObjDoor-v0", "BabyAI-PutNextS5N2Carrying-v0",
]
STEPS = 24
DIRS = jmg.DIR_TO_VEC
OBJS = (jmg.KEY, jmg.BALL, jmg.BOX)
NONE = np.zeros(3, np.int8)


def test_seventy_ids_parse_and_nineteen_raise():
    """All 89 BabyAI ids of the registry parse in the port: these 43, the
    27 maze ids and the 19 of composite instructions (which raised before
    the instruction slice, hence the name)."""
    from test_torch_babyai_mazes import MAZE_IDS
    from tests.test_registry_matrix import REGISTERED

    babyai = [i for i in REGISTERED if i.startswith("BabyAI-")]
    assert len(set(ROOM_IDS)) == 43 and len(set(MAZE_IDS)) == 27
    assert set(ROOM_IDS) | set(MAZE_IDS) | set(INSTRUCTION_IDS) == set(babyai)
    assert len(babyai) == 89 and len(INSTRUCTION_IDS) == 19
    for env_id in INSTRUCTION_IDS:
        assert jmg.parse_env_id(env_id).success == "babyai_seq"
        assert tmg.parse_env_id(env_id).success == "babyai_seq"
    assert all(tmg.parse_env_id(i).kind == jmg.parse_env_id(i).kind for i in babyai)


@pytest.mark.parametrize("env_id", ROOM_IDS + INSTRUCTION_IDS)
def test_parse_matches_jax(env_id):
    tp, jp = tmg.parse_env_id(env_id), jmg.parse_env_id(env_id)
    for f in dataclasses.fields(tp):
        assert getattr(tp, f.name) == getattr(jp, f.name), f.name


@pytest.mark.parametrize("env_id", INSTRUCTION_IDS[::3])
def test_instruction_ids_are_refused_by_slice(env_id):
    """Every third id of composite instructions, refused until the BabyAI
    instruction slice brought them (hence the name), now parses to the JAX
    package's ``EnvParams`` on every field, the composite ones
    (``instr_kinds``, ``action_kinds``, ``locations``, ``check_reachable``,
    ``locked_room_prob``, ``comp``, ``first_color``, ``second_color``)
    included, and resets with its instruction in ``instr``."""
    tp, jp = tmg.parse_env_id(env_id), jmg.parse_env_id(env_id)
    assert dataclasses.asdict(tp) == {f.name: getattr(jp, f.name)
                                      for f in dataclasses.fields(tp)}
    gen = torch.Generator()
    gen.manual_seed(0)
    st = tmg.reset(tp, 4, gen, "cpu")
    assert (st.instr[:, :, 0] > 0).any(1).all()


# ---------------------------------------------------------------------------
# Reset invariants
# ---------------------------------------------------------------------------


def objects(g):
    return [tuple(map(int, c)) for c in np.argwhere(np.isin(g[..., 0], OBJS))]


def doors(g):
    return [tuple(map(int, c)) for c in np.argwhere(g[..., 0] == jmg.DOOR)]


def pair(g, c):
    return int(g[c][0]), int(g[c][1])


def flood(obj, seed, passable=(jmg.EMPTY, jmg.DOOR)):
    """Cells 4-connected to ``seed`` through ``passable`` cells."""
    filled, stack = {tuple(seed)}, [tuple(seed)]
    while stack:
        x, y = stack.pop()
        for dx, dy in DIRS:
            c = (x + dx, y + dy)
            if (c not in filled and 0 <= c[0] < obj.shape[0] and 0 <= c[1] < obj.shape[1]
                    and obj[c] in passable):
                filled.add(c)
                stack.append(c)
    return filled


def all_reachable(obj, pos):
    """Upstream's check_objs_reachable: every cell that is neither EMPTY nor
    WALL is in the flood over EMPTY and DOOR cells or next to it."""
    filled = flood(obj, pos)
    for x, y in np.argwhere((obj != jmg.EMPTY) & (obj != jmg.WALL)).tolist():
        if (x, y) not in filled and not {(x + dx, y + dy) for dx, dy in DIRS} & filled:
            return False
    return True


def bordered(g):
    obj = g[..., 0]
    return all((e == jmg.WALL).all() for e in (obj[0], obj[-1], obj[:, 0], obj[:, -1]))


def _check_goto(p, g, pos, d, t):
    objs = objects(g)
    fixed = p.target_color >= 0 or p.rb_target or p.type_only
    assert len(objs) == p.num_objs + int(fixed) and bordered(g)
    pairs = [pair(g, c) for c in objs]
    if p.type_only:
        assert (t[0], t[1]) == (jmg.BALL, -1) and pairs[0][0] == jmg.BALL
    elif p.rb_target:
        rb = [c for c in pairs if c[0] == jmg.BALL and c[1] in (jmg.RED, jmg.BLUE)]
        assert len(rb) == 1 and (t[0], t[1]) == rb[0]
    elif p.target_color >= 0:
        assert (t[0], t[1]) == (jmg.BALL, jmg.RED) and (jmg.BALL, jmg.RED) in pairs
        if p.grey_dists:
            reds = [c for c in pairs if c[1] != jmg.GREY]
            assert reds == [(jmg.BALL, jmg.RED)]
    else:
        assert (int(t[0]), int(t[1])) in pairs
    assert not t[2:].any() and g[pos][0] == jmg.EMPTY
    assert all_reachable(g[..., 0], pos)


def _check_putnext(p, g, pos, d, t):
    pairs = {pair(g, c) for c in objects(g)}
    assert len(objects(g)) == len(pairs) == p.num_objs and bordered(g)
    assert (int(t[0]), int(t[1])) in pairs and (int(t[2]), int(t[3])) in pairs
    assert (t[0], t[1]) != (t[2], t[3]) and not t[4:].any()
    assert all_reachable(g[..., 0], pos)


def _check_pickup(p, g, pos, d, t):
    pairs = {pair(g, c) for c in objects(g)}
    assert len(objects(g)) == len(pairs) == 5 and bordered(g)
    assert not (t[0] < 0 and t[1] < 0) and not t[2:].any()
    assert any((t[0] < 0 or a == t[0]) and (t[1] < 0 or b == t[1]) for a, b in pairs)


def _check_openred(p, g, pos, d, t):
    (dx, dy), = doors(g)
    assert dx == 4 and 1 <= dy <= 3 and tuple(g[dx, dy]) == (jmg.DOOR, jmg.RED, jmg.CLOSED)
    assert all(g[4, y, 0] == jmg.WALL for y in range(p.height) if y != dy)
    assert 1 <= pos[0] <= 3 and 1 <= pos[1] <= 3
    assert t[0] == 4 * p.height + dy + 1 and not t[1:].any()


def sides(pos, d, cells):
    """{word: the cells it names from pose (pos, d)}, computed here from the
    vector v to each cell: left/right by v·right, front/behind by v·forward."""
    fwd, right = DIRS[d], DIRS[(d + 1) % 4]
    out = {w: set() for w in tmg.LOCATION_WORDS}
    for c in cells:
        v = (c[0] - pos[0], c[1] - pos[1])
        f, r = v[0] * fwd[0] + v[1] * fwd[1], v[0] * right[0] + v[1] * right[1]
        for w, ok in zip(tmg.LOCATION_WORDS, (r < 0, r > 0, f > 0, f < 0)):
            if ok:
                out[w].add(c)
    return out


def _center_doors_ok(g, pitch):
    ds = doors(g)
    assert len(ds) == 4
    walls = {(x if x in (pitch, 2 * pitch) else None, y if y in (pitch, 2 * pitch) else None)
             for x, y in ds}
    assert walls == {(2 * pitch, None), (None, 2 * pitch), (pitch, None), (None, pitch)}
    for x, y in ds:
        assert pitch < (y if x in (pitch, 2 * pitch) else x) < 2 * pitch
        assert g[x, y, 2] == jmg.CLOSED
    return ds


def _in_center(c, pitch):
    return pitch < c[0] < 2 * pitch and pitch < c[1] < 2 * pitch


def _check_opendoor(p, g, pos, d, t):
    ds = _center_doors_ok(g, 7)
    assert len({int(g[c][1]) for c in ds}) == 4 and _in_center(pos, 7)
    packed = {int(v) for v in t[:4] if v}
    assert not t[4:].any() and all(v == 0 or v in packed for v in t[:4])
    matched = {c for c in ds if c[0] * p.height + c[1] + 1 in packed}
    by_color = matched == {c for c in ds if c[0] == 14}
    by_loc = matched in list(sides(pos, d, ds).values())
    assert matched and {"color": by_color, "loc": by_loc}.get(p.select_by, by_color or by_loc)


def _check_actionobj(p, g, pos, d, t):
    ds = _center_doors_ok(g, 6)
    objs = objects(g)
    assert len(objs) == len({pair(g, c) for c in objs}) == 5
    assert all(_in_center(c, 6) for c in objs) and _in_center(pos, 6)
    assert not t[3:].any()
    if t[1] == jmg.DOOR:
        assert t[0] in (0, 2) and t[2] in {int(g[c][1]) for c in ds}
    else:
        assert t[0] in (0, 1) and (int(t[1]), int(t[2])) in {pair(g, c) for c in objs}


def _check_putnext2(p, g, pos, d, t, carrying):
    s, k = p.max_room_size, p.num_objs
    assert bordered(g) and (g[s - 1, 1:-1, 0] != jmg.WALL).all()  # no dividing wall
    objs = objects(g)
    held = [tuple(map(int, carrying[:2]))] if carrying[0] else []
    assert bool(held) == p.start_carrying
    pairs = [pair(g, c) for c in objs] + held
    assert len(pairs) == len(set(pairs)) == 2 * k
    left = [pair(g, c) for c in objs if c[0] < s - 1]
    right = [pair(g, c) for c in objs if c[0] > s - 1]
    assert len(left) + len(right) == len(objs) and pos[0] < s - 1
    mv, fx = (int(t[0]), int(t[1])), (int(t[2]), int(t[3]))
    assert not t[4:].any()
    if p.start_carrying:
        assert held == [mv] and g[pos][0] == jmg.EMPTY
        assert fx in left + right and len(left if fx in right else right) == k - 1
    else:
        assert (mv in left and fx in right) or (mv in right and fx in left)
        assert len(left) == len(right) == k


CHECKS = {
    "babyai_goto": _check_goto, "babyai_putnext": _check_putnext,
    "babyai_pickup": _check_pickup, "babyai_openred": _check_openred,
    "babyai_opendoor": _check_opendoor, "babyai_actionobj": _check_actionobj,
}


def resets(env_id, n=48, seed=0):
    p = tmg.parse_env_id(env_id)
    gen = torch.Generator()
    gen.manual_seed(seed)
    st = tmg.reset(p, n, gen, "cpu")
    assert st.target.dtype == torch.int32 and st.target.shape == (n, 8)
    return p, st


@pytest.mark.parametrize("env_id", ROOM_IDS)
def test_reset_invariants(env_id):
    p, st = resets(env_id)
    grids, targets = st.grid.numpy(), st.target.numpy()
    for i in range(grids.shape[0]):
        pos, d = tuple(int(v) for v in st.agent_pos[i]), int(st.agent_dir[i])
        if p.kind == "babyai_putnext2":
            _check_putnext2(p, grids[i], pos, d, targets[i], st.carrying[i].numpy())
        else:
            assert not st.carrying[i].any()
            CHECKS[p.kind](p, grids[i], pos, d, targets[i])
    assert len({g.tobytes() for g in grids}) > 1 and len(set(st.agent_dir.tolist())) == 4
    if p.kind != "babyai_openred" and p.target_color < 0 and not p.type_only:
        assert len({tuple(r) for r in targets.tolist()}) > 1  # the mission varies
    if p.kind == "babyai_pickup":  # by type, by color and by both
        assert {(bool(a < 0), bool(b < 0)) for a, b in targets[:, :2]} == {
            (False, False), (True, False), (False, True)}
    if p.kind == "babyai_actionobj":
        assert set(targets[:, 0].tolist()) == {0, 1, 2}
    if p.kind == "babyai_opendoor" and not p.select_by:  # both modes drawn
        counts = {int((t[:4] != 0).sum()) for t in targets}
        assert len(counts) > 1 or any(t[0] == 0 for t in targets)


def test_location_words_from_crafted_poses():
    """The four words from poses facing each way, with the doors in line
    with the agent and off it: facing up (north), right is the east door
    and left the west one; facing down, right is west; facing east, front
    is east, behind west and right south; a door off the agent's line is
    named by two words."""
    e, s_, w, n = (14, 10), (10, 14), (7, 10), (10, 7)

    def named(pos, ds):
        dx = torch.tensor([[c[0] for c in ds]] * 4)
        dy = torch.tensor([[c[1] for c in ds]] * 4)
        got = tmg.door_sides(torch.tensor([pos] * 4), torch.arange(4), dx, dy).numpy()
        return {(d, word): {ds[k] for k in range(len(ds)) if got[d, i, k]}
                for d in range(4) for i, word in enumerate(tmg.LOCATION_WORDS)}

    got = named((10, 10), [e, s_, w, n])  # [dir, word] → the doors named
    assert (got[(3, "right")], got[(3, "left")], got[(3, "front")], got[(3, "behind")]) == (
        {e}, {w}, {n}, {s_})
    assert (got[(1, "right")], got[(1, "left")], got[(1, "front")], got[(1, "behind")]) == (
        {w}, {e}, {s_}, {n})
    assert (got[(0, "right")], got[(0, "left")], got[(0, "front")], got[(0, "behind")]) == (
        {s_}, {n}, {e}, {w})
    assert (got[(2, "right")], got[(2, "left")], got[(2, "front")], got[(2, "behind")]) == (
        {n}, {s_}, {w}, {e})
    off = [(14, 12), (9, 14), (7, 8), (12, 7)]
    got = named((10, 10), off)
    assert got[(3, "right")] == {(14, 12), (12, 7)} and got[(3, "behind")] == {(14, 12), (9, 14)}
    for d in range(4):
        want = sides((10, 10), d, off)
        assert all(got[(d, word)] == want[word] for word in tmg.LOCATION_WORDS)


def test_opendoorloc_names_every_word_and_door_side():
    """Over 256 resets every word is drawn, and a door can be named from
    either side of the agent: the matched set is one word's set of doors."""
    p, st = resets("BabyAI-OpenDoorLoc-v0", n=256, seed=3)
    words = set()
    for i in range(256):
        g, t = st.grid[i].numpy(), st.target[i].numpy()
        pos, d = tuple(int(v) for v in st.agent_pos[i]), int(st.agent_dir[i])
        ds = doors(g)
        matched = {c for c in ds if c[0] * p.height + c[1] + 1 in set(t[:4].tolist())}
        words |= {w for w, cells in sides(pos, d, ds).items() if cells == matched}
    assert words == set(tmg.LOCATION_WORDS)


# ---------------------------------------------------------------------------
# Transitions against the JAX package
# ---------------------------------------------------------------------------


def faces(g, cell, allow=(jmg.EMPTY,)):
    """Every (pos, dir) from which the agent faces ``cell``."""
    out = []
    for d, (dx, dy) in enumerate(DIRS):
        x, y = cell[0] - dx, cell[1] - dy
        if 0 <= x < g.shape[0] and 0 <= y < g.shape[1] and g[x, y, 0] in allow:
            out.append((np.array([x, y]), d))
    return out


def craft(p, g, t, carrying=NONE):
    """Crafted states of one reset grid ``g``, its target ``t`` and carried
    object: (grid, pos, dir, carrying, target, scripted actions, expected
    (terminated, rewarded) after the first action or None)."""
    out = []

    def add(grid, cell, actions, expect, carry=carrying, target=t, sides=1):
        for pos, d in faces(grid, cell)[:sides]:
            out.append((grid.copy(), pos, d, np.asarray(carry, np.int8),
                        np.asarray(target, np.int32), actions, expect))

    def match(c, ttype, tcol):
        return (ttype < 0 or g[c][0] == ttype) and (tcol < 0 or g[c][1] == tcol)

    objs, ds, mode = objects(g), doors(g), p.success
    empty = [tuple(map(int, c)) for c in np.argwhere(g[..., 0] == jmg.EMPTY)]
    if mode == "babyai_goto":
        good = [c for c in objs + ds if match(c, t[0], t[1])]
        bad = [c for c in objs if not match(c, t[0], t[1])]
        for c in good[:1]:
            add(g, c, [jmg.A_DONE], (True, True))        # facing the target
            if g[c][0] != jmg.DOOR:
                add(g, c, [jmg.A_PICKUP], (True, True))  # picking the faced target up
        for c in bad[:1]:
            add(g, c, [jmg.A_DONE], (False, False))      # facing another object
        if t[0] in OBJS:                                 # dropping a match in front
            c = next(c for c in empty if faces(g, c))
            add(g, c, [jmg.A_DROP], (True, True), carry=[t[0], t[1], 0])
    if mode == "babyai_putnext":
        held = g.copy()
        for c in objs:
            if pair(g, c) == (t[0], t[1]):
                held[c] = [jmg.EMPTY, 0, 0]
        fixed = next(c for c in objs if pair(g, c) == (t[2], t[3]))
        carry = [t[0], t[1], 0]
        around = [(fixed[0] + dx, fixed[1] + dy) for dx, dy in DIRS]
        diag = [(fixed[0] + dx, fixed[1] + dy) for dx in (-1, 1) for dy in (-1, 1)]
        far = [c for c in empty if abs(c[0] - fixed[0]) + abs(c[1] - fixed[1]) > 2]
        for cells, expect in ((around, (True, True)), (diag, (False, False)),
                              (far, (False, False))):
            for c in [c for c in cells if held[c][0] == jmg.EMPTY][:1]:
                add(held, c, [jmg.A_DROP], expect, carry=carry)
        add(held, fixed, [jmg.A_DROP], (False, False), carry=carry)  # onto the object: fails
    if mode in ("babyai_pickup", "pickup_box"):
        good = [c for c in objs if match(c, t[0], t[1])]
        bad = [c for c in objs if not match(c, t[0], t[1])]
        for c in good[:1]:
            add(g, c, [jmg.A_PICKUP], (True, True))
        for c in bad[:2]:                                # a wrong pickup: strict fails it
            add(g, c, [jmg.A_PICKUP], (p.strict, False))
        if objs:                                         # holding a match, pickup again
            hold = [max(t[0], jmg.KEY), max(t[1], 0), 0]
            add(g, objs[0], [jmg.A_PICKUP], (True, True), carry=hold)
    if mode in ("babyai_open", "babyai_open_color"):
        packed = {int(v) for v in t[:4] if v}
        for c in ds:
            if mode == "babyai_open":
                ok = c[0] * p.height + c[1] + 1 in packed
            else:
                ok = t[1] < 0 or g[c][1] == t[1]
            if g[c][2] == jmg.LOCKED:                    # with and without its key
                add(g, c, [jmg.A_TOGGLE], (ok, ok), carry=[jmg.KEY, g[c][1], 0])
                add(g, c, [jmg.A_TOGGLE], (False, False))
            else:                                        # both sides of the door
                add(g, c, [jmg.A_TOGGLE], (ok or p.strict, ok), sides=2)
            if ok and mode == "babyai_open":             # re-closing an opened door
                opened = g.copy()
                opened[c][2] = jmg.OPEN
                add(opened, c, [jmg.A_TOGGLE], (p.strict, False))
        box = [c for c in objs if g[c][0] == jmg.BOX and g[c][2] > 0]
        for c in box[:1]:                                # the box reveals its key
            add(g, c, [jmg.A_TOGGLE, jmg.A_PICKUP], (False, False))
    if mode == "babyai_action":
        door, obj = ds[0], objs[0]
        dt = [0, jmg.DOOR, g[door][1]] + [0] * 5
        ot = [0, g[obj][0], g[obj][1]] + [0] * 5
        for target, cell, action, expect in (
                (dt, door, jmg.A_DONE, (True, True)),        # goto the door
                (ot, obj, jmg.A_PICKUP, (True, True)),       # goto: picking it up
                ([1] + ot[1:], obj, jmg.A_PICKUP, (True, True)),
                ([1] + ot[1:], obj, jmg.A_DONE, (False, False)),
                ([2] + dt[1:], door, jmg.A_TOGGLE, (True, True)),
                ([2] + dt[1:], door, jmg.A_DONE, (False, False))):
            add(g, cell, [action], expect, target=target)
    return out


def step_and_compare(env_id, n_reset=6, seed=5):
    """Step the port's resets and the crafted states on the port and on the
    JAX package 24 times; returns the crafted states and the first step's
    (rewards, terminated) of each."""
    tp, jp = tmg.parse_env_id(env_id), jmg.parse_env_id(env_id)
    gen = torch.Generator()
    gen.manual_seed(seed)
    fresh = tmg.reset(tp, n_reset, gen, "cpu")
    grids, pos, dirs = list(fresh.grid.numpy()), list(fresh.agent_pos.numpy()), list(
        fresh.agent_dir.numpy())
    carry, targets = list(fresh.carrying.numpy()), list(fresh.target.numpy())
    steps = [0] * n_reset
    crafted = [c for i in range(3) for c in craft(tp, grids[i], targets[i], carry[i])]
    assert crafted, env_id
    scripted = {}
    for k, (cg, cp, cd, cc, ct, actions, _) in enumerate(crafted):
        scripted[len(grids)] = actions
        grids.append(cg), pos.append(cp), dirs.append(cd), carry.append(cc), targets.append(ct)
        steps.append(tp.max_steps - 3 if k == 0 else tp.max_steps // 2)  # one truncates
    n = len(grids)
    js = _jax_states(np.stack(grids), np.stack(pos), np.array(dirs), np.stack(carry),
                     np.array(steps), np.stack(targets))
    ts = convert.env_state(jax.tree_util.tree_map(np.asarray, js))
    actions = np.random.RandomState(0).randint(0, jp.num_actions, size=(STEPS, n))
    for i, seq in scripted.items():
        actions[:len(seq), i] = seq
    jstep = jax.vmap(jmg.step, in_axes=(None, 0, 0))
    jobs = jax.vmap(jmg.observe, in_axes=(None, 0))
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
        if t == 0:
            first = (tr.numpy()[n_reset:], tterm.numpy()[n_reset:])
    np.testing.assert_array_equal(tmg.observe(tp, ts).numpy(), np.asarray(jobs(jp, js)))
    release_jax_executables()
    return crafted, first



def check_modes(env_id, crafted, first):
    """Each crafted state's first transition did what its mode says; the
    level's success was reached, and its strict failure where it has one."""
    reward, term = first
    seen = set()
    for i, c in enumerate(crafted):
        if c[6] is None:
            continue
        assert (bool(term[i]), bool(reward[i] > 0)) == c[6], (env_id, i, c[5], c[6])
        seen.add(c[6])
    assert (True, True) in seen, env_id
    if tmg.parse_env_id(env_id).strict:
        assert (True, False) in seen, env_id


@pytest.mark.parametrize("env_id", STEP_CASES)
def test_step_and_observe_equal(env_id):
    check_modes(env_id, *step_and_compare(env_id))
