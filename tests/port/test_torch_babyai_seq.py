"""The port's BabyAI levels of composite instructions against the JAX
package's: GoToSeq[S5R2], Synth[S5R2|Loc|Seq], [Mini]BossLevel[NoUnlock]
(LevelGen), MoveTwoAcross, OpenTwoDoors, OpenRedBlueDoors[Debug],
OpenDoorsOrderN{2,4}[Debug] and PickupLoc, and all 165 registry ids.

Every registry id parses and resets in the port. Resets draw from different
generators in the two packages, so the port's resets are held to the
invariants of ``tests/test_babyai_levelgen.py`` and ``test_babyai_seq.py``:
every used instruction slot's description matches some object and the
unused slots are zero, GoToSeq is goto-only without locks, BossLevel's locked
room has its key, SynthLoc's positional slots point at objects,
OpenTwoDoors' and OpenDoorsOrder's doors have distinct colors on the right
walls, and PickupLoc's room holds its 8 reachable objects.

The verifier (``_seq_verify``) is held for equality: scripted scenarios in
the layouts of the port's resets, with injected instructions where no level
emits them (mirroring ``tests/test_babyai_seq.py:234-575``): before, after
and and, the latches that an and-composed B half gathers before A, the
single B half that does not persist, strict OpenInstr and PickupInstr
failures, a strict SeqInstr that fails when B comes first, MoveTwoAcross
with B met before A, PickupLoc's identity tracking and the positional set
that re-syncs on a drop. Each scenario step puts the agent in front of its
cell (and, where it says, an object into its hand), then both packages step
the same states with the same actions: views, rewards, flags and next
states, ``instr`` and ``instr_state`` included, must be EQUAL (the
time-scaled rewards within 2^-23), and each step is also held to the
outcome its scenario names. The JAX step and observe run eagerly under
``vmap``, and no JAX reset runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.envs.minigrid import core as jmg
from clip_ppo_tpu_torch.envs.minigrid import core as tmg
from test_torch_babyai_rooms import INSTRUCTION_IDS, all_reachable, bordered, doors, objects
from test_torch_minigrid_missions import _assert_rewards_equal, release_jax_executables
from tests.test_registry_matrix import REGISTERED

DIRS = jmg.DIR_TO_VEC
OBJS = (jmg.KEY, jmg.BALL, jmg.BOX)
EMPTY_CELL = (jmg.EMPTY, 0, 0)
LEVELGEN_IDS = [i for i in INSTRUCTION_IDS if jmg.parse_env_id(i).kind == "babyai_levelgen"]
F, T = False, True


def _reset(env_id, n=32, seed=0):
    p = tmg.parse_env_id(env_id)
    gen = torch.Generator()
    gen.manual_seed(seed)
    return p, tmg.reset(p, n, gen, "cpu")


@pytest.mark.parametrize("env_id", REGISTERED)
def test_registered_id_parses_and_resets(env_id):
    p, st = _reset(env_id, n=3)
    assert st.grid.shape == (3, p.width, p.height, 3)
    assert st.instr.shape == (3, 4, 12) and st.instr.dtype == torch.int32
    assert st.instr_state.shape == (3, 4, 2) and not st.instr_state.any()
    assert bool(st.instr.any()) == (p.success == "babyai_seq")
    assert tmg.observe(p, st).shape == (3, 7, 7, 3)


# ---------------------------------------------------------------------------
# Reset invariants
# ---------------------------------------------------------------------------


def _matches(g, t, c, types=(*OBJS, jmg.DOOR)):
    m = np.isin(g[..., 0], types) & ((g[..., 0] == t) if t >= 0 else True)
    return m & ((g[..., 1] == c) if c >= 0 else True)


def _used(instr, comp):
    return {0} | ({1} if comp == 1 or (comp >= 2 and instr[1][0]) else set()) | (
        {2} if comp >= 2 else set()) | ({3} if comp >= 2 and instr[3][0] else set())


def _check_slots(p, g, instr, comp):
    """Each used slot is an atomic instruction whose descriptions match some
    object (a positional one: its positions are objects); the rest are 0."""
    used = _used(instr, comp)
    for i in range(4):
        row = instr[i]
        if i not in used:
            assert not row.any()
            continue
        assert row[0] in (1, 2, 3, 4)
        if row[5] & 1:
            poss = [int(v) for v in row[6:12] if v]
            assert poss and (row[1], row[2]) == (-1, -1)
            for v in poss:
                assert g[(v - 1) // p.height, (v - 1) % p.height, 0] in (*OBJS, jmg.DOOR)
        else:
            assert not row[6:12].any() and _matches(g, row[1], row[2]).any()
        if row[0] == 4:
            assert _matches(g, row[3], row[4], OBJS).any()
        else:
            assert not row[3:5].any()


@pytest.mark.parametrize("env_id", LEVELGEN_IDS)
def test_levelgen_reset_invariants(env_id):
    p, st = _reset(env_id)
    verbs = {1: "goto", 2: "open", 3: "pickup", 4: "putnext"}
    allowed = set(p.action_kinds.split(","))
    comps, locked_seen = set(), 0
    for i in range(st.grid.shape[0]):
        g, instr = st.grid[i].numpy(), st.instr[i].numpy()
        comp, pos = int(st.target[i, 0]), tuple(int(v) for v in st.agent_pos[i])
        assert not st.target[i, 1:].any() and comp in (0, 1, 2, 3)
        comps.add(comp)
        assert bordered(g) and g[pos][0] == jmg.EMPTY
        _check_slots(p, g, instr, comp)
        assert {verbs[int(v)] for v in instr[:, 0] if v} <= allowed
        if not p.locations:
            assert not (instr[:, 5] & 1).any()
        locked = np.argwhere((g[..., 0] == jmg.DOOR) & (g[..., 2] == jmg.LOCKED))
        assert len(locked) <= (1 if p.locked_room_prob else 0)
        if len(locked):  # add_locked_room: the key of its color lies in the maze
            locked_seen += 1
            assert (((g[..., 0] == jmg.KEY) & (g[..., 1] == g[tuple(locked[0])][1])).any())
        if p.check_reachable:
            assert all_reachable(g[..., 0], pos)
        n_objs = int(np.isin(g[..., 0], OBJS).sum())
        assert p.num_objs <= n_objs <= p.num_objs + 1
    assert comps == ({0, 1, 2, 3} if "seq" in p.instr_kinds else {0})
    if p.locked_room_prob:
        assert 0 < locked_seen < st.grid.shape[0]


def test_synthloc_positional_slots_hold_every_match_up_to_six():
    """A positional slot's set is the matching cells on the named side of
    the start pose: the 6 largest packed positions of objects of one type
    (and color, where named), all on one side."""
    p, st = _reset("BabyAI-SynthLoc-v0", n=64, seed=2)
    seen = 0
    for i in range(64):
        row = st.instr[i, 0].numpy()
        if not row[5] & 1:
            continue
        seen += 1
        g = st.grid[i].numpy()
        cells = [((v - 1) // p.height, (v - 1) % p.height) for v in row[6:12] if v]
        assert len({(g[c][0]) for c in cells}) == 1
        assert list(row[6:12][:len(cells)]) == sorted(row[6:12][:len(cells)], reverse=True)
    assert seen >= 4


def test_twodoors_reset_invariants():
    for env_id in ("BabyAI-OpenTwoDoors-v0", "BabyAI-OpenRedBlueDoorsDebug-v0",
                   "BabyAI-OpenDoorsOrderN2-v0", "BabyAI-OpenDoorsOrderN4Debug-v0"):
        p, st = _reset(env_id)
        comps = set()
        for i in range(32):
            g, instr = st.grid[i].numpy(), st.instr[i].numpy()
            comp = int(st.target[i, 0])
            comps.add(comp)
            ds = doors(g)
            colors = [int(g[c][1]) for c in ds]
            assert len(set(colors)) == len(ds) and all(g[c][2] == jmg.CLOSED for c in ds)
            walls = {(x == 5, x == 10, y == 5, y == 10) for x, y in ds}
            assert len(walls) == len(ds) and all(sum(w) == 1 for w in walls)
            assert all(5 < v < 10 for c in ds for v in c if v not in (5, 10))
            pos = tuple(int(v) for v in st.agent_pos[i])
            assert 5 < pos[0] < 10 and 5 < pos[1] < 10
            first = next(c for c in ds if g[c][1] == instr[0][2])
            strict = 2 if p.strict else 0
            assert instr[0][:2].tolist() == [2, jmg.DOOR] and instr[0][5] == strict
            if p.comp == "before":
                assert len(ds) == 2 and comp == 2 and first[0] == 5
                second = next(c for c in ds if g[c][1] == instr[2][2])
                assert second[0] == 10 and instr[2][5] == 0
                if p.first_color >= 0:
                    assert (instr[0][2], instr[2][2]) == (jmg.RED, jmg.BLUE)
            else:
                assert len(ds) == p.num_objs
                if comp:
                    assert instr[2][:2].tolist() == [2, jmg.DOOR] and instr[2][5] == strict
                    assert instr[2][2] != instr[0][2] and instr[2][2] in colors
                else:
                    assert not instr[2].any()
            assert not instr[1].any() and not instr[3].any()
        assert comps == ({2} if p.comp == "before" else {0, 2, 3})


def test_pickuploc_and_movetwoacross_reset_invariants():
    p, st = _reset("BabyAI-PickupLoc-v0")
    kinds = set()
    for i in range(32):
        g, instr = st.grid[i].numpy(), st.instr[i].numpy()
        pos = tuple(int(v) for v in st.agent_pos[i])
        assert bordered(g) and len(objects(g)) == 8 and all_reachable(g[..., 0], pos)
        assert instr[0][0] == 3 and not st.target[i].any()
        _check_slots(p, g, instr, 0)
        kinds.add(bool(instr[0][5] & 1))
    assert kinds == {True, False}
    p, st = _reset("BabyAI-MoveTwoAcrossS8N9-v0")
    s = p.max_room_size
    for i in range(32):
        g, instr = st.grid[i].numpy(), st.instr[i].numpy()
        pairs = {(int(g[c][0]), int(g[c][1])): c for c in objects(g)}
        assert len(pairs) == len(objects(g)) == 18 and int(st.target[i, 0]) == 2
        assert instr[0][0] == instr[2][0] == 4 and not instr[1].any() and not instr[3].any()
        for slot, mv_left in ((0, True), (2, False)):
            mv, fx = pairs[tuple(instr[slot][1:3])], pairs[tuple(instr[slot][3:5])]
            assert (mv[0] < s - 1) == mv_left and (fx[0] < s - 1) != mv_left


# ---------------------------------------------------------------------------
# The verifier against the JAX package
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Scenario:
    """One env of a scripted batch: its start state and its steps, each
    (cell to face or None, action, cell whose object goes into the hand or
    None, expected (terminated, rewarded) or None, {slot: done latch}
    expected after it)."""

    grid: np.ndarray
    pos: tuple
    dir: int
    target: np.ndarray
    instr: np.ndarray
    steps: list
    carrying: tuple = (0, 0, 0)


def _face(g, cell):
    for d, (dx, dy) in enumerate(DIRS):
        x, y = cell[0] - dx, cell[1] - dy
        if 0 <= x < g.shape[0] and 0 <= y < g.shape[1] and g[x, y, 0] == jmg.EMPTY:
            return (x, y), d
    raise AssertionError(f"no free cell in front of {cell}")


def _can_face(g, cell):
    try:
        _face(g, cell)
    except AssertionError:
        return False
    return True


def _beside(g, cell, avoid=()):
    """An EMPTY cell cardinally next to ``cell`` that the agent can face."""
    for dx, dy in DIRS:
        c = (cell[0] + dx, cell[1] + dy)
        if g[c][0] == jmg.EMPTY and c not in avoid and _can_face(g, c):
            return c
    return None


def _jax_states(st):
    n = st.grid.shape[0]
    return jmg.EnvState(
        grid=jnp.asarray(st.grid.numpy()), agent_pos=jnp.asarray(st.agent_pos.numpy(), jnp.int32),
        agent_dir=jnp.asarray(st.agent_dir.numpy(), jnp.int32),
        carrying=jnp.asarray(st.carrying.numpy()),
        step_count=jnp.asarray(st.step_count.numpy(), jnp.int32),
        rng=jax.random.split(jax.random.PRNGKey(0), n),
        target=jnp.asarray(st.target.numpy()), instr=jnp.asarray(st.instr.numpy()),
        instr_state=jnp.asarray(st.instr_state.numpy()))


def run_scenarios(env_id, scenarios, extra=None, tail=6, seed=0):
    """Step the scenarios (and ``extra``, a state of the port's resets
    stepped at random) on both packages; every step's outputs must be equal.
    Returns each step's (terminated, reward, instr, instr_state)."""
    tp, jp = tmg.parse_env_id(env_id), jmg.parse_env_id(env_id)
    n = len(scenarios)
    cols = [np.stack([getattr(s, k) for s in scenarios]) for k in ("grid", "target", "instr")]
    st = tmg.EnvState(
        torch.as_tensor(cols[0]), torch.as_tensor(np.array([s.pos for s in scenarios])),
        torch.as_tensor(np.array([s.dir for s in scenarios])),
        torch.as_tensor(np.array([s.carrying for s in scenarios], np.int8)),
        torch.full((n,), tp.max_steps // 2, dtype=torch.int32),
        torch.as_tensor(cols[1], dtype=torch.int32), torch.as_tensor(cols[2], dtype=torch.int32),
        torch.zeros((n, 4, 2), dtype=torch.int32))
    if extra is not None:
        st = tmg.EnvState(*(torch.cat([a, b]) for a, b in zip(dataclasses.astuple(st),
                                                              dataclasses.astuple(extra))))
    total = st.grid.shape[0]
    rng = np.random.RandomState(seed)
    jstep = jax.vmap(jmg.step, in_axes=(None, 0, 0))
    jobs = jax.vmap(jmg.observe, in_axes=(None, 0))
    out = []
    for k in range(max(len(s.steps) for s in scenarios) + tail):
        grid, pos = st.grid.clone(), st.agent_pos.clone()
        dirs, carry = st.agent_dir.clone(), st.carrying.clone()
        actions = rng.randint(0, jp.num_actions, size=total)
        for i, s in enumerate(scenarios):
            if k >= len(s.steps):
                continue
            cell, action, take, _, _ = s.steps[k]
            if take is not None:
                carry[i] = grid[i, take[0], take[1]]
                grid[i, take[0], take[1]] = torch.tensor(EMPTY_CELL)
            if cell is not None:
                (x, y), d = _face(grid[i].numpy(), cell)
                pos[i], dirs[i] = torch.tensor([x, y]), d
            actions[i] = action
        st = dataclasses.replace(st, grid=grid, agent_pos=pos, agent_dir=dirs, carrying=carry)
        js = _jax_states(st)
        np.testing.assert_array_equal(tmg.observe(tp, st).numpy(), np.asarray(jobs(jp, js)),
                                      err_msg=f"view before step {k}")
        js, jr, jterm, jtrunc = jstep(jp, js, jnp.asarray(actions, jnp.int32))
        st, tr, tterm, ttrunc = tmg.step(tp, st, torch.as_tensor(actions))
        _assert_rewards_equal(tr.numpy(), np.asarray(jr), k)
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm), err_msg=f"term {k}")
        np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc), err_msg=f"trunc {k}")
        for f in dataclasses.fields(jmg.EnvState):
            if f.name != "rng":
                np.testing.assert_array_equal(getattr(st, f.name).numpy(),
                                              np.asarray(getattr(js, f.name)),
                                              err_msg=f"{f.name} after step {k}")
        out.append((tterm.numpy(), tr.numpy(), st.instr.numpy(), st.instr_state.numpy()))
    release_jax_executables()
    return out


def check_outcomes(scenarios, out):
    for i, s in enumerate(scenarios):
        for k, (_, _, _, expect, latches) in enumerate(s.steps):
            term, reward, _, state = out[k]
            if expect is not None:
                assert (bool(term[i]), bool(reward[i] > 0)) == expect, (i, k, s.steps[k])
            for slot, v in (latches or {}).items():
                assert state[i, slot, 0] == v, (i, k, slot)


def _door(g, color):
    return next(c for c in doors(g) if g[c][1] == color)


def _row(verb, t=0, c=0, t2=0, c2=0, flags=0, poss=()):
    row = np.zeros(12, np.int32)
    row[:6] = verb, t, c, t2, c2, flags
    row[6:6 + len(poss)] = poss
    return row


def _scenario(st, i, instr=None, comp=None, seq_strict=0, steps=(), grid=None):
    target = st.target[i].numpy().copy()
    if comp is not None:
        target[:2] = comp, seq_strict
    return Scenario(st.grid[i].numpy().copy() if grid is None else grid,
                    tuple(int(v) for v in st.agent_pos[i]), int(st.agent_dir[i]), target,
                    st.instr[i].numpy().copy() if instr is None else instr, list(steps))


def test_twodoors_before_and_strict_failure():
    """OpenTwoDoors: door 2 first is not verified and does not persist, door
    1 latches A, door 2 (opened early) closes and then opens: success.
    OpenRedBlueDoorsDebug: the blue door first fails the strict OpenInstr;
    red then blue succeeds."""
    _, st = _reset("BabyAI-OpenTwoDoors-v0", n=2)
    g, instr = st.grid[0].numpy(), st.instr[0].numpy()
    d1, d2 = _door(g, instr[0][2]), _door(g, instr[2][2])
    tg = lambda c, e, latch=None: (c, jmg.A_TOGGLE, None, e, latch)  # noqa: E731
    two = [_scenario(st, 0, steps=[tg(d2, (F, F), {2: 0}), tg(d1, (F, F), {0: 1, 2: 0}),
                                   tg(d2, (F, F)), tg(d2, (T, T))])]
    check_outcomes(two, run_scenarios("BabyAI-OpenTwoDoors-v0", two, extra=st))
    _, st = _reset("BabyAI-OpenRedBlueDoorsDebug-v0", n=2)
    g = st.grid[0].numpy()
    red, blue = _door(g, jmg.RED), _door(g, jmg.BLUE)
    rb = [_scenario(st, 0, steps=[tg(blue, (T, F))]),
          _scenario(st, 0, steps=[tg(red, (F, F), {0: 1}), tg(blue, (T, T))])]
    check_outcomes(rb, run_scenarios("BabyAI-OpenRedBlueDoorsDebug-v0", rb, extra=st))


def test_opendoorsorder_single_before_after_and_and_strict_seq():
    """OpenDoorsOrderN2's three modes, and over injected instructions: and
    in either order, and a strict SeqInstr that fails when B comes first;
    N4: before(A, and(B1, B2)), whose B1 latches before A (upstream's
    non-strict BeforeInstr verifies B every step), and N4Debug's strict
    OpenInstr failing on a door of another color."""
    p, st = _reset("BabyAI-OpenDoorsOrderN2-v0")
    comp = st.target[:, 0].tolist()
    tg = lambda c, e, latch=None: (c, jmg.A_TOGGLE, None, e, latch)  # noqa: E731
    scen = []
    for mode, steps in ((0, lambda d1, d2: [tg(d1, (T, T))]),
                        (2, lambda d1, d2: [tg(d1, (F, F), {0: 1}), tg(d2, (T, T))]),
                        (3, lambda d1, d2: [tg(d1, (F, F), {0: 0}), tg(d2, (F, F), {2: 1}),
                                            tg(d1, (F, F)), tg(d1, (T, T))])):
        i = comp.index(mode)
        g, instr = st.grid[i].numpy(), st.instr[i].numpy()
        scen.append(_scenario(st, i, steps=steps(_door(g, instr[0][2]),
                                                 _door(g, instr[2][2]) if mode else None)))
    i = comp.index(2)
    g, instr = st.grid[i].numpy(), st.instr[i].numpy()
    d1, d2 = _door(g, instr[0][2]), _door(g, instr[2][2])
    both = np.zeros((4, 12), np.int32)
    both[0], both[1] = instr[0], instr[2]
    scen.append(_scenario(st, i, both, comp=1, steps=[tg(d2, (F, F), {1: 1}), tg(d1, (T, T))]))
    scen.append(_scenario(st, i, both, comp=1, steps=[tg(d1, (F, F), {0: 1}), tg(d2, (T, T))]))
    scen.append(_scenario(st, i, comp=2, seq_strict=1, steps=[tg(d2, (T, F))]))
    scen.append(_scenario(st, i, comp=3, seq_strict=1, steps=[tg(d1, (T, F))]))
    check_outcomes(scen, run_scenarios("BabyAI-OpenDoorsOrderN2-v0", scen,
                                       extra=tmg.take(st, 0, 4)))

    p, st = _reset("BabyAI-OpenDoorsOrderN4Debug-v0")
    g = st.grid[0].numpy()
    ds = doors(g)
    c1, c2, c3, c4 = (int(g[c][1]) for c in ds)
    instr = np.zeros((4, 12), np.int32)
    instr[0], instr[2], instr[3] = (_row(2, jmg.DOOR, c) for c in (c1, c2, c3))
    scen = [_scenario(st, 0, instr, comp=2, steps=[tg(ds[1], (F, F), {2: 1}),
                                                   tg(ds[0], (F, F), {0: 1, 2: 1}),
                                                   tg(ds[2], (T, T))])]
    single = np.zeros((4, 12), np.int32)
    single[0] = _row(2, jmg.DOOR, c1, flags=2)
    scen.append(_scenario(st, 0, single, comp=0, steps=[tg(ds[3], (T, F))]))
    scen.append(_scenario(st, 0, single, comp=0, steps=[tg(ds[0], (T, T))]))
    check_outcomes(scen, run_scenarios("BabyAI-OpenDoorsOrderN4Debug-v0", scen,
                                       extra=tmg.take(st, 0, 4)))


def _carry_next_to(g, mover, fixed, avoid=()):
    """(cell to face, the mover's cell): drop the mover beside ``fixed``."""
    g = g.copy()
    g[mover] = EMPTY_CELL
    return _beside(g, fixed, avoid), mover


def test_movetwoacross_before_putnext_and_b_first():
    """Put a next to b (A latches), then c next to d: success. With c
    already beside d, the drop that completes A succeeds at once."""
    p, st = _reset("BabyAI-MoveTwoAcrossS5N2-v0")
    scen = []
    for i in range(32):
        g, instr = st.grid[i].numpy(), st.instr[i].numpy()
        cells = {(int(g[c][0]), int(g[c][1])): c for c in objects(g)}
        a, b, c, d = (cells[tuple(instr[s][k:k + 2])] for s, k in ((0, 1), (0, 3), (2, 1), (2, 3)))
        if abs(c[0] - d[0]) + abs(c[1] - d[1]) == 1 or a in (c, d) or b in (c, d):
            continue
        first, _ = _carry_next_to(g, a, b)
        if first is None:
            continue
        after = g.copy()
        after[a], after[first] = EMPTY_CELL, g[a]
        second, _ = _carry_next_to(after, c, d)
        moved = g.copy()  # c already beside d
        spot = _beside(moved, d, avoid=(a, b))
        if second is None or spot is None:
            continue
        moved[c], moved[spot] = EMPTY_CELL, g[c]
        early, _ = _carry_next_to(moved, a, b, avoid=(spot,))
        if early is None:
            continue
        drop = jmg.A_DROP
        scen.append(_scenario(st, i, steps=[(first, drop, a, (F, F), {0: 1, 2: 0}),
                                            (second, drop, c, (T, T), {2: 1})]))
        scen.append(_scenario(st, i, grid=moved, steps=[(early, drop, a, (T, T), {0: 1, 2: 1})]))
        if len(scen) == 4:
            break
    assert len(scen) == 4
    check_outcomes(scen, run_scenarios("BabyAI-MoveTwoAcrossS5N2-v0", scen,
                                       extra=tmg.take(st, 0, 4)))


def test_pickuploc_identity_tracking_and_drop_resync():
    """A positional PickupInstr: picking up an object outside the set does
    nothing, dropping it neither; the tracked object succeeds. In and(pickup
    {X}, goto {Y}) the pickup of X latches slot 0 and marks its carry, the
    drop elsewhere moves X's position in the set to the landing cell, and
    facing Y completes the and. A strict non-positional PickupInstr fails on
    another object."""
    p, st = _reset("BabyAI-PickupLoc-v0")
    h = p.height
    scen, expect_sets = [], []
    for i in range(32):
        g = st.grid[i].numpy()
        objs = objects(g)
        x, y = objs[0], next((o for o in objs[1:] if tuple(g[o][:2]) != tuple(g[objs[0]][:2])),
                             None)
        if y is None:
            continue
        px, py = x[0] * h + x[1] + 1, y[0] * h + y[1] + 1
        after = g.copy()
        after[x] = EMPTY_CELL
        land = next((c for c in map(tuple, np.argwhere(after[..., 0] == jmg.EMPTY))
                     if c != x and _can_face(after, c)), None)
        if land is None or not (_can_face(g, x) and _can_face(g, y)):
            continue
        track = np.zeros((4, 12), np.int32)
        track[0] = _row(3, -1, -1, flags=1, poss=[px])
        scen.append(_scenario(st, i, track, comp=0, steps=[
            (y, jmg.A_PICKUP, None, (F, F), None), (land, jmg.A_DROP, None, (F, F), None),
            (x, jmg.A_PICKUP, None, (T, T), None)]))
        pair = np.zeros((4, 12), np.int32)
        pair[0] = _row(3, -1, -1, flags=1, poss=[px])
        pair[1] = _row(1, -1, -1, flags=1, poss=[py])
        scen.append(_scenario(st, i, pair, comp=1, steps=[
            (x, jmg.A_PICKUP, None, (F, F), {0: 1, 1: 0}),
            (land, jmg.A_DROP, None, (F, F), {0: 1}), (y, jmg.A_DONE, None, (T, T), {1: 1})]))
        expect_sets.append((len(scen) - 1, px, land[0] * h + land[1] + 1))
        strict = np.zeros((4, 12), np.int32)
        strict[0] = _row(3, int(g[x][0]), int(g[x][1]), flags=2)
        scen.append(_scenario(st, i, strict, comp=0, steps=[(y, jmg.A_PICKUP, None, (T, F), None)]))
        if len(scen) >= 6:
            break
    assert len(scen) == 6
    out = run_scenarios("BabyAI-PickupLoc-v0", scen, extra=tmg.take(st, 0, 4))
    check_outcomes(scen, out)
    for i, old, new in expect_sets:
        assert out[0][3][i, 0, 1] == old  # the carry marks the tracked position
        assert set(out[1][2][i, 0, 6:]) == {new, 0} and out[1][3][i, 0, 1] == 0


@pytest.mark.parametrize("env_id", ["BabyAI-MiniBossLevel-v0", "BabyAI-GoToSeqS5R2-v0"])
def test_levelgen_steps_equal(env_id):
    """The LevelGen levels' own instructions: resets stepped at random, and
    each reset with its slot 0 made to succeed first where it can: goto by
    facing a match, open by toggling one, pickup by picking one up."""
    p, st = _reset(env_id, n=24, seed=4)
    scen = []
    for i in range(24):
        g, row = st.grid[i].numpy(), st.instr[i, 0].numpy()
        if row[5] & 1:
            cells = [((v - 1) // p.height, (v - 1) % p.height) for v in row[6:12] if v]
        else:
            cells = [tuple(c) for c in np.argwhere(_matches(g, row[1], row[2]))]
        action = {1: jmg.A_DONE, 2: jmg.A_TOGGLE, 3: jmg.A_PICKUP}.get(int(row[0]))
        comp = int(st.target[i, 0])
        gated = comp < 3 or st.instr[i, 1, 0] > 0  # after(A, B) verifies a single A after B
        for c in cells:
            if (action is None or (g[c][0] == jmg.DOOR and g[c][2] == jmg.LOCKED)
                    or not _can_face(g, c)):
                continue
            scen.append(_scenario(st, i, steps=[(c, action, None, (T, T) if comp == 0 else None,
                                                 {0: 1} if gated else None)]))
            break
    assert len(scen) >= 8
    check_outcomes(scen, run_scenarios(env_id, scen, extra=st, tail=10))
