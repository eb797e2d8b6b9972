"""The port's MiniGrid (Empty-*, DoorKey-*) against the JAX package's.

States are carried across with ``clip_ppo_tpu_torch.convert``; both
packages step them with the same actions, and observations, rewards,
terminated/truncated flags and next states must be EQUAL (all integers,
and the reward is the same float32 expression). DoorKey batches include
crafted mid-episode states: the agent facing the key (then PICKUP), and
the agent carrying the key facing the locked door (then TOGGLE and
FORWARD through it). Resets draw from different generators in the two
packages, so DoorKey resets are held to the layout's structural properties.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.envs import JaxVectorEnv
from clip_ppo_tpu.envs.minigrid import core as jmg
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.envs.minigrid import core as tmg
from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv

STEPS = 24


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_resets(params, n, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return jax.vmap(jmg.reset, in_axes=(None, 0))(params, keys)


def _craft_doorkey(states, params):
    """Two crafted mid-episode DoorKey states appended to a reset batch:
    [-2] faces the key; [-1] carries the key and faces the locked door."""
    s = _np_tree(states)
    grid = np.array(s.grid)
    pos, dirs, carry = np.array(s.agent_pos), np.array(s.agent_dir), np.array(s.carrying)
    # env 0: stand left of or above the key, facing it
    g = grid[0]
    kx, ky = np.argwhere(g[..., 0] == jmg.KEY)[0]
    for d, (dx, dy) in enumerate(jmg.DIR_TO_VEC):
        ax, ay = kx - dx, ky - dy
        if g[ax, ay, 0] == jmg.EMPTY:
            facing_key = (g, np.array([ax, ay]), d, np.zeros(3, np.int8))
            break
    # env 1: key in hand, standing left of the door, facing right
    g = grid[1].copy()
    kx, ky = np.argwhere(g[..., 0] == jmg.KEY)[0]
    g[kx, ky] = [jmg.EMPTY, 0, 0]
    dx, dy = np.argwhere(g[..., 0] == jmg.DOOR)[0]
    facing_door = (g, np.array([dx - 1, dy]), 0, np.array([jmg.KEY, jmg.YELLOW, 0], np.int8))
    for cg, cp, cd, cc in (facing_key, facing_door):
        grid = np.concatenate([grid, cg[None]])
        pos = np.concatenate([pos, cp[None]])
        dirs = np.concatenate([dirs, [cd]])
        carry = np.concatenate([carry, cc[None]])
    n = grid.shape[0]
    return jmg.EnvState(
        grid=jnp.asarray(grid), agent_pos=jnp.asarray(pos, jnp.int32),
        agent_dir=jnp.asarray(dirs, jnp.int32), carrying=jnp.asarray(carry),
        step_count=jnp.asarray(np.concatenate([np.array(s.step_count), [5, 9]]), jnp.int32),
        rng=jnp.concatenate([s.rng, s.rng[:2]]),
        target=jnp.zeros((n, 8), jnp.int32), instr=jnp.zeros((n, 4, 12), jnp.int32),
        instr_state=jnp.zeros((n, 4, 2), jnp.int32),
    )


def _assert_state_equal(ts: tmg.EnvState, js):
    js = _np_tree(js)
    np.testing.assert_array_equal(ts.grid.numpy(), js.grid)
    np.testing.assert_array_equal(ts.agent_pos.numpy(), js.agent_pos)
    np.testing.assert_array_equal(ts.agent_dir.numpy(), js.agent_dir)
    np.testing.assert_array_equal(ts.carrying.numpy(), js.carrying)
    np.testing.assert_array_equal(ts.step_count.numpy(), js.step_count)


@pytest.mark.parametrize("env_id", [
    "MiniGrid-Empty-5x5-v0", "MiniGrid-Empty-16x16-v0", "MiniGrid-DoorKey-6x6-v0",
])
def test_step_and_observe_equal(env_id):
    jp, tp = jmg.parse_env_id(env_id), tmg.parse_env_id(env_id)
    assert (jp.width, jp.height, jp.max_steps, jp.see_through_walls) == \
        (tp.width, tp.height, tp.max_steps, tp.see_through_walls)
    js = _jax_resets(jp, 6, seed=3)
    scripted = {}
    if jp.kind == "doorkey":
        js = _craft_doorkey(js, jp)
        n = js.grid.shape[0]
        scripted = {n - 2: [jmg.A_PICKUP], n - 1: [jmg.A_TOGGLE, jmg.A_FORWARD, jmg.A_FORWARD]}
    n = js.grid.shape[0]
    ts = convert.env_state(_np_tree(js))
    rng = np.random.RandomState(0)
    actions = rng.randint(0, jp.num_actions, size=(STEPS, n))
    for env_i, seq in scripted.items():
        actions[: len(seq), env_i] = seq
    jstep = jax.jit(jax.vmap(jmg.step, in_axes=(None, 0, 0)), static_argnums=0)
    jobs = jax.jit(jax.vmap(jmg.observe, in_axes=(None, 0)), static_argnums=0)
    for t in range(STEPS):
        np.testing.assert_array_equal(tmg.observe(tp, ts).numpy(), np.asarray(jobs(jp, js)))
        a = actions[t]
        js, jr, jterm, jtrunc = jstep(jp, js, jnp.asarray(a, jnp.int32))
        ts, tr, tterm, ttrunc = tmg.step(tp, ts, torch.as_tensor(a))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc))
        _assert_state_equal(ts, js)
    if scripted:
        carrying = ts.carrying.numpy()
        assert carrying[n - 2, 0] == jmg.KEY  # picked the key up
        g = ts.grid.numpy()[n - 1]
        assert (g[..., 0] == jmg.DOOR).any() and (g[g[..., 0] == jmg.DOOR][:, 2] == jmg.OPEN).all()


def test_render_equal():
    jp, tp = jmg.parse_env_id("MiniGrid-DoorKey-6x6-v0"), tmg.parse_env_id("MiniGrid-DoorKey-6x6-v0")
    js = jax.tree_util.tree_map(lambda x: x[0], _jax_resets(jp, 1, seed=1))
    ts = convert.env_state(_np_tree(jax.tree_util.tree_map(lambda x: x[None], js)))
    want = np.asarray(jmg.render_rgb(jp, js))
    got = tmg.render_rgb(tp, ts.grid[0], ts.agent_pos[0], ts.agent_dir[0]).numpy()
    np.testing.assert_array_equal(got, want)


def test_vector_env_autoreset_equal():
    """Same-step autoreset and episode stats on Empty-5x5 (whose reset is
    deterministic, so both packages restart identically): the goal is
    reached with the fifth action and the episode restarts in the same step."""
    jenv = JaxVectorEnv("MiniGrid-Empty-5x5-v0", 3)
    tenv = TorchVectorEnv("MiniGrid-Empty-5x5-v0", 3, "cpu")
    js, jobs = jenv.reset_fn(jax.random.PRNGKey(0))
    ts = convert.vec_state(_np_tree(js))
    gen = torch.Generator()
    np.testing.assert_array_equal(tenv.observe_fn(ts).numpy(), np.asarray(jobs))
    path = [jmg.A_FORWARD, jmg.A_FORWARD, jmg.A_RIGHT, jmg.A_FORWARD, jmg.A_FORWARD, jmg.A_LEFT]
    rng = np.random.RandomState(1)
    for t in range(12):
        a = np.array([path[t % len(path)], rng.randint(7), rng.randint(7)])
        js, jobs, jr, jterm, jtrunc, jinfo = jenv.step_fn(js, jnp.asarray(a, jnp.int32))
        ts, tobs, tr, tterm, ttrunc, tinfo = tenv.step_fn(ts, torch.as_tensor(a), gen)
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        for k in ("done_mask", "episode_return", "episode_length"):
            np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]))
        _assert_state_equal(ts.env, js.env)
        np.testing.assert_array_equal(ts.episode_return.numpy(), np.asarray(js.episode_return))
        if t == 4:
            assert bool(tinfo["done_mask"][0])  # reached the goal, restarted


def test_doorkey_reset_statistics():
    """Every DoorKey-6x6 reset: a full wall column at x in [2, w-3] holding
    one locked yellow door at a row in [1, w-3]; agent and yellow key on
    distinct empty cells left of it; goal at (w-2, h-2). Over 64 resets
    both wall columns and all four start directions occur."""
    p = tmg.parse_env_id("MiniGrid-DoorKey-6x6-v0")
    gen = torch.Generator()
    gen.manual_seed(0)
    st = tmg.reset(p, 64, gen, "cpu")
    w, h = p.width, p.height
    splits, dirs = set(), set()
    for i in range(64):
        g = st.grid[i].numpy()
        obj = g[..., 0]
        cols = [x for x in range(1, w - 1) if (obj[x, 1:h - 1] != tmg.EMPTY).all()
                and (obj[x, 1:h - 1] != tmg.KEY).all()]
        assert len(cols) == 1
        split = cols[0]
        splits.add(split)
        assert 2 <= split <= w - 3
        door = np.argwhere(obj == tmg.DOOR)
        assert len(door) == 1 and door[0][0] == split and 1 <= door[0][1] <= w - 3
        assert tuple(g[door[0][0], door[0][1]]) == (tmg.DOOR, tmg.YELLOW, tmg.LOCKED)
        key = np.argwhere(obj == tmg.KEY)
        assert len(key) == 1 and key[0][0] < split and g[key[0][0], key[0][1], 1] == tmg.YELLOW
        ax, ay = st.agent_pos[i].tolist()
        assert ax < split and obj[ax, ay] == tmg.EMPTY and (ax, ay) != tuple(key[0])
        assert obj[w - 2, h - 2] == tmg.GOAL
        dirs.add(int(st.agent_dir[i]))
    assert splits == {2, 3} and dirs == {0, 1, 2, 3}


def test_parse_env_id_rejects_later_families():
    """Ids the JAX package does not run raise with the list the port runs;
    the families a later slice brought (the last, BabyAI's composite
    levels, hence the name) parse."""
    for env_id in ("BabyAI-PickupLoc-v0", "BabyAI-GoToSeq-v0"):
        assert tmg.parse_env_id(env_id).success == "babyai_seq"
    for env_id in ("MiniGrid-WFC-MazeSimple-v0", "BabyAI-GoToSeqS9R4-v0"):
        with pytest.raises(ValueError, match="unsupported MiniGrid env id.*BabyAI-PickupLoc"):
            tmg.parse_env_id(env_id)
