"""The port's native Atari games and vector env against the JAX package's.

(a) Breakout, Pong and Seaquest: both packages step the same states with
the same random actions for a few hundred steps. The port's state is taken
across from the JAX state before each step (``convert.atari_vec_state``), so
a fault shows at the step that makes it; the step's draws (Breakout's serve
x and direction, Pong's serve direction and speed, Seaquest's spawns) are
rebuilt from the JAX state's key with the splits ``core.py`` and
``seaquest.py`` make. Next states, frames, rewards, ``terminated`` and
game-over must be EQUAL, and so must the text descriptions.

(b) ``AtariVectorEnv``: both vector envs run side by side from the same
reset, each carrying its own state, the port fed the JAX chain's draws. A
few games start one life (or one point) from their end, so game over,
autoreset, the restarted stack and the episode statistics occur in the
run. Stacks, rewards, flags and statistics must be EQUAL.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.envs.atari import core as jcore
from clip_ppo_tpu.envs.atari import seaquest as jsq
from clip_ppo_tpu.envs.atari.vector import AtariVectorEnv as JAtariVectorEnv
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.envs.atari import core as tcore
from clip_ppo_tpu_torch.envs.atari import seaquest as tsq
from clip_ppo_tpu_torch.envs.atari.vector import AtariVectorEnv

GAMES = {"breakout": "ALE/Breakout-v5", "pong": "ALE/Pong-v5", "seaquest": "ALE/Seaquest-v5"}
N = 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_draws(game: str):
    """The jitted map from the JAX games' keys [N, 2] to the draws their
    next step makes, in the port's form (numpy leaves)."""

    def one(rng):
        if game == "breakout":
            _, k_launch = jax.random.split(rng)
            kx, kd, _ = jax.random.split(k_launch, 3)
            lo, hi = tcore.BK_SERVE_X
            return (jax.random.uniform(kx, (), minval=lo, maxval=hi), jax.random.bernoulli(kd))
        if game == "pong":
            _, k_serve = jax.random.split(rng)
            kd, kv, _ = jax.random.split(k_serve, 3)
            lo, hi = tcore.PG_SERVE_DY
            return (jax.random.bernoulli(kd), jax.random.uniform(kv, (), minval=lo, maxval=hi))
        out = []
        for _ in range(jcore.SUBSTEPS):  # seaquest._sq_substep, once a frame
            rng, k_en, k_dv = jax.random.split(rng, 3)
            frame = []
            for k, n, p in ((k_en, jsq.N_ENEMIES, 0.02), (k_dv, jsq.N_DIVERS, 0.01)):
                ks, kl, kd = jax.random.split(k, 3)
                frame.append((jax.random.bernoulli(ks, p, (n,)),
                              jax.random.randint(kl, (n,), 0, len(jsq.LANES)),
                              jax.random.bernoulli(kd, 0.5, (n,))))
            out.append(frame)
        stack = lambda who, i: jnp.stack([f[who][i] for f in out])  # noqa: E731
        return tuple(stack(who, i) for who in (0, 1) for i in range(3))

    return jax.jit(jax.vmap(one))


def _port_draws(game: str, draws) -> tuple:
    cls = {"breakout": tcore.BreakoutDraws, "pong": tcore.PongDraws,
           "seaquest": tsq.SeaquestDraws}[game]
    ts = [torch.as_tensor(np.array(d)) for d in draws]
    if game == "seaquest":
        ts = [t.long() if t.dtype == torch.int32 else t for t in ts]
    return cls(*ts)


def _port_state(jstate, game: str):
    """The port's batched game state from the JAX one."""
    jv = type("V", (), {"env": jstate, "frames": np.zeros((1, 1, 1, 1), np.uint8),
                        "episode_return": np.zeros(1), "episode_length": np.zeros(1)})
    return convert.atari_vec_state(jv, game).env


def _assert_state_equal(ts, js, where: str):
    js = _np(js)
    for f in dataclasses.fields(ts):
        got, want = getattr(ts, f.name).numpy(), getattr(js, f.name)
        assert got.dtype == want.dtype, f"{where}: {f.name} {got.dtype} vs {want.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=f"{where}: {f.name}")


@pytest.mark.parametrize("game", list(GAMES))
def test_game_steps_and_frames_equal_jax(game):
    jp = jcore.parse_atari_id(GAMES[game])
    tp = tcore.parse_atari_id(GAMES[game])
    assert tp.num_actions == jp.num_actions
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    jstate = jax.vmap(lambda k: jcore.reset(jp, k))(keys)
    jstep = jax.jit(jax.vmap(lambda s, a: jcore.step(jp, s, a)))
    jrender = jax.jit(jax.vmap(lambda s: jcore.render(jp, s)))
    jdraws = _jax_draws(game)

    treset = tcore.reset(tp, N, "cpu")
    for f in dataclasses.fields(treset):  # the reset, all but the key
        np.testing.assert_array_equal(getattr(treset, f.name).numpy(),
                                      np.asarray(getattr(jstate, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(tcore.render(tp, treset).numpy(), np.asarray(jrender(jstate)))

    rs = np.random.RandomState(len(game))
    totals = {"reward": 0.0, "terminated": 0, "game_over": 0}
    for t in range(300):
        actions = rs.randint(0, jp.num_actions, N).astype(np.int32)
        draws = _port_draws(game, jdraws(jstate.rng))
        tstate = _port_state(jstate, game)
        if t % 50 == 0 and game != "seaquest":
            assert tcore.describe_states(tp, tstate) == jcore.describe_states(jp, jstate, N)
        jstate, jr, jterm, jover = jstep(jstate, jnp.asarray(actions))
        tstate, tr, tterm, tover = tcore.step(tp, tstate, torch.as_tensor(actions), draws)
        where = f"{game} step {t}"
        _assert_state_equal(tstate, jstate, where)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr), err_msg=where)
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm), err_msg=where)
        np.testing.assert_array_equal(tover.numpy(), np.asarray(jover), err_msg=where)
        np.testing.assert_array_equal(tcore.render(tp, tstate).numpy(), np.asarray(jrender(jstate)),
                                      err_msg=where)
        totals["reward"] += float(np.abs(np.asarray(jr)).sum())
        totals["terminated"] += int(np.asarray(jterm).sum())
        totals["game_over"] += int(np.asarray(jover).sum())
    # The run exercised scoring and life loss, not only the serve.
    assert totals["reward"] > 0 and (game == "pong" or totals["terminated"] > 0), totals
    if game == "seaquest":
        with pytest.raises(ValueError, match="Seaquest not supported"):
            tcore.describe_states(tp, tstate)


def _near_the_end(jstate, game: str):
    """Half of the games one life (or, Pong, one point each way) from the end."""
    end = np.arange(N) % 2 == 0
    if game == "pong":
        return dataclasses.replace(
            jstate, player_score=jnp.where(end, 20, jstate.player_score),
            enemy_score=jnp.where(end, 20, jstate.enemy_score))
    return dataclasses.replace(jstate, lives=jnp.where(end, 1, jstate.lives))


@pytest.mark.parametrize("game", list(GAMES))
def test_vector_env_stack_autoreset_and_stats_equal_jax(game):
    jenv = JAtariVectorEnv(GAMES[game], N)
    tenv = AtariVectorEnv(GAMES[game], N, "cpu")
    assert (tenv.num_actions, tenv.obs_size) == (jenv.num_actions, jenv.obs_size)
    jstate, jobs = jenv.reset_fn(jax.random.PRNGKey(5))
    tstate, tobs = tenv.reset_fn(None)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    jstate = dataclasses.replace(jstate, env=_near_the_end(jstate.env, game))
    tstate = convert.atari_vec_state(_np(jstate), game)
    jdraws = _jax_draws(game)
    rs = np.random.RandomState(11)
    games_over = 0
    for t in range(160):
        actions = rs.randint(0, jenv.num_actions, N).astype(np.int32)
        draws = _port_draws(game, jdraws(jstate.env.rng))
        jstate, jobs, jr, jterm, jtrunc, jinfo = jenv.step_fn(jstate, jnp.asarray(actions))
        tstate, tobs, tr, tterm, ttrunc, tinfo = tenv.step_fn(
            tstate, torch.as_tensor(actions), draws=draws)
        where = f"{game} step {t}"
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs), err_msg=where)
        np.testing.assert_array_equal(tstate.frames.numpy(), np.asarray(jstate.frames))
        for got, want in ((tr, jr), (tterm, jterm), (ttrunc, jtrunc)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=where)
        for k in ("done_mask", "episode_return", "episode_length"):
            np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                          err_msg=f"{where} {k}")
        np.testing.assert_array_equal(tstate.episode_return.numpy(),
                                      np.asarray(jstate.episode_return), err_msg=where)
        np.testing.assert_array_equal(tstate.episode_length.numpy(),
                                      np.asarray(jstate.episode_length), err_msg=where)
        _assert_state_equal(tstate.env, jstate.env, where)
        games_over += int(np.asarray(jinfo["done_mask"]).sum())
    assert games_over > 0  # autoreset and the restarted stack were exercised
    np.testing.assert_array_equal(tenv.render_env0(tstate).numpy(),
                                  np.asarray(jenv.render_env0(jstate)))
    assert tenv.rollout_desc(tstate) == jenv.rollout_desc(jstate) == {}
    if game != "seaquest":
        assert tenv.describe(tstate) == jenv.describe(jstate)


def test_parse_atari_id_refuses_other_games():
    assert tcore.parse_atari_id("BreakoutNoFrameskip-v4") == tcore.AtariParams("breakout")
    with pytest.raises(ValueError, match="unsupported Atari env id"):
        tcore.parse_atari_id("ALE/Asteroids-v5")


def test_step_draws_from_the_generator_when_not_given():
    env = AtariVectorEnv("ALE/Pong-v5", 4, "cpu")
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        state, _ = env.reset_fn(gen)
        for _ in range(3):  # the serve happens at the second step
            state, obs, *_ = env.step_fn(state, torch.zeros(4, dtype=torch.long), gen)
        outs.append((obs, state.env.ball_vy))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert outs[0][1].abs().max() > 0 and len(set(outs[0][1].tolist())) > 1
