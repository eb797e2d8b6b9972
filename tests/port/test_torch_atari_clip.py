"""The Atari CLIP pieces of the port against the JAX package's.

(c) ``stack_frames``: the port's plain version (K1's plain version once a
frame) against ``disturb(x, key, p, "stack_frames")``, the draws rebuilt
from the JAX splits (``split(key, S)``, then ``split(k, 3)`` a frame), at
every severity, 2e-6 absolute on [0, 1] values as ``test_torch_disturb.py``
holds the batched pipeline.

(d) The multi-frame embeddings (``make_multiframe_embed_fn``) and the
FROZEN_CLIP stack features (``make_frozen_clip_stack_features_fn``) at a
tiny tower (image 32, patch 16, width 128, 2 layers): 1e-4 in float32, and
in bf16 2e-2 of the largest value, the bound ``tests/test_clip.py`` puts on
bf16 (the two packages round the same bf16 steps in other orders). The
projected CLIP loss and its gradients through the whole minibatch loss
agree to float32 round-off, and the CLIP term's own gradient reaches
``temporal_projection`` alone in both.

(e) One Trainer iteration of the image modality, clean and under HARD
``stack_frames`` disturbances: the JAX Trainer's rollout, GAE, multi-frame
encode (float32) and projected update against the port's, with the state
carried by ``convert`` and every draw (the Gumbel batch, each step's
disturbance of each frame, the games' serves, the permutations) rebuilt
from the JAX key chain. Actions, rewards, flags and the stored stacks are
equal (disturbed stacks within one uint8 level, at most 2 in 10,000
elements apart: the blur's float sums round apart, see the test); values,
log-probs and embeddings within 1e-4, the losses 1e-4 relative, the
parameters within 1e-4 after 4 Adam steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.envs.atari.vector import AtariVectorEnv as JAtariVectorEnv
from clip_ppo_tpu.models import agent as jagent
from clip_ppo_tpu.models import clip_utils as jcu
from clip_ppo_tpu.models.clip import CLIPConfig
from clip_ppo_tpu.ops.disturbances import _cutout_patch_hw, disturb as jdisturb
from clip_ppo_tpu.ops.severity import DisturbanceSeverity as JSev
from clip_ppo_tpu.ops.severity import SEVERITY_CONFIGS as JSEVERITY
from clip_ppo_tpu.train import PPOConfig as JPPOConfig
from clip_ppo_tpu.train import Trainer as JTrainer
from clip_ppo_tpu.train import ppo as jppo
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.envs.atari import core as tcore
from clip_ppo_tpu_torch.envs.atari.vector import AtariVectorEnv
from clip_ppo_tpu_torch.models import agent as tagent
from clip_ppo_tpu_torch.models import clip_utils as tcu
from clip_ppo_tpu_torch.models.clip import model as tmodel
from clip_ppo_tpu_torch.models.clip.config import CLIPConfig as TCLIPConfig
from clip_ppo_tpu_torch.ops import disturbances as td
from clip_ppo_tpu_torch.ops.severity import DisturbanceSeverity as TSev
from clip_ppo_tpu_torch.ops.severity import SEVERITY_CONFIGS as TSEVERITY
from clip_ppo_tpu_torch.train import ppo as tppo
from clip_ppo_tpu_torch.train.runner import Draws, Trainer as TTrainer, TrainState
from clip_ppo_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

TINY = dict(embed_dim=512, image_size=32, patch_size=16, vision_width=128, vision_layers=2,
            vision_heads=2, text_width=128, text_heads=2, text_layers=1, vocab_size=49408)
ENV_ID = "ALE/Breakout-v5"
CFG = dict(num_envs=2, num_steps=8, num_minibatches=2, update_epochs=2, clip_mode="projected")
SEVERITIES = ("MILD", "MODERATE", "HARD", "SEVERE")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tower():
    """The JAX package's tree (numpy leaves), and the port's in float32."""
    gen = torch.Generator()
    gen.manual_seed(5)
    jp = tree_map(lambda t: t.numpy(), tmodel.init_clip_params(gen, TCLIPConfig(**TINY), "cpu"))
    return jp, convert.clip_params(jp)


def _jax_agent_params(seed: int, num_actions: int) -> dict:
    """Atari agent params (4 input channels, temporal projection) in the JAX
    package's layout (conv kernels HWIO), drawn by the port's initializer."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    out = tree_map(lambda t: t.numpy(), tagent.init_agent_params(
        gen, num_actions, "cpu", in_channels=4, with_temporal_projection=True))
    for name in ("conv1", "conv2", "conv3"):
        out["trunk"][name]["w"] = np.ascontiguousarray(out["trunk"][name]["w"].transpose(2, 3, 1, 0))
    return out


def _frame_draws(key, frame_shape, params):
    """The draws ``disturb(..., "batched")`` makes for one frame
    (`disturbances.py:222-228`), in the port's form."""
    _, h, w, _ = frame_shape
    k_noise, k_contrast, k_cutout = jax.random.split(key, 3)
    lo, hi = params.contrast_range
    factor = jax.random.uniform(k_contrast, (), jnp.float32, minval=lo, maxval=hi)
    ph, pw = _cutout_patch_hw(h, w, params.cutout_ratio)
    kh, kw = jax.random.split(k_cutout)
    sh = jax.random.randint(kh, (), 0, max(1, h - ph + 1))
    sw = jax.random.randint(kw, (), 0, max(1, w - pw + 1))
    noise = np.array(jax.random.normal(k_noise, frame_shape, jnp.float32))
    return td.DisturbanceDraws(torch.as_tensor(noise), torch.tensor(float(factor)),
                               torch.tensor([int(sh), int(sw)], dtype=torch.int32))


def _stack_draws(key, x_shape, params):
    """The draws of ``disturb(..., "stack_frames")``: ``split(key, S)``, one
    batched call a frame (`disturbances.py:209-220`)."""
    frame = tuple(x_shape[:-1]) + (1,)
    return tuple(_frame_draws(k, frame, params) for k in jax.random.split(key, x_shape[-1]))


@pytest.mark.parametrize("severity", SEVERITIES)
def test_stack_frames_matches_jax(severity):
    jparams = JSEVERITY[JSev[severity]]
    x = np.random.RandomState(len(severity)).rand(3, 84, 84, 4).astype(np.float32)
    key = jax.random.PRNGKey(17)
    want = np.asarray(jdisturb(jnp.asarray(x), key, jparams, "stack_frames"))
    draws = _stack_draws(key, x.shape, jparams)
    got = td.disturb(torch.as_tensor(x), TSEVERITY[TSev[severity]], draws, "stack_frames")
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
    # Each frame drew its own: the frames of one stack are disturbed apart.
    assert len({float(d.factor) for d in draws}) == 4


def test_stack_frames_draws_one_batched_call_a_frame():
    params = TSEVERITY[TSev.HARD]
    x = torch.rand(2, 84, 84, 4, generator=torch.Generator().manual_seed(1))
    draws = td.draw(x, params, torch.Generator().manual_seed(2), "stack_frames")
    assert len(draws) == 4 and all(d.noise.shape == (2, 84, 84, 1) for d in draws)
    assert all(d.factor.dim() == 0 and d.origin.shape == (2,) for d in draws)
    got = td.disturb(x, params, draws, "stack_frames")
    for s, d in enumerate(draws):
        torch.testing.assert_close(got[..., s:s + 1], td.disturb(x[..., s:s + 1], params, d),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="3 draws for 4 frames"):
        td.disturb(x, params, draws[:3], "stack_frames")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multiframe_embeddings_and_frozen_stack_features_match_jax(tower, dtype):
    jp, tp = tower
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if tdt == torch.bfloat16:
        tp = tmodel.cast_tower(tp, torch.bfloat16)
    obs = np.random.RandomState(6).randint(0, 256, (3, 84, 84, 4)).astype(np.uint8)
    np.testing.assert_array_equal(
        tcu.stack_to_rgb_frames(torch.as_tensor(obs)).numpy(),
        np.asarray(jcu.stack_to_rgb_frames(jnp.asarray(obs))))
    cfg, tcfg = CLIPConfig(**TINY), TCLIPConfig(**TINY)
    want = np.asarray(jax.jit(jcu.make_multiframe_embed_fn(cfg, jdt))(jnp.asarray(obs),
                                                                       {"clip": jp}))
    got = tcu.make_multiframe_embed_fn(tcfg, tdt)(torch.as_tensor(obs), {"clip": tp})
    assert got.dtype == torch.float32 and got.shape == (3, 4 * 512)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(got.reshape(3, 4, 512).norm(dim=-1).numpy(), 1.0, rtol=1e-5)

    params = _jax_agent_params(1, 4)
    jfeat = jcu.make_frozen_clip_stack_features_fn(cfg, jdt)
    want = np.asarray(jax.jit(jfeat)(params, jnp.asarray(obs), {"clip": jp}))
    tparams = convert.agent_params(params)
    tfeat = tcu.make_frozen_clip_stack_features_fn(tcfg, tdt)
    got = tfeat(tparams, torch.as_tensor(obs), {"clip": tp})
    assert got.shape == (3, 512)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=(1e-4 if dtype == "float32" else 2e-2) * max(scale, 1.0))
    # The gradient reaches the projection and stops at the frozen tower.
    live = {k: v.detach().requires_grad_(True) for k, v in tparams["temporal_projection"].items()}
    out = tfeat(dict(tparams, temporal_projection=live), torch.as_tensor(obs), {"clip": tp})
    out.sum().backward()
    assert live["w"].grad.abs().sum() > 0
    assert all(t.grad is None for t in tree_leaves(tp) if t.is_floating_point())


def _loss_batch(seed: int, b: int = 8) -> dict:
    rs = np.random.RandomState(seed)
    emb = rs.randn(b, 4, 512).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    return {
        "obs": rs.randint(0, 256, (b, 84, 84, 4)).astype(np.uint8),
        "actions": rs.randint(0, 4, b).astype(np.int32),
        "logprobs": (np.log(0.25) + 0.1 * rs.randn(b)).astype(np.float32),
        "advantages": rs.randn(b).astype(np.float32),
        "returns": rs.randn(b).astype(np.float32),
        "values": rs.randn(b).astype(np.float32),
        "emb": emb.reshape(b, -1),
    }


def test_projected_loss_and_gradients_match_jax():
    """The whole minibatch loss with the projected CLIP term (λ = 0.5): loss,
    aux and every gradient; and the CLIP term's own gradient, which reaches
    ``temporal_projection`` and no other parameter in either package."""
    b = _loss_batch(3)
    params = _jax_agent_params(2, 4)
    jcfg, tcfg = JPPOConfig(**CFG), tppo.PPOConfig(**CFG)
    mb = {k: v for k, v in b.items() if k != "emb"}
    jmb = {k: jnp.asarray(v) for k, v in mb.items()}
    emb = jnp.asarray(b["emb"])

    def jloss(p):
        return jppo.ppo_loss(p, jmb, jcfg, jagent.cnn_features, emb, jnp.float32(0.5),
                             jnp.bool_(True))

    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    jclip_grads = jax.jit(jax.grad(lambda p: jloss(p)[1]["clip_loss"]))(params)

    tparams = convert.agent_params(params)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tparams)]
    tmb = {k: torch.as_tensor(v) for k, v in mb.items()}
    tl, taux = tppo.ppo_loss(tparams, tmb, tcfg, tagent.cnn_features, torch.as_tensor(b["emb"]),
                             0.5, True)
    tgrads = torch.autograd.grad(tl, leaves, retain_graph=True)
    tclip = torch.autograd.grad(taux["clip_loss"], leaves, allow_unused=True,
                                materialize_grads=True)

    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(taux[k].detach()), float(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(taux["clip_loss"].detach()) > 0.0
    for which, got_tree, want_tree in (
            ("loss", tree_unflatten(tparams, list(tgrads)), convert.agent_params(_np(jgrads))),
            ("clip", tree_unflatten(tparams, list(tclip)), convert.agent_params(_np(jclip_grads)))):
        got_named, want_named = _named(got_tree), _named(want_tree)
        assert got_named.keys() == want_named.keys()
        for name, want in want_named.items():
            got = got_named[name]
            if which == "clip":
                on_projection = name.startswith("temporal_projection")
                moved = (bool(got.abs().max() > 0), bool(want.abs().max() > 0))
                assert moved == (on_projection, on_projection), name
            scale = max(float(want.abs().max()), 1e-6)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4 * scale,
                                       err_msg=f"{which} {name}")


def _named(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        return {n: v for k in tree for n, v in _named(tree[k], f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


def _port_state(jstate) -> TrainState:
    return TrainState(
        params=convert.agent_params(_np(jstate.params)),
        opt_state=convert.adam_state(_np(jstate.opt_state)),
        vec_state=convert.atari_vec_state(_np(jstate.vec_state), "breakout"),
        obs=torch.as_tensor(np.array(jstate.obs)),
        next_done=torch.as_tensor(np.array(jstate.next_done)),
        gen=torch.Generator(),
    )


def _env_draws(jenv, vec_state, actions) -> list:
    """Each rollout step's serve draws, from the JAX games' keys as the JAX
    env steps them with the rollout's actions."""
    out = []
    for a in np.asarray(actions):
        def one(rng):
            _, k_launch = jax.random.split(rng)
            kx, kd, _ = jax.random.split(k_launch, 3)
            lo, hi = tcore.BK_SERVE_X
            return jax.random.uniform(kx, (), minval=lo, maxval=hi), jax.random.bernoulli(kd)

        x, right = jax.vmap(one)(vec_state.env.rng)
        out.append(tcore.BreakoutDraws(torch.as_tensor(np.array(x)),
                                       torch.as_tensor(np.array(right))))
        vec_state = jenv._jit_step(vec_state, jnp.asarray(a))[0]
    return out


@pytest.mark.parametrize("severity", [None, "HARD"])
def test_trainer_image_modality_iteration_matches_jax(tower, severity):
    jp, tp = tower
    jcfg, lam = JPPOConfig(**CFG), 0.5
    jdist = None if severity is None else JSEVERITY[JSev[severity]]
    jenv = JAtariVectorEnv(ENV_ID, CFG["num_envs"])
    # 2 iterations: λ's warmup (0.2 of them) rounds to none, so the first
    # iteration already runs the full λ.
    jtr = JTrainer(jcfg, jenv, 2, disturbance=jdist, disturbance_semantics="stack_frames",
                   embed_images_fn=jcu.make_multiframe_embed_fn(CLIPConfig(**TINY), jnp.float32),
                   clip_lambda=lam, frozen_params={"clip": jp})
    jstate = jtr.init_state(_jax_agent_params(4, jenv.num_actions), 3)

    def one_iteration(state, frozen):
        state1, batch = jtr._rollout(state, frozen)
        data = jtr._data2d(state1, batch, frozen)
        emb = jtr.embed_images_fn(data["obs"].reshape((-1,) + data["obs"].shape[2:]), frozen)
        state2, scalars = jtr._update(state1, data, jnp.int32(1), emb, frozen)
        return batch, emb, scalars, state2

    jbatch, jemb, jscalars, jstate2 = jax.jit(one_iteration)(jstate, jtr.frozen_params)

    # The JAX iteration's draws (rollout.py:96-106, runner.py:500, ppo.py:298).
    key, k_gumbel = jax.random.split(jstate.key)
    gumbels = jax.random.gumbel(k_gumbel, (8, 2, jenv.num_actions), jnp.float32)
    disturb = None
    if jdist is not None:
        disturb = []
        for _ in range(CFG["num_steps"]):
            key, k_dist = jax.random.split(key)
            disturb.append(_stack_draws(k_dist, (2, 84, 84, 4), jdist))
    _, k_update = jax.random.split(key)
    perms = np.stack([np.asarray(jax.random.permutation(k, jcfg.batch_size))
                      for k in jax.random.split(k_update, jcfg.update_epochs)])
    draws = Draws(torch.as_tensor(np.array(gumbels)), disturb, torch.as_tensor(perms),
                  env=_env_draws(jenv, jstate.vec_state, jbatch.actions))

    tenv = AtariVectorEnv(ENV_ID, CFG["num_envs"], "cpu")
    ttr = TTrainer(tppo.PPOConfig(**CFG), tenv, 2,
                   disturbance=None if severity is None else TSEVERITY[TSev[severity]],
                   disturbance_semantics="stack_frames",
                   embed_images_fn=tcu.make_multiframe_embed_fn(TCLIPConfig(**TINY), torch.float32),
                   clip_lambda=lam, frozen_params={"clip": tp})
    assert not ttr.view_mode
    tstate = _port_state(jstate)
    proj0 = tstate.params["temporal_projection"]["w"].clone()
    tstate2, tscalars, _, tbatch, tdata = ttr.iteration(tstate, 1, draws)

    for name in ("actions", "rewards", "dones", "done_mask"):
        np.testing.assert_array_equal(getattr(tbatch, name).numpy(),
                                      np.asarray(getattr(jbatch, name)), err_msg=name)
    got, want = tbatch.obs.numpy().astype(int), np.asarray(jbatch.obs).astype(int)
    if severity is None:
        np.testing.assert_array_equal(got, want)
    else:
        # The blur's sums round apart by ~1e-7 (a convolution in the JAX
        # package, gathered taps here), which moves a value sitting on a
        # uint8 boundary by one level when it is stored.
        off = np.abs(got - want)
        assert off.max() <= 1 and (off > 0).mean() <= 2e-4, (off.max(), (off > 0).mean())
        # The stored stacks are the disturbed ones: a frame differs from
        # itself one step later, where it sits one channel lower.
        assert not np.array_equal(want[1:, ..., :3], want[:-1, ..., 1:])
    np.testing.assert_array_equal(tstate2.obs.numpy(), np.asarray(jstate2.obs))  # the clean stack
    for name in ("values", "logprobs"):
        np.testing.assert_allclose(getattr(tbatch, name).numpy(), np.asarray(getattr(jbatch, name)),
                                   rtol=0, atol=1e-4, err_msg=name)
    temb = ttr.embed(tbatch, tdata)
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), rtol=0, atol=1e-4)
    for name, value in jscalars.items():
        np.testing.assert_allclose(float(tscalars[name]), float(value), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert float(tscalars["first_clip_loss"]) > 0.0
    jparams = convert.agent_params(_np(jstate2.params))
    for got, want in zip(tree_leaves(tstate2.params), tree_leaves(jparams)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
    assert not torch.equal(tstate2.params["temporal_projection"]["w"], proj0)


def test_split_path_equals_the_fused_iteration():
    """The text modality's split path (``run_rollout_half``, embeddings from
    the host, ``run_update_half``, ``fetch_logs``) computes what one fused
    iteration computes with the same draws and embeddings."""
    cfg = dict(CFG, clip_mode="precomputed")
    normals = torch.randn(16, 512, generator=torch.Generator().manual_seed(9))
    emb = tcu.l2_normalize(normals)
    draws = Draws(
        gumbels=tagent.gumbel_like((8, 2, 4), torch.Generator().manual_seed(1), "cpu"),
        permutations=torch.stack([torch.randperm(16, generator=torch.Generator().manual_seed(s))
                                  for s in (2, 3)]),
        env=[tcore.breakout_draw(2, torch.Generator().manual_seed(10 + t), "cpu")
             for t in range(8)])
    outs = []
    for split in (True, False):
        tr = TTrainer(tppo.PPOConfig(**cfg), AtariVectorEnv(ENV_ID, 2, "cpu"), 2, clip_lambda=0.5,
                      embed_random_fn=None if split else tcu.make_random_embed_fn(16))
        state = tr.init_state(convert.agent_params(_jax_agent_params(4, 4)), 3)
        if split:
            state, data, stats, desc = tr.run_rollout_half(state, draws)
            assert desc == {}
            state, scalars = tr.run_update_half(state, data, 1, emb, draws)
        else:
            state, scalars, stats, _, _ = tr.iteration(state, 1, draws._replace(
                random_embeddings=normals))
        outs.append((state, tr.fetch_logs(scalars, stats)))
    (s1, (sc1, st1)), (s2, (sc2, st2)) = outs
    for got, want in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        assert torch.equal(got, want)
    assert sc1.keys() == sc2.keys() and all(sc1[k] == sc2[k] or k == "explained_variance"
                                            for k in sc1)
    assert float(sc1["first_clip_loss"]) > 0.0
    for k in ("done_mask", "episode_return", "episode_length", "b_returns"):
        np.testing.assert_array_equal(st1[k], st2[k], err_msg=k)
