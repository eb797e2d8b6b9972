"""The MiniGrid view fast path in the port: ``nature_cnn_view`` against the
port's dense ``nature_cnn`` and against the JAX package's
``nature_cnn_view`` on carried weights, the Trainer's view-mode rule, and
one iteration in view mode against one in obs mode.

Tolerances: features and gradients 1e-5 (absolute and relative). The view
path sums conv1's weights per tile before the contraction, so its sums run
in another order than the dense conv's; the JAX side computes at HIGHEST
precision so that both packages compute in float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.models import nature_cnn as jcnn
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.envs.vector import TorchVectorEnv
from clip_ppo_tpu_torch.models import agent as tagent
from clip_ppo_tpu_torch.models import nature_cnn as tcnn
from clip_ppo_tpu_torch.ops.resize import upscale_nearest
from clip_ppo_tpu_torch.ops.severity import SEVERITY_CONFIGS, DisturbanceSeverity
from clip_ppo_tpu_torch.train.ppo import PPOConfig
from clip_ppo_tpu_torch.train.runner import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)


def _trunk(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return tcnn.init_nature_cnn(gen, 3, "cpu")


def _views(b, seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return torch.randint(0, 11, (b, 7, 7, 3), generator=gen, dtype=torch.uint8)


def _grads(p, loss_fn):
    leaves = [p[k][n] for k in p for n in ("w", "b")]
    for t in leaves:
        t.requires_grad_(True)
    return torch.autograd.grad(loss_fn(p), leaves)


def test_view_cnn_matches_dense_conv():
    """Forward and gradients of every trunk weight: the view path on the raw
    views against the dense conv on their ×12 upscale."""
    p = _trunk(0)
    view = _views(5, 1)
    dense = lambda q: tcnn.nature_cnn(q, upscale_nearest(view, 12).float() / 255.0)  # noqa: E731
    viewed = lambda q: tcnn.nature_cnn_view(q, view.float(), 12, v_scale=1.0 / 255.0)  # noqa: E731
    torch.testing.assert_close(viewed(p), dense(p), **TOL)
    weights = torch.randn(5, 512, generator=torch.Generator().manual_seed(2))
    for got, want in zip(_grads(p, lambda q: (viewed(q) * weights).sum()),
                         _grads(p, lambda q: (dense(q) * weights).sum())):
        torch.testing.assert_close(got, want, **TOL)


def test_fixed_view_features_equal_the_autograd_ones():
    """The rollout's copy with conv1's pre-sum computed once gives the same
    features as the update's, which recomputes it inside autograd."""
    gen = torch.Generator()
    gen.manual_seed(3)
    params = tagent.init_agent_params(gen, 7, "cpu")
    view = _views(4, 4)
    features = tagent.make_view_features(12)
    torch.testing.assert_close(features.fixed(params)(params, view), features(params, view),
                               rtol=0, atol=0)


def test_view_cnn_matches_jax():
    """The port's view trunk against the JAX package's on carried weights,
    forward and the gradients of every weight."""
    jp = jcnn.init_nature_cnn(jax.random.PRNGKey(5), 3)
    view = np.asarray(_views(3, 6)).astype(np.float32)
    weights = np.random.RandomState(7).randn(3, 512).astype(np.float32)

    def jloss(p):
        feat = jcnn.nature_cnn_view(p, jnp.asarray(view), 12, v_scale=1.0 / 255.0)
        return (feat * weights).sum(), feat

    with jax.default_matmul_precision("highest"):
        jgrad, jfeat = jax.jit(jax.grad(jloss, has_aux=True))(jp)
    jfeat = np.array(jfeat)
    tp = convert.agent_params({"trunk": jax.tree_util.tree_map(np.asarray, jp)})["trunk"]
    got = tcnn.nature_cnn_view(tp, torch.as_tensor(view), 12, v_scale=1.0 / 255.0)
    torch.testing.assert_close(got, torch.as_tensor(jfeat), **TOL)
    tgrads = _grads(tp, lambda q: (tcnn.nature_cnn_view(q, torch.as_tensor(view), 12,
                                                        v_scale=1.0 / 255.0)
                                   * torch.as_tensor(weights)).sum())
    want = convert.agent_params({"trunk": jax.tree_util.tree_map(np.asarray, jgrad)})["trunk"]
    for got_g, (k, n) in zip(tgrads, [(k, n) for k in tp for n in ("w", "b")]):
        torch.testing.assert_close(got_g, want[k][n], **TOL, msg=f"{k}.{n}")


# -- the Trainer's rule (`clip_ppo_tpu/train/runner.py:204-211`) ------------

CFG = PPOConfig(num_envs=4, num_steps=8, num_minibatches=2, update_epochs=1)


def _other_features(params, obs, frozen=None):
    return tagent.cnn_features(params, obs, frozen)


def _embed_images(obs, frozen):  # any image consumer needs the 84×84 frames
    return obs.float().flatten(1)


@pytest.mark.parametrize("kwargs,view_mode", [
    ({}, True),
    ({"disturbance": SEVERITY_CONFIGS[DisturbanceSeverity.HARD]}, False),
    ({"disturbance": SEVERITY_CONFIGS[DisturbanceSeverity.MILD],
      "disturbance_semantics": "per_image"}, False),
    ({"features_fn": _other_features}, False),
    ({"embed_images_fn": _embed_images}, False),
], ids=["default", "batched-disturbance", "per-image-disturbance", "custom-features",
        "image-embeddings"])
def test_trainer_view_mode_rule(kwargs, view_mode):
    env = TorchVectorEnv("MiniGrid-Empty-16x16-v0", 4, "cpu")
    tr = Trainer(CFG, env, num_iterations=4, **kwargs)
    assert tr.view_mode is view_mode
    st = tr.init_state(tagent.init_agent_params(torch.Generator(), 7, "cpu"), seed=0)
    assert st.obs.shape == ((4, 7, 7, 3) if view_mode else (4, 84, 84, 3))


def test_view_mode_iteration_matches_obs_mode():
    """Same seed, one iteration in each mode: both draw the same numbers in
    the same order, so actions and rewards are equal and every logged
    scalar agrees to float32 round-off of the two conv1 formulations."""
    env = TorchVectorEnv("MiniGrid-Empty-5x5-v0", 2, "cpu")
    cfg = PPOConfig(num_envs=2, num_steps=16, num_minibatches=2, update_epochs=2)

    def run(view_mode):
        tr = Trainer(cfg, env, num_iterations=8)
        assert tr.view_mode
        if not view_mode:
            tr.view_mode, tr.features_fn = False, tagent.cnn_features
        gen = torch.Generator()
        gen.manual_seed(0)
        st = tr.init_state(tagent.init_agent_params(gen, 7, "cpu"), seed=0)
        st, scalars, _, batch, _ = tr.iteration(st, 1)
        return st, scalars, batch

    (sv, a, bv), (so, b, bo) = run(True), run(False)
    assert bv.obs.shape == (16, 2, 7, 7, 3) and bo.obs.shape == (16, 2, 84, 84, 3)
    np.testing.assert_array_equal(upscale_nearest(bv.obs.reshape(32, 7, 7, 3), 12).numpy(),
                                  bo.obs.reshape(32, 84, 84, 3).numpy())
    for name in ("actions", "rewards", "dones"):
        torch.testing.assert_close(getattr(bv, name), getattr(bo, name), rtol=0, atol=0)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-4, atol=1e-5, msg=k)
    for k in ("actor", "critic"):
        torch.testing.assert_close(sv.params[k]["w"], so.params[k]["w"], rtol=0, atol=1e-5)
