"""GAE and the PPO update against the JAX package.

GAE: the JAX package solves the recurrence with an associative scan, the
port with a reverse loop, so the two differ only by float32 association
(atol 1e-5 on O(1) values, as the JAX package pins its own scan).

Update: the same flat batch, params, Adam state, CLIP embeddings and
per-epoch permutations (recomputed with the JAX package's
``jax.random.split(key, update_epochs)`` / ``permutation`` calls) go
through ``update_epochs`` in both packages. The port writes optax's
``clip_by_global_norm`` (scale by max/‖g‖, divide then multiply, only when
‖g‖ ≥ max) and its Adam (eps outside the square root) out by hand, so no
tolerance is spent on the clipping form. Tolerances: losses and metrics
1e-5 relative; parameters within 2e-6 absolute of JAX's after 8 Adam
steps of ~2.5e-4 each (the per-step update is normalized, so fp32
gradient round-off of ~1e-6 relative moves a parameter by far less).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.models import agent as jagent
from clip_ppo_tpu.train import gae as jgae
from clip_ppo_tpu.train import ppo as jppo
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.train import gae as tgae
from clip_ppo_tpu_torch.train import ppo as tppo


def test_gae_matches():
    rng = np.random.RandomState(0)
    t, n = 32, 5
    rewards = rng.rand(t, n).astype(np.float32)
    values = rng.randn(t, n).astype(np.float32)
    dones = (rng.rand(t, n) < 0.1).astype(np.float32)
    next_value = rng.randn(n).astype(np.float32)
    next_done = (rng.rand(n) < 0.5).astype(np.float32)
    ja, jr = jgae.compute_gae(*(jnp.asarray(v) for v in (rewards, values, dones, next_value,
                                                          next_done)), 0.99, 0.95)
    ta, tr = tgae.compute_gae(*(torch.as_tensor(v) for v in (rewards, values, dones, next_value,
                                                             next_done)), 0.99, 0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5, rtol=0)


def test_optimizer_step_matches_optax():
    """Clip+Adam steps with gradients both above and below the clip
    threshold agree to 2 float32 ulps (the bias corrections' powers
    round independently)."""
    rng = np.random.RandomState(1)
    cfg = tppo.PPOConfig(max_grad_norm=0.5)
    params = {"a": rng.randn(7, 3).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    opt = jppo.make_optimizer(jppo.PPOConfig(max_grad_norm=0.5))
    jstate = jppo.set_learning_rate(opt.init(jax.tree_util.tree_map(jnp.asarray, params)), 3e-4)
    tparams = {k: torch.as_tensor(v) for k, v in params.items()}
    tstate = tppo.init_adam_state(tparams)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    for scale in (0.01, 10.0, 0.3):
        g = {k: (scale * rng.randn(*v.shape)).astype(np.float32) for k, v in params.items()}
        upd, jstate = opt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        tparams, tstate = tppo.adam_step(tparams, {k: torch.as_tensor(v) for k, v in g.items()},
                                         tstate, 3e-4, cfg.max_grad_norm)
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jp[k]), rtol=2.4e-7, atol=0)
    assert int(tstate["count"]) == 3


@pytest.mark.parametrize("target_kl", [None, 1e-4])
def test_update_epochs_matches(target_kl):
    cfg_kw = dict(num_envs=4, num_steps=16, num_minibatches=4, update_epochs=2,
                  target_kl=target_kl, clip_mode="precomputed")
    jcfg, tcfg = jppo.PPOConfig(**cfg_kw), tppo.PPOConfig(**cfg_kw)
    rng = np.random.RandomState(2)
    b = jcfg.batch_size
    batch = {
        "obs": rng.randint(0, 256, size=(b, 84, 84, 3)).astype(np.uint8),
        "actions": rng.randint(0, 7, size=b).astype(np.int32),
        "logprobs": (np.log(1 / 7) + 0.05 * rng.randn(b)).astype(np.float32),
        "advantages": rng.randn(b).astype(np.float32),
        "returns": rng.randn(b).astype(np.float32),
        "values": rng.randn(b).astype(np.float32),
    }
    emb = rng.randn(b, 512).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    lr, lam = 2.5e-4, 0.1
    jp = jagent.init_agent_params(jax.random.PRNGKey(4), 7)
    opt = jppo.make_optimizer(jcfg)
    jstate = jppo.set_learning_rate(opt.init(jp), lr)
    key = jax.random.PRNGKey(5)
    perms = np.stack([np.asarray(jax.random.permutation(k, b))
                      for k in jax.random.split(key, jcfg.update_epochs)])

    with jax.default_matmul_precision("highest"):
        jp2, jstate2, jm = jax.jit(
            lambda p, s, bt, e: jppo.update_epochs(p, s, bt, key, jcfg, opt, clip_embeddings=e,
                                                   clip_lambda_eff=lam)
        )(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(emb))

    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tp = convert.agent_params(np_tree(jp))
    tstate = convert.adam_state(np_tree(jstate))
    tp2, tstate2, tm = tppo.update_epochs(
        tp, tstate, {k: torch.as_tensor(v) for k, v in batch.items()}, tcfg, lr,
        clip_embeddings=torch.as_tensor(emb), clip_lambda_eff=lam,
        permutations=torch.as_tensor(perms))

    names = ("pg_loss", "v_loss", "entropy", "old_approx_kl", "approx_kl", "clipfrac",
             "clip_loss", "grad_norm", "first_pg_loss", "first_v_loss", "first_entropy",
             "first_clip_loss")
    for name in names:
        np.testing.assert_allclose(float(tm[name]), float(getattr(jm, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    want = convert.agent_params(np_tree(jp2))
    want_state = convert.adam_state(np_tree(jstate2))
    for got_t, want_t in ((tp2, want), (tstate2["mu"], want_state["mu"])):
        for k in ("actor", "critic"):
            np.testing.assert_allclose(got_t[k]["w"].numpy(), want_t[k]["w"].numpy(),
                                       rtol=0, atol=2e-6)
        for k in ("conv1", "conv2", "conv3", "fc"):
            np.testing.assert_allclose(got_t["trunk"][k]["w"].numpy(),
                                       want_t["trunk"][k]["w"].numpy(), rtol=0, atol=2e-6)
    assert int(tstate2["count"]) == int(want_state["count"])
    # the port's parameters moved at all
    assert not torch.equal(tp2["actor"]["w"], tp["actor"]["w"])


def test_explained_variance_and_anneal_match():
    rng = np.random.RandomState(3)
    v, r = rng.randn(50).astype(np.float32), rng.randn(50).astype(np.float32)
    np.testing.assert_allclose(float(tppo.explained_variance(torch.as_tensor(v), torch.as_tensor(r))),
                               float(jppo.explained_variance(jnp.asarray(v), jnp.asarray(r))),
                               rtol=1e-6)
    assert np.isnan(float(tppo.explained_variance(torch.as_tensor(v), torch.ones(50))))
    cfg = jppo.PPOConfig()
    for it in (1, 7, 48):
        assert tppo.anneal_lr(tppo.PPOConfig(), it, 48) == float(jppo.anneal_lr(cfg, jnp.int32(it), 48))


def test_projected_clip_mode_names_the_atari_slice():
    """The "projected" CLIP mode (the JAX package's Atari temporal
    projection) is refused with the slice that brings it."""
    cfg = tppo.PPOConfig(clip_mode="projected")
    n = 4
    mb = {"logprobs": torch.zeros(n), "advantages": torch.randn(n), "values": torch.zeros(n),
          "returns": torch.zeros(n)}
    with pytest.raises(ValueError, match="Atari slice"):
        tppo._ppo_from_eval(mb, cfg, torch.zeros(n), torch.zeros(n), torch.zeros(n),
                            torch.zeros(n, 8), torch.zeros(n, 8), 1.0, True)
