"""The port's Nature-CNN agent against the JAX package's, with the same
weights carried across (conv HWIO → OIHW).

Tolerance: float32 round-off of two convolution implementations (XLA:CPU
at full precision vs PyTorch's CPU kernels) summing up to 3136 products in
another order — rtol/atol 1e-5 on features, logits and values, and 1e-4
relative to each gradient's largest entry. Gumbel-max sampling from the
same Gumbel batch must pick the same actions.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.models import agent as jagent
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.models import agent as tagent


def _setup(seed=0, b=6):
    jp = jagent.init_agent_params(jax.random.PRNGKey(seed), 7)
    tp = convert.agent_params(jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.RandomState(seed)
    obs = rng.randint(0, 256, size=(b, 84, 84, 3)).astype(np.uint8)
    return jp, tp, obs, rng


def test_forward_matches():
    jp, tp, obs, rng = _setup()
    actions = rng.randint(0, 7, size=obs.shape[0])
    with jax.default_matmul_precision("highest"):
        jlp, jent, jval, jhid = jagent.evaluate_actions(jp, jnp.asarray(obs), jnp.asarray(actions))
        jv = jagent.get_value(jp, jnp.asarray(obs))
        jlat = jagent.get_latent_representation(jp, jnp.asarray(obs))
    tlp, tent, tval, thid = tagent.evaluate_actions(tp, torch.as_tensor(obs), torch.as_tensor(actions))
    for got, want in ((thid, jhid), (tlp, jlp), (tent, jent), (tval, jval),
                      (tagent.get_value(tp, torch.as_tensor(obs)), jv),
                      (tagent.get_latent_representation(tp, torch.as_tensor(obs)), jlat)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    jlog, _ = jagent.heads(jp, jhid)
    tlog, _ = tagent.heads(tp, thid)
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog), rtol=1e-5, atol=1e-5)


def test_gradients_match():
    jp, tp, obs, rng = _setup(seed=1)
    actions = rng.randint(0, 7, size=obs.shape[0])
    w = rng.randn(obs.shape[0]).astype(np.float32)

    def jloss(p):
        lp, ent, val, hid = jagent.evaluate_actions(p, jnp.asarray(obs), jnp.asarray(actions))
        return jnp.sum(lp * w) + jnp.sum(ent) + jnp.sum(val ** 2) + 1e-3 * jnp.sum(hid)

    with jax.default_matmul_precision("highest"):
        jg = convert.agent_params(jax.tree_util.tree_map(np.asarray, jax.grad(jloss)(jp)))
    leaves = {k: v for k, v in _flat(tp).items()}
    for v in leaves.values():
        v.requires_grad_(True)
    lp, ent, val, hid = tagent.evaluate_actions(tp, torch.as_tensor(obs), torch.as_tensor(actions))
    loss = (lp * torch.as_tensor(w)).sum() + ent.sum() + (val ** 2).sum() + 1e-3 * hid.sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    want = _flat(jg)
    for (name, _), g in zip(leaves.items(), grads):
        scale = float(want[name].abs().max()) or 1.0
        np.testing.assert_allclose(g.numpy() / scale, want[name].numpy() / scale,
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_gumbel_sampling_same_actions():
    jp, tp, obs, rng = _setup(seed=2, b=8)
    gumbel = rng.gumbel(size=(obs.shape[0], 7)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ja, jlp, jv = jagent.get_action_and_value_gumbel(jp, jnp.asarray(obs), jnp.asarray(gumbel))
    ta, tlp, tv = tagent.get_action_and_value_gumbel(tp, torch.as_tensor(obs), torch.as_tensor(gumbel))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tlp.detach().numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
