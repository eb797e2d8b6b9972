"""Checkpoints carry across between the two packages, in both directions.

A checkpoint the port writes loads with the JAX package's
``load_checkpoint`` onto ``init_agent_params`` and optax's state, and one
the JAX package writes loads with the port's, each giving back the other
package's params and Adam state exactly (the layouts differ only by the
conv kernels' axis order). The port reads the JAX payload without optax.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from clip_ppo_tpu.io.checkpoint import load_checkpoint as jload
from clip_ppo_tpu.io.checkpoint import save_checkpoint as jsave
from clip_ppo_tpu.models import agent as jagent
from clip_ppo_tpu.train import ppo as jppo
from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.io.checkpoint import load_checkpoint as tload
from clip_ppo_tpu_torch.io.checkpoint import save_checkpoint as tsave
from clip_ppo_tpu_torch.models import agent as tagent
from clip_ppo_tpu_torch.train.ppo import init_adam_state
from clip_ppo_tpu_torch.utils.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parent.parent.parent


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(got, want):
    def same(a, b):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    assert len(tree_leaves(got)) == len(tree_leaves(want))
    tree_map(same, got, want)


def test_port_checkpoint_loads_in_jax(tmp_path):
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tagent.init_agent_params(gen, 7, "cpu")
    state = {"mu": tree_map(lambda p: torch.randn(p.shape, generator=gen), params),
             "nu": tree_map(lambda p: torch.rand(p.shape, generator=gen), params),
             "count": torch.tensor(5, dtype=torch.int32)}
    path = tsave(str(tmp_path / "port"), params, state, 3, 96, {"seed": 1}, final=True,
                 learning_rate=1.25e-4)
    template = jagent.init_agent_params(jax.random.PRNGKey(0), 7)
    opt_template = jppo.make_optimizer(jppo.PPOConfig()).init(template)
    jparams, jopt, it, step, raw = jload(path, template, opt_template)
    assert (it, step) == (3, 96) and raw["training_complete"]
    _assert_trees_equal(convert.agent_params(_np(jparams)), params)
    _assert_trees_equal(convert.adam_state(_np(jopt)), state)
    inject = jopt[1]
    assert int(inject.count) == 5
    assert float(inject.hyperparams["learning_rate"]) == np.float32(1.25e-4)
    # The JAX package resumes from it: one more optax step runs.
    grads = jax.tree_util.tree_map(jnp.ones_like, jparams)
    jppo.make_optimizer(jppo.PPOConfig()).update(grads, jopt, jparams)


def _jax_checkpoint(tmp_path) -> tuple[str, dict, tuple]:
    params = jagent.init_agent_params(jax.random.PRNGKey(1), 7)
    opt = jppo.make_optimizer(jppo.PPOConfig())
    state = jppo.set_learning_rate(opt.init(params), 2e-4)
    rng = np.random.RandomState(2)
    grads = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.randn(*p.shape), p.dtype), params)
    _, state = opt.update(grads, state, params)
    path = jsave(str(tmp_path / "jax"), params, state, 2, 64, {"seed": 1}, final=True)
    return path, params, state


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    path, jparams, jstate = _jax_checkpoint(tmp_path)
    template = tagent.init_agent_params(torch.Generator(), 7, "cpu")
    params, state, it, step, _ = tload(path, template, init_adam_state(template), "cpu")
    assert (it, step) == (2, 64)
    _assert_trees_equal(params, convert.agent_params(_np(jparams)))
    _assert_trees_equal(state, convert.adam_state(_np(jstate)))
    assert int(state["count"]) == 1


def test_port_reads_a_jax_checkpoint_without_optax(tmp_path):
    path, _, _ = _jax_checkpoint(tmp_path)
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'optax', 'clip_ppo_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from clip_ppo_tpu_torch.io.checkpoint import load_checkpoint\n"
        "from clip_ppo_tpu_torch.models.agent import init_agent_params\n"
        "from clip_ppo_tpu_torch.train.ppo import init_adam_state\n"
        "t = init_agent_params(torch.Generator(), 7, 'cpu')\n"
        f"_, state, it, _, _ = load_checkpoint({path!r}, t, init_adam_state(t), 'cpu')\n"
        "print(it, int(state['count']))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].split() == ["2", "1"]
