"""Checkpoint save/load with the reference's naming and payload schema.

Port of ``clip_ppo_tpu/io/checkpoint.py`` (`shared/checkpoint_utils.py:9-46`):
one pickle per checkpoint holding iteration, global_step, the agent and
optimizer state as numpy trees, the args dict, the last batch returns and a
``training_complete`` flag. Naming: ``{prefix}_step_{global_step}.ckpt``
plus a ``_latest.ckpt`` overwrite, and ``{prefix}_final{ext}`` at the end
(``CLIP_PPO_CKPT_EXT=.pt`` gives the reference's extension).

The payload is the JAX package's, so each package resumes and evaluates
the other's checkpoints: conv kernels HWIO, and the optimizer state as
optax's ``chain(clip_by_global_norm, inject_hyperparams(adam))`` state
(``convert.jax_agent_params`` / ``convert.jax_adam_state`` on the way out,
``convert.agent_params`` / ``convert.adam_state`` on the way in). The
optax classes are written under optax's own names, so ``pickle`` gives
optax's classes where optax is installed, and read back as
``convert``'s stand-ins here, which never imports optax.

Extra payloads follow the JAX schema: ``extra_models={name: tree}`` is
stored as ``{name}_state`` (numpy leaves), and ``extra_templates`` restores
each stored name onto its template. A JAX vanilla checkpoint's
``loop_state`` pickles the JAX package's ``VecState`` and ``EnvState``;
they are read as ``convert``'s stand-ins, so loading never imports the JAX
package, and any other class of that package is refused by name. The
port's vanilla CLI writes its env state there too (``jax_loop``), as the
stand-ins under the JAX package's names, so the JAX CLI resumes it.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from enum import Enum
from typing import Any, Optional

import numpy as np
import torch

from clip_ppo_tpu_torch import convert
from clip_ppo_tpu_torch.utils.tree import tree_map

_STANDINS = {name: cls for cls, (_, name) in convert.OPTAX_CLASSES.items()}
# Each stand-in that is written and the module and name it is written under.
_WRITTEN_AS = {**convert.OPTAX_CLASSES,
               **{cls: key for key, cls in convert.JAX_STATE_CLASSES.items()}}


class _Pickler(pickle._Pickler):
    """The standard pickler, writing ``convert``'s stand-ins under the names
    of the optax and JAX-package classes they stand for. (The pure-Python
    pickler: the C one has no hook for how a class reference is written.)"""

    def save_global(self, obj, name=None):
        if obj not in _WRITTEN_AS:
            return super().save_global(obj, name)
        module, qualname = _WRITTEN_AS[obj]
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    """Reads optax's state classes and the JAX package's env-state classes
    as ``convert``'s stand-ins."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if top == "optax":
            if name not in _STANDINS:
                raise pickle.UnpicklingError(
                    f"{module}.{name}: not part of the optimizer state this package reads "
                    f"(one of {', '.join(_STANDINS)})")
            return _STANDINS[name]
        if top == "clip_ppo_tpu":
            standin = convert.JAX_STATE_CLASSES.get((module, name))
            if standin is None:
                known = ", ".join(f"{m}.{n}" for m, n in convert.JAX_STATE_CLASSES)
                raise pickle.UnpicklingError(
                    f"{module}.{name}: a class of the JAX package that this package does not "
                    f"read (it reads {known})")
            return standin
        return super().find_class(module, name)


def _dump(checkpoint: dict, filename: str) -> None:
    with open(filename, "wb") as f:
        _Pickler(f, protocol=4).dump(checkpoint)


def _onto(template, tree):
    """``tree``, checked against ``template``'s structure and shapes."""
    def check(t, a):
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf of shape {tuple(a.shape)} where the model has "
                             f"{tuple(t.shape)}")
        return a
    return tree_map(check, template, tree)


def _restore(template, stored):
    """``stored`` (numpy leaves) as tensors of ``template``'s dtypes and
    devices, its shapes checked; a dict entry that ``stored`` lacks (a
    field added after the checkpoint was written) is left out."""
    if isinstance(template, dict):
        return {k: _restore(t, stored[k]) for k, t in template.items() if k in stored}
    if isinstance(template, (list, tuple)):
        return type(template)(_restore(t, a) for t, a in zip(template, stored))
    a = torch.as_tensor(np.array(stored), dtype=template.dtype, device=template.device)
    return _onto(template, a)


def _jsonable(value):
    if isinstance(value, Enum):
        return value.value
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _jsonable(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, (list, tuple)):
        return type(value)(_jsonable(v) for v in value)
    return value


def _ext() -> str:
    return os.environ.get("CLIP_PPO_CKPT_EXT", ".ckpt")


def save_checkpoint(prefix: str, params: dict, opt_state: Any, iteration: int,
                    global_step: int, args: Any, b_returns: Optional[np.ndarray] = None,
                    final: bool = False, *, learning_rate: float,
                    extra_models: Optional[dict] = None,
                    jax_loop: Optional[dict] = None) -> str:
    """Write the checkpoint; ``learning_rate`` is that of the last update,
    which the JAX package's optimizer state records. ``extra_models``:
    optional ``{name: tree of tensors}``, each stored as ``{name}_state``.
    ``jax_loop``: optional, the JAX vanilla CLI's ``loop`` payload (numpy
    leaves, ``convert.jax_vec_state``), stored as its ``loop_state``."""
    checkpoint = {
        "iteration": int(iteration),
        "global_step": int(global_step),
        "agent_state": convert.jax_agent_params(params),
        "optimizer_state": convert.jax_adam_state(opt_state, learning_rate),
        "args": _jsonable(dataclasses.asdict(args) if dataclasses.is_dataclass(args) else dict(args)),
        "returns": np.asarray(b_returns) if b_returns is not None else None,
        "training_complete": bool(final),
    }
    for name, tree in (extra_models or {}).items():
        if tree is not None:
            checkpoint[f"{name}_state"] = tree_map(lambda t: t.detach().cpu().numpy(), tree)
    if jax_loop is not None:
        checkpoint["loop_state"] = jax_loop
    ext = _ext()
    if final:
        filename = f"{prefix}_final{ext}"
        print(f"Final model saved: {filename}")
    else:
        filename = f"{prefix}_step_{global_step}{ext}"
        print(f"Model saved at step {global_step}")
        _dump(checkpoint, f"{prefix}_latest{ext}")
    _dump(checkpoint, filename)
    return filename


def load_checkpoint(path: str, params_template: dict, opt_state_template: Any, device,
                    extra_templates: Optional[dict] = None) -> tuple[dict, Any, int, int, dict]:
    """Restore (params, opt_state, iteration, global_step, raw_checkpoint)
    onto the templates' structure on ``device``, from a checkpoint of this
    package or of the JAX package. Loads a pickle: only open checkpoints
    these programs wrote.

    ``extra_templates``: optional ``{name: tree of tensors}``; each stored
    ``{name}_state`` is restored onto its template's structure, shapes,
    dtypes and devices into ``raw_checkpoint["extras"][name]``. Names the
    checkpoint lacks are skipped, and so are the dict entries of a stored
    tree that lacks them."""
    print(f"Loading checkpoint from {path}")
    with open(path, "rb") as f:
        checkpoint = _Unpickler(f).load()
    params = _onto(params_template, convert.agent_params(checkpoint["agent_state"], device))
    opt_state = _onto(opt_state_template,
                      convert.adam_state(checkpoint["optimizer_state"], device))
    for name, template in (extra_templates or {}).items():
        stored = checkpoint.get(f"{name}_state")
        if stored is not None:
            checkpoint.setdefault("extras", {})[name] = _restore(template, stored)
    iteration, global_step = checkpoint["iteration"], checkpoint["global_step"]
    print(f"Checkpoint loaded: iteration {iteration}, global_step {global_step}")
    if checkpoint.get("training_complete", False):
        print("Warning: This was a final checkpoint - training was marked as complete")
    return params, opt_state, iteration, global_step, checkpoint
