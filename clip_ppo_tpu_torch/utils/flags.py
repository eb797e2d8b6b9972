"""Dataclass-driven CLI parsing (tyro-compatible surface, zero deps).

The reference parses every entry point's ``Args`` dataclass with ``tyro.cli``
(`ppo_minigrid.py:166`); tyro is not available in this environment, so this
module re-implements the subset of its contract the reference exercises:

* flags derived from field names, accepting ``-`` and ``_`` interchangeably
  (``--clip-config.clip_lambda`` == ``--clip-config.clip-lambda``, see
  `run_experiments.py:37,55-57`);
* nested dataclasses addressed with dotted flags;
* booleans as bare ``--flag`` / ``--no-flag`` pairs (also ``--flag true``);
* Enums parsed by member name (case-insensitive);
* ``Optional[...]`` fields accepting the literal ``None``;
* ``--help`` output listing every flag with its docstring-adjacent comment.
"""

from __future__ import annotations

import dataclasses
import enum
import sys
import typing
from typing import Any, Optional, Sequence, Type, TypeVar, Union

T = TypeVar("T")


def _norm(name: str) -> str:
    return name.replace("-", "_")


def _is_optional(tp: Any) -> tuple[bool, Any]:
    origin = typing.get_origin(tp)
    if origin is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return True, args[0]
    return False, tp


def _convert(value: str, tp: Any, flag: str) -> Any:
    optional, tp = _is_optional(tp)
    if optional and value in ("None", "none", "null"):
        return None
    if tp is bool or tp == "bool":
        low = value.lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise SystemExit(f"error: invalid boolean for {flag}: {value!r}")
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        for member in tp:
            if member.name.lower() == value.lower() or str(member.value).lower() == value.lower():
                return member
        raise SystemExit(
            f"error: invalid choice for {flag}: {value!r} "
            f"(choose from {[m.name for m in tp]})"
        )
    if tp is int or tp == "int":
        try:
            return int(value)
        except ValueError:
            raise SystemExit(f"error: invalid int for {flag}: {value!r}")
    if tp is float or tp == "float":
        try:
            return float(value)
        except ValueError:
            raise SystemExit(f"error: invalid float for {flag}: {value!r}")
    if tp is str or tp == "str" or tp is Any:
        return value
    if _seq_kind(tp) is not None:
        elem = _seq_elem(tp)
        parts = [p for p in value.split(",") if p]
        seq = [_convert(p, elem, flag) for p in parts]
        return tuple(seq) if _seq_kind(tp) is tuple else seq
    # Fall back to the constructor (e.g. pathlib.Path).
    return tp(value)


def _seq_kind(tp: Any):
    """tuple/list for sequence-typed flags (bare or parameterized), else None."""
    _, tp = _is_optional(tp)
    origin = typing.get_origin(tp)
    if origin in (list, tuple):
        return origin
    if tp in (list, tuple):
        return tp
    return None


def _seq_elem(tp: Any):
    _, tp = _is_optional(tp)
    args = [a for a in typing.get_args(tp) if a is not Ellipsis]
    return args[0] if args else str


def _resolve_types(cls: type) -> dict[str, Any]:
    try:
        return typing.get_type_hints(cls)
    except Exception:
        return {f.name: f.type for f in dataclasses.fields(cls)}


def _iter_flags(cls: type, prefix: str = ""):
    """Yield (dotted_path, field, resolved_type, is_nested_dataclass)."""
    hints = _resolve_types(cls)
    for f in dataclasses.fields(cls):
        tp = hints.get(f.name, f.type)
        path = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(tp):
            yield from _iter_flags(tp, prefix=f"{path}.")
        else:
            yield path, f, tp


def _default_of(f: dataclasses.Field) -> Any:
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
        return f.default_factory()  # type: ignore[misc]
    return dataclasses.MISSING


def _print_help(cls: type, prog: str) -> None:
    print(f"usage: {prog} [--flag value ...]\n\noptions:")
    print(f"  {'--help':<44} show this help message and exit")
    for path, f, tp in _iter_flags(cls):
        flag = "--" + path.replace("_", "-")
        default = _default_of(f)
        tname = getattr(tp, "__name__", str(tp))
        print(f"  {flag:<44} {tname} (default: {default!r})")


def _get_dotted(overrides: dict, path: str):
    node = overrides
    for p in path.split("."):
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


def _set_dotted(overrides: dict, path: str, value: Any) -> None:
    parts = path.split(".")
    node = overrides
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _apply_overrides(instance: Any, overrides: dict) -> Any:
    """Apply dotted overrides onto an existing dataclass instance
    (recursing into nested dataclasses) — preserves customized field
    defaults/default_factory instances like tyro does."""
    changes = {}
    hints = _resolve_types(type(instance))
    for f in dataclasses.fields(type(instance)):
        if f.name not in overrides:
            continue
        tp = hints.get(f.name, f.type)
        value = overrides[f.name]
        if dataclasses.is_dataclass(tp) and isinstance(value, dict):
            changes[f.name] = _apply_overrides(getattr(instance, f.name), value)
        else:
            changes[f.name] = value
    return dataclasses.replace(instance, **changes) if changes else instance


def _build(cls: type, overrides: dict) -> Any:
    hints = _resolve_types(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        tp = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(tp):
            # Start from the FIELD default (which may customize the nested
            # config) rather than the nested class's own defaults.
            base = _default_of(f)
            sub = overrides.get(f.name, {})
            if base is dataclasses.MISSING:
                kwargs[f.name] = _build(tp, sub)
            else:
                kwargs[f.name] = _apply_overrides(base, sub)
        elif f.name in overrides:
            kwargs[f.name] = overrides[f.name]
        else:
            default = _default_of(f)
            if default is dataclasses.MISSING:
                raise SystemExit(f"error: missing required flag --{f.name.replace('_', '-')}")
            kwargs[f.name] = default
    return cls(**kwargs)


def parse(cls: Type[T], args: Optional[Sequence[str]] = None, prog: Optional[str] = None) -> T:
    """Parse command-line flags into an instance of dataclass ``cls``."""
    argv = list(sys.argv[1:] if args is None else args)
    prog = prog or sys.argv[0]

    flag_types: dict[str, Any] = {}
    for path, _f, tp in _iter_flags(cls):
        flag_types[_norm(path)] = tp

    overrides: dict = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in ("--help", "-h"):
            _print_help(cls, prog)
            raise SystemExit(0)
        if not tok.startswith("--"):
            raise SystemExit(f"error: unexpected positional argument {tok!r}")
        body = tok[2:]
        inline = None
        if "=" in body:
            body, inline = body.split("=", 1)
        key = ".".join(_norm(p) for p in body.split("."))

        negated = False
        if key not in flag_types:
            # --no-<flag> boolean negation (tyro style).
            parts = key.split(".")
            if parts[-1].startswith("no_"):
                candidate = ".".join(parts[:-1] + [parts[-1][3:]])
                if candidate in flag_types:
                    key, negated = candidate, True
        if key not in flag_types:
            raise SystemExit(f"error: unrecognized flag {tok!r}")

        tp = flag_types[key]
        _opt, base_tp = _is_optional(tp)
        if base_tp is bool:
            if negated:
                value: Any = False
                i += 1
            elif inline is not None:
                value = _convert(inline, tp, tok)
                i += 1
            elif i + 1 < len(argv) and argv[i + 1].lower() in (
                "true", "false", "1", "0", "yes", "no", "on", "off",
            ):
                value = _convert(argv[i + 1], tp, tok)
                i += 2
            else:
                value = True
                i += 1
        elif _seq_kind(tp) is not None:
            # Sequence-typed flag: consume every following non-flag token
            # (tyro-style multi-value), and accumulate across repeats, so
            # `--disturbance-runs runs/hard runs/severe` and repeated
            # `--algorithms ...` both work. Comma-joined values in a single
            # token are also accepted.
            kind = _seq_kind(tp)
            elem = _seq_elem(tp)
            raws: list[str] = []
            if inline is not None:
                raws.append(inline)
                i += 1
            else:
                i += 1
                while i < len(argv) and not argv[i].startswith("--"):
                    raws.append(argv[i])
                    i += 1
                if not raws:
                    raise SystemExit(f"error: flag {tok!r} expects a value")
            items = [
                _convert(p, elem, tok)
                for raw in raws
                for p in (raw.split(",") if "," in raw else [raw])
                if p
            ]
            prev = _get_dotted(overrides, key)
            if prev is not None:
                items = list(prev) + items
            value = tuple(items) if kind is tuple else items
        else:
            if inline is not None:
                raw = inline
                i += 1
            else:
                if i + 1 >= len(argv):
                    raise SystemExit(f"error: flag {tok!r} expects a value")
                raw = argv[i + 1]
                i += 2
            value = _convert(raw, tp, tok)
        _set_dotted(overrides, key, value)

    return _build(cls, overrides)


def cli(cls: Type[T], args: Optional[Sequence[str]] = None) -> T:
    """Alias matching ``tyro.cli``'s call signature."""
    return parse(cls, args=args)
