"""Hydra-compatible configuration system (no hydra dependency).

The port's own copy of ``diffwave_sashimi_tpu/config.py`` (same grammar,
same ``configs/`` tree at the repository root), kept here so the port
imports nothing of the JAX package.  It reproduces the subset of
Hydra/OmegaConf behaviour the reference framework relies on
(``@hydra.main(config_path="configs/", config_name="config")``):

- a root ``config.yaml`` with a ``defaults`` list selecting an ``experiment``
  group entry,
- experiment files marked ``# @package _global_`` that compose ``/model`` and
  ``/dataset`` groups and overlay top-level keys,
- ``${a.b}``-style interpolation (e.g. ``L: ${dataset.segment_length}`` in
  configs/model/sashimi.yaml),
- dotted CLI overrides: ``experiment=sc09``, ``model.d_model=64``,
  ``train.n_iters=100``, ``+new.key=value`` (OmegaConf.set_struct(False)
  semantics: new keys may be injected at runtime).

The result is a :class:`Config` — a dict subclass with attribute access, so
downstream code can use either ``cfg.model.d_model`` or ``cfg["model"]``.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Sequence

import yaml

_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


class Config(dict):
    """dict with attribute access, recursive wrapping, and Hydra-ish helpers."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __setitem__(self, name: str, value: Any) -> None:
        super().__setitem__(name, _wrap(value))

    def __delattr__(self, name: str) -> None:
        del self[name]

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: Any = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = _wrap(value)

    def to_dict(self) -> Dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()}

    def to_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def copy(self) -> "Config":  # type: ignore[override]
        return _wrap(copy.deepcopy(self.to_dict()))


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, dict):
        c = Config()
        for k, v in value.items():
            c[k] = v
        return c
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


def _deep_merge(base: Dict[str, Any], overlay: Dict[str, Any]) -> None:
    """Merge ``overlay`` into ``base`` in place (overlay wins; dicts recurse)."""
    for k, v in overlay.items():
        if k in base and isinstance(base[k], dict) and isinstance(v, dict):
            _deep_merge(base[k], v)
        else:
            base[k] = copy.deepcopy(v)


_SCI_FLOAT_RE = re.compile(r"^[+-]?(\d+(\.\d*)?|\.\d+)[eE][+-]?\d+$")


def _coerce_scalars(node: Any) -> Any:
    """YAML 1.1 (pyyaml) parses ``2e-4`` as a string; Hydra/OmegaConf (YAML
    1.2) parse it as a float.  Coerce such scalars to float for parity."""
    if isinstance(node, str) and _SCI_FLOAT_RE.match(node):
        return float(node)
    if isinstance(node, dict):
        return {k: _coerce_scalars(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_coerce_scalars(v) for v in node]
    return node


def _parse_value(text: str) -> Any:
    """Parse a CLI override value with YAML scalar semantics.

    ``null`` -> None, ``true`` -> True, ``2e-4`` -> float, ``[4,4]`` -> list,
    anything else -> str.
    """
    try:
        return _coerce_scalars(yaml.safe_load(text))
    except yaml.YAMLError:
        return text


def _load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(f"Config file {path} must contain a mapping")
    return _coerce_scalars(data)


class _Composer:
    def __init__(self, config_dir: str):
        self.config_dir = config_dir

    def group_file(self, group: str, name: str) -> str:
        return os.path.join(self.config_dir, group, f"{name}.yaml")

    def compose(self, config_name: str, overrides: Sequence[str]) -> Config:
        # Split overrides into group selections (experiment=..., model=...) and
        # key-value overrides.
        group_choices: Dict[str, str] = {}
        kv_overrides: List[tuple] = []
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"Override {ov!r} must have form key=value")
            key, val = ov.split("=", 1)
            key = key.lstrip("+")  # '+key=value' appends a new key
            if key in ("experiment", "model", "dataset") and "." not in key:
                group_choices[key] = val.strip()
            else:
                kv_overrides.append((key, _parse_value(val)))

        root = _load_yaml(os.path.join(self.config_dir, f"{config_name}.yaml"))
        defaults = root.pop("defaults", ["_self_"])

        cfg: Dict[str, Any] = {}
        for entry in defaults:
            if entry == "_self_":
                _deep_merge(cfg, root)
            elif isinstance(entry, dict):
                for group, name in entry.items():
                    name = group_choices.get(group, name)
                    self._merge_group(cfg, group, name, group_choices)
            else:
                raise ValueError(f"Unsupported defaults entry: {entry!r}")

        for key, val in kv_overrides:
            _set_dotted(cfg, key, val)

        _resolve_interpolations(cfg)
        return _wrap(cfg)

    def _merge_group(self, cfg: Dict[str, Any], group: str, name: str,
                     group_choices: Dict[str, str]) -> None:
        path = self.group_file(group, name)
        data = _load_yaml(path)
        with open(path, "r") as f:
            header = f.readline()
        pkg_global = "@package _global_" in header

        sub_defaults = data.pop("defaults", [])
        for entry in sub_defaults:
            if isinstance(entry, dict):
                for g, n in entry.items():
                    g = g.lstrip("/")
                    n = group_choices.get(g, n)
                    self._merge_group(cfg, g, n, group_choices)
            elif entry == "_self_":
                pass
            else:
                raise ValueError(f"Unsupported defaults entry: {entry!r}")

        if pkg_global:
            _deep_merge(cfg, data)
        else:
            cfg.setdefault(group, {})
            _deep_merge(cfg[group], data)


def _set_dotted(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = cfg
    for part in parts[:-1]:
        if part not in node or not isinstance(node[part], dict):
            node[part] = {}
        node = node[part]
    node[parts[-1]] = value


def _resolve_interpolations(cfg: Dict[str, Any]) -> None:
    """Resolve ``${a.b.c}`` references against the root config."""

    def lookup(dotted: str) -> Any:
        node: Any = cfg
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(f"Interpolation key not found: {dotted}")
            node = node[part]
        return node

    def resolve(node: Any) -> Any:
        if isinstance(node, str):
            m = _INTERP_RE.fullmatch(node)
            if m:
                return resolve(lookup(m.group(1)))
            return _INTERP_RE.sub(lambda m: str(resolve(lookup(m.group(1)))), node)
        if isinstance(node, dict):
            for k in list(node):
                node[k] = resolve(node[k])
            return node
        if isinstance(node, list):
            return [resolve(v) for v in node]
        return node

    resolve(cfg)


def default_config_dir() -> str:
    """Locate the ``configs/`` tree: repo root next to the package (the
    same tree the JAX package reads)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, "configs")


def load_config(config_name: str = "config",
                overrides: Optional[Sequence[str]] = None,
                config_dir: Optional[str] = None) -> Config:
    """Compose a config like ``hydra.main`` would.

    ``overrides`` is a list of CLI-style strings, e.g.
    ``["experiment=sc09", "model.d_model=64", "train.n_iters=100"]``.
    """
    composer = _Composer(config_dir or default_config_dir())
    return composer.compose(config_name, overrides or [])


def _split_top_level_commas(text: str) -> List[str]:
    """Split a sweep value on commas that are not inside []/()/quotes
    (so ``pool=[2,2],[4,4]`` is two choices, not four)."""
    parts, depth, quote, cur = [], 0, None, []
    for ch in text:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch in "[(":
            depth += 1
        elif ch in "])":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    parts.append("".join(cur))
    return parts


def sweep_overrides(overrides: Sequence[str]) -> List[List[str]]:
    """Hydra ``--multirun`` choice-sweep expansion: each override whose
    value is a top-level comma list (``model.d_model=32,64``) becomes a
    sweep dimension; the result is the cartesian product of all
    dimensions, in Hydra's order (later overrides vary fastest).
    Mirrors the sweep surface the reference gets for free from
    ``@hydra.main`` (reference train.py:226)."""
    import itertools

    dims: List[List[str]] = []
    for ov in overrides:
        if "=" in ov:
            key, val = ov.split("=", 1)
            choices = _split_top_level_commas(val)
            dims.append([f"{key}={c}" for c in choices])
        else:
            dims.append([ov])
    return [list(combo) for combo in itertools.product(*dims)]


def extract_multirun_flag(args: Sequence[str]) -> tuple:
    """Strip ``-m``/``--multirun`` from CLI args; return (args, multirun)."""
    out = [a for a in args if a not in ("-m", "--multirun")]
    return out, len(out) != len(args)
