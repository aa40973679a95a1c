"""Config registry: group composition, CLI overrides and interpolation
(``hulc2_tpu/core/config.py``).

The port's own copy of the JAX package's dependency-free stand-in for the
reference's Hydra stack:

- config *groups* are registered dicts: ``register("model/distribution",
  "discrete", {...})``;
- composites declare ``"_defaults_": [("model", "calvin_hulc"), ...]`` lists,
  expanded depth first like Hydra defaults lists, the composite's own keys
  merged last;
- CLI-style overrides: ``model.kl_beta=0.1`` (a dotted set, the value parsed
  as JSON where it parses), ``model/distribution=continuous`` (a group swap)
  and ``aff_detection=<option>`` (a top-level group);
- ``${a.b.c}`` interpolations are resolved after the overrides.

The resolved config is a plain nested dict; a training run saves it as
``config.json``, which is the model's spec at evaluation time. One deviation:
a dotted override of a key the config does not have raises ``KeyError``
(the JAX package creates the key), so that a typo cannot pass unnoticed;
the exceptions are the optional keys that the model and optimizer read
and no composite carries (``CREATABLE``), which an override creates as in
JAX.
The JAX package's ``instantiate`` and factory registry are not carried: the
port builds its modules with ``models.build``.
"""
from __future__ import annotations

import copy
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Sequence, Union

_GROUPS: Dict[str, Dict[str, dict]] = {}

_INTERP_RE = re.compile(r"^\$\{([a-zA-Z0-9_./]+)\}$")
_INTERP_INLINE_RE = re.compile(r"\$\{([a-zA-Z0-9_./]+)\}")


# optional keys the port's model and optimizer read with a default, which no
# registered composite holds: an override may create them (the JAX tests reach
# the aux heads this way, tests/test_model.py:240-244)
CREATABLE = frozenset({
    "model.use_state_recons", "model.use_bc_z_auxiliary_loss", "model.use_mia_auxiliary_loss",
    "model.use_lang_task_auxiliary_loss", "model.lang_task_classes",
    "model.optimizer.gradient_clip_norm",
    # the pretrained encoders' precision and CLIP's tower sizes
    # (hulc2_tpu/models/build.py:57-95, pretrained_vision.py:56)
    "model.perceptual_encoder.rgb_static.compute_dtype",
    "model.perceptual_encoder.rgb_gripper.compute_dtype",
    "model.perceptual_encoder.tactile.compute_dtype",
    "model.perceptual_encoder.rgb_static.tower_kwargs",
    # the detector's bf16 decoder (hulc2_tpu/affordance/train_affordance.py:40)
    "aff_detection.compute_dtype",
})


def register(group: str, name: str, cfg: dict) -> dict:
    """Register option ``name`` of config group ``group``. Returns cfg."""
    _GROUPS.setdefault(group, {})[name] = cfg
    return cfg


def options(group: str) -> List[str]:
    return sorted(_GROUPS.get(group, {}))


def _get_group_cfg(group: str, name: str) -> dict:
    if name in (None, "none", "null"):
        return None  # type: ignore[return-value]
    try:
        return copy.deepcopy(_GROUPS[group][name])
    except KeyError:
        raise KeyError(f"unknown config {group}={name}; known options: {options(group)}") from None


def _expand_defaults(cfg: dict) -> dict:
    """Depth-first expansion of ``_defaults_`` lists, self-last merge."""
    if not isinstance(cfg, dict):
        return cfg
    out: dict = {}
    for group, name in cfg.get("_defaults_", []):
        sub = _get_group_cfg(group, name)
        out[group.split("/")[-1]] = _expand_defaults(sub) if sub is not None else None
    for k, v in cfg.items():
        if k == "_defaults_":
            continue
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k].update(_expand_defaults(v))
        else:
            out[k] = _expand_defaults(v) if isinstance(v, dict) else v
    return out


def _parse_value(s: str) -> Any:
    try:
        return json.loads(s)
    except (json.JSONDecodeError, TypeError):
        return s


def _set_path(cfg: dict, dotted: str, value: Any, strict: bool, override: str) -> None:
    *parents, leaf = dotted.split(".")
    node = cfg
    for k in parents:
        if not isinstance(node.get(k), dict):
            if strict:
                raise KeyError(f"override {override!r}: no config section {k!r}")
            node[k] = {}
        node = node[k]
    if strict and leaf not in node and dotted not in CREATABLE:
        raise KeyError(f"override {override!r}: unknown key {leaf!r}; known: {sorted(node)}")
    node[leaf] = value


def _get_path(cfg: dict, dotted: str) -> Any:
    node: Any = cfg
    for k in dotted.split("."):
        node = node[k]
    return node


def apply_overrides(cfg: dict, overrides: Sequence[str]) -> dict:
    """Apply CLI-style overrides to ``cfg`` in place, in order.

    ``group/sub=option`` swaps in a config-group option at the dotted path
    the slashes give (without the group root when that is not a top-level
    key of ``cfg``); ``group=option`` for a registered top-level group selects
    it; ``a.b.c=value`` sets an existing key (or creates one of ``CREATABLE``)."""
    for ov in overrides:
        key, sep, val = ov.partition("=")
        if not sep:
            raise ValueError(f"override {ov!r} must be key=value")
        val = val.strip()
        if "/" not in key and "." not in key and key in _GROUPS and val in _GROUPS[key]:
            _set_path(cfg, key, _expand_defaults(_get_group_cfg(key, val)), False, ov)
        elif "/" in key:
            sub = _get_group_cfg(key, val)
            parts = key.split("/")
            if parts[0] not in cfg and len(parts) > 1:
                parts = parts[1:]
            _set_path(cfg, ".".join(parts), _expand_defaults(sub) if sub is not None else None,
                      False, ov)
        else:
            _set_path(cfg, key, _parse_value(val), True, ov)
    return cfg


def resolve_interpolations(cfg: dict) -> dict:
    """Resolve ``${a.b.c}`` references against the root config, to a fixpoint.
    A reference that is the whole string keeps the referenced value's type."""

    def resolve_node(node: Any, root: dict) -> Any:
        if isinstance(node, dict):
            return {k: resolve_node(v, root) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve_node(v, root) for v in node]
        if isinstance(node, str):
            m = _INTERP_RE.match(node)
            if m:
                return _get_path(root, m.group(1).replace("/", "."))
            return _INTERP_INLINE_RE.sub(
                lambda mm: str(_get_path(root, mm.group(1).replace("/", "."))), node)
        return node

    for _ in range(8):  # chase chained interpolations
        new = resolve_node(cfg, cfg)
        if new == cfg:
            return new
        cfg = new
    raise ValueError("interpolation did not converge (circular reference?)")


def compose(name: str, overrides: Sequence[str] = ()) -> dict:
    """The resolved config of the registered root ``name`` with ``overrides``."""
    cfg = _expand_defaults(_get_group_cfg("root", name))
    return resolve_interpolations(apply_overrides(cfg, overrides))


def save_config(cfg: dict, path: Union[str, Path]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(cfg, indent=2, default=str))


def load_config(path: Union[str, Path]) -> dict:
    return json.loads(Path(path).read_text())
