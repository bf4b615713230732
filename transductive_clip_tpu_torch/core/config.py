"""Configuration substrate.

Semantics mirror the reference's 3-layer YAML config system
(reference: src/utils.py:40-168, main.py:19-35):

* YAML files have exactly one level of section nesting; section headers are
  discarded and all leaf keys are flattened into a single namespace.
* CLI overrides come as a flat ``["key", "value", ...]`` list; string values
  are ``ast.literal_eval``'d and type-coerced against the existing value.
* Unknown keys are silently created (the reference relies on this).
* The full load order is: main config -> CLI opts -> dataset config ->
  method config -> CLI opts again, then ``n_class = num_classes_test``.
"""

from __future__ import annotations

import copy
import os
from ast import literal_eval
from typing import List, Optional

import yaml


class CfgNode(dict):
    """A dict with attribute access, used as a flat config namespace."""

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else dict(init_dict)
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                init_dict[k] = CfgNode(v)
        super().__init__(init_dict)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __deepcopy__(self, memo):
        return CfgNode({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __str__(self):
        lines = []
        for k in sorted(self.keys()):
            lines.append(f"{k}: {self[k]}")
        return "\n".join(lines)


def _decode_cfg_value(v):
    """Literal-eval a CLI string when possible ('True'->True, '1e-4'->float)."""
    if not isinstance(v, str):
        return v
    try:
        return literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _coerce_value_type(replacement, original, key):
    """Coerce `replacement` to the type of `original` (tuple<->list only)."""
    if original is None or type(replacement) is type(original):
        return replacement
    # numeric cross-assignment (int -> float slot) is accepted; bool is an
    # int subclass but True/False into a float slot is a typo, not a value
    if (isinstance(original, float) and isinstance(replacement, int)
            and not isinstance(replacement, bool)):
        return float(replacement)
    casts = [(tuple, list), (list, tuple)]
    for from_type, to_type in casts:
        if isinstance(replacement, from_type) and isinstance(original, to_type):
            return to_type(replacement)
    raise ValueError(
        f"Type mismatch ({type(original)} vs {type(replacement)}) "
        f"with values ({original} vs {replacement}) for config key: {key}"
    )


def load_cfg_from_cfg_file(file: str) -> CfgNode:
    """Load a YAML file and flatten its single level of sections."""
    if not (os.path.isfile(file) and file.endswith(".yaml")):
        raise FileNotFoundError(f"{file} is not a yaml file")
    with open(file, "r") as f:
        raw = yaml.safe_load(f) or {}
    cfg = {}
    for section in raw:
        for k, v in (raw[section] or {}).items():
            cfg[k] = v
    return CfgNode(cfg)


def merge_cfg_from_list(cfg: CfgNode, cfg_list: List[str]) -> CfgNode:
    """Merge flat ["key", "value", ...] CLI overrides into a copy of cfg."""
    new_cfg = copy.deepcopy(cfg)
    if len(cfg_list) % 2 != 0:
        raise ValueError(f"Override list must have even length: {cfg_list}")
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        subkey = full_key.split(".")[-1]
        value = _decode_cfg_value(v)
        if subkey in cfg:
            value = _coerce_value_type(value, cfg[subkey], subkey)
        new_cfg[subkey] = value
    return new_cfg


def load_full_config(
    opts: Optional[List[str]] = None,
    config_root: str = "config",
    main_config: Optional[str] = None,
) -> CfgNode:
    """Full 3-layer load: main -> opts -> dataset -> method -> opts."""
    main_config = main_config or os.path.join(config_root, "main_config.yaml")
    cfg = load_cfg_from_cfg_file(main_config)
    if opts:
        cfg = merge_cfg_from_list(cfg, opts)
    dataset_config = os.path.join(
        config_root, "datasets_config", f"config_{cfg.dataset}.yaml"
    )
    method_config = os.path.join(config_root, "methods_config", f"{cfg.method}.yaml")
    cfg.update(load_cfg_from_cfg_file(dataset_config))
    cfg.update(load_cfg_from_cfg_file(method_config))
    if opts:
        cfg = merge_cfg_from_list(cfg, opts)
    cfg.n_class = cfg.num_classes_test
    return cfg
