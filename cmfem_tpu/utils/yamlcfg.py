"""YAML configuration loading with the reference's conventions.

The reference parses YAML key-by-key with defaults-in-struct and
validation-with-throw (LoadParams pattern,
linear_convection_diffusion_2D.cpp:62-127).  ``load_yaml`` additionally
resolves data-file paths relative to the YAML's own directory so the
reference's Input/*.yaml files work from any CWD.
"""

from __future__ import annotations

import os


def yaml_safe_load(stream):
    """``yaml.safe_load``, importing PyYAML only when a deck is read, so
    that the package itself does not need it."""
    try:
        import yaml
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            "reading a YAML deck needs the PyYAML package, which is not "
            "installed") from e
    return yaml.safe_load(stream)


def load_yaml(path: str) -> dict:
    if not path:
        raise ValueError("Input YAML file path is empty.")
    if not os.path.exists(path):
        raise FileNotFoundError(f"YAML input file not found: {path}")
    with open(path) as f:
        data = yaml_safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(
            f"YAML input must be a mapping of config keys, got "
            f"{type(data).__name__}: {path}")
    data["_yaml_dir"] = os.path.dirname(os.path.abspath(path))
    return data


def cfg_get(cfg: dict, key: str, default=None, required: bool = False):
    if key in cfg:
        return cfg[key]
    if required:
        raise KeyError(f"Missing required YAML key: {key}")
    return default


def resolve_path(cfg: dict, p: str) -> str:
    """Resolve a data path: as-is if it exists, else relative to the YAML
    dir, else relative to the YAML dir's parent (reference layout has
    Input/ and Mesh/ as siblings)."""
    if os.path.exists(p):
        return p
    base = cfg.get("_yaml_dir", ".")
    for cand in (os.path.join(base, p), os.path.join(os.path.dirname(base), p)):
        if os.path.exists(cand):
            return cand
    return p
