"""Configuration files -> the port's and the reference's config objects.

A configuration file (configs/<name>.json) holds the network's sizes
under the names of the port's config dataclasses (`sam6d_tpu_torch/
config.py`, whose fields the reference's copy shares), beside the
benchmark's own keys (source, dtypes, weight seed, assumed sizes).
"""

from __future__ import annotations

import dataclasses
import typing


def build(cls, values: dict):
    """cls(**values), nested dataclass fields built from nested dicts,
    lists made tuples; fields not in values keep their defaults, and a
    key that is no field raises."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(values) - names
    if unknown:
        raise KeyError(f"{cls.__name__} has no fields {sorted(unknown)}")
    kwargs = {}
    for key, val in values.items():
        hint = hints.get(key)
        if isinstance(val, dict) and dataclasses.is_dataclass(hint):
            val = build(hint, val)
        elif isinstance(val, list):
            val = tuple(val)
        kwargs[key] = val
    return cls(**kwargs)


def dtype(name: str):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
