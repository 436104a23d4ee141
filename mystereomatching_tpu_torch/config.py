"""The pipeline configuration, shared with the JAX package.

``MatchConfig`` and its constructors are the JAX package's own
(``mystereomatching_tpu/config.py``), loaded by path so that this package
never imports jax. The two packages therefore hold two distinct
``MatchConfig`` classes with the same fields; :func:`as_port_config` converts
an instance of the JAX one.
"""

from __future__ import annotations

import dataclasses

from mystereomatching_tpu_torch._reference import load_module

_config = load_module("config.py", "mystereomatching_tpu_torch._reference_config")

MatchConfig = _config.MatchConfig
default_config = _config.default_config
fast_config = _config.fast_config


def as_port_config(cfg) -> MatchConfig:
    """This package's ``MatchConfig`` with the fields of ``cfg``, which may
    be an instance of the JAX package's class."""
    if isinstance(cfg, MatchConfig):
        return cfg
    return MatchConfig(**dataclasses.asdict(cfg))
