"""Stereo pairs: the JAX package's numpy data module, loaded by path.

``make_synthetic_pair`` is numpy-only and seeded, so both packages see the
same inputs.
"""

from __future__ import annotations

from mystereomatching_tpu_torch._reference import load_module

_data = load_module("data.py", "mystereomatching_tpu_torch._reference_data")

StereoPair = _data.StereoPair
make_synthetic_pair = _data.make_synthetic_pair
