"""Explicit seed policy (port of ``egm_unet_tpu/utils/seeding.py``): one root
seed per run, a derived seed per subsystem name.  ``numpy(name)`` is the
JAX package's generator for the same root and name in the same process (the
name's hash, like Python's, varies between processes unless
``PYTHONHASHSEED`` is set); ``generator(name)`` is a ``torch.Generator``
seeded the same way, in place of the JAX package's ``key(name)``."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Seeds:
    root: int = 0

    def _seed(self, name: str) -> int:
        return abs(hash((self.root, name))) % (2**31)

    def generator(self, name: str) -> torch.Generator:
        return torch.Generator().manual_seed(self._seed(name))

    def numpy(self, name: str) -> np.random.Generator:
        return np.random.default_rng(self._seed(name))
