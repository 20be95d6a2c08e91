"""Matrix families, one module each, found by a configuration's
``family``.  Each module states ``make(cfg, seed, device)``, which builds
the configuration's H on ``device`` from ``seed`` and returns a
:class:`Problem`; ``reference/<family>.py`` states its exact spectrum
(``exact(inputs)``, None where it has none)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Problem:
    H: torch.Tensor        # the (N, N) matrix both sides are handed
    inputs: dict           # what the reference needs besides H (family's)
    norm: float            # the largest |λ| of H, as the family states it
