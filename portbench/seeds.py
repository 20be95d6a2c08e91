"""Sub-seeds: every random input of a run is drawn from a generator seeded
by (``--seed``, a tag, an index), so that one seed gives the same inputs
and no two inputs of a run share a stream."""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed from ``seed`` (any whole number) and ``tags`` (str or
    int)."""
    words = [int(seed) % 2**64]
    for tag in tags:
        if isinstance(tag, str):
            words.extend(tag.encode())
        else:
            words.append(int(tag) % 2**64)
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(device, seed: int, *tags) -> torch.Generator:
    """A torch.Generator on ``device`` seeded from (seed, *tags)."""
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))
