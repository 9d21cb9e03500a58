"""Uniform random choices among candidate rows, the same on every device.

The JAX package draws with ``jax.random.categorical`` over logits that
are 0 on the candidates and -inf elsewhere: a uniform choice among the
candidates.  Torch cannot replay ``jax.random`` streams, so the port draws
uniforms in [0, 1) from a CPU ``torch.Generator`` (``uniform_draws``), the
same numbers whatever device the clouds are on, and turns each into the
candidate of that rank on the clouds' device (``choose_uniform``).  Tests
inject the reference's own draws as indices instead.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch


def seeded_generator(*seed: int) -> torch.Generator:
    """A CPU generator seeded from the integers ``seed`` (for example a
    run's seed and a scan index), each stream independent of the others."""
    mixed = np.random.SeedSequence([int(s) for s in seed]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(mixed))


def uniform_draws(generator: torch.Generator | Sequence[torch.Generator],
                  batch: int, shape: tuple[int, ...],
                  device="cpu") -> torch.Tensor:
    """(batch, *shape) f32 uniforms in [0, 1) on ``device``.

    ``generator``: one generator, drawn from for the rows in turn, or one
    generator per row, so that a row's draws do not depend on how many
    rows share the call."""
    if isinstance(generator, torch.Generator):
        u = torch.rand((batch,) + tuple(shape), generator=generator)
    else:
        if len(generator) != batch:
            raise ValueError(f"{len(generator)} generators for {batch} rows")
        u = torch.stack([torch.rand(tuple(shape), generator=g) for g in generator])
    return u.to(device)


def choose_uniform(u: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """Row indices (B, M) int64 for uniforms ``u`` (B, M): the candidate
    (``candidates`` (B, N) bool) of rank floor(u * k) among a row's k
    candidates, or among all N rows where the row has none (the reference's
    guard: its logits become all zero)."""
    cand = torch.where(candidates.any(-1, keepdim=True), candidates,
                       torch.ones_like(candidates))
    cs = torch.cumsum(cand.to(torch.int64), dim=-1)
    k = cs[..., -1:]
    rank = torch.minimum((u * k).to(torch.int64), k - 1)
    return torch.searchsorted(cs, rank + 1)
