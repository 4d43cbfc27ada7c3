"""The random inputs of a run, made from ``--seed`` by a fixed recipe that
the benchmark hands to the program and repeats itself for the reference.

* Each epoch's permutation of the train vertices and every step's sampler
  integers come from a ``torch.Generator`` on the run's device seeded by
  :func:`epoch_seed` (the program is given ``--seed`` and draws them as
  :func:`epoch_randomness` does); a data-parallel rank's from the seed of
  ``(seed, epoch, rank)``.
* Dropout draws, on one device, from a generator seeded by
  :func:`dropout_seed`, which the benchmark sets on the program's dropout
  generator before the first step and which runs on through the epochs
  (:func:`advance`); a data-parallel rank's is reseeded every epoch by the
  program, from :func:`epoch_seed`'s ``stream`` 1.
* The initial parameters: :func:`uniform_leaves`, one ``torch.rand`` call on
  the device for every leaf, scaled leaf by leaf to its bound.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DRAW_HIGH = 2**31 - 1          # sampler integers lie in [0, 2**31 - 1)


def epoch_seed(seed: int, epoch: int, rank: Optional[int] = None, stream: int = 0) -> int:
    """The seed of epoch ``epoch``'s generator on one device, or with
    ``rank`` a data-parallel rank's: ``stream`` 0 its permutation and
    sampler integers, 1 its dropout."""
    key = [seed ^ 0x5EED, epoch] + ([] if rank is None else [rank, stream])
    return int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])


def dropout_seed(seed: int) -> int:
    """The seed of the dropout generator (63 bits)."""
    return int(np.random.SeedSequence([seed, 0xD80]).generate_state(1, np.uint64)[0] >> 1)


def weight_seed(seed: int) -> int:
    """The seed of the initial parameters (63 bits)."""
    return int(np.random.SeedSequence([seed, 0x3E1]).generate_state(1, np.uint64)[0] >> 1)


def hop_sizes(batch_size: int, hop_fanouts: Sequence[int]) -> Tuple[int, ...]:
    """Destination rows of each hop, seeds outward: ``B``, ``B (f0 + 1)``, ..."""
    sizes, n = [], batch_size
    for f in hop_fanouts:
        sizes.append(n)
        n *= f + 1
    return tuple(sizes)


def advance(gen: torch.Generator, steps: int, draw_step: Callable[[torch.Generator], None]
            ) -> torch.Generator:
    """``gen`` moved past ``steps`` steps' draws, ``draw_step(gen)`` making
    one step's: on a card by Philox's offset (a step's draws advance it by
    the same amount each time), elsewhere by drawing them."""
    if steps <= 0:
        return gen
    if gen.device.type == "cuda":
        start = gen.get_offset()
        draw_step(gen)
        gen.set_offset(start + (gen.get_offset() - start) * steps)
    else:
        for _ in range(steps):
            draw_step(gen)
    return gen


def epoch_randomness(seed: int, epoch: int, n_train: int, num_batches: int, batch_size: int,
                     hop_fanouts: Sequence[int], device, rank: Optional[int] = None
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``(perm int64 [n_train], draws)``: one int32 ``[num_batches, hop rows,
    fanout]`` tensor a hop, seeds outward, from the epoch's (or the rank's)
    generator."""
    gen = torch.Generator(device=device).manual_seed(epoch_seed(seed, epoch, rank))
    perm = torch.empty(n_train, dtype=torch.int64, device=device)
    torch.randperm(n_train, generator=gen, out=perm)
    draws = []
    for n, f in zip(hop_sizes(batch_size, hop_fanouts), hop_fanouts):
        out = torch.empty((num_batches, n, f), dtype=torch.int32, device=device)
        draws.append(torch.randint(0, DRAW_HIGH, out.shape, generator=gen, out=out))
    return perm, draws


def epoch_schedule(perm: torch.Tensor, train_nids: torch.Tensor, num_batches: int,
                   batch_size: int, wrapped_valid: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeds int64 and mask bool ``[num_batches, B]``: the train vertices in
    permutation order, the tail padded by wrapping and masked; with
    ``wrapped_valid`` (a data-parallel rank, ``num_batches`` the lockstep
    count) every wrapped seed is valid."""
    n_train = train_nids.shape[0]
    idx = torch.arange(num_batches * batch_size, device=perm.device)
    seeds = train_nids[perm[idx % n_train]].view(num_batches, batch_size)
    if wrapped_valid:
        return seeds, torch.ones_like(seeds, dtype=torch.bool)
    return seeds, (idx < n_train).view(num_batches, batch_size)


def uniform_leaves(specs: Sequence[Tuple[str, Tuple[int, ...], float]], seed: int,
                   device) -> Dict[str, torch.Tensor]:
    """Each ``(name, shape, bound)`` leaf uniform in ``(-bound, bound)``, f32,
    all of them cut from one ``torch.rand`` draw on ``device``."""
    gen = torch.Generator(device=device).manual_seed(weight_seed(seed))
    total = sum(int(np.prod(shape)) for _, shape, _ in specs)
    flat = torch.rand(total, generator=gen, device=device)
    flat.mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape, bound in specs:
        n = int(np.prod(shape))
        out[name] = (flat[at:at + n] * bound).view(shape).clone()
        at += n
    return out
