"""The sharded programs' collectives as small explicit tensor moves.

Counterpart of the `jax.lax` collectives of `sourmash_tpu/parallel/
__init__.py` inside its `shard_map`s. One process drives every device of a
mesh (the JAX package is single-controller too), so a collective is a
handful of copies: each takes one small per-shard tensor a shard, moves
them to the first shard's device (`.to(dev, non_blocking=True)`, a no-op
where the devices are the same), reduces there and sends the result back
to every shard's device. Nothing reads back to the host: the caller's
round loop stays free of synchronisations.

- `psum_placed`: the per-shard blocks placed at their row offsets and
  summed (`dynamic_update_slice` + `psum`): the blocks are disjoint and
  equal, so the sum is their concatenation along the last axis;
- `pmax`: the largest of the per-shard keys (`pmax`);
- `por`: the OR of the per-shard words (the psum of the owner's row, where
  one shard contributes and the others give zeros).
"""

from __future__ import annotations

import torch


def _gather_to(parts, device):
    return [p.to(device, non_blocking=True) for p in parts]


def broadcast(t: torch.Tensor, devices) -> list:
    "t on each of `devices` (the same tensor where it already is)."
    return [t.to(d, non_blocking=True) for d in devices]


def psum_placed(parts) -> list:
    """[..., per] blocks, shard s's the rows [s * per, (s + 1) * per): the
    full [..., per * n] on every shard's device."""
    full = torch.cat(_gather_to(parts, parts[0].device), dim=-1)
    return broadcast(full, [p.device for p in parts])


def pmax(parts) -> list:
    "Equal-shaped per-shard tensors: their elementwise max, on every shard's device."
    acc = None
    for p in _gather_to(parts, parts[0].device):
        acc = p if acc is None else torch.maximum(acc, p)
    return broadcast(acc, [p.device for p in parts])


def por(parts) -> list:
    "Equal-shaped per-shard integer words: their OR, on every shard's device."
    acc = None
    for p in _gather_to(parts, parts[0].device):
        acc = p if acc is None else acc | p
    return broadcast(acc, [p.device for p in parts])
