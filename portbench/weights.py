"""A cell's initial weights, drawn on the device from the run's seed.

The tables' values are one stream of uniform draws and the dense layers'
one stream of normal draws, each from its own ``torch.Generator`` on the
device and made in chunks of :data:`CHUNK` values, so that a few large
calls draw every leaf and the transient memory stays at one chunk. The
same seed, device and leaves give the same values bit for bit, so both
the program and the reference are filled from here, and the change of a
trained leaf is measured against the values drawn again.
"""

from typing import Iterator, List, Sequence, Tuple

import torch

from portbench.arch import Leaf

CHUNK = 1 << 26  # values a draw (256 MB of float32)
_STREAMS = {"uniform": 0, "normal": 1}


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed of the run's seed and a stream number."""
    return (int(seed) * 0x9E3779B97F4A7C15 + (stream + 1)
            * 0xBF58476D1CE4E5B9) % (1 << 63)


def generator(device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def pieces(leaves: Sequence[Leaf], seed: int, device
           ) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """(leaf index, flat offset in the leaf, initial values) covering
    every leaf once."""
    for law, stream in _STREAMS.items():
        idx = [i for i, leaf in enumerate(leaves) if leaf.law == law]
        total = sum(leaves[i].numel for i in idx)
        gen = generator(device, seed, stream)
        k, at = 0, 0  # the leaf the chunk starts in and its offset there
        for start in range(0, total, CHUNK):
            n = min(CHUNK, total - start)
            if law == "uniform":
                raw = torch.rand(n, generator=gen, device=device)
            else:
                raw = torch.randn(n, generator=gen, device=device)
            used = 0
            while used < n:
                leaf = leaves[idx[k]]
                m = min(leaf.numel - at, n - used)
                vals = raw[used:used + m]
                if law == "uniform":
                    vals = vals * (2.0 * leaf.scale) - leaf.scale
                else:
                    vals = vals * leaf.scale
                yield idx[k], at, vals
                used += m
                at += m
                if at == leaf.numel:
                    k, at = k + 1, 0


@torch.no_grad()
def fill(leaves: Sequence[Leaf], tensors: Sequence[torch.Tensor],
         seed: int):
    """Write the initial weights into ``tensors`` (contiguous, float32,
    the leaves' shapes, all on one device)."""
    for i, at, vals in pieces(leaves, seed, tensors[0].device):
        tensors[i].view(-1)[at:at + vals.numel()].copy_(vals)


@torch.no_grad()
def change_norms(leaves: Sequence[Leaf], tensors: Sequence[torch.Tensor],
                 seed: int) -> List[float]:
    """The norm of each tensor's change from its initial weights, the
    whole leaf (rows no step touched included)."""
    sq = torch.zeros(len(leaves), dtype=torch.float64,
                     device=tensors[0].device)
    for i, at, vals in pieces(leaves, seed, tensors[0].device):
        d = tensors[i].detach().reshape(-1)[at:at + vals.numel()] - vals
        sq[i] += torch.linalg.vector_norm(d).double() ** 2
    return sq.sqrt().tolist()
