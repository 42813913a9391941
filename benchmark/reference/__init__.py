"""The plain references: each game's integer step, the 4-lane digest and
the replay's expected carry, in plain PyTorch.  Nothing here imports the
program."""

import torch


def shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Arithmetic shift right: floor division by 2^k, in the integer or the
    float arithmetic ``x`` carries."""
    return torch.floor(x / float(1 << k)) if x.is_floating_point() else x >> k
