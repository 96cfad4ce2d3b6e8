"""Flax's default initializers and dropout, for the baseline models.

The models are initialized from the same distributions as their flax
counterparts (not the same bits): lecun-normal kernels (a normal truncated
at two standard deviations, scaled to a variance of 1 / fan_in), zero
biases, orthogonal recurrent kernels (one a gate), and embeddings drawn
from N(0, 1 / features), flax's ``nn.Embed`` default. Every draw takes an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize every Conv1d, Linear, Embedding and LSTM of ``module``
    in place, as flax initializes its Conv, Dense, Embed and
    OptimizedLSTMCell."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Linear)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, std=math.sqrt(1.0 / m.embedding_dim), generator=generator)
        elif isinstance(m, nn.LSTM):
            h = m.hidden_size
            for name, p in m.named_parameters():
                if name.startswith("weight_ih"):
                    lecun_normal_(p, p.shape[1], generator)
                elif name.startswith("weight_hh"):
                    for gate in range(4):
                        nn.init.orthogonal_(p[gate * h : (gate + 1) * h], generator=generator)
                else:
                    nn.init.zeros_(p)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout (keep with 1 - p, scaled by 1 / (1 - p)), as flax's
    ``nn.Dropout``, drawing its mask from ``generator``."""
    if not training or p == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)
