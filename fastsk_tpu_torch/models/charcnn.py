"""Character-level CNN baseline, Zhang et al. 2015 variant.

Counterpart of ``fastsk_tpu/models/charcnn.py`` as a ``torch.nn.Module``:
three conv1d + relu stages (7/7/3 kernels, 256 channels, VALID padding,
max-pool 3 after the first two), then a 1024-1024-classes MLP with dropout.
The input is a one-hot ``[B, L, A]`` tensor, as in the JAX package. The
first convolution and the first dense layer take their input widths from
the first call (lazy modules), as flax's ``init`` does from its sample.

The flattened features are taken in flax's ``(L', C)`` order (the
activations are transposed back to ``[B, L', C]`` first), so
``from_flax_params`` only transposes kernels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .init import dropout, flax_init_


class CharCNN(nn.Module):
    def __init__(self, n_classes: int = 2, channels: int = 256,
                 dropout_input: float = 0.1, dropout_fc: float = 0.5):
        super().__init__()
        self.n_classes = n_classes
        self.dropout_input = dropout_input
        self.dropout_fc = dropout_fc
        self.conv0 = nn.LazyConv1d(channels, 7)
        self.conv1 = nn.Conv1d(channels, channels, 7)
        self.conv2 = nn.Conv1d(channels, channels, 3)
        self.dense0 = nn.LazyLinear(1024)
        self.dense1 = nn.Linear(1024, 1024)
        self.dense2 = nn.Linear(1024, n_classes)
        # dropout's random stream in training (None: torch's default)
        self.generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``[B, L, A]`` one-hot; dropout runs in training mode only."""
        x = dropout(x, self.dropout_input, self.training, self.generator)
        x = x.transpose(1, 2)  # [B, A, L]
        x = F.max_pool1d(F.relu(self.conv0(x)), 3, 3)
        x = F.max_pool1d(F.relu(self.conv1(x)), 3, 3)
        x = F.relu(self.conv2(x))
        x = x.transpose(1, 2).reshape(x.shape[0], -1)  # flax's (L', C) order
        x = F.relu(self.dense0(x))
        x = dropout(x, self.dropout_fc, self.training, self.generator)
        x = F.relu(self.dense1(x))
        x = dropout(x, self.dropout_fc, self.training, self.generator)
        return self.dense2(x)

    def init_params(self, sample: torch.Tensor, generator: torch.Generator) -> "CharCNN":
        """Materialize the lazy layers on ``sample`` and initialize every
        weight as flax does (lecun-normal kernels, zero biases)."""
        with torch.no_grad():
            self.eval()(sample)
        flax_init_(self, generator)
        return self.train()

    def from_flax_params(self, tree) -> dict:
        """The flax parameter tree (``{"params": ...}`` or its inside, as
        numpy or jax arrays) as this module's ``state_dict``: Conv kernels
        ``[kw, in, out]`` -> ``[out, in, kw]``, Dense ``[in, out]`` ->
        ``[out, in]``."""
        p = tree.get("params", tree)
        out = {}
        for i in range(3):
            layer = p[f"Conv_{i}"]
            out[f"conv{i}.weight"] = np.asarray(layer["kernel"]).transpose(2, 1, 0)
            out[f"conv{i}.bias"] = np.asarray(layer["bias"])
        for i in range(3):
            layer = p[f"Dense_{i}"]
            out[f"dense{i}.weight"] = np.asarray(layer["kernel"]).T
            out[f"dense{i}.bias"] = np.asarray(layer["bias"])
        return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}
