"""Character-level LSTM baseline.

Counterpart of ``fastsk_tpu/models/lstm.py`` as a ``torch.nn.Module``:
embedding -> (optionally stacked) LSTM -> linear head on the final hidden
state of the last *valid* timestep. Variable lengths go through
``pack_padded_sequence(enforce_sorted=False)``, which computes what flax's
``seq_lengths`` does (each row's carry frozen past its length); a row of
length 0, which ``encode_dataset`` gives an empty sequence, keeps flax's
zero carry. With ``bidir`` the reverse direction of a one-layer
bidirectional LSTM runs over each row's valid prefix reversed, as the JAX
package's second pass does.

With ``bidir`` and ``n_layers > 1`` the JAX module computes only the first
layer (``fastsk_tpu/models/lstm.py:54``); the port raises there instead of
copying that.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence

_GATES = ("i", "f", "g", "o")  # nn.LSTM's gate order


class SeqLSTM(nn.Module):
    def __init__(self, vocab_size: int, embedding_size: int = 64, hidden_size: int = 128,
                 n_classes: int = 2, n_layers: int = 1, bidir: bool = False):
        super().__init__()
        if bidir and n_layers > 1:
            raise ValueError(
                "bidir with n_layers > 1 is not supported: the JAX model runs only "
                "its first layer there (fastsk_tpu/models/lstm.py:54)"
            )
        self.vocab_size = vocab_size
        self.n_layers = n_layers
        self.bidir = bidir
        self.embed = nn.Embedding(vocab_size, embedding_size)
        self.lstm = nn.LSTM(embedding_size, hidden_size, num_layers=n_layers,
                            batch_first=True, bidirectional=bidir)
        self.dense = nn.Linear(hidden_size * (2 if bidir else 1), n_classes)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """tokens: ``[B, L]`` int (0 = pad); lengths: ``[B]`` (on any
        device; a CPU tensor spares a device read)."""
        x = self.embed(tokens)
        lengths_cpu = lengths.to("cpu", torch.int64)
        if bool((lengths_cpu == tokens.shape[1]).all()):
            # every row is full: packing would change nothing
            _, (h, _) = self.lstm(x)
        else:
            packed = pack_padded_sequence(
                x, lengths_cpu.clamp_min(1), batch_first=True, enforce_sorted=False
            )
            _, (h, _) = self.lstm(packed)
        final = torch.cat([h[-2], h[-1]], dim=-1) if self.bidir else h[-1]
        valid = (lengths_cpu > 0).to(final.device)[:, None]
        return self.dense(torch.where(valid, final, torch.zeros_like(final)))

    def from_flax_params(self, tree) -> dict:
        """The flax parameter tree (``{"params": ...}`` or its inside) as
        this module's ``state_dict``. Flax's cells are
        ``OptimizedLSTMCell_<i>`` (layer i, or with ``bidir`` 0 forward
        and 1 reverse), with input kernels ``ii, if, ig, io`` (no bias) and
        hidden kernels ``hi, hf, hg, ho`` (with bias); ``bias_ih`` is 0."""
        p = tree.get("params", tree)
        out = {"embed.weight": np.asarray(p["Embed_0"]["embedding"])}
        names = ([f"l{i}" for i in range(self.n_layers)] if not self.bidir
                 else ["l0", "l0_reverse"])
        for i, suffix in enumerate(names):
            cell = p[f"OptimizedLSTMCell_{i}"]
            w_ih = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]).T for g in _GATES])
            w_hh = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]).T for g in _GATES])
            b_hh = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in _GATES])
            out[f"lstm.weight_ih_{suffix}"] = w_ih
            out[f"lstm.weight_hh_{suffix}"] = w_hh
            out[f"lstm.bias_ih_{suffix}"] = np.zeros_like(b_hh)
            out[f"lstm.bias_hh_{suffix}"] = b_hh
        out["dense.weight"] = np.asarray(p["Dense_0"]["kernel"]).T
        out["dense.bias"] = np.asarray(p["Dense_0"]["bias"])
        return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}
