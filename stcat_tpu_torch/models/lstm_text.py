"""GloVe + (bi)LSTM text encoder: the MODEL.USE_LSTM alternative to RoBERTa
(the JAX package's models/lstm_text.py).

embedding (a GloVe table from a local .npy when MODEL.LSTM.GLOVE_PATH names
one) -> NUM_LAYERS (bi)LSTM layers of HIDDEN_SIZE // 2 units per direction
(HIDDEN_SIZE unidirectional) -> ``proj`` to d_model. Returns the token
features [B, L, d] and the sentence vector [B, d]: ``proj`` of the last
layer's output at the last valid token, max(len - 1, 0), not the LSTM's final
state.

Each direction of each layer is a one-layer ``torch.nn.LSTM``, ``fwd_{l}``
and ``bwd_{l}``, in fp32 whatever TPU.COMPUTE_DTYPE says (the JAX cells run
in fp32 too). The JAX encoder runs flax RNNs with the valid lengths: the
forward direction over the whole padded sequence, the backward one over each
sequence reversed within its own length (the pads reversed among themselves
behind it) and turned back afterwards. Here that reversal is an index
gather computed on the device -- no packed sequences, whose lengths would be
read on the host -- so every position, the pads' included, equals the JAX
output. flax's cells keep per-gate kernels in the gate order i, f, g, o,
torch's order; ``convert.py`` packs them into ``weight_ih`` / ``weight_hh``
and the hidden biases into ``bias_hh``, leaving ``bias_ih`` at 0. flax's
input kernels have no bias, so ``bias_ih`` takes no gradient
(``requires_grad`` False) and stays 0 in training: each gate trains one bias,
as in the JAX encoder. A state_dict whose ``bias_ih`` is not 0 (one trained
while it still took a gradient) has it folded into ``bias_hh`` when loaded,
which leaves the forward as it was.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from .attention import lecun_normal_


def load_glove_embedding(path: str, vocab_size: int, embed_dim: int = 300) -> Optional[np.ndarray]:
    """A [vocab, embed_dim] GloVe matrix from a local .npy; None if there is none."""
    if not path or not os.path.exists(path):
        return None
    table = np.load(path)
    if table.shape != (vocab_size, embed_dim):
        raise ValueError(f"{path}: GloVe table {table.shape}, expected {(vocab_size, embed_dim)}")
    return table


def _gather_time(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, t]] along the time axis of a [B, L, F] tensor."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


@torch.no_grad()
def _fold_input_bias(encoder: nn.Module, incompatible_keys) -> None:
    """After a load: each LSTM's bias_ih added into its bias_hh and zeroed
    (the gates see their sum, so the forward does not change)."""
    for mod in encoder.children():
        if isinstance(mod, nn.LSTM):
            mod.bias_hh_l0.add_(mod.bias_ih_l0)
            mod.bias_ih_l0.zero_()


class LSTMTextEncoder(nn.Module):
    def __init__(self, vocab_size: int, d_model: int, hidden_size: int = 512,
                 embed_dim: int = 300, num_layers: int = 2, bidirectional: bool = True,
                 glove_path: str = ""):
        super().__init__()
        self.num_layers, self.bidirectional, self.glove_path = num_layers, bidirectional, glove_path
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        per_dir = hidden_size // (2 if bidirectional else 1)
        width = embed_dim
        for layer in range(num_layers):
            for direction in self._directions():
                lstm = nn.LSTM(width, per_dir, batch_first=True)
                lstm.bias_ih_l0.requires_grad_(False)
                self.add_module(f"{direction}_{layer}", lstm)
            width = per_dir * len(self._directions())
        self.proj = nn.Linear(width, d_model)
        self._load_glove()
        self.register_load_state_dict_post_hook(_fold_input_bias)

    def _directions(self):
        return ("fwd", "bwd") if self.bidirectional else ("fwd",)

    @torch.no_grad()
    def _load_glove(self) -> bool:
        table = load_glove_embedding(self.glove_path, *self.embedding.weight.shape)
        if table is not None:
            self.embedding.weight.copy_(torch.from_numpy(table))
        return table is not None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX init's distributions, drawn from ``generator``: the GloVe
        table where there is one, else normal(0, 1 / embed_dim) embeddings
        (untruncated, as flax's ``variance_scaling(..., "normal")``);
        lecun-normal input kernels and projection (truncated at 2 sigma), an
        orthogonal recurrent kernel per gate, zero biases."""
        if not self._load_glove():
            self.embedding.weight.copy_(torch.randn(self.embedding.weight.shape,
                                                    generator=generator)
                                        / math.sqrt(self.embedding.embedding_dim))
        for mod in self.children():
            if isinstance(mod, nn.LSTM):
                lecun_normal_(mod.weight_ih_l0, mod.input_size, generator)
                for gate in mod.weight_hh_l0.chunk(4):
                    nn.init.orthogonal_(gate, generator=generator)
                mod.bias_ih_l0.zero_()
                mod.bias_hh_l0.zero_()
        lecun_normal_(self.proj.weight, self.proj.in_features, generator)
        self.proj.bias.zero_()

    def forward(self, token_ids: torch.Tensor, token_valid: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """(token features [B, L, d], sentence vector [B, d]), fp32. The
        encoder draws no dropout; ``generator`` is taken for the text
        encoders' common call."""
        lengths = token_valid.long().sum(1)
        n = token_ids.shape[1]
        pos = torch.arange(n, device=token_ids.device)
        # each row reversed within its length, its pads reversed behind it
        # (flax's flip_sequences); the gather is its own inverse
        flip = (n - 1 - pos[None, :] + lengths[:, None]) % n
        h = self.embedding(token_ids.long()).float()
        for layer in range(self.num_layers):
            out = getattr(self, f"fwd_{layer}")(h)[0]
            if self.bidirectional:
                back = getattr(self, f"bwd_{layer}")(_gather_time(h, flip))[0]
                out = torch.cat([out, _gather_time(back, flip)], dim=-1)
            h = out
        last = _gather_time(h, (lengths - 1).clamp(min=0)[:, None])[:, 0]
        return self.proj(h), self.proj(last)
