"""BiGRU — the Negational network.

PyTorch counterpart of clairs_to_tpu/models/bigru.py: two stacked
bidirectional GRUs (hidden 128 -> 192) over the 33-position axis, flatten,
fc1(128), per-allele fc2+fc3 heads with SELU after every fc, and the CvT's
training-time fc dropout at the same three sites.  The gate
order is r, z, n and the reset gate multiplies the *biased* hidden branch:
n = tanh(x_n + b_in + r * (h W_hn + b_hn)).  The recurrence runs in
ops/gru.py: the CUDA kernel for CUDA tensors, the plain loop for CPU ones.
The kernel has no backward pass: training runs the plain loop under
autograd, as the JAX package trains through its plain ``lax.scan``.
"""

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from clairs_to_tpu_torch.models.cvt import (INDEL_ALLELES, SNV_ALLELES, Head, Linear,
                                            heads_forward)
from clairs_to_tpu_torch.ops.gru import bigru_layer


@dataclass(frozen=True)
class BiGRUConfig:
    in_channels: int = 34
    width: int = 33
    hidden1: int = 128
    hidden2: int = 192
    fc_dim: int = 128
    num_classes: int = 2
    alleles: Tuple[str, ...] = SNV_ALLELES


SNV_BIGRU_CONFIG = BiGRUConfig()
INDEL_BIGRU_CONFIG = BiGRUConfig(alleles=INDEL_ALLELES)


def _gru_params(in_dim, hidden):
    # torch.nn.GRU layouts: weight_ih (3H, in), weight_hh (3H, H)
    return nn.ModuleDict({
        "ih": Linear(in_dim, 3 * hidden),
        "hh": Linear(hidden, 3 * hidden),
        "ih_reverse": Linear(in_dim, 3 * hidden),
        "hh_reverse": Linear(hidden, 3 * hidden),
    })


def _as_dict(layer):
    return {k: {"weight": m.weight, "bias": m.bias} for k, m in layer.items()}


class BiGRU(nn.Module):
    """(B, 33, 34) pileup tensors -> (B, n_alleles, num_classes) logits."""

    def __init__(self, config: BiGRUConfig = SNV_BIGRU_CONFIG):
        super().__init__()
        self.config = config
        self.gru1 = _gru_params(config.in_channels, config.hidden1)
        self.gru2 = _gru_params(2 * config.hidden1, config.hidden2)
        self.fc1 = Linear(config.width * 2 * config.hidden2, config.fc_dim)
        self.heads = nn.ModuleDict(
            {al: Head(config.fc_dim, config.num_classes) for al in config.alleles})

    def forward(self, x, use_kernel=None, dropout_rate=0.0, generator=None):
        """``use_kernel`` None or True: ops/gru.py's ``gru_direction`` (the
        kernel on CUDA tensors, the plain loop on CPU ones); False: the plain
        loop everywhere.  ``dropout_rate``/``generator``: training-time fc
        dropout; the inference forward leaves them at 0/None."""
        use_kernel = True if use_kernel is None else use_kernel
        out = bigru_layer(x, _as_dict(self.gru1), self.config.hidden1, use_kernel)
        out = bigru_layer(out, _as_dict(self.gru2), self.config.hidden2, use_kernel)
        return heads_forward(self, out.reshape(out.shape[0], -1), dropout_rate, generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """Random weights with the JAX ``init``'s distributions: GRU weights
        uniform in +-1/sqrt(hidden), linears in +-1/sqrt(in)."""
        for name, t in self.named_parameters():
            if name.startswith("gru"):
                hidden = t.shape[0] // 3
                bound = hidden ** -0.5
            else:
                bound = self.get_parameter(name.rsplit(".", 1)[0] + ".weight").shape[1] ** -0.5
            t.uniform_(-bound, bound, generator=generator)
        return self
