"""Multi-layer LSTM cell (torch gate layout) for the transducer predictors.

Counterpart of ``asr_tpu/layers/lstm.py``: the Parakeet / Nemotron RNN-T
predictors are small stacked LSTMs stepped once per emitted token. Weights
are stored transposed from torch's ``nn.LSTM`` layout, ``w_ih (I, 4H)`` and
``w_hh (H, 4H)``, gates ordered [input, forget, cell (g), output]. Their
key names keep them out of ``quantize_pytree``: the gate products stay f32
matmuls, as the JAX package computes them outside any kernel. A stack is a
tuple or list of per-layer dicts (an artifact loads it as a list).
"""

from __future__ import annotations

import torch


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, p: dict):
    """One LSTM cell step. x (B, I); h / c (B, H). Returns (h', c')."""
    gates = x @ p["w_ih"] + p["b_ih"] + h @ p["w_hh"] + p["b_hh"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return h2, c2


def lstm_step_stack(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, layers):
    """One step through stacked LSTM layers. h / c: (L, B, H). Returns
    (top output (B, H), h' (L, B, H), c' (L, B, H))."""
    hs, cs = [], []
    y = x
    for li, p in enumerate(layers):
        y, c2 = lstm_cell(y, h[li], c[li], p)
        hs.append(y)
        cs.append(c2)
    return y, torch.stack(hs), torch.stack(cs)


def init_lstm_params(normal, zeros, input_size: int, hidden: int, num_layers: int) -> tuple:
    """Random-init stack with the JAX package's scales; ``normal(*shape,
    std=)`` and ``zeros(*shape)`` are the caller's generator-bound helpers."""
    layers = []
    for li in range(num_layers):
        i = input_size if li == 0 else hidden
        layers.append({"w_ih": normal(i, 4 * hidden, std=i ** -0.5),
                       "w_hh": normal(hidden, 4 * hidden, std=hidden ** -0.5),
                       "b_ih": zeros(4 * hidden), "b_hh": zeros(4 * hidden)})
    return tuple(layers)
