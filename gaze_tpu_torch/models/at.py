"""AT — attention transition: fixation pooling, LSTM step, attention map.

Counterpart of ``gaze_tpu/models/at.py``:

- ``fixation_pool`` averages conv5 over a roi_size x roi_size window
  around the gaze point (cell index by round-half-even, window clamped
  inside the grid);
- ``LSTMNet`` runs an LSTM over the pooled 512-d channel weights, one
  step at a time (``step``) or over a whole sequence (``forward``,
  ``rollout``), and predicts the next fixation's weights through a ReLU
  linear head;
- ``attention_map`` reweights conv5 channels by the prediction, min-max
  normalizes on the conv5 grid and upsamples bilinearly.

``LSTMNet.dtype`` is the activation type (flax's ``dtype``, parameters
float32): the carry, the gates and the head run in it.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from gaze_tpu_torch.core.config import ATConfig
from gaze_tpu_torch.ops.preprocess import resize_nchw

Carry = Tuple[torch.Tensor, torch.Tensor]  # (c, h), the flax carry order


def fixation_pool(
    features: torch.Tensor, points: torch.Tensor, cfg: ATConfig
) -> torch.Tensor:
    """(B, h, w, C) conv5 features, (B, 2) (x, y) input-pixel points ->
    (B, C) channel-weight vectors."""
    B, h, w, C = features.shape
    # Clamp the ROI to the grid (tiny inputs give grids below 3x3).
    r = min(cfg.roi_size, h, w)
    # torch.round rounds half to even, as jnp.round.
    fx = torch.clamp(
        torch.round(points[:, 0] / cfg.feature_stride).to(torch.int64) - r // 2, 0, w - r
    )
    fy = torch.clamp(
        torch.round(points[:, 1] / cfg.feature_stride).to(torch.int64) - r // 2, 0, h - r
    )
    off = torch.arange(r, device=features.device)
    rows = (fy[:, None] + off)[:, :, None]          # (B, r, 1)
    cols = (fx[:, None] + off)[:, None, :]          # (B, 1, r)
    bidx = torch.arange(B, device=features.device)[:, None, None]
    roi = features[bidx, rows, cols]                # (B, r, r, C)
    return roi.mean(dim=(1, 2))


class LSTMNet(nn.Module):
    """LSTM over channel-weight vectors + ReLU linear head.

    Parameters are named as ``torch.nn.LSTM``'s (``weight_ih_l{k}``,
    ``weight_hh_l{k}``, ``bias_ih_l{k}``, ``bias_hh_l{k}``; gate rows
    packed i, f, g, o) plus ``head.*`` — the weight bridge's keys. The
    flax cell has one bias per gate, ``bias_hh``: ``bias_ih`` is zero and
    not trained (``requires_grad`` False). The carry is a list over
    layers of (c, h) pairs, the flax order. Every path (``step``,
    ``forward``, ``rollout``) runs the same cells.
    """

    def __init__(self, cfg: ATConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        hs = cfg.hidden_size
        for k in range(cfg.num_layers):
            inp = cfg.feature_dim if k == 0 else hs
            self.register_parameter(f"weight_ih_l{k}", nn.Parameter(torch.empty(4 * hs, inp)))
            self.register_parameter(f"weight_hh_l{k}", nn.Parameter(torch.empty(4 * hs, hs)))
            self.register_parameter(f"bias_ih_l{k}",
                                    nn.Parameter(torch.empty(4 * hs), requires_grad=False))
            self.register_parameter(f"bias_hh_l{k}", nn.Parameter(torch.empty(4 * hs)))
        self.head = nn.Linear(hs, cfg.feature_dim)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """``torch.nn.LSTM``'s initialisation, U(-1/sqrt(hidden), +), with
        ``bias_ih`` zero."""
        bound = 1.0 / math.sqrt(self.cfg.hidden_size)
        for name, p in self.named_parameters():
            with torch.no_grad():
                if name.startswith("bias_ih"):
                    p.zero_()
                elif not name.startswith("head."):
                    # drawn on the CPU, where the generator lives
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))

    def init_carry(self, batch: int, device=None) -> List[Carry]:
        """Zero (c, h) state for every layer."""
        z = torch.zeros((batch, self.cfg.hidden_size), dtype=self.dtype, device=device)
        return [(z, z) for _ in range(self.cfg.num_layers)]

    def _cell(self, k: int, carry: Carry, x: torch.Tensor) -> Carry:
        """Layer ``k``'s cell: (c, h), (B, D_in) -> new (c, h)."""
        dt = self.dtype
        c, h = carry
        w_ih = getattr(self, f"weight_ih_l{k}").to(dt)
        w_hh = getattr(self, f"weight_hh_l{k}").to(dt)
        b_ih = getattr(self, f"bias_ih_l{k}").to(dt)
        b_hh = getattr(self, f"bias_hh_l{k}").to(dt)
        # flax OptimizedLSTMCell order: (h W_h + b_h) + x W_i.
        gates = (h @ w_hh.T + b_hh) + (x.to(dt) @ w_ih.T + b_ih)
        gi, gf, gg, go = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        return c, torch.sigmoid(go) * torch.tanh(c)

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.relu(F.linear(h, self.head.weight.to(dt), self.head.bias.to(dt)))

    def step(self, carries: List[Carry], w: torch.Tensor) -> Tuple[List[Carry], torch.Tensor]:
        """One recurrence step: (carries, (B, D)) -> (carries, (B, D))."""
        h_in = w.to(self.dtype)
        new_carries = []
        for k, carry in enumerate(carries):
            carry = self._cell(k, carry, h_in)
            new_carries.append(carry)
            h_in = carry[1]
        return new_carries, self._head(h_in)

    def rollout(
        self, carries: List[Carry], ws: torch.Tensor
    ) -> Tuple[List[Carry], torch.Tensor]:
        """Sequence rollout from an explicit initial carry: (carries,
        (B, T, D)) -> (final carries, (B, T, D) predictions). Layer by
        layer over the whole sequence, then the head, as flax's scanned
        cells (the TBPTT entry: a window resumes from the previous
        window's final carry)."""
        h = ws.to(self.dtype)
        new_carries = []
        for k, carry in enumerate(carries):
            outs = []
            for t in range(h.shape[1]):
                carry = self._cell(k, carry, h[:, t])
                outs.append(carry[1])
            new_carries.append(carry)
            h = torch.stack(outs, dim=1)
        return new_carries, self._head(h)

    def forward(self, ws: torch.Tensor) -> torch.Tensor:
        """(B, T, D) -> (B, T, D) next-step predictions from zero carries."""
        return self.rollout(self.init_carry(ws.shape[0], ws.device), ws)[1]


def attention_map(
    features: torch.Tensor, w_hat: torch.Tensor, out_hw: Tuple[int, int]
) -> torch.Tensor:
    """(B, h, w, C) conv5, (B, C) predicted weights -> (B, H, W) maps in
    [0, 1]: min-max on the conv5 grid, then bilinear upsampling."""
    amap = torch.einsum("bhwc,bc->bhw", features, w_hat)
    mn = torch.amin(amap, dim=(1, 2), keepdim=True)
    mx = torch.amax(amap, dim=(1, 2), keepdim=True)
    amap = (amap - mn) / (mx - mn + 1e-8)
    return resize_nchw(amap[:, None], out_hw)[:, 0]
