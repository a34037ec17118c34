"""Training augmentation: per-sample horizontal flip, on the device.

Counterpart of ``gaze_tpu/data/augment.py``. Opt-in
(``TrainConfig.augment_flip``), off on the parity path. A flip mirrors
the frames (the TV-L1 solve runs after it, so its flow mirrors too),
maps the gaze x to ``(W - 1) - x`` on the model grid, and mirrors a
precomputed flow image with its x channel negated on the 8-bit grid
(``v -> 255 - v``, exact through the temporal normalization, whose zero
motion code 0.5 is the symmetry centre).

The mask is drawn once per step, before the microbatch split, from a
``torch.Generator`` seeded from (seed, step): deterministic in both and
different across steps. It cannot reproduce JAX's threefry bits; the
parity tests pass the mask under ``"_flip"`` themselves. Under a data
mesh the coin is drawn for every row of the global batch and each rank
keeps its rows' coins, so the flips do not depend on the mesh size.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from gaze_tpu_torch.core.distributed import local_batch_rows
from gaze_tpu_torch.parallel.mesh import Mesh


def flip_mask(seed: int, step: int, batch: int) -> torch.Tensor:
    """(batch,) float32 Bernoulli(0.5) bits, a function of (seed, step)."""
    s = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    gen = torch.Generator().manual_seed(int(s[0]) << 32 | int(s[1]))
    return (torch.rand(batch, generator=gen) < 0.5).to(torch.float32)


def with_flip_mask(batch: Dict[str, torch.Tensor], seed: int, step: int,
                   mesh: Optional[Mesh] = None, num_microbatches: int = 1) -> Dict:
    """A copy of ``batch`` with its per-sample flip mask under ``"_flip"``
    (float 0/1, on the gaze's device, so it splits into microbatches
    like every other entry). With a ``mesh``, ``batch`` is the rank's
    rows of the global batch in the layout of ``num_microbatches``
    (``local_batch_rows``), and gets those rows' coins of the global
    draw."""
    g = batch["gaze"]
    if mesh is None:
        return dict(batch, _flip=flip_mask(seed, step, g.shape[0]).to(g.device))
    total = g.shape[0] * mesh.size
    rows = torch.from_numpy(local_batch_rows(total, num_microbatches, mesh))
    return dict(batch, _flip=flip_mask(seed, step, total)[rows].to(g.device))


def apply_hflip(batch: Dict[str, torch.Tensor], model_width: int) -> Dict:
    """Apply the ``"_flip"`` mask: mirror the frames and flow images (x
    negated), mirror the gaze x on the model grid; rows with mask 0 pass
    untouched. An involution: the same mask twice restores the batch."""
    if "_flip" not in batch:
        return batch
    m = batch["_flip"] > 0
    out = dict(batch)
    rows = m[:, None, None, None]
    for k in ("prev", "cur"):
        if k in out:
            out[k] = torch.where(rows, torch.flip(out[k], dims=[2]), out[k])
    if out.get("flow_img") is not None:
        f = torch.flip(out["flow_img"], dims=[2])
        fx = (255 - f[..., :1].to(torch.int32)).to(f.dtype)
        out["flow_img"] = torch.where(rows, torch.cat([fx, f[..., 1:]], dim=-1), out["flow_img"])
    if "gaze" in out:
        g = out["gaze"]
        gx = torch.where(m, (model_width - 1) - g[..., 0], g[..., 0])
        out["gaze"] = torch.stack([gx, g[..., 1]], dim=-1)
    return out
