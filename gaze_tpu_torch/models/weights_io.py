"""torchvision VGG16 -> the SP streams (``--pretrained_vgg``).

Counterpart of ``gaze_tpu/models/weights_io.py``. The reference starts
both SP encoders from torchvision's ImageNet VGG16; this reads a local
``vgg16*.pth`` state dict (nothing is downloaded). torchvision's
``features.N`` convs are OIHW, as the port's are, so the weights load as
they are. The temporal stream's first conv takes ``flow_channels``
inputs: its kernel is the mean over the RGB inputs, replicated over the
flow channels and scaled by 3 / flow_channels (TSN's cross-modality
initialization), the same numbers the JAX function writes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# torchvision vgg16 ``features`` index of each conv, in the layer order.
_TORCH_FEATURE_IDX = {
    "conv1_1": 0, "conv1_2": 2,
    "conv2_1": 5, "conv2_2": 7,
    "conv3_1": 10, "conv3_2": 12, "conv3_3": 14,
    "conv4_1": 17, "conv4_2": 19, "conv4_3": 21,
    "conv5_1": 24, "conv5_2": 26, "conv5_3": 28,
}


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.pth``/``.pth.tar`` state dict (or ``{"state_dict": ...}``) as
    numpy arrays."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in obj.items() if hasattr(v, "detach")}


def vgg16_params_from_torch(state: Dict[str, np.ndarray], in_channels: int = 3,
                            prefix: str = "features") -> Dict[str, np.ndarray]:
    """The state dict of one ``VGG16Features`` stream (``conv{s}_{i}.weight``
    OIHW, ``.bias``) from a torchvision vgg16 state dict; conv1_1 takes
    ``in_channels`` inputs (channel-averaged and replicated when they are
    not the checkpoint's 3)."""
    out: Dict[str, np.ndarray] = {}
    for name, idx in _TORCH_FEATURE_IDX.items():
        w = state[f"{prefix}.{idx}.weight"]  # (O, I, kh, kw)
        b = state[f"{prefix}.{idx}.bias"]
        if name == "conv1_1" and in_channels != w.shape[1]:
            mean = w.mean(axis=1, keepdims=True)
            w = np.repeat(mean, in_channels, axis=1) * (w.shape[1] / in_channels)
        out[f"{name}.weight"] = np.ascontiguousarray(w, dtype=np.float32)
        out[f"{name}.bias"] = b.astype(np.float32)
    return out


@torch.no_grad()
def init_sp_from_torch_vgg16(sp_module: torch.nn.Module, vgg_pth_path: str,
                             flow_channels: int) -> torch.nn.Module:
    """Load both encoder streams of ``sp_module`` (an ``SPNet``) in place
    from an ImageNet VGG16 checkpoint; the fuse conv and the decoder keep
    their initialization (the reference trains them from scratch).
    Returns ``sp_module``."""
    state = load_torch_state_dict(vgg_pth_path)
    for stream, cin in (("spatial", 3), ("temporal", flow_channels)):
        params = vgg16_params_from_torch(state, in_channels=cin)
        getattr(sp_module, stream).load_state_dict(
            {k: torch.from_numpy(v) for k, v in params.items()})
    return sp_module
