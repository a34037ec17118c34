"""Weights: the JAX -> PyTorch bridge and the port's own initialisation.

The bridge is the port's copy of ``gaze_tpu/models/weights_export.py``:
it takes the JAX variables as nested dicts of numpy arrays
(``{"sp": {...}, "at": {...}, "lf": {...}}``, as
``jax.tree.map(np.asarray, variables)`` gives them) and returns state
dicts with the same keys and conventions, so a file written by
``export_pipeline_to_torch`` loads as it is:

- Conv2d weight: OIHW (flax HWIO transposed (3, 2, 0, 1)).
- ConvTranspose2d weight: (I, O, kh, kw) with the taps flipped (torch's
  transposed conv is a true convolution of the dilated input; flax
  cross-correlates it with the kernel as stored).
- BatchNorm: scale/bias -> weight/bias, batch_stats -> running_mean/var.
- LSTM: rows packed i, f, g, o; ``bias_ih`` zero, the flax hidden biases
  in ``bias_hh``.
- Linear: weight = kernel.T.

The conversions are linear, so they carry Adam's moments and gradients
as they carry parameters: ``train_state_from_jax`` moves a JAX
``TrainState`` (params, batch_stats, the Adam ``mu``/``nu`` and count,
the step) into a port training state.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from gaze_tpu_torch.models.at import LSTMNet
from gaze_tpu_torch.models.lf import LateFusion
from gaze_tpu_torch.models.sp import SPNet

_GATES = ("i", "f", "g", "o")

StateDict = Dict[str, torch.Tensor]


def _np(x) -> np.ndarray:
    return np.array(x, dtype=np.float32)


def _conv(out: Dict[str, np.ndarray], key: str, p: Dict[str, Any]) -> None:
    out[f"{key}.weight"] = np.ascontiguousarray(_np(p["kernel"]).transpose(3, 2, 0, 1))
    out[f"{key}.bias"] = _np(p["bias"])


def _deconv(out: Dict[str, np.ndarray], key: str, p: Dict[str, Any]) -> None:
    w = _np(p["kernel"]).transpose(2, 3, 0, 1)  # (I, O, kh, kw)
    out[f"{key}.weight"] = w[:, :, ::-1, ::-1].copy()
    out[f"{key}.bias"] = _np(p["bias"])


def _bn(out, key: str, p: Dict[str, Any], stats: Dict[str, Any]) -> None:
    out[f"{key}.weight"] = _np(p["scale"])
    out[f"{key}.bias"] = _np(p["bias"])
    out[f"{key}.running_mean"] = _np(stats["mean"])
    out[f"{key}.running_var"] = _np(stats["var"])


def sp_to_torch_state(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """SPNet variables ({params, batch_stats}) -> SPNet state dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}
    for stream in ("spatial", "temporal"):
        for name, p in params[stream].items():
            _conv(out, f"{stream}.{name}", p)
    _conv(out, "fuse_conv", params["fuse_conv"])
    dec_stats = stats.get("decoder", {})
    for name, p in params["decoder"].items():
        if name.startswith("deconv"):
            _deconv(out, f"decoder.{name}", p)
        elif name.startswith("bn"):
            _bn(out, f"decoder.{name}", p, dec_stats[name])
        else:  # out_conv
            _conv(out, f"decoder.{name}", p)
    return out


def at_to_torch_state(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """LSTMNet variables -> LSTMNet state dict."""
    params = variables["params"]
    out: Dict[str, np.ndarray] = {}
    k = 0
    while f"lstm{k}" in params:
        cell = params[f"lstm{k}"]
        b_hh = np.concatenate([_np(cell[f"h{g}"]["bias"]) for g in _GATES], 0)
        out[f"weight_ih_l{k}"] = np.concatenate(
            [_np(cell[f"i{g}"]["kernel"]).T for g in _GATES], 0)
        out[f"weight_hh_l{k}"] = np.concatenate(
            [_np(cell[f"h{g}"]["kernel"]).T for g in _GATES], 0)
        out[f"bias_ih_l{k}"] = np.zeros_like(b_hh)
        out[f"bias_hh_l{k}"] = b_hh
        k += 1
    out["head.weight"] = np.ascontiguousarray(_np(params["head"]["kernel"]).T)
    out["head.bias"] = _np(params["head"]["bias"])
    return out


def lf_to_torch_state(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """LateFusion variables -> LateFusion state dict."""
    out: Dict[str, np.ndarray] = {}
    for name, p in variables["params"].items():
        _conv(out, name, p)
    return out


def torch_state_from_jax(variables: Dict[str, Any]) -> Dict[str, StateDict]:
    """JAX pipeline variables -> ``{"sp", "at", "lf"}`` state dicts of
    tensors — the same bundle ``export_pipeline_to_torch`` saves."""
    bundle = {
        "sp": sp_to_torch_state(variables["sp"]),
        "at": at_to_torch_state(variables["at"]),
        "lf": lf_to_torch_state(variables["lf"]),
    }
    return {k: {kk: torch.from_numpy(v) for kk, v in sd.items()} for k, sd in bundle.items()}


def module_to_torch_state(module: nn.Module, variables: Dict[str, Any]) -> StateDict:
    """The bridge for ``module``'s kind (SPNet, LSTMNet, LateFusion):
    its JAX variables ({"params", optionally "batch_stats"}) as its state
    dict of tensors."""
    for kind, fn in ((SPNet, sp_to_torch_state), (LSTMNet, at_to_torch_state),
                     (LateFusion, lf_to_torch_state)):
        if isinstance(module, kind):
            return {k: torch.from_numpy(v) for k, v in fn(variables).items()}
    raise TypeError(f"no weight bridge for {type(module).__name__}")


def _adam_state(opt_state):
    """The (count, mu, nu) node of an optax state tree: the one object in
    the (named)tuple nesting with ``mu`` and ``nu`` fields."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        found = [a for a in map(_adam_state, opt_state) if a is not None]
        if len(found) > 1:
            raise ValueError("more than one Adam state in the optax state")
        return found[0] if found else None
    return None


def train_state_from_jax(jax_state: Any, state) -> None:
    """Copy a JAX ``TrainState`` (its leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, state)``) into the port's ``state``
    (``train/common.py:TrainState``) in place: parameters and BatchNorm
    statistics through the module's bridge, Adam's ``mu`` and ``nu``
    through the same linear conversions, the Adam count and the step."""
    stats = jax_state.batch_stats or {}
    module = state.module
    with torch.no_grad():
        load_state(module, module_to_torch_state(
            module, {"params": jax_state.params, "batch_stats": stats}))
        adam = _adam_state(jax_state.opt_state)
        if adam is None:
            raise ValueError("no Adam state (mu, nu) in the optax state")
        for moments, ours in ((adam.mu, state.opt_state.mu), (adam.nu, state.opt_state.nu)):
            conv = module_to_torch_state(module, {"params": moments, "batch_stats": stats})
            for name, dst in zip(state.param_names, ours):
                dst.copy_(conv[name])
    state.opt_state.count = int(np.asarray(adam.count))
    state.step = int(np.asarray(jax_state.step))


def load_state(module: nn.Module, state: StateDict) -> None:
    """Load a bridge state dict: every parameter and buffer must be
    present except BatchNorm's ``num_batches_tracked`` (the bridge has
    no counterpart), and no key may be left over."""
    missing, unexpected = module.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, unexpected {unexpected}")


def draw(param: torch.Tensor, sample) -> None:
    """``param`` filled in place by ``sample`` applied to a CPU tensor of
    its shape and dtype."""
    param.copy_(sample(torch.empty(param.shape, dtype=param.dtype)))


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The port's default initialisation, drawn from ``generator``.

    Convolutions: He-normal weights for the ReLU stacks (std
    sqrt(2 / fan_in), fan_in of a stride-2 transposed conv counted per
    output pixel) and U(-1/sqrt(fan_in), +) biases; linear layers
    LeCun-normal; BatchNorm identity; LSTM as ``torch.nn.LSTM``; a
    residual LF head's last conv zero. The draws are made on the CPU
    (``generator`` is a CPU generator) and copied to the module's device,
    so a seed gives the same weights on either.
    """
    for m in module.modules():
        with torch.no_grad():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                k = m.kernel_size[0] * m.kernel_size[1]
                if isinstance(m, nn.ConvTranspose2d):
                    fan_in = m.in_channels * k // (m.stride[0] * m.stride[1])
                else:
                    fan_in = m.in_channels * k
                draw(m.weight, lambda t: t.normal_(0.0, math.sqrt(2.0 / fan_in),
                                                   generator=generator))
                b = 1.0 / math.sqrt(fan_in)
                draw(m.bias, lambda t: t.uniform_(-b, b, generator=generator))
            elif isinstance(m, nn.Linear):
                draw(m.weight, lambda t: t.normal_(0.0, math.sqrt(1.0 / m.in_features),
                                                   generator=generator))
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, LSTMNet):
                m.reset_parameters(generator)
    for m in module.modules():
        if isinstance(m, LateFusion) and m.cfg.residual:
            with torch.no_grad():
                m.out_conv.weight.zero_()  # the stack starts as a zero correction
