"""The model's weights, made on the device from a run's seed.

The benchmark makes the weights itself and hands the same tensors to the
program (``GazePipeline.load_state_dicts``) and to the plain reference.
The keys and shapes follow from the configuration's sizes alone: the
state-dict names of the two VGG16 streams, the fuse conv, the decoder,
the AT LSTM and the LF head. Every normal draw of the model comes from
one ``torch.randn`` call and every uniform draw from one ``torch.rand``
call of a ``torch.Generator`` on the device, then sliced and scaled:

- convolutions: He-normal weights (std sqrt(2 / fan_in); a stride-2
  transposed conv counts fan_in per output pixel), U(-1/sqrt(fan_in), +)
  biases;
- BatchNorm: scale U(0.8, 1.2), bias U(-0.1, 0.1), running mean
  U(-0.1, 0.1), running variance U(0.6, 1.4), so inference-mode
  normalization is not the identity;
- LSTM: U(-1/sqrt(hidden), +) as ``torch.nn.LSTM``, ``bias_ih`` zero;
  the head LeCun-normal with a zero bias.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, str, Tuple[int, ...], Tuple[str, float, float]]


def _conv(part: str, key: str, o: int, i: int, k: int) -> List[Spec]:
    fan_in = i * k * k
    b = 1.0 / math.sqrt(fan_in)
    return [(part, f"{key}.weight", (o, i, k, k), ("normal", 0.0, math.sqrt(2.0 / fan_in))),
            (part, f"{key}.bias", (o,), ("uniform", -b, b))]


def weight_specs(cfg: dict) -> List[Spec]:
    """(part, key, shape, (draw, a, b)) of every tensor of the model, in a
    fixed order: ``normal`` draws mean a, std b; ``uniform`` draws in
    [a, b); ``const`` fills with a."""
    sp, at, lf = cfg["sp"], cfg["at"], cfg["lf"]
    specs: List[Spec] = []
    for stream, cin in (("spatial", 3), ("temporal", sp["flow_channels"])):
        c = cin
        for s, stage in enumerate(sp["stages"]):
            for i, ch in enumerate(stage):
                specs += _conv("sp", f"{stream}.conv{s + 1}_{i + 1}", ch, c, 3)
                c = ch
    c5 = sp["stages"][-1][-1]
    specs += _conv("sp", "fuse_conv", sp["fused_channels"], 2 * c5, 1)
    c = sp["fused_channels"]
    for i, ch in enumerate(sp["decoder_channels"]):
        fan_in = c * 16 // 4
        b = 1.0 / math.sqrt(fan_in)
        key = f"decoder.deconv{i + 1}"
        specs += [("sp", f"{key}.weight", (c, ch, 4, 4), ("normal", 0.0, math.sqrt(2.0 / fan_in))),
                  ("sp", f"{key}.bias", (ch,), ("uniform", -b, b))]
        bn = f"decoder.bn{i + 1}"
        specs += [("sp", f"{bn}.weight", (ch,), ("uniform", 0.8, 1.2)),
                  ("sp", f"{bn}.bias", (ch,), ("uniform", -0.1, 0.1)),
                  ("sp", f"{bn}.running_mean", (ch,), ("uniform", -0.1, 0.1)),
                  ("sp", f"{bn}.running_var", (ch,), ("uniform", 0.6, 1.4))]
        c = ch
    specs += _conv("sp", "decoder.out_conv", 1, c, 1)
    hs, fd = at["hidden_size"], at["feature_dim"]
    bound = 1.0 / math.sqrt(hs)
    for k in range(at["num_layers"]):
        inp = fd if k == 0 else hs
        specs += [("at", f"weight_ih_l{k}", (4 * hs, inp), ("uniform", -bound, bound)),
                  ("at", f"weight_hh_l{k}", (4 * hs, hs), ("uniform", -bound, bound)),
                  ("at", f"bias_ih_l{k}", (4 * hs,), ("const", 0.0, 0.0)),
                  ("at", f"bias_hh_l{k}", (4 * hs,), ("uniform", -bound, bound))]
    specs += [("at", "head.weight", (fd, hs), ("normal", 0.0, math.sqrt(1.0 / hs))),
              ("at", "head.bias", (fd,), ("const", 0.0, 0.0))]
    c = 2
    for i, ch in enumerate(lf["channels"]):
        specs += _conv("lf", f"conv{i + 1}", ch, c, 3)
        c = ch
    specs += _conv("lf", "out_conv", 1, c, 3)
    return specs


def make_weights(cfg: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"sp", "at", "lf"}`` state dicts of float32 tensors on ``device``,
    drawn from ``torch.Generator(device).manual_seed(seed)`` in two
    calls."""
    specs = weight_specs(cfg)
    counts = {"normal": 0, "uniform": 0}
    for _, _, shape, (kind, _, _) in specs:
        if kind in counts:
            counts[kind] += math.prod(shape)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    pools = {"normal": torch.randn(counts["normal"], generator=gen, device=device),
             "uniform": torch.rand(counts["uniform"], generator=gen, device=device)}
    at = {"normal": 0, "uniform": 0}
    out: Dict[str, Dict[str, torch.Tensor]] = {"sp": {}, "at": {}, "lf": {}}
    for part, key, shape, (kind, a, b) in specs:
        n = math.prod(shape)
        if kind == "const":
            t = torch.full(shape, a, device=device)
        else:
            raw = pools[kind][at[kind]:at[kind] + n].view(shape)
            at[kind] += n
            t = raw * b + a if kind == "normal" else raw * (b - a) + a
        out[part][key] = t
    return out
