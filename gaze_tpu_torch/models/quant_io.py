"""The int8 weights carried across: JAX ``QuantSP`` bundles to the port's.

Counterpart of ``gaze_tpu/models/quant_io.py``, with the same ``.npz``
format, so a bundle calibrated by either package serves in the other:
one ``.npz`` with flat dotted keys (``spatial.kernels.conv1_1``,
``temporal.act_scales.conv3_2``, ``tail.w_scales.up2``, ...),
``meta.version`` 1, the bf16 stem kernel stored as float32 (exact: it is
a bf16 cast of float32 weights), and with an int8 fuse/decoder tail its
five dicts under ``tail.<field>.<layer>`` and ``tail.num_blocks``.

Unlike the JAX package (whose ``np.savez`` appends ``.npz`` to a bare
path on save while its load reads the path as given), save and load here
both append ``.npz`` to a path without the suffix, so a path that saves
also loads.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

from gaze_tpu_torch.models.quant import QuantSP, QuantVGG
from gaze_tpu_torch.models.quant_tail import QuantTail

# QuantVGG's and QuantTail's dicts of tensors by layer name
_VGG_DICTS = ("kernels", "w_scales", "biases", "act_scales", "col_sums")
_VERSION = 1


def _field(obj: Any, name: str) -> Any:
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _vgg_from_numpy(obj: Any) -> QuantVGG:
    dicts = {f: {k: torch.from_numpy(np.array(v)) for k, v in _field(obj, f).items()}
             for f in _VGG_DICTS}
    stem_k, stem_b = _field(obj, "stem_kernel"), _field(obj, "stem_bias")
    return QuantVGG(
        **dicts,
        stem_kernel=None if stem_k is None
        else torch.from_numpy(np.asarray(stem_k, np.float32)).to(torch.bfloat16),
        stem_bias=None if stem_b is None else torch.from_numpy(np.array(stem_b, np.float32)),
    )


def quant_tail_from_numpy(obj: Any) -> QuantTail:
    """A JAX ``QuantTail`` as numpy arrays (or a dict with the same field
    names) -> the port's on the CPU."""
    dicts = {f: {k: torch.from_numpy(np.array(v)) for k, v in _field(obj, f).items()}
             for f in _VGG_DICTS}
    return QuantTail(**dicts, num_blocks=int(_field(obj, "num_blocks")))


def quant_sp_from_numpy(bundle: Any) -> QuantSP:
    """A JAX ``QuantSP`` as numpy arrays (``jax.tree.map(np.asarray,
    qsp)``, or nested dicts with the same field names), its tail included,
    -> the port's ``QuantSP`` on the CPU."""
    tail = bundle.get("tail") if isinstance(bundle, Mapping) else getattr(bundle, "tail", None)
    return QuantSP(_vgg_from_numpy(_field(bundle, "spatial")),
                   _vgg_from_numpy(_field(bundle, "temporal")),
                   None if tail is None else quant_tail_from_numpy(tail))


def _npz_path(path: str) -> str:
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _flatten_vgg(prefix: str, q: QuantVGG, out: Dict[str, np.ndarray]) -> None:
    for field in _VGG_DICTS:
        for k, v in getattr(q, field).items():
            out[f"{prefix}.{field}.{k}"] = v.detach().cpu().numpy()
    if q.stem_kernel is not None:
        out[f"{prefix}.stem_kernel"] = q.stem_kernel.detach().float().cpu().numpy()
        out[f"{prefix}.stem_bias"] = q.stem_bias.detach().float().cpu().numpy()


def _unflatten_vgg(prefix: str, data: Dict[str, np.ndarray]) -> Dict[str, Any]:
    fields: Dict[str, Any] = {f: {} for f in _VGG_DICTS}
    fields["stem_kernel"] = fields["stem_bias"] = None
    for key, v in data.items():
        if not key.startswith(prefix + "."):
            continue
        rest = key[len(prefix) + 1:]
        if rest in ("stem_kernel", "stem_bias"):
            fields[rest] = v
        else:
            field, name = rest.split(".", 1)
            fields[field][name] = v
    return fields


def save_quant_sp(path: str, qsp: QuantSP) -> None:
    """Write ``qsp`` to ``path`` (``.npz`` appended if absent)."""
    out: Dict[str, np.ndarray] = {"meta.version": np.int64(_VERSION)}
    _flatten_vgg("spatial", qsp.spatial, out)
    _flatten_vgg("temporal", qsp.temporal, out)
    if qsp.tail is not None:
        for field in _VGG_DICTS:
            for k, v in getattr(qsp.tail, field).items():
                out[f"tail.{field}.{k}"] = v.detach().cpu().numpy()
        out["tail.num_blocks"] = np.int64(qsp.tail.num_blocks)
    np.savez(_npz_path(path), **out)


def load_quant_sp(path: str) -> QuantSP:
    """Load a bundle written by either package's ``save_quant_sp`` (``.npz``
    appended if absent), on the CPU."""
    path = _npz_path(path)
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    version = int(data.pop("meta.version", 0))
    if version != _VERSION:
        raise ValueError(f"unsupported quant bundle version {version} in {path!r} "
                         f"(expected {_VERSION})")
    tail = None
    if any(k.startswith("tail.") for k in data):
        tail = {f: {} for f in _VGG_DICTS}
        for key, v in data.items():
            if key == "tail.num_blocks":
                tail["num_blocks"] = int(v)
            elif key.startswith("tail."):
                field, name = key[len("tail."):].split(".", 1)
                tail[field][name] = v
    return quant_sp_from_numpy({"spatial": _unflatten_vgg("spatial", data),
                                "temporal": _unflatten_vgg("temporal", data), "tail": tail})
