"""The pipeline's weights as one torch bundle (``--export_torch``).

Counterpart of ``gaze_tpu/models/weights_export.py:export_pipeline_to_torch``.
The port's modules already hold the bundle's layout (the weight bridge's
keys and conventions, ``models/weights.py``), so the export is their
state dicts: ``{"sp", "at", "lf"}``, float32 tensors on the CPU, with
exactly the JAX export's keys (BatchNorm's ``num_batches_tracked``, which
the JAX export has no counterpart for, left out). The file loads into
fresh modules with ``GazePipeline.load_state_dicts(torch.load(path))``.
"""

from __future__ import annotations

import torch


def export_pipeline_to_torch(pipeline, path: str) -> None:
    """Write the pipeline's ``{"sp", "at", "lf"}`` bundle to ``path``
    (``torch.save``; load it with ``torch.load``): CPU float32 copies of
    its modules' state dicts, without ``num_batches_tracked``."""
    torch.save({name: {k: v.detach().to("cpu", torch.float32, copy=True).contiguous()
                       for k, v in module.state_dict().items()
                       if not k.endswith("num_batches_tracked")}
                for name, module in pipeline.modules().items()}, path)
