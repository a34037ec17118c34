"""gaze_tpu_torch — the PyTorch/CUDA port of the gaze pipeline.

The per-frame path of ``gaze_tpu`` (TV-L1 flow -> two-stream SP ->
onset-gated AT LSTM -> LF head -> argmax gaze) on an NVIDIA H100, with
its int8 serving path (the VGG streams and the fuse/decoder tail), its
serving and evaluation surface and its training stages (SP, QAT, AT,
LF), on one card or data-parallel over several:

- ``core``       — configuration dataclasses, device resolution,
                   checkpoints, process-group start-up and the
                   collectives (``core.distributed``);
- ``ops``        — preprocessing, image primitives, warp, TV-L1, the
                   int8 GEMM convs of the quantized tail;
- ``ops.cuda``   — the hand-written Hopper kernels (built from ``csrc/``
                   with nvcc at first use, bound with ctypes);
- ``models``     — SP, AT, LF modules, the int8 streams and tail, the
                   QAT fake-quant forward, the decoder variants, the
                   weight bridge, the torchvision VGG16 import and the
                   torch export, the pipeline;
- ``evaluation`` — AAE/AUC metrics, losses, the sequential rollout,
                   the golden-file hooks;
- ``data``       — the GTEA manifest and batches, the video and JPEG
                   host IO, flow-image extraction on the card, the
                   synthetic corpus, I-DT fixation labels, the flip
                   augmentation, the device prefetcher;
- ``serve``      — ``StreamServer``, the multi-stream server (sharded
                   over a mesh too), and ``DistributedStreamServer``;
- ``train``      — the SP, QAT, AT and LF training steps, AdamW, and
                   the trainer (``train.stages``), data-parallel over a
                   mesh;
- ``parallel``   — the data mesh: one process per card;
- ``utils``      — the step logger, the TensorBoard writer, the gaze
                   overlays, profiling;
- ``cli``        — the command line, ``python -m gaze_tpu_torch.cli``.

Importing the package builds nothing and touches no device; entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API (``import gaze_tpu_torch`` stays cheap)."""
    if name in ("GazePipeline", "StreamState", "run_clip"):
        from gaze_tpu_torch.models import pipeline

        return getattr(pipeline, name)
    if name in ("PipelineConfig", "parity_config"):
        from gaze_tpu_torch.core import config

        return getattr(config, name)
    if name in ("QuantSP", "calibrate_pipeline_sp"):
        from gaze_tpu_torch.models import quant

        return getattr(quant, name)
    if name in ("save_quant_sp", "load_quant_sp"):
        from gaze_tpu_torch.models import quant_io

        return getattr(quant_io, name)
    if name == "QuantTail":
        from gaze_tpu_torch.models.quant_tail import QuantTail

        return QuantTail
    if name == "tvl1_flow":
        from gaze_tpu_torch.ops.tvl1 import tvl1_flow

        return tvl1_flow
    if name in ("StreamServer", "DistributedStreamServer"):
        from gaze_tpu_torch import serve

        return getattr(serve, name)
    if name in ("initialize", "global_mesh"):
        from gaze_tpu_torch.core import distributed

        return getattr(distributed, name)
    if name in ("make_mesh", "shard_batch"):
        from gaze_tpu_torch.parallel import mesh

        return getattr(mesh, name)
    if name in ("rollout_eval_arrays", "rollout_eval_videos"):
        from gaze_tpu_torch.evaluation import rollout

        return getattr(rollout, name)
    if name == "build_manifest":
        from gaze_tpu_torch.data.gtea import build_manifest

        return build_manifest
    if name == "extract_flow_images":
        from gaze_tpu_torch.data.flow_extract import extract_flow_images

        return extract_flow_images
    if name == "compute_aae_auc":
        from gaze_tpu_torch.evaluation.metrics import compute_aae_auc

        return compute_aae_auc
    raise AttributeError(name)
