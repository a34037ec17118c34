"""Configuration dataclasses of the port.

The port's own copy of the ``gaze_tpu`` config classes it needs
(``gaze_tpu/core/config.py``): same class names, field names and
defaults, so a config written for one package reads the same in the
other. ``tests/test_torch_isolation.py`` holds the two copies equal
field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ImageConfig:
    """Input geometry + normalization."""

    height: int = 224
    width: int = 224
    # ImageNet mean/std, RGB order.
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    # Ground-truth heatmap Gaussian sigma in pixels at 224x224.
    heatmap_sigma: float = 32.0


@dataclasses.dataclass(frozen=True)
class TVL1Config:
    """Pyramidal TV-L1 optical flow (Sanchez et al., IPOL 2013) with
    fixed level/warp/iteration counts."""

    pyramid_levels: int = 5
    pyramid_factor: float = 0.5      # downscale per level
    tau: float = 0.25                # dual ascent time step
    lambda_: float = 0.15            # data-term weight
    theta: float = 0.3               # tightness
    warps: int = 5                   # image warps per level
    iters: int = 10                  # primal-dual iterations per warp
    quant_bound: float = 15.0        # 8-bit flow image clip, pixels
    presmooth_sigma: float = 0.8     # Gaussian presmoothing of the pyramid
    median_filter: bool = True       # 3x3 median on the flow between warps
    median_kernel: int = 3           # 3 = one pass, 5 = two chained passes
    # Run the warp (kernel K1) and the primal-dual loop (kernel K2)
    # through the hand-written CUDA kernels for CUDA tensors. False runs
    # the plain PyTorch versions on any device — the reference the
    # kernels are held against on the card. CPU tensors always take the
    # plain versions.
    use_pallas_warp: bool = True
    use_pallas_pd: bool = True
    # Solve the flow at this fraction of the model grid, then upsample the
    # field and rescale the displacements (1.0 = parity; 0.5 = production).
    flow_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class SPConfig:
    """Two-stream saliency-prediction network: VGG16 over RGB and over
    the flow image, 1x1 fusion at conv5_3, ConvTranspose+BN decoder."""

    flow_channels: int = 2
    fused_channels: int = 512
    decoder_channels: Tuple[int, ...] = (512, 256, 128, 64)
    use_batchnorm: bool = True
    # Channel widths of the VGG stages (a max-pool follows every stage but
    # the last). Narrow variants keep the 2,2,3,3,3 layout so layer names
    # conv{s}_{i} are unchanged; the conv5 width must equal
    # ATConfig.feature_dim.
    stages: Tuple[Tuple[int, ...], ...] = (
        (64, 64),
        (128, 128),
        (256, 256, 256),
        (512, 512, 512),
        (512, 512, 512),
    )
    # Training-time rematerialization; inference ignores it.
    remat: str = "none"


@dataclasses.dataclass(frozen=True)
class ATConfig:
    """Attention-transition LSTM over conv5 channel-weight vectors."""

    feature_dim: int = 512
    hidden_size: int = 512
    num_layers: int = 1
    # ROI width in feature cells for fixation pooling.
    roi_size: int = 3
    # conv5 stride relative to input pixels (224/14).
    feature_stride: int = 16


@dataclasses.dataclass(frozen=True)
class LFConfig:
    """Late-fusion conv head: concat(SP map, AT map) -> 3x3 convs ->
    1-channel sigmoid heatmap."""

    channels: Tuple[int, ...] = (32, 32, 8)
    # "zero" (parity) or "edge" (replicate) padding of the 3x3 convs.
    padding: str = "zero"
    # Logit-space residual correction of the SP saliency channel.
    residual: bool = False


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Focal-style BCE on dense heatmaps (``evaluation/losses.py``)."""

    gamma: float = 2.0
    eps: float = 1e-7


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera geometry for AAE (``evaluation/metrics.py``): a pinhole
    model with the focal length from the horizontal field of view at the
    native capture resolution, the principal point at the image centre
    and square pixels."""

    # Native capture resolution of GTEA Gaze+ videos.
    native_width: int = 960
    native_height: int = 720
    # Horizontal field of view, degrees.
    fov_x_deg: float = 74.0

    @staticmethod
    def gtea_gaze_plus() -> "CameraConfig":
        """GTEA Gaze+ capture geometry (the default)."""
        return CameraConfig()

    @staticmethod
    def gtea_gaze() -> "CameraConfig":
        """GTEA Gaze (original) capture geometry: the eye tracker's
        640x480 scene camera."""
        return CameraConfig(native_width=640, native_height=480, fov_x_deg=64.0)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Per-stage optimization knobs (``train/``)."""

    batch_size: int = 32
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    epochs: int = 10
    # "constant", "cosine" (warmup -> cosine decay over lr_decay_steps) or
    # "step" (x lr_decay_rate every lr_decay_steps); warmup applies to all.
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    lr_decay_steps: int = 0
    lr_decay_rate: float = 0.1
    # Global-norm gradient clipping; 0 = off.
    grad_clip_norm: float = 0.0
    # Microbatches per optimizer step (mean gradient); 1 = off.
    grad_accum: int = 1
    # Per-sample horizontal flip inside the SP train step (data/augment.py).
    augment_flip: bool = False
    # Activation type of the throughput path; float32 on the parity path.
    compute_dtype: str = "float32"
    checkpoint_dir: str = "save"
    checkpoint_every_steps: int = 500
    log_every_steps: int = 50
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Config tree of the SP -> AT -> LF pipeline, its evaluation (loss,
    camera) and its training."""

    image: ImageConfig = dataclasses.field(default_factory=ImageConfig)
    tvl1: TVL1Config = dataclasses.field(default_factory=TVL1Config)
    sp: SPConfig = dataclasses.field(default_factory=SPConfig)
    at: ATConfig = dataclasses.field(default_factory=ATConfig)
    lf: LFConfig = dataclasses.field(default_factory=LFConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def dense_flow_tvl1_config() -> TVL1Config:
    """The TV-L1 schedule of OpenCV's DualTVL1 defaults, the solver that
    dense_flow (the paper's flow-image producer) wraps: 5 scales at
    factor 0.8, 5 warps, a 5-wide median, and a fixed 30 primal-dual
    iterations per warp in place of OpenCV's epsilon-stopped schedule."""
    return TVL1Config(
        pyramid_levels=5,
        pyramid_factor=0.8,
        warps=5,
        iters=30,
        median_kernel=5,
    )


def parity_config() -> PipelineConfig:
    """The exact-math path for reference comparison: full-grid flow,
    float32 activations (GazePipeline's default dtype)."""
    base = PipelineConfig()
    return dataclasses.replace(
        base, tvl1=dataclasses.replace(base.tvl1, flow_scale=1.0)
    )


def production_config() -> PipelineConfig:
    """The serving/throughput preset: half-grid TV-L1 — pair with
    dtype=bfloat16."""
    base = PipelineConfig()
    return dataclasses.replace(
        base, tvl1=dataclasses.replace(base.tvl1, flow_scale=0.5)
    )


def production_fast_config() -> PipelineConfig:
    """production_config with reduced TV-L1 effort (3 warps, 5
    iterations per warp)."""
    base = production_config()
    return dataclasses.replace(
        base, tvl1=dataclasses.replace(base.tvl1, warps=3, iters=5)
    )


# The named serving configurations of the JAX package's benchmark
# (``bench.py:PRESETS``), with the same keys and values. ``turbo`` is
# ``production_fast_config()`` served in bfloat16 with both VGG streams in
# int8 (calibrated at the 99.9th percentile of |x|, bf16 conv1_1 stem).
PRESETS = {
    "turbo": dict(dtype="bfloat16", flow_scale=0.5, tvl1_warps=3,
                  tvl1_iters=5, quant=True, quant_percentile=99.9,
                  quant_stem="bf16", decoder="deconv"),
    "production": dict(dtype="bfloat16", flow_scale=0.5, tvl1_warps=None,
                       tvl1_iters=None, quant=False,
                       quant_percentile=None, quant_stem="int8",
                       decoder="deconv"),
    "parity": dict(dtype="float32", flow_scale=1.0, tvl1_warps=None,
                   tvl1_iters=None, quant=False, quant_percentile=None,
                   quant_stem="int8", decoder="deconv"),
}


def preset_config(name: str, base: PipelineConfig | None = None) -> PipelineConfig:
    """``base`` (default ``PipelineConfig()``) with the TV-L1 settings of
    ``PRESETS[name]``: its flow scale, and its warps and iterations where
    the preset sets them."""
    p = PRESETS[name]
    base = base or PipelineConfig()
    tv = dataclasses.replace(base.tvl1, flow_scale=p["flow_scale"])
    if p["tvl1_warps"] is not None:
        tv = dataclasses.replace(tv, warps=p["tvl1_warps"])
    if p["tvl1_iters"] is not None:
        tv = dataclasses.replace(tv, iters=p["tvl1_iters"])
    return dataclasses.replace(base, tvl1=tv)
