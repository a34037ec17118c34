"""The per-frame gaze step: flow -> SP -> AT -> LF -> argmax, on the card.

Counterpart of ``gaze_tpu/models/pipeline.py`` (``GazePipeline.step``
and ``make_clip_fn``) with the deconv decoder. Per frame:

    uint8 frame pair -> resize, normalize, BT.601 gray
    -> TV-L1 flow (kernels K1, K2), at the model grid or at
       ``tvl1.flow_scale`` of it and upsampled -> 8-bit-clipped input
    -> SP two streams (float, or int8 through kernel K3 with ``quant_sp``)
    -> saliency S_t, conv5 F_t
    -> pool F_t at argmax(S_t) -> LSTM step, kept only at a fixation onset
    -> attention map from the predicted channel weights
    -> LF(S_t, A_t) -> heatmap -> argmax gaze

The presets (``core/config.py:PRESETS``): parity is float32 at the full
flow grid; production is bfloat16 activations with half-grid flow;
turbo adds reduced TV-L1 effort and int8 VGG streams
(``models/quant.py``). The weights live in the modules (``sp``, ``lstm``,
``lf``); the JAX package's ``variables`` load through
``models/weights.py``. ``sp_forward_train`` and ``forward_step`` serve
the training stages (``train/``). The JAX pipeline's inference options
are ported:
a precomputed flow image in place of the TV-L1 solve (``flow_img``), AT
pooling at the previous prediction (``at_pool="prediction"``) and the
polyphase or half-resolution decoder (``decoder_impl``,
``models/decode_fast.py``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from gaze_tpu_torch.core.config import PipelineConfig
from gaze_tpu_torch.core.device import resolve_device, set_parity_precision
from gaze_tpu_torch.models import decode_fast
from gaze_tpu_torch.models.at import LSTMNet, attention_map, fixation_pool
from gaze_tpu_torch.models.lf import LateFusion
from gaze_tpu_torch.models.quant import CONV_IMPLS, QuantSP, quant_taps, quant_vgg_forward
from gaze_tpu_torch.models.quant_tail import quant_tail_forward, tail_taps
from gaze_tpu_torch.models.sp import SPNet
from gaze_tpu_torch.models.weights import StateDict, init_weights, load_state
from gaze_tpu_torch.ops.heatmap import heatmap_argmax
from gaze_tpu_torch.ops.image import resize_bilinear
from gaze_tpu_torch.ops.preprocess import (
    normalize_flow_image,
    normalize_rgb,
    prepare_temporal_input,
    resize_frames,
    resize_nchw,
    rgb_to_gray,
    to_float,
)
from gaze_tpu_torch.ops.tvl1 import tvl1_flow


class StreamState(NamedTuple):
    """Per-stream recurrent state carried across frames."""

    carries: List[Tuple[torch.Tensor, torch.Tensor]]  # LSTM (c, h) per layer
    w_hat: torch.Tensor      # (B, C) last predicted channel weights
    prev_fix: torch.Tensor   # (B,) previous frame's fixation bit
    prev_gaze: torch.Tensor  # (B, 2) previous frame's predicted gaze


class GazePipeline:
    """SP, AT and LF modules plus config, on one device.

    Args:
      config: the pipeline config (``parity_config()``,
        ``production_config()``, ``production_fast_config()``, or
        ``preset_config(name)``).
      dtype: activation type: float32 (parity) or bfloat16 (production,
        turbo). Parameters stay float32.
      device: ``None`` means ``cuda`` and raises when CUDA is absent;
        ``"cpu"`` runs every op, kernels included, as plain PyTorch.
      seed: seed of the ``torch.Generator`` the weights are drawn from
        (``models/weights.py:init_weights``); replace them with
        :meth:`load_state_dicts`.
      quant_sp: a ``models.quant.QuantSP`` (from ``calibrate_pipeline_sp``
        or ``models/quant_io.py:load_quant_sp``): both VGG streams run
        int8, the fuse/decoder tail in ``dtype``, or int8 too when the
        bundle holds a ``tail``.
      quant_conv: the JAX pipeline's int8 conv choice, "xla" or
        "pallas"; both run through kernel K3 on the card.
      at_pool: where AT pools its channel weights when no teacher gaze
        is given: "sp_argmax" (the current frame's saliency argmax, the
        parity path) or "prediction" (the previous frame's final gaze,
        ``StreamState.prev_gaze``: the model tracks its own estimate).
      decoder_impl: the SP decoder tail: "deconv" (canonical),
        "pixelshuffle" (exact polyphase form) or "halfres" (the last
        block at half resolution, interleaved up); the last two fold
        BatchNorm and serve inference only (``models/decode_fast.py``).
    """

    def __init__(
        self,
        config: PipelineConfig,
        dtype: torch.dtype = torch.float32,
        device=None,
        seed: int = 0,
        at_pool: str = "sp_argmax",
        decoder_impl: str = "deconv",
        quant_sp: QuantSP | None = None,
        quant_conv: str = "xla",
    ):
        if at_pool not in ("sp_argmax", "prediction"):
            raise ValueError(f"unknown at_pool {at_pool!r}")
        if decoder_impl not in ("deconv", "pixelshuffle", "halfres"):
            raise ValueError(f"unknown decoder_impl {decoder_impl!r}")
        if quant_conv not in CONV_IMPLS:
            raise ValueError(f"unknown quant_conv {quant_conv!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported dtype {dtype}")
        if quant_sp is not None and not isinstance(quant_sp, QuantSP):
            raise TypeError(f"quant_sp must be a models.quant.QuantSP, got {type(quant_sp)}")
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_parity_precision()
        gen = torch.Generator().manual_seed(seed)
        self.sp = SPNet(config.sp, dtype)
        self.lstm = LSTMNet(config.at, dtype)
        self.lf = LateFusion(config.lf, dtype)
        for m in self.modules().values():
            init_weights(m, gen)
            m.to(self.device).eval()
        self.at_pool = at_pool
        self.decoder_impl = decoder_impl
        self.quant_conv = quant_conv
        self.quant_sp = None if quant_sp is None else quant_sp.to(self.device)
        self._taps = None if quant_sp is None else {
            "spatial": quant_taps(self.quant_sp.spatial),
            "temporal": quant_taps(self.quant_sp.temporal),
        }
        if quant_sp is not None and quant_sp.tail is not None:
            self._taps["tail"] = tail_taps(self.quant_sp.tail)

    # ------------------------------------------------------- weights ----
    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"sp": self.sp, "at": self.lstm, "lf": self.lf}

    def load_state_dicts(self, bundle: Dict[str, StateDict]) -> None:
        """Load ``{"sp", "at", "lf"}`` state dicts: the weight bridge's
        output, an ``export_pipeline_to_torch`` file, or another
        pipeline's :meth:`state_dicts`."""
        for name, m in self.modules().items():
            load_state(m, bundle[name])

    def state_dicts(self) -> Dict[str, StateDict]:
        return {name: m.state_dict() for name, m in self.modules().items()}

    # ---------------------------------------------------------- state ----
    def init_state(self, batch: int) -> StreamState:
        cfg = self.config
        center = torch.tensor(
            [(cfg.image.width - 1) / 2.0, (cfg.image.height - 1) / 2.0],
            dtype=torch.float32, device=self.device,
        )
        return StreamState(
            carries=self.lstm.init_carry(batch, self.device),
            w_hat=torch.ones((batch, cfg.at.feature_dim), dtype=torch.float32, device=self.device),
            prev_fix=torch.zeros((batch,), device=self.device),
            prev_gaze=center.expand(batch, 2).clone(),
        )

    # ------------------------------------------------------- preproc ----
    def preprocess_pair(
        self, prev_u8: torch.Tensor, cur_u8: torch.Tensor, flow_img=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8 (B, H, W, 3) frame pair -> (normalized rgb, normalized
        flow input), both NHWC at the model grid in ``dtype``. The frames
        are resized before the TV-L1 solve. With ``tvl1.flow_scale`` below
        1 the gray frames are resized (antialiased) to that fraction of
        the grid, solved there, and the flow is upsampled bilinearly and
        its displacements scaled by 1 / flow_scale.

        ``flow_img``: optional (B, h, w, 2) uint8 precomputed flow images
        (the dense_flow input). The TV-L1 solve is skipped and the flow is
        treated as an image: resized bilinearly as pixels (antialiased
        when it shrinks; the values are not rescaled), then normalized."""
        cfg = self.config
        H, W = cfg.image.height, cfg.image.width
        cur = resize_frames(to_float(cur_u8), H, W)
        if flow_img is not None:
            flow_in = normalize_flow_image(resize_frames(to_float(flow_img), H, W))
            return normalize_rgb(cur, cfg.image).to(self.dtype), flow_in.to(self.dtype)
        prev = resize_frames(to_float(prev_u8), H, W)
        g0, g1 = rgb_to_gray(prev), rgb_to_gray(cur)
        s = cfg.tvl1.flow_scale
        # The flow is a constant of the model: no gradient flows through
        # the solve (jax.lax.stop_gradient in the JAX pipeline), and the
        # kernels, which have no backward, never see a tensor that
        # requires one.
        with torch.no_grad():
            if s != 1.0:
                fhw = (int(round(H * s)), int(round(W * s)))
                flow_lo = tvl1_flow(resize_bilinear(g0, fhw), resize_bilinear(g1, fhw),
                                    cfg.tvl1, device=self.device)
                flow = resize_nchw(flow_lo.permute(0, 3, 1, 2), (H, W)).permute(0, 2, 3, 1)
                flow = flow * (1.0 / s)
            else:
                flow = tvl1_flow(g0, g1, cfg.tvl1, device=self.device)
        flow_in = prepare_temporal_input(flow, cfg.tvl1.quant_bound)
        return normalize_rgb(cur, cfg.image).to(self.dtype), flow_in.to(self.dtype)

    def sp_forward(
        self, rgb_in: torch.Tensor, flow_in: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(saliency (B, H, W), spatial conv5 (B, h, w, C)), both float32.
        With ``quant_sp`` the two streams run int8 and their float32
        features go through the fuse/decoder tail in ``dtype``; the tail
        is ``decoder_impl``'s, or, when ``quant_sp.tail`` is set, the int8
        tail (``models/quant_tail.py``) whatever ``decoder_impl`` is."""
        if self.quant_sp is not None:
            feat = quant_vgg_forward(self.quant_sp.spatial, rgb_in, self.quant_conv,
                                     self._taps["spatial"])
            f_temporal = quant_vgg_forward(self.quant_sp.temporal, flow_in, self.quant_conv,
                                           self._taps["temporal"])
            if self.quant_sp.tail is not None:
                sal = quant_tail_forward(self.quant_sp.tail, feat, f_temporal,
                                         self._taps["tail"])
                return sal, feat
        elif self.decoder_impl == "deconv":
            return self.sp(rgb_in, flow_in)
        else:
            feat, f_temporal = self.sp.encode(rgb_in, flow_in)
            feat = feat.float()
        dt = self.dtype
        if self.decoder_impl == "pixelshuffle":
            sal = decode_fast.fast_fuse_decode(self.sp, feat.to(dt), f_temporal.to(dt), dt)
        elif self.decoder_impl == "halfres":
            sal = decode_fast.halfres_fuse_decode(self.sp, feat.to(dt), f_temporal.to(dt), dt)
        else:
            sal = self.sp.fuse_decode(feat.to(dt), f_temporal.to(dt))
        return sal, feat

    def sp_forward_train(
        self, rgb_in: torch.Tensor, flow_in: torch.Tensor, mesh=None
    ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """The training forward of the float SP with the deconv decoder:
        train-mode BatchNorm (over the global batch under a data
        ``mesh``), ``config.sp.remat`` applied. Returns (saliency, spatial
        conv5, new BatchNorm running statistics); the module's statistics
        are not updated (``SPNet.forward_train``)."""
        if self.quant_sp is not None or self.decoder_impl != "deconv":
            raise ValueError("training runs the float SP with the deconv decoder")
        return self.sp.forward_train(rgb_in, flow_in, mesh)

    # ---------------------------------------------------------- step ----
    def attend(
        self,
        state: StreamState,
        sal: torch.Tensor,
        feat: torch.Tensor,
        fixation: torch.Tensor,
        gaze_xy: torch.Tensor | None = None,
    ) -> Tuple[StreamState, Dict[str, torch.Tensor]]:
        """The AT + LF part of :meth:`step`, from SP's outputs on."""
        cfg = self.config
        if gaze_xy is not None:
            pool_pt = gaze_xy
        elif self.at_pool == "prediction":
            pool_pt = state.prev_gaze
        else:
            pool_pt = heatmap_argmax(sal)
        w = fixation_pool(feat, pool_pt, cfg.at)
        new_carries, w_pred = self.lstm.step(state.carries, w)
        # The AT LSTM steps once per fixation ONSET, not on every frame
        # of a fixation; prev_fix takes the current bit either way.
        onset = fixation * (1.0 - state.prev_fix)
        m = onset.reshape(-1, 1) != 0
        carries = [
            (torch.where(m, nc, oc), torch.where(m, nh, oh))
            for (nc, nh), (oc, oh) in zip(new_carries, state.carries)
        ]
        w_hat = torch.where(m, w_pred, state.w_hat)
        amap = attention_map(feat, w_hat, (cfg.image.height, cfg.image.width))
        final = self.lf(torch.stack([sal, amap], dim=-1))
        gaze = heatmap_argmax(final)
        out = {"saliency": sal, "attention": amap, "heatmap": final, "gaze": gaze}
        return StreamState(carries, w_hat, fixation, gaze), out

    @torch.inference_mode()
    def step(
        self,
        state: StreamState,
        prev_u8,
        cur_u8,
        fixation,
        gaze_xy=None,
        flow_img=None,
    ) -> Tuple[StreamState, Dict[str, torch.Tensor]]:
        """:meth:`forward_step` under ``torch.inference_mode``: the
        serving and evaluation step."""
        return self.forward_step(state, prev_u8, cur_u8, fixation, gaze_xy, flow_img)

    def forward_step(
        self,
        state: StreamState,
        prev_u8,
        cur_u8,
        fixation,
        gaze_xy=None,
        flow_img=None,
    ) -> Tuple[StreamState, Dict[str, torch.Tensor]]:
        """One per-frame step over B independent streams, in the caller's
        autograd mode. :meth:`step` runs it under inference mode, whose
        tensors autograd refuses to save; a training step that feeds the
        outputs to a module it trains runs this under ``torch.no_grad()``.

        Args:
          state: recurrent StreamState.
          prev_u8, cur_u8: (B, H, W, 3) uint8 frames (moved to the device).
          fixation: (B,) 1.0 where frame t is a fixation.
          gaze_xy: optional (B, 2) teacher gaze to pool at instead of the
            saliency argmax.
          flow_img: optional (B, h, w, 2) uint8 precomputed flow image in
            place of the TV-L1 solve (see :meth:`preprocess_pair`).

        Returns:
          (new_state, outputs): saliency, attention and final heatmaps
          (B, H, W) and the decoded gaze (B, 2).
        """
        dev = self.device
        fixation = torch.as_tensor(fixation, dtype=torch.float32, device=dev)
        if gaze_xy is not None:
            gaze_xy = torch.as_tensor(gaze_xy, dtype=torch.float32, device=dev)
        if flow_img is not None:
            flow_img = torch.as_tensor(flow_img, device=dev)
        rgb_in, flow_in = self.preprocess_pair(
            torch.as_tensor(prev_u8, device=dev), torch.as_tensor(cur_u8, device=dev), flow_img
        )
        sal, feat = self.sp_forward(rgb_in, flow_in)
        return self.attend(state, sal, feat, fixation, gaze_xy)


@torch.inference_mode()
def run_clip(
    pipeline: GazePipeline, frames_u8, fixsac
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T+1, H, W, 3) uint8 frames, (B, T+1) fixation bits ->
    (heatmaps (B, T, H, W), gaze (B, T, 2)) on the pipeline's device.

    The counterpart of ``make_clip_fn``: B streams advance in lockstep
    from a fresh state; step t consumes frames t and t+1 and the
    fixation bit of frame t+1. The frames move to the device once and
    every intermediate stays there.
    """
    dev = pipeline.device
    frames = torch.as_tensor(frames_u8, device=dev)
    fix = torch.as_tensor(fixsac, dtype=torch.float32, device=dev)
    state = pipeline.init_state(frames.shape[0])
    heatmaps, gaze = [], []
    for t in range(frames.shape[1] - 1):
        state, out = pipeline.step(state, frames[:, t], frames[:, t + 1], fix[:, t + 1])
        heatmaps.append(out["heatmap"])
        gaze.append(out["gaze"])
    return torch.stack(heatmaps, dim=1), torch.stack(gaze, dim=1)
