"""AT stage training: the attention-transition LSTM regresses the next
fixation's channel-weight vector (masked MSE) over per-video fixation
sequences.

Counterpart of ``gaze_tpu/train/at.py``. The state's module is the
pipeline's LSTM (``pipeline.lstm``), trained in place. Two batchings:

- stateful windows (default, truncated BPTT): each video's sequence is
  cut into fixed-length windows whose LSTM carry is chained across
  windows (detached at the boundary) and reset at each video's start
  (``build_tbptt_schedule``, ``make_at_tbptt_step``,
  ``make_at_stateful_eval``);
- stateless zero-carry windows (``build_weight_sequences``,
  ``make_at_train_step``, ``make_at_eval_step``), kept for ablation.

The numpy schedule builders are the JAX package's, copied line for line
(the port imports nothing of it), so one corpus gives the same windows
in both packages. Under a data ``mesh`` each rank feeds its rows
(windows, or lanes with their carries) of the global batch, and the
masked MSE divides by the global mask count.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.models.weights import init_weights
from gaze_tpu_torch.core.distributed import all_reduce_sum_
from gaze_tpu_torch.train.common import (
    TrainState,
    dp_reduce,
    jit_dp_step,
    make_optimizer,
    make_state,
    to_device,
)


def create_at_state(pipeline: GazePipeline, seed: Optional[int] = None) -> TrainState:
    """The AT stage's state: ``pipeline.lstm`` drawn anew from
    ``torch.Generator(seed)`` (default ``train.seed``), a fresh AdamW."""
    cfg = pipeline.config
    init_weights(pipeline.lstm, torch.Generator().manual_seed(
        cfg.train.seed if seed is None else seed))
    return make_state(pipeline.lstm, make_optimizer(cfg.train))


def _masked_mse(pred: torch.Tensor, target: torch.Tensor, m: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """sum((pred - target)^2 * m) / (sum(m) * C + 1e-8), m broadcast over C;
    under a ``mesh`` the rank's share: its sum over the global
    denominator (the all-reduced mask count)."""
    err = (pred - target) ** 2 * m
    return torch.sum(err) / (all_reduce_sum_(torch.sum(m), mesh) * pred.shape[-1] + 1e-8)


def make_at_train_step(pipeline: GazePipeline, mesh=None):
    """Stateless windows: ``batch`` = {"weights" (B, T, C), "mask" (B, T)};
    the LSTM from zero carries predicts w[1:] from w[:-1]. With a
    ``mesh``, this rank's rows of the global batch."""
    lstm = pipeline.lstm

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        batch = to_device(batch, pipeline.device)
        ws, mask = batch["weights"], batch["mask"]
        m = (mask[:, :-1] * mask[:, 1:])[..., None]
        loss = _masked_mse(lstm(ws[:, :-1]), ws[:, 1:], m, mesh)
        loss, grads = dp_reduce(loss, torch.autograd.grad(loss, state.params), mesh)
        state.apply_gradients(grads)
        return state, {"loss": loss.detach()}

    return jit_dp_step(step, mesh)


def make_at_eval_step(pipeline: GazePipeline):
    """``eval_mse(lstm, seqs (N, T, C), mask (N, T)) -> scalar``: the
    masked next-weight MSE of zero-carry windows (the stateless mode's
    validation)."""

    @torch.no_grad()
    def eval_mse(lstm, seqs, mask) -> torch.Tensor:
        seqs = torch.as_tensor(seqs, device=pipeline.device)
        mask = torch.as_tensor(mask, device=pipeline.device)
        m = (mask[:, :-1] * mask[:, 1:])[..., None]
        return _masked_mse(lstm(seqs[:, :-1]), seqs[:, 1:], m)

    return eval_mse


def _carries(batch: Dict[str, torch.Tensor], num_layers: int):
    """The (c, h) carries of a TBPTT batch, zeroed on reset lanes."""
    keep = (1.0 - batch["reset"]).reshape(-1, 1, 1)
    cc = batch["carry_c"] * keep
    ch = batch["carry_h"] * keep
    return [(cc[:, i], ch[:, i]) for i in range(num_layers)]


def make_at_stateful_eval(pipeline: GazePipeline):
    """Stateful (TBPTT-matched) validation: ``evaluate(lstm, schedule) ->
    float``, the masked mean MSE over a :func:`build_tbptt_schedule`'s
    windows with the carry threaded across each lane's windows as in
    training (NaN on an empty schedule). One scalar leaves the device."""
    L = pipeline.config.at.num_layers
    H = pipeline.config.at.hidden_size

    @torch.no_grad()
    def evaluate(lstm, schedule: List[Dict[str, np.ndarray]]) -> float:
        if not schedule:
            return float("nan")
        dev = pipeline.device
        lanes = schedule[0]["inputs"].shape[0]
        cc = torch.zeros((lanes, L, H), device=dev)
        ch = torch.zeros((lanes, L, H), device=dev)
        tot = torch.zeros((), device=dev)
        cnt = torch.zeros((), device=dev)
        for sched in schedule:
            b = to_device(sched, dev)
            b["carry_c"], b["carry_h"] = cc, ch
            new, pred = lstm.rollout(_carries(b, L), b["inputs"])
            tot = tot + torch.sum((pred - b["targets"]) ** 2 * b["mask"][..., None])
            cnt = cnt + torch.sum(b["mask"]) * pred.shape[-1]
            cc = torch.stack([c for c, _ in new], dim=1)
            ch = torch.stack([h for _, h in new], dim=1)
        return float(tot) / max(float(cnt), 1e-8)

    return evaluate


def split_at_validation(
    video_w: List[np.ndarray], holdout_frac: float = 0.1
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Deterministic train/val split of per-video fixation sequences.

    Multi-video corpora hold out the trailing ``max(1, N*frac)`` videos
    (order is the caller's sorted-by-name order, so the split is stable
    across runs). A single-video corpus holds out the trailing 20% of
    its fixations (both sides keeping >=2 so each yields a pair); below
    6 fixations the whole sequence doubles as validation — degenerate
    but still a monotone signal for best-tracking on tiny smoke runs.
    """
    if len(video_w) >= 2:
        n_val = max(1, int(len(video_w) * holdout_frac))
        return video_w[:-n_val], video_w[-n_val:]
    w = video_w[0]
    if len(w) >= 6:
        k = min(len(w) - 2, max(2, int(0.8 * len(w))))
        return [w[:k]], [w[k:]]
    return [w], [w]


def build_at_validation_windows(
    val_w: List[np.ndarray], seq_len: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack validation sequences into (N, seq_len, C) windows + mask
    for :func:`make_at_eval_step`."""
    seqs, masks = [], []
    for w in val_w:
        s, m = build_weight_sequences(
            w, np.ones((len(w),), np.float32), seq_len, per_fixation=False
        )
        if len(s):
            seqs.append(s)
            masks.append(m)
    if not seqs:
        dim = val_w[0].shape[-1] if val_w else 0
        return (np.zeros((0, seq_len, dim), np.float32),
                np.zeros((0, seq_len), np.float32))
    return np.concatenate(seqs), np.concatenate(masks)


def fixation_onset_weights(weights: np.ndarray, fixsac: np.ndarray) -> np.ndarray:
    """Per-fixation weight vectors: one per run of fixsac==1 (its first
    frame — the reference operates per fixation, not per frame [M])."""
    starts = [
        i for i in range(len(fixsac)) if fixsac[i] > 0 and (i == 0 or fixsac[i - 1] == 0)
    ]
    if not starts:
        return np.zeros((0, weights.shape[-1]), np.float32)
    return weights[starts].astype(np.float32)


def build_tbptt_schedule(
    video_weights: List[np.ndarray], seq_len: int, lanes: int
) -> List[Dict[str, np.ndarray]]:
    """Pack per-video fixation-weight sequences into a TBPTT schedule.

    Each video's sequence w_0..w_{K-1} becomes (input=w[:-1],
    target=w[1:]) split into consecutive ``seq_len`` windows. Videos are
    packed greedily into ``lanes`` parallel lanes (longest first, onto
    the shortest lane); a lane runs its videos back to back, raising
    ``reset`` on each video's first window so the train step zeroes that
    lane's carry.

    Returns a list of per-step dicts — iterate IN ORDER, threading the
    carry returned by :func:`make_at_tbptt_step`:
      inputs  (lanes, seq_len, C)
      targets (lanes, seq_len, C)
      mask    (lanes, seq_len)   1.0 on real (input, target) pairs
      reset   (lanes,)           1.0 where the lane starts a new video
    """
    per_video: List[List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = []
    dim = None
    for w in video_weights:
        if len(w) < 2:
            continue
        dim = w.shape[-1]
        inp, tgt = w[:-1], w[1:]
        wins = []
        for s in range(0, len(inp), seq_len):
            ci, ct = inp[s : s + seq_len], tgt[s : s + seq_len]
            pad = seq_len - len(ci)
            m = np.concatenate([np.ones(len(ci)), np.zeros(pad)]).astype(np.float32)
            if pad:
                z = np.zeros((pad, dim), np.float32)
                ci = np.concatenate([ci, z])
                ct = np.concatenate([ct, z])
            wins.append((ci.astype(np.float32), ct.astype(np.float32), m))
        per_video.append(wins)
    if not per_video:
        return []

    lane_wins: List[List[Tuple[Tuple, bool]]] = [[] for _ in range(lanes)]
    for wins in sorted(per_video, key=len, reverse=True):
        lane = min(lane_wins, key=len)
        lane.extend((w, j == 0) for j, w in enumerate(wins))

    steps = []
    for k in range(max(len(l) for l in lane_wins)):
        inputs = np.zeros((lanes, seq_len, dim), np.float32)
        targets = np.zeros((lanes, seq_len, dim), np.float32)
        mask = np.zeros((lanes, seq_len), np.float32)
        reset = np.zeros((lanes,), np.float32)
        for li, lane in enumerate(lane_wins):
            if k < len(lane):
                (ci, ct, m), is_start = lane[k]
                inputs[li], targets[li], mask[li] = ci, ct, m
                reset[li] = float(is_start)
        steps.append(
            {"inputs": inputs, "targets": targets, "mask": mask, "reset": reset}
        )
    return steps


def make_at_tbptt_step(pipeline: GazePipeline, mesh=None):
    """Stateful-window step: ``batch`` = a :func:`build_tbptt_schedule`
    entry plus ``carry_c``/``carry_h`` (B, num_layers, hidden), the
    previous window's final carries (zeros first). ``reset`` zeroes a
    lane's carry at a video start. The metrics return the new carries,
    detached (truncated BPTT). With a ``mesh``, this rank's lanes of the
    global batch, and their carries."""
    L = pipeline.config.at.num_layers
    lstm = pipeline.lstm

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        batch = to_device(batch, pipeline.device)
        mask = batch["mask"]
        new, pred = lstm.rollout(_carries(batch, L), batch["inputs"])
        loss = _masked_mse(pred, batch["targets"], mask[..., None], mesh)
        loss, grads = dp_reduce(loss, torch.autograd.grad(loss, state.params), mesh)
        state.apply_gradients(grads)
        return state, {
            "loss": loss.detach(),
            "carry_c": torch.stack([c for c, _ in new], dim=1).detach(),
            "carry_h": torch.stack([h for _, h in new], dim=1).detach(),
        }

    return jit_dp_step(step, mesh)


def build_weight_sequences(
    weights: np.ndarray,
    fixsac: np.ndarray,
    seq_len: int,
    per_fixation: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Group per-frame weight vectors into per-fixation sequences.

    One weight vector per fixation *segment* (first frame of each run of
    fixsac==1 — the reference operates per fixation, not per frame [M]),
    windowed into (N, seq_len, C) with a (N, seq_len) validity mask.
    With ``per_fixation=False`` the weights are taken as an
    already-extracted fixation sequence and only windowed.
    """
    if per_fixation:
        fix_w = fixation_onset_weights(weights, fixsac)
    else:
        fix_w = np.asarray(weights, np.float32)
    n = len(fix_w)
    if n < 2:
        return (
            np.zeros((0, seq_len, weights.shape[-1]), np.float32),
            np.zeros((0, seq_len), np.float32),
        )
    seqs, masks = [], []
    for s in range(0, n, seq_len):
        chunk = fix_w[s : s + seq_len]
        pad = seq_len - len(chunk)
        m = np.concatenate([np.ones(len(chunk)), np.zeros(pad)]).astype(np.float32)
        if pad:
            chunk = np.concatenate([chunk, np.zeros((pad, chunk.shape[-1]), chunk.dtype)])
        if m.sum() >= 2:  # need at least one (w_t, w_{t+1}) pair
            seqs.append(chunk)
            masks.append(m)
    if not seqs:
        return (
            np.zeros((0, seq_len, weights.shape[-1]), np.float32),
            np.zeros((0, seq_len), np.float32),
        )
    return np.stack(seqs).astype(np.float32), np.stack(masks)
