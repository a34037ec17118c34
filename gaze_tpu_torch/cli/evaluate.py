"""``--eval``: the whole pipeline scored per video, AAE and AUC.

Counterpart of ``gaze_tpu/cli.py:885-1009``. By default the sequential
rollout (``evaluation/rollout.py``): the LSTM state carried across each
video, gated on fixation onsets, AT pooled at the SP argmax, the
reference's evaluation semantics. On the synthetic corpus that is four
held-out videos (seeds 1000+i) of ``T = max(32, batch_size, 40 k if k >
1)`` frames for the ``k``-blob corpus, scored by summing over every
frame; on a GTEA tree (``--data_root``) the held-out subject's videos
through ``rollout_eval_videos``, scored by the mean of the per-video
means. ``--eval_teacher_forced`` is the stateless diagnostic instead:
AT pooled at the ground-truth gaze, one step per frame, untracked frames
left out. ``--eval_map`` picks the map that is scored. With a data
``mesh`` the rollouts split their videos over the ranks.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from gaze_tpu_torch.cli.args import stage_options
from gaze_tpu_torch.core.config import PipelineConfig
from gaze_tpu_torch.data.gtea import pair_batches
from gaze_tpu_torch.data.synthetic import generate_sequence
from gaze_tpu_torch.evaluation.rollout import rollout_eval_arrays, rollout_eval_videos
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.train.lf import make_lf_eval_step
from gaze_tpu_torch.train.stages import _batches, _flow_mode, _gtea_split, _synth_spec

SYNTHETIC_EVAL_VIDEOS = 4


def run_eval(args, cfg: PipelineConfig, pipeline: GazePipeline, lf_state,
             mesh=None) -> Dict[str, float]:
    """Score the pipeline's weights (``lf_state.module`` is its LF head);
    prints a line per GTEA video and the result, and returns
    ``{"AAE_deg", "AUC"}``."""
    if not args.eval_teacher_forced:
        return _run_eval_rollout(args, cfg, pipeline, mesh)
    opts = stage_options(args)
    frozen = {"sp": pipeline.sp.state_dict(), "at": pipeline.lstm.state_dict()}
    eval_fn = make_lf_eval_step(pipeline, frozen, score_key=args.eval_map)

    def eval_batches(batches) -> Tuple[float, float]:
        aaes, aucs = [], []
        for batch in batches:
            m = eval_fn(lf_state, batch)
            # untracked frames have no ground truth: left out
            keep = np.asarray(batch["valid"]) > 0 if "valid" in batch else slice(None)
            aaes.append(m["aae"].cpu().numpy()[keep])
            aucs.append(m["auc"].cpu().numpy()[keep])
        if not aaes or not len(np.concatenate(aaes)):
            return float("nan"), float("nan")
        return float(np.concatenate(aaes).mean()), float(np.concatenate(aucs).mean())

    if args.data_root:
        _, test_recs = _gtea_split(opts, cfg)
        per_video = {}
        for v in sorted({r.video for r in test_recs}):
            aae_v, auc_v = eval_batches(pair_batches(
                [r for r in test_recs if r.video == v], args.batch_size,
                (cfg.image.height, cfg.image.width), shuffle=False, drop_remainder=False,
                use_precomputed_flow=_flow_mode(opts)))
            per_video[v] = (aae_v, auc_v)
            print({"video": v, "AAE_deg": round(aae_v, 3), "AUC": round(auc_v, 4)})
        aae = float(np.mean([a for a, _ in per_video.values()]))
        auc = float(np.mean([c for _, c in per_video.values()]))
    else:
        aae, auc = eval_batches(_batches(opts, cfg, train=False))
    result = {"AAE_deg": aae, "AUC": auc}
    print(result)
    return result


def synthetic_eval_corpus(args, cfg: PipelineConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The held-out synthetic videos of the rollout: (frames, gaze,
    fixsac) stacked over seeds 1000, 1001, ..."""
    k = args.synthetic_blobs
    T = max(32, args.batch_size, 40 * k if k > 1 else 0)
    opts = stage_options(args)
    seqs = [generate_sequence(_synth_spec(opts, cfg, 1000 + i, num_frames=T))
            for i in range(SYNTHETIC_EVAL_VIDEOS)]
    return tuple(np.stack(x) for x in zip(*seqs))


def _run_eval_rollout(args, cfg: PipelineConfig, pipeline: GazePipeline,
                      mesh=None) -> Dict[str, float]:
    if args.data_root:
        opts = stage_options(args)
        _, test_recs = _gtea_split(opts, cfg)
        vids: Dict[str, List] = {}
        for r in test_recs:
            vids.setdefault(r.video, []).append(r)
        results = rollout_eval_videos(pipeline, vids, use_precomputed_flow=_flow_mode(opts),
                                      mesh=mesh, score_key=args.eval_map)
        per_video = {}
        for v in sorted(results):
            aae_v, auc_v, n = results[v]
            per_video[v] = (aae_v, auc_v)
            print({"video": v, "AAE_deg": round(aae_v, 3), "AUC": round(auc_v, 4),
                   "frames": n})
        aae = float(np.mean([a for a, _ in per_video.values()]))
        auc = float(np.mean([c for _, c in per_video.values()]))
    else:
        frames, gaze, fixsac = synthetic_eval_corpus(args, cfg)
        aae_s, auc_s, cnt = rollout_eval_arrays(pipeline, frames, gaze, fixsac, mesh=mesh,
                                                score_key=args.eval_map)
        aae = float(aae_s.sum() / cnt.sum())
        auc = float(auc_s.sum() / cnt.sum())
    result = {"AAE_deg": aae, "AUC": auc}
    print(result)
    return result
