"""``--extract_late`` and ``--extract_flow``: the reference's on-disk stages.

Counterpart of ``gaze_tpu/cli.py:808-882``:

- ``run_extract_late`` writes the frozen SP saliency and teacher-forced
  AT attention maps of every video to ``<save_dir>/maps/<video>.npz``
  (``saliency``, ``attention`` float16 and ``index``), every subject's
  videos of a GTEA tree or the held-out synthetic sequence as
  ``synthetic``, through ``train/lf.py:make_map_extract_step``. The
  in-memory LF stage never reads them; they are the files the
  reference's workflow expects.
- ``run_extract_flow`` is the offline dense_flow pass: TV-L1 on the card
  over every consecutive frame pair of ``<data_root>/images/``, written
  as 8-bit flow images (``data/flow_extract.py``).
"""

from __future__ import annotations

import os

import numpy as np

from gaze_tpu_torch.cli.args import stage_options
from gaze_tpu_torch.core.config import PipelineConfig
from gaze_tpu_torch.data.flow_extract import FlowExtractSpec, extract_flow_images
from gaze_tpu_torch.data.gtea import pair_batches
from gaze_tpu_torch.models.pipeline import GazePipeline
from gaze_tpu_torch.train.lf import make_map_extract_step
from gaze_tpu_torch.train.stages import _batches, _flow_mode, _gtea_split


def run_extract_late(args, cfg: PipelineConfig, pipeline: GazePipeline) -> None:
    opts = stage_options(args)
    step = make_map_extract_step(pipeline, {"sp": pipeline.sp.state_dict(),
                                            "at": pipeline.lstm.state_dict()})
    out_dir = os.path.join(args.save_dir, "maps")
    os.makedirs(out_dir, exist_ok=True)

    def dump(video: str, batches) -> None:
        sal, amap, idx = [], [], []
        for batch in batches:
            m = step({k: v for k, v in batch.items() if k != "index"})
            sal.append(m["saliency"].cpu().numpy().astype(np.float16))
            amap.append(m["attention"].cpu().numpy().astype(np.float16))
            idx.append(np.asarray(batch.get("index", np.arange(len(sal[-1])))))
        if not sal:
            return
        path = os.path.join(out_dir, f"{video}.npz")
        np.savez_compressed(path, saliency=np.concatenate(sal),
                            attention=np.concatenate(amap), index=np.concatenate(idx))
        print({"extracted": video, "frames": sum(len(s) for s in sal), "path": path})

    if args.data_root:
        train_recs, test_recs = _gtea_split(opts, cfg)
        all_recs = train_recs + test_recs   # the reference extracts every frame
        for v in sorted({r.video for r in all_recs}):
            dump(v, pair_batches([r for r in all_recs if r.video == v], args.batch_size,
                                 (cfg.image.height, cfg.image.width), shuffle=False,
                                 drop_remainder=False, use_precomputed_flow=_flow_mode(opts)))
    else:
        dump("synthetic", _batches(opts, cfg, train=False))


def run_extract_flow(args, cfg: PipelineConfig, device=None) -> int:
    """Flow images of every video under ``--data_root`` (to ``--flow_out``,
    default ``<data_root>/flows``), clipped at ``--flow_bound`` (default
    the config's ``tvl1.quant_bound``, the grid the consumers expect).
    Needs only ``<data_root>/images/``. Returns the images written."""
    if not args.data_root:
        raise ValueError("--extract_flow requires --data_root")
    spec = FlowExtractSpec(
        tvl1=cfg.tvl1,
        bound=args.flow_bound if args.flow_bound is not None else cfg.tvl1.quant_bound,
        layout=args.flow_layout,
        fmt=args.flow_format,
        batch_size=args.batch_size,
        flow_scale=args.flow_scale,
    )
    total = extract_flow_images(args.data_root, spec, out_root=args.flow_out, device=device)
    print({"extract_flow_total": total,
           "out": args.flow_out or os.path.join(args.data_root, "flows")})
    return total
