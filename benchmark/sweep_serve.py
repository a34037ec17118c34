"""The serve sweep: the highest tick rate a server cell sustains, found
once on the card. One set-up, then at each rate a window of ticks in the
cell's open loop, gaze alone read back as in the cell's window: the tick latency (p50, p95), how late the generator
handed frames at the start and at the end of the window (a backlog that
grows shows as a lag that grows), and the device idle share over a
traced span of 16 ticks at that rate.

    python3 benchmark/sweep_serve.py --workload serve.turbo.s128 --seed 7 \\
        --rates 12,14,15,16,17 [--seconds 15]

Prints one JSON line per rate. The benchmark's own runs never run this.
"""

import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.kinds import serve  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="serve.turbo.s128")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args()
    harness.set_cache_dirs()
    run = harness.Run(args.workload, args.seed, args.seconds, True,
                      harness.cell_spec(args.workload))
    st = serve.setup(run)
    first = 0
    for rate in (float(r) for r in args.rates.split(",")):
        run.traffic["rate_hz"] = rate
        n = int(args.seconds * rate)
        due, handed, back = serve.ticks(run, st, first, n)
        first += n
        lat = np.array([(back[i] - due[i]) * 1e3 for i in range(n)])
        lag = np.array([(h - d) * 1e3 for d, h in zip(due, handed)])
        k = max(1, n // 10)
        run.trace_span(lambda: serve.ticks(run, st, first, 16))
        first += 16
        dt = run.device_trace
        print(json.dumps({
            "rate_hz": rate, "stream_frames_per_s": rate * run.traffic["slots"], "ticks": n,
            "tick_p50_ms": float(np.percentile(lat, 50)),
            "tick_p95_ms": float(np.percentile(lat, 95)),
            "lag_first_tenth_ms": float(lag[:k].mean()), "lag_last_tenth_ms": float(lag[-k:].mean()),
            "idle_share_pct": 100.0 * (1 - dt.busy_s() / dt.wall_s)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
