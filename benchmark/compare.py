"""The heatmap number the inference cells' checks compare.

With random weights every bf16 computation of the model lands about as
far from the exact answer as any other: two computations that differ in
a single rounding drift apart through the layers until they differ by
the precisions' own rounding noise. So the program's distance from the
exact answer alone cannot tell bf16 from a lower precision, whose
distance is only 2-3 times that noise. The reference therefore works out
the noise itself, from the same inputs, as the distance of its own
computation at the stated precisions (float32 TV-L1, bf16 activations,
the int8 streams as stated) from its exact one (float64 TV-L1, float32
activations), and the check compares what the program adds beyond it:

    heatmap_excess = sqrt(max(0, (g_program / g_stated)^2 - 1))

where ``g_program`` is the mean |program heatmap - exact reference| over
the compared frames and ``g_stated`` the mean |stated-precision reference
- exact reference| over the same frames. Errors that are independent add in
squares, so a program at the stated precision reads near 0 and one a
step below reads about sqrt(r^2 - 1) for a ratio r of its error to the
stated precision's.
"""

from __future__ import annotations

import math


def excess(g_program: float, g_precision: float) -> float:
    """``heatmap_excess`` from the two mean gaps (infinite where the
    stated precision's own gap is 0 or not a number)."""
    if not (g_precision > 0 and math.isfinite(g_program)):
        return float("inf")
    return math.sqrt(max(0.0, (g_program / g_precision) ** 2 - 1.0))
