"""Faults planted in the program for the tests that show the check can
fail (``benchmark/tests``), one per way the timed path can go wrong:

- ``state_unchanged``: the per-frame step hands back the state it was
  given and answers from it: the AT LSTM never advances, and the
  attention keeps its initial channel weights;
- ``answer_altered``: stream 0's gaze is moved to the far corner where
  the step produces it;
- ``half_batch``: the train step sees only the first half of its batch
  (the mean taken over those rows).

``plant`` wraps the pipeline object the run drives, ``plant_server``
the server (whose state is its streams' recurrent state and the previous
frame it keeps); the program's code is not touched.
"""

from __future__ import annotations

INFERENCE = ("state_unchanged", "answer_altered")


def plant(variant: str, pipe):
    """``pipe`` with the fault ``variant`` planted (as it is for
    ``program`` and ``control``)."""
    if variant not in INFERENCE:
        return pipe
    attend = pipe.attend
    H, W = pipe.config.image.height, pipe.config.image.width

    def faulty(state, sal, feat, fixation, gaze_xy=None):
        if variant == "state_unchanged":
            return state, attend(state, sal, feat, fixation * 0, gaze_xy)[1]
        new_state, out = attend(state, sal, feat, fixation, gaze_xy)
        g = out["gaze"].clone()
        g[0, 0], g[0, 1] = W - 1 - g[0, 0], H - 1 - g[0, 1]
        return new_state._replace(prev_gaze=g), dict(out, gaze=g)

    pipe.attend = faulty
    return pipe


def plant_server(variant: str, server) -> None:
    """``server`` with the fault ``variant`` planted in place: for
    ``state_unchanged`` every tick leaves the server's state (the
    streams' recurrent state and the previous frame) as it found it;
    ``answer_altered`` is planted in its pipeline."""
    if variant == "answer_altered":
        plant(variant, server.pipeline)
    if variant != "state_unchanged":
        return
    advance = server._advance

    def unchanged(cur, fixations):
        state, prev = server._state, server._prev.clone()
        out = advance(cur, fixations)
        server._state = state
        server._prev.copy_(prev)
        return out

    server._advance = unchanged
