"""One driver per traffic kind: set-up, the timed window, the traced span
and the correctness check."""
