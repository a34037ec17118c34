"""Host-side data: the synthetic corpus and I-DT fixation labels."""
