"""Host-side data: the synthetic corpus, I-DT fixation labels, the flip
augmentation and the device prefetcher."""
