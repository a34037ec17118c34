"""Host-side data: the GTEA manifest and batches (``gtea``), frame
extraction from video (``video``), the threaded JPEG decoder
(``native_io``), flow-image extraction on the card (``flow_extract``),
the synthetic corpus, I-DT fixation labels, the flip augmentation and
the device prefetcher.

``build_manifest`` and ``extract_flow_images`` are exported here.
"""


def __getattr__(name):
    if name == "build_manifest":
        from gaze_tpu_torch.data.gtea import build_manifest

        return build_manifest
    if name == "extract_flow_images":
        from gaze_tpu_torch.data.flow_extract import extract_flow_images

        return extract_flow_images
    raise AttributeError(name)
