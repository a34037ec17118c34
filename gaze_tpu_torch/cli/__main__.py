"""``python -m gaze_tpu_torch.cli``: see ``gaze_tpu_torch/cli/__init__.py``."""

from gaze_tpu_torch.cli import main

main()
