"""The plain reference of the gaze pipeline: float32 PyTorch with TF32
off, written from the configuration's sizes and the published equations.
It imports nothing of the program and takes nothing the program made:
the weights and frames it is given are the benchmark's own."""
