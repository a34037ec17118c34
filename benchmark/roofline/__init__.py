"""Operation and byte counts of the model and the port's kernels."""
