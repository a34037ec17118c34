"""SP / AT / LF modules, the weight bridge and the fused pipeline."""
