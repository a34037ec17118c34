"""Evaluation: the AAE/AUC metrics, the heatmap losses, the rollout."""
