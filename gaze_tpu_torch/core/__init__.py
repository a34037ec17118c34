"""Configuration, device resolution and checkpoints for the port."""
