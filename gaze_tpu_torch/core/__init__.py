"""Configuration and device resolution for the port."""
