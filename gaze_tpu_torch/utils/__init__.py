"""Host utilities: structured step logging."""
