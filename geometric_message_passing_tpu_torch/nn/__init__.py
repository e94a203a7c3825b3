"""Parameter initialisation helpers."""
