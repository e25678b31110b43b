"""Graph storage and synthetic generators."""
