"""Training engines of the port (single device so far)."""
