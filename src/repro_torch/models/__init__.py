"""Model layers of the port (GQA decoder slice)."""
