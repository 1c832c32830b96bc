"""Models of the port (the dense family's paged serving path)."""
