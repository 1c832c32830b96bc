"""Retrieval core of the port: k-means, EcoVector device search, SCR and
the window index."""
