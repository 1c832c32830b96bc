"""Distributed and fault-tolerance pieces of the port."""
