"""Serving stack of the port: embedder, pager, trace, continuous engine,
sLM, session and the MobileRAG pipeline."""
