"""Serving stack of the port: embedder, pager, trace, continuous engine,
sLM, session and the MobileRAG pipeline; the fault-injection harness and
the replica schedulers."""
