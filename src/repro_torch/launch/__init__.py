"""Command-line entry points of the port, run as `python -m
repro_torch.launch.<name>`: `serve` (the RAG pipelines on the session,
scheduler and tiers), `scrub_index` (the store's offline checksum
scrubber) and `soak_store` (the store's crash-safety soak)."""
