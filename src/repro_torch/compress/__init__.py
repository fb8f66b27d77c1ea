"""Paged KV-cache memory model (host-side block pool, cache reports)."""
