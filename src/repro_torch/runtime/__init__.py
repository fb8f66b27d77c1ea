"""Serving runtime: the paged engine and the continuous-batching scheduler."""
