"""Serving on the port: continuous batching over the LM decode path."""
