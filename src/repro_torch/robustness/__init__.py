"""Serving-path guardrails of the port."""
