"""Optimizers for the port (``repro_torch.optim.adamw``)."""
