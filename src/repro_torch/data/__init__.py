"""Token data for the port's LM training (``repro_torch.data.pipeline``)."""
