"""Hand-written CUDA kernels for Hopper, their plain torch versions and the ops
that dispatch between them by device (see ``kernels.ops``)."""
