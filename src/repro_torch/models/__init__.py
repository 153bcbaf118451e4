"""Models served through the port's distributed kernels."""
