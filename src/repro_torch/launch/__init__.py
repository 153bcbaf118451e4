"""Launch-side helpers of the port (per-executable memory so far)."""
