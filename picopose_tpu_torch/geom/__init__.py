"""Batched fp32 geometry on (x, y) points and (..., 3, 3) affines."""
