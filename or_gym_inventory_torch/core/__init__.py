"""Spaces, the TimeStep struct, NumPy-parity RNG and device resolution."""
