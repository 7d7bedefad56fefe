"""Synthetic subjects (NumPy only)."""
