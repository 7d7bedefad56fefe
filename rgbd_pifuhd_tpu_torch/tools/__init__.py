"""Measurement tools for the card (not imported by the package itself)."""
