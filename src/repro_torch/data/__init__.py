"""Synthetic data generators (numpy; bitwise the reference's windows)."""
