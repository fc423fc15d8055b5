"""Synthetic sequences and trajectory evaluation (numpy)."""
