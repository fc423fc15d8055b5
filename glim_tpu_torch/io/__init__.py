"""Synthetic sequences, trajectory evaluation, scan loaders and map dumps
(numpy host code; dumps read device clouds in one copy a submap)."""
