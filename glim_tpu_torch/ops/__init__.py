"""Device ops (torch) and host manifold helpers (numpy)."""
