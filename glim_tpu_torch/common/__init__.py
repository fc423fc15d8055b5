"""Shared estimation helpers (numpy)."""
