"""Scan preprocessing."""
