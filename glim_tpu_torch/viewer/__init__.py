"""Headless viewers, the run stream and the interactive correction tools."""
