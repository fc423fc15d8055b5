"""Odometry estimation modules."""
