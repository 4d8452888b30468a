"""Geometry, partitioning, precision, solver and reconstruction."""
