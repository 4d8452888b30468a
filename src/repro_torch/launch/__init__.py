"""Drivers: reconstruction."""
