"""Typed failures of the solve."""
