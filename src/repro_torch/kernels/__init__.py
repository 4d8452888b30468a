"""Blocked-ELL SpMM: the CUDA kernel, its plain version and the oracles."""
