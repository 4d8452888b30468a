"""Atomic checkpoints of nested arrays (the port's copy of ``repro.ckpt``)."""
