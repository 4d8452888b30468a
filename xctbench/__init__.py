"""The benchmark of ``repro_torch``: see ``run.py`` and ``harness.py``."""
