"""Deprecated alias: the LM toy server moved to ``launch.lm_serve``.

The ``serve`` name belongs to the reconstruction service
(``repro_torch.serve.ReconServer``); this shim keeps
``python -m repro_torch.launch.serve`` invocations and imports working,
as the reference's does.
"""
from __future__ import annotations

import warnings

from .lm_serve import main

__all__ = ["main"]

warnings.warn(
    "repro_torch.launch.serve is deprecated: the LM toy server lives at "
    "repro_torch.launch.lm_serve; the reconstruction service is "
    "repro_torch.serve",
    DeprecationWarning,
    stacklevel=2,
)

if __name__ == "__main__":
    main()
