"""Configurations: the paper's XCT datasets (Table II)."""
from .xct_datasets import DATASETS as XCT_DATASETS  # noqa: F401

__all__ = ["XCT_DATASETS"]
