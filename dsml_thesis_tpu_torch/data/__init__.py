"""Datasets and the loader of the port."""
from .datasets import DataLoader, SyntheticDataset, collate  # noqa: F401
