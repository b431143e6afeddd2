"""Datasets and the loader of the port."""
from .datasets import (AffectnetDataset, AffectnetTest,  # noqa: F401
                       AffectnetTrain, DataLoader, LatentDataset, LatentTest,
                       LatentTrain, MEADBase3, MEADBase5, MEADTalkingFace,
                       SyntheticDataset, collate, load_image, load_images)
