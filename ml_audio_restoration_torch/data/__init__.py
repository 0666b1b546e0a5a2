"""Training data of the port: chunk datasets and a seeded loader."""
from .datasets import ChunkDataset, StereoDataset
from .loader import DataLoader, collate, train_val_split

__all__ = ["ChunkDataset", "DataLoader", "StereoDataset", "collate",
           "train_val_split"]
