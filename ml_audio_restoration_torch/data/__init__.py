"""Training data of the port: chunk datasets, a seeded loader and the 78rpm
artifact simulator."""
from .artifacts import (
    apply_artifacts, draw_artifacts, simulate_batch, simulate_vinyl_artifacts,
    zero_phase_fir, zero_phase_fir_bank)
from .datasets import (
    AdaptiveArtifactDataset, ChunkDataset, MixedRestorationDataset,
    RestorationDataset, StereoDataset, SuperResolutionDataset)
from .loader import DataLoader, collate, train_val_split

__all__ = ["AdaptiveArtifactDataset", "ChunkDataset", "DataLoader",
           "MixedRestorationDataset", "RestorationDataset",
           "StereoDataset", "SuperResolutionDataset", "apply_artifacts",
           "collate", "draw_artifacts", "simulate_batch",
           "simulate_vinyl_artifacts", "train_val_split", "zero_phase_fir",
           "zero_phase_fir_bank"]
