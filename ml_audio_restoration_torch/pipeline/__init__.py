"""Offline restoration pipeline of the port."""
from .restore import RestorationPipeline, load_stage, restore_audio

__all__ = ["RestorationPipeline", "load_stage", "restore_audio"]
