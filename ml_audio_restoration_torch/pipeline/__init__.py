"""Offline and streaming restoration of the port."""
from .restore import RestorationPipeline, load_stage, restore_audio
from .streaming import StreamingRestorer

__all__ = ["RestorationPipeline", "StreamingRestorer", "load_stage",
           "restore_audio"]
