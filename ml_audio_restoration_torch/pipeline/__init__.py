"""Offline and streaming restoration of the port, and its serving daemon."""
from .restore import RestorationPipeline, load_stage, restore_audio
from .server import RestorationServer, StreamServer
from .streaming import StreamingRestorer

__all__ = ["RestorationPipeline", "RestorationServer", "StreamServer",
           "StreamingRestorer", "load_stage", "restore_audio"]
