"""Offline, streaming and staged restoration of the port, and its serving
daemon."""
from .restore import RestorationPipeline, load_stage, restore_audio
from .server import RestorationServer, StreamServer
from .staged import StagedRestorationPipeline
from .streaming import StreamingRestorer

__all__ = ["RestorationPipeline", "RestorationServer",
           "StagedRestorationPipeline", "StreamServer", "StreamingRestorer",
           "load_stage", "restore_audio"]
