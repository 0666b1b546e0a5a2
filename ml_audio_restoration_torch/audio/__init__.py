"""WAV I/O for the port (numpy only)."""
from .io import load_audio, normalize_audio, resample, save_audio
from .wav import read_wav, wav_info, write_wav

__all__ = ["load_audio", "normalize_audio", "read_wav", "resample",
           "save_audio", "wav_info", "write_wav"]
