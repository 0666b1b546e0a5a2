"""WAV I/O for the port (numpy only), and impulse analytics."""
from .analyze import detect_impulses_analytical
from .io import (
    AUDIO_EXTENSIONS, add_noise, apply_highpass_filter, find_audio_files,
    load_audio, load_audio_chunk, normalize_audio, resample, save_audio)
from .wav import read_wav, wav_info, write_wav

__all__ = ["AUDIO_EXTENSIONS", "add_noise", "apply_highpass_filter",
           "detect_impulses_analytical", "find_audio_files", "load_audio",
           "load_audio_chunk", "normalize_audio", "read_wav", "resample",
           "save_audio", "wav_info", "write_wav"]
