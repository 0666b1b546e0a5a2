"""Audio I/O (WAV, FLAC, mp3/ogg), normalization, resampling and analytics;
the names of ml_audio_restoration_tpu/audio/__init__.py."""
from .analyze import detect_impulses_analytical
from .flac import FlacInfo, flac_info, read_flac, write_flac
from .io import (
    AUDIO_EXTENSIONS, add_noise, apply_highpass_filter, find_audio_files,
    load_audio, load_audio_chunk, normalize_audio, resample, save_audio)
from .wav import WavInfo, decode_wav, encode_wav, read_wav, wav_info, write_wav

__all__ = ["AUDIO_EXTENSIONS", "FlacInfo", "WavInfo", "add_noise",
           "apply_highpass_filter", "decode_wav", "detect_impulses_analytical",
           "encode_wav", "find_audio_files", "flac_info", "load_audio",
           "load_audio_chunk", "normalize_audio", "read_flac", "read_wav",
           "resample", "save_audio", "wav_info", "write_flac", "write_wav"]
