"""Training-data acquisition: scrapers for stereo recordings and Freesound
OAuth, counterpart of ml_audio_restoration_tpu/acquire/."""

from .scrapers import (
    AudioFile,
    ScraperConfig,
    ScraperStats,
    BaseScraper,
    InternetArchiveScraper,
    FreesoundScraper,
    MusopenScraper,
    SCRAPERS,
)
from .oauth import FreesoundOAuth

__all__ = [
    "AudioFile",
    "ScraperConfig",
    "ScraperStats",
    "BaseScraper",
    "InternetArchiveScraper",
    "FreesoundScraper",
    "MusopenScraper",
    "SCRAPERS",
    "FreesoundOAuth",
]
