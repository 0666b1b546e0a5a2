"""Training-data acquisition: source scrapers for stereo music recordings.

The port's own copy of ml_audio_restoration_tpu/acquire/scrapers.py
(standard library only). An abstract BaseScraper holds the eligibility
filter (>= 44.1 kHz, exactly 2 channels, 30-600 s, wav/flac) and streaming
downloads that skip files already present; the Internet Archive scraper
searches curated collections and fetches each item's metadata at one
request a second; the Freesound scraper runs a text search and downloads
through OAuth2 (oauth.py); the Musopen helper only lists.

Every network entry point (`fetch`, `sleep`, OAuth's `post`) is
injectable, so tests run on fakes and never reach the network.
"""
from __future__ import annotations

import json
import re
import threading
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional


@dataclass
class AudioFile:
    id: str
    name: str
    download_url: str
    duration: float = 0.0
    sample_rate: int = 0
    channels: int = 0
    format: str = ""
    source: str = ""


@dataclass
class ScraperConfig:
    output_dir: str = "data/raw"
    required_sample_rate: int = 44100
    required_channels: int = 2
    min_duration: float = 30.0
    max_duration: float = 600.0
    max_files_per_source: int = 50
    rate_limit_s: float = 1.0


@dataclass
class ScraperStats:
    searched: int = 0
    eligible: int = 0
    downloaded: int = 0
    skipped: int = 0
    failed: int = 0


def _default_fetch(url: str, timeout: float = 30.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


class BaseScraper:
    """Search a source for eligible stereo recordings and download them."""

    name = "base"
    allowed_formats = ("wav", "flac")

    def __init__(self, config: Optional[ScraperConfig] = None,
                 fetch: Callable[[str], bytes] = _default_fetch):
        self.config = config or ScraperConfig()
        self.fetch = fetch
        self.stats = ScraperStats()
        # download() runs on run()'s thread pool: counter bumps go through
        # this lock so ScraperStats stays consistent under concurrency.
        self._stats_lock = threading.Lock()

    def _bump(self, field: str, n: int = 1):
        with self._stats_lock:
            setattr(self.stats, field, getattr(self.stats, field) + n)

    # -- override -----------------------------------------------------------
    def search(self) -> List[AudioFile]:
        raise NotImplementedError

    # -- shared -------------------------------------------------------------
    def is_eligible(self, f: AudioFile) -> bool:
        """The reference filter (BaseScraper.ts:32-55)."""
        if f.sample_rate < self.config.required_sample_rate:
            return False
        if f.channels != self.config.required_channels:
            return False
        if not (self.config.min_duration <= f.duration
                <= self.config.max_duration):
            return False
        return f.format.lower() in self.allowed_formats

    @staticmethod
    def sanitize_filename(name: str) -> str:
        return re.sub(r"[^A-Za-z0-9._-]+", "_", name)[:128]

    def _target_path(self, f: AudioFile) -> Path:
        fname = self.sanitize_filename(f.name)
        return Path(self.config.output_dir) / f"{self.name}_{f.id}_{fname}"

    def download(self, f: AudioFile) -> bool:
        """Streamed download with skip-if-exists (BaseScraper.ts:57-99).
        Writes to a .part temp file then renames, so an interrupted download
        never leaves a truncated file that skip-if-exists would trust."""
        path = self._target_path(f)
        if path.exists():
            self._bump("skipped")
            return False
        path.parent.mkdir(parents=True, exist_ok=True)
        try:
            data = self.fetch(f.download_url)
            tmp = path.with_suffix(path.suffix + ".part")
            tmp.write_bytes(data)
            tmp.rename(path)
            self._bump("downloaded")
            return True
        except Exception as e:  # noqa: BLE001 — per-file failures are logged
            self._bump("failed")
            print(f"download failed: {f.name}: {e}")
            return False

    def run(self, concurrency: int = 3) -> ScraperStats:
        """Search then download with a small worker pool (the reference uses
        p-queue concurrency, data-scraper/src/index.ts:108-114)."""
        from concurrent.futures import ThreadPoolExecutor

        files = self.search()
        if concurrency <= 1 or len(files) <= 1:
            for f in files:
                self.download(f)
        else:
            with ThreadPoolExecutor(max_workers=concurrency) as pool:
                list(pool.map(self.download, files))
        return self.stats


class InternetArchiveScraper(BaseScraper):
    """advancedsearch over curated collections + per-item metadata
    (InternetArchiveScraper.ts:15-80)."""

    name = "internetarchive"
    SEARCH_URL = "https://archive.org/advancedsearch.php"
    METADATA_URL = "https://archive.org/metadata/"
    DOWNLOAD_URL = "https://archive.org/download/"

    COLLECTIONS = ("etree", "opensource_audio", "audio_music",
                   "GratefulDead", "georgeblood")
    QUERIES = ("jazz stereo", "classical stereo", "orchestra stereo",
               "piano stereo", "chamber music stereo", "live recording",
               "soundboard")

    def __init__(self, *args, sleep: Callable[[float], None] = time.sleep,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.sleep = sleep

    def search(self) -> List[AudioFile]:
        eligible: List[AudioFile] = []
        for collection in self.COLLECTIONS:
            for query in self.QUERIES:
                q = (f"collection:{collection} AND {query} AND "
                     "format:(wav OR flac) AND NOT 78rpm AND NOT mono")
                params = urllib.parse.urlencode({
                    "q": q, "fl": "identifier,title", "rows": 50,
                    "output": "json"})
                try:
                    data = json.loads(self.fetch(
                        f"{self.SEARCH_URL}?{params}"))
                except Exception as e:  # noqa: BLE001
                    print(f"search failed ({collection}): {e}")
                    continue
                docs = data.get("response", {}).get("docs", [])
                self.stats.searched += len(docs)
                for item in docs:
                    eligible.extend(self._item_files(item.get("identifier")))
                    if len(eligible) >= self.config.max_files_per_source:
                        return eligible[:self.config.max_files_per_source]
                    self.sleep(self.config.rate_limit_s)
        return eligible

    def _item_files(self, identifier: Optional[str]) -> List[AudioFile]:
        if not identifier:
            return []
        try:
            meta = json.loads(self.fetch(self.METADATA_URL + identifier))
        except Exception:  # noqa: BLE001
            return []
        out = []
        for f in meta.get("files", []):
            fmt = str(f.get("format", "")).lower()
            ext = str(f.get("name", "")).rsplit(".", 1)[-1].lower()
            if ext not in self.allowed_formats and "wave" not in fmt \
                    and "flac" not in fmt:
                continue
            af = AudioFile(
                id=f"{identifier}_{f.get('name', '')}",
                name=str(f.get("name", "")),
                download_url=(self.DOWNLOAD_URL + identifier + "/"
                              + urllib.parse.quote(str(f.get("name", "")))),
                duration=float(f.get("length", 0) or 0),
                sample_rate=int(f.get("sample_rate", 0) or 0),
                channels=int(f.get("channels", 0) or 0),
                format=ext,
                source=self.name,
            )
            if self.is_eligible(af):
                self.stats.eligible += 1
                out.append(af)
        return out


class FreesoundScraper(BaseScraper):
    """Text-search API; downloads require OAuth2 (FreesoundScraper.ts)."""

    name = "freesound"
    BASE_URL = "https://freesound.org/apiv2"
    QUERIES = ("music stereo", "piano recording", "orchestra", "jazz band",
               "acoustic guitar")

    def __init__(self, *args, api_key: Optional[str] = None,
                 oauth: Optional["FreesoundOAuth"] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.api_key = api_key
        self.oauth = oauth

    def search(self) -> List[AudioFile]:
        if not self.api_key:
            print("freesound: no API key configured; skipping search")
            return []
        eligible: List[AudioFile] = []
        for query in self.QUERIES:
            params = urllib.parse.urlencode({
                "query": query, "page_size": 50,
                "fields": "id,name,duration,channels,samplerate,type,download",
                "token": self.api_key})
            try:
                data = json.loads(self.fetch(
                    f"{self.BASE_URL}/search/text/?{params}"))
            except Exception as e:  # noqa: BLE001
                print(f"freesound search failed ({query}): {e}")
                continue
            results = data.get("results", [])
            self.stats.searched += len(results)
            for item in results:
                af = AudioFile(
                    id=str(item.get("id")),
                    name=str(item.get("name", "")),
                    download_url=str(item.get("download", "")),
                    duration=float(item.get("duration", 0) or 0),
                    sample_rate=int(item.get("samplerate", 0) or 0),
                    channels=int(item.get("channels", 0) or 0),
                    format=str(item.get("type", "")),
                    source=self.name,
                )
                if self.is_eligible(af):
                    self.stats.eligible += 1
                    eligible.append(af)
                if len(eligible) >= self.config.max_files_per_source:
                    return eligible
        return eligible

    def download(self, f: AudioFile) -> bool:
        if self.oauth is None:
            print(f"freesound: OAuth not configured — manual download: "
                  f"https://freesound.org/s/sounds/{f.id}/")
            self._bump("skipped")
            return False
        path = self._target_path(f)
        if path.exists():
            self._bump("skipped")
            return False
        path.parent.mkdir(parents=True, exist_ok=True)
        try:
            data = self.oauth.fetch(f.download_url)
            tmp = path.with_suffix(path.suffix + ".part")
            tmp.write_bytes(data)
            tmp.rename(path)
            self._bump("downloaded")
            return True
        except Exception as e:  # noqa: BLE001
            self._bump("failed")
            print(f"freesound download failed: {f.name}: {e}")
            return False


class MusopenScraper(BaseScraper):
    """List-only source (manual download), like the reference's
    MusopenScraper.ts."""

    name = "musopen"

    def search(self) -> List[AudioFile]:
        print("musopen: listing only — browse https://musopen.org/music/ "
              "and download lossless stereo recordings manually into "
              f"{self.config.output_dir}")
        return []

    def download(self, f: AudioFile) -> bool:  # pragma: no cover
        self.stats.skipped += 1
        return False


SCRAPERS = {
    "internetarchive": InternetArchiveScraper,
    "freesound": FreesoundScraper,
    "musopen": MusopenScraper,
}
