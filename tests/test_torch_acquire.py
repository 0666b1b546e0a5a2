"""The port's acquire/ (its own copy of the JAX package's standard-library
scrapers and Freesound OAuth) with the fakes of tests/test_acquire.py:
the same cases, nothing reaches the network; plus `cli acquire` parsing
the JAX package's command line."""
import json

import numpy as np
import pytest

from ml_audio_restoration_torch.acquire import (
    AudioFile,
    ScraperConfig,
    BaseScraper,
    InternetArchiveScraper,
    FreesoundScraper,
    FreesoundOAuth,
)


def _eligible(**kw):
    base = dict(id="1", name="a.wav", download_url="http://x/a.wav",
                duration=120.0, sample_rate=44100, channels=2, format="wav")
    base.update(kw)
    return AudioFile(**base)


class TestEligibility:
    def test_accepts_valid(self):
        s = BaseScraper(ScraperConfig())
        assert s.is_eligible(_eligible())

    @pytest.mark.parametrize("kw", [
        dict(sample_rate=22050),       # too low
        dict(channels=1),              # mono
        dict(duration=10.0),           # too short
        dict(duration=1000.0),         # too long
        dict(format="mp3"),            # lossy
    ])
    def test_rejects(self, kw):
        s = BaseScraper(ScraperConfig())
        assert not s.is_eligible(_eligible(**kw))


class TestDownload:
    def test_download_and_skip_if_exists(self, tmp_path):
        payload = b"RIFFfake"
        calls = []

        def fetch(url):
            calls.append(url)
            return payload

        s = BaseScraper(ScraperConfig(output_dir=str(tmp_path)), fetch=fetch)
        s.name = "test"
        f = _eligible()
        assert s.download(f) is True
        target = tmp_path / "test_1_a.wav"
        assert target.read_bytes() == payload
        # second download skips
        assert s.download(f) is False
        assert s.stats.skipped == 1
        assert len(calls) == 1

    def test_failed_download_counted(self, tmp_path):
        def fetch(url):
            raise IOError("net down")

        s = BaseScraper(ScraperConfig(output_dir=str(tmp_path)), fetch=fetch)
        s.name = "test"
        assert s.download(_eligible()) is False
        assert s.stats.failed == 1


class TestInternetArchive:
    def test_search_filters_and_limits(self, tmp_path):
        search_resp = json.dumps({"response": {"docs": [
            {"identifier": "item1", "title": "Jazz"}]}}).encode()
        meta_resp = json.dumps({"files": [
            {"name": "good.flac", "format": "FLAC", "length": "120.5",
             "sample_rate": "44100", "channels": "2"},
            {"name": "bad_mono.wav", "format": "WAVE", "length": "120",
             "sample_rate": "44100", "channels": "1"},
            {"name": "notes.txt", "format": "Text"},
        ]}).encode()

        def fetch(url):
            return meta_resp if "metadata" in url else search_resp

        s = InternetArchiveScraper(
            ScraperConfig(output_dir=str(tmp_path), max_files_per_source=3),
            fetch=fetch, sleep=lambda _s: None)
        files = s.search()
        # every (collection, query) pair returns the same eligible file;
        # the cap must hold
        assert 1 <= len(files) <= 3
        assert files[0].name == "good.flac"
        assert files[0].channels == 2
        assert "archive.org/download/item1/good.flac" in files[0].download_url


class TestFreesound:
    def test_search_requires_key(self, tmp_path):
        s = FreesoundScraper(ScraperConfig(output_dir=str(tmp_path)))
        assert s.search() == []

    def test_search_parses_results(self, tmp_path):
        resp = json.dumps({"results": [
            {"id": 11, "name": "ok.wav", "duration": 60, "channels": 2,
             "samplerate": 48000, "type": "wav", "download": "http://d/11"},
            {"id": 12, "name": "mono.wav", "duration": 60, "channels": 1,
             "samplerate": 48000, "type": "wav", "download": "http://d/12"},
        ]}).encode()
        s = FreesoundScraper(
            ScraperConfig(output_dir=str(tmp_path), max_files_per_source=1),
            fetch=lambda url: resp, api_key="k")
        files = s.search()
        assert [f.id for f in files] == ["11"]

    def test_download_without_oauth_skips(self, tmp_path):
        s = FreesoundScraper(ScraperConfig(output_dir=str(tmp_path)),
                             api_key="k")
        assert s.download(_eligible()) is False
        assert s.stats.skipped == 1


class TestOAuth:
    def test_token_exchange_and_cache(self, tmp_path):
        posted = {}

        def post(url, data):
            posted.update(data)
            return json.dumps({"access_token": "AT", "refresh_token": "RT",
                               "expires_in": 86400}).encode()

        cache = tmp_path / "tok.json"
        oauth = FreesoundOAuth("cid", "secret", token_cache=str(cache),
                               post=post)
        tokens = oauth.exchange_code("THECODE")
        assert tokens["access_token"] == "AT"
        assert posted["grant_type"] == "authorization_code"
        assert posted["code"] == "THECODE"
        assert cache.exists()

        # a fresh instance reuses the cache without re-authorizing
        oauth2 = FreesoundOAuth("cid", "secret", token_cache=str(cache),
                                post=post)
        assert oauth2.access_token() == "AT"

    def test_refresh_on_expiry(self, tmp_path):
        calls = []

        def post(url, data):
            calls.append(data["grant_type"])
            return json.dumps({"access_token": f"AT{len(calls)}",
                               "refresh_token": "RT",
                               "expires_in": 86400}).encode()

        cache = tmp_path / "tok.json"
        oauth = FreesoundOAuth("cid", "secret", token_cache=str(cache),
                               post=post)
        oauth.exchange_code("C")
        oauth.tokens["obtained_at"] = 0  # force expiry
        assert oauth.access_token() == "AT2"
        assert calls == ["authorization_code", "refresh_token"]

    def test_authorization_url(self):
        oauth = FreesoundOAuth("cid", "secret", token_cache="/dev/null")
        url = oauth.authorization_url("STATE123")
        assert "client_id=cid" in url
        assert "response_type=code" in url
        assert "state=STATE123" in url
        assert "localhost%3A3000%2Fcallback" in url

    def test_callback_server_receives_code(self, tmp_path):
        import threading
        import urllib.error
        import urllib.request

        oauth = FreesoundOAuth("cid", "secret", redirect_port=38742,
                               token_cache=str(tmp_path / "t.json"))
        result = {}

        def run():
            result["code"] = oauth.wait_for_code(timeout=10)

        t = threading.Thread(target=run)
        t.start()
        import time as _t

        for _ in range(50):  # wait for server + its per-flow state
            _t.sleep(0.05)
            state = getattr(oauth, "pending_state", None)
            if state is None:
                continue
            # a forged callback without the right state must be rejected
            # (login-CSRF guard) and must NOT terminate the wait
            try:
                urllib.request.urlopen(
                    "http://localhost:38742/callback?code=EVIL&state=wrong",
                    timeout=2)
                raise AssertionError("state mismatch not rejected")
            except urllib.error.HTTPError as e:
                assert e.code == 400
            except OSError:
                continue
            urllib.request.urlopen(
                f"http://localhost:38742/callback?code=ZZZ&state={state}",
                timeout=2)
            break
        t.join(timeout=10)
        assert result.get("code") == "ZZZ"


# ---------------------------------------------------------------- the CLI
@pytest.mark.parametrize("argv", [
    ["acquire", "internetarchive"],
    ["acquire", "freesound", "--output-dir", "d", "--max-files", "3",
     "--freesound-api-key", "K"],
    ["acquire", "musopen", "--max-files", "1"]])
def test_cli_acquire_parses_the_jax_command_line(argv, tmp_path,
                                                 monkeypatch, capsys):
    """The port's parser takes the JAX CLI's acquire arguments, and the
    command builds the scraper the JAX command builds (a fake here)."""
    import argparse

    from ml_audio_restoration_tpu import cli as jcli
    from ml_audio_restoration_torch import acquire, cli
    from ml_audio_restoration_torch.acquire import ScraperStats

    parsed = []
    for mod in (cli, jcli):
        parser = argparse.ArgumentParser()
        mod._add_acquire(parser.add_subparsers(dest="command"))
        parsed.append(vars(parser.parse_args(argv)))
    assert parsed[0] == parsed[1]

    made = []

    class Fake:
        def __init__(self, config, **kw):
            made.append((config, kw))

        def run(self):
            return ScraperStats(searched=4, eligible=2, downloaded=1)

    monkeypatch.setitem(acquire.SCRAPERS, argv[1], Fake)
    assert cli.main(argv) == 0
    config, kw = made[0]
    assert config.output_dir == parsed[0]["output_dir"]
    assert config.max_files_per_source == parsed[0]["max_files"]
    assert kw == ({"api_key": "K"} if argv[1] == "freesound" else {})
    assert "searched=4 eligible=2 downloaded=1" in capsys.readouterr().out
