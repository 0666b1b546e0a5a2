"""Freesound OAuth2 (the authorization-code flow) with a local callback
server and a token cache; the port's own copy of
ml_audio_restoration_tpu/acquire/oauth.py.

Flow: serve the redirect port on localhost, print the authorization URL,
wait for the browser's redirect carrying ?code=... (and the flow's state),
exchange the code for an access/refresh token pair, cache the tokens on
disk and refresh them on expiry.
"""
from __future__ import annotations

import json
import os
import secrets
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path
from typing import Callable, Optional


def _default_post(url: str, data: dict) -> bytes:
    body = urllib.parse.urlencode(data).encode()
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


class FreesoundOAuth:
    AUTH_URL = "https://freesound.org/apiv2/oauth2/authorize/"
    TOKEN_URL = "https://freesound.org/apiv2/oauth2/access_token/"

    def __init__(self, client_id: str, client_secret: str,
                 redirect_port: int = 3000,
                 token_cache: str = ".freesound_tokens.json",
                 post: Callable[[str, dict], bytes] = _default_post,
                 fetch: Optional[Callable[[str, dict], bytes]] = None):
        self.client_id = client_id
        self.client_secret = client_secret
        self.redirect_port = redirect_port
        self.redirect_uri = f"http://localhost:{redirect_port}/callback"
        self.token_cache = Path(token_cache)
        self.post = post
        self._fetch = fetch
        self.tokens: Optional[dict] = None
        self._load_cache()

    # ------------------------------------------------------------- caching
    def _load_cache(self):
        if self.token_cache.exists():
            try:
                self.tokens = json.loads(self.token_cache.read_text())
            except (OSError, json.JSONDecodeError):
                self.tokens = None

    def _save_cache(self):
        # Access/refresh tokens are credentials: 0600, never world-readable.
        fd = os.open(self.token_cache,
                     os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps(self.tokens))

    # ---------------------------------------------------------------- flow
    def authorization_url(self, state: str) -> str:
        params = urllib.parse.urlencode({
            "client_id": self.client_id,
            "response_type": "code",
            "state": state,
            "redirect_uri": self.redirect_uri,
        })
        return f"{self.AUTH_URL}?{params}"

    def wait_for_code(self, timeout: float = 300.0) -> str:
        """Run the local callback server until the browser delivers ?code=.

        A per-flow random `state` is sent with the authorization URL and the
        callback is rejected unless it echoes the same value (login-CSRF /
        code-injection guard on the local listener)."""
        result: dict = {}
        done = threading.Event()
        expected_state = self.pending_state = secrets.token_urlsafe(24)

        class Handler(BaseHTTPRequestHandler):
            def do_GET(handler):  # noqa: N805
                parsed = urllib.parse.urlparse(handler.path)
                if parsed.path != "/callback":
                    handler.send_response(404)
                    handler.end_headers()
                    return
                query = urllib.parse.parse_qs(parsed.query)
                if query.get("state", [None])[0] != expected_state:
                    # Do not set done: keep waiting for the genuine redirect.
                    handler.send_response(400)
                    handler.end_headers()
                    handler.wfile.write(b"<h1>State mismatch</h1>")
                    return
                if "error" in query:
                    result["error"] = query["error"][0]
                    handler.send_response(400)
                    handler.end_headers()
                    handler.wfile.write(b"<h1>Authorization failed</h1>")
                elif "code" in query:
                    result["code"] = query["code"][0]
                    handler.send_response(200)
                    handler.end_headers()
                    handler.wfile.write(
                        b"<h1>Authorization successful</h1>"
                        b"<p>You can close this window.</p>")
                else:
                    handler.send_response(400)
                    handler.end_headers()
                done.set()

            def log_message(self, *args):  # quiet
                pass

        server = HTTPServer(("localhost", self.redirect_port), Handler)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        print(f"visit to authorize:\n  {self.authorization_url(expected_state)}")
        try:
            if not done.wait(timeout):
                raise TimeoutError("authorization timeout")
        finally:
            server.shutdown()
        if "error" in result:
            raise RuntimeError(f"authorization failed: {result['error']}")
        return result["code"]

    def exchange_code(self, code: str) -> dict:
        data = json.loads(self.post(self.TOKEN_URL, {
            "client_id": self.client_id,
            "client_secret": self.client_secret,
            "grant_type": "authorization_code",
            "code": code,
        }))
        data["obtained_at"] = time.time()
        self.tokens = data
        self._save_cache()
        return data

    def refresh(self) -> dict:
        if not self.tokens or "refresh_token" not in self.tokens:
            raise RuntimeError("no refresh token; run authorize() first")
        data = json.loads(self.post(self.TOKEN_URL, {
            "client_id": self.client_id,
            "client_secret": self.client_secret,
            "grant_type": "refresh_token",
            "refresh_token": self.tokens["refresh_token"],
        }))
        data["obtained_at"] = time.time()
        self.tokens = data
        self._save_cache()
        return data

    def access_token(self) -> str:
        if not self.tokens:
            code = self.wait_for_code()
            self.exchange_code(code)
        elif (time.time() - self.tokens.get("obtained_at", 0)
              > self.tokens.get("expires_in", 86400) - 60):
            self.refresh()
        return self.tokens["access_token"]

    def fetch(self, url: str) -> bytes:
        """Authenticated download."""
        token = self.access_token()
        if self._fetch is not None:
            return self._fetch(url, {"Authorization": f"Bearer {token}"})
        req = urllib.request.Request(
            url, headers={"Authorization": f"Bearer {token}"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read()
