"""Serving-path logging + moderation helpers.

Parity with the reference demo plumbing (yellow-binary-tree/STAIR
``video_chatgpt/utils.py:16-120``): a ``build_logger`` that installs a
daily-rotating file handler on every logger and redirects stdout/stderr
through the logging stream, and a ``violates_moderation`` hook.

Differences by design:
  * stdlib only (``logging.handlers`` + ``urllib``) — the reference pulls
    in ``requests``;
  * the moderation endpoint is configuration (``MODERATION_API_URL`` /
    ``MODERATION_API_KEY`` env vars) rather than a hard-coded third-party
    URL, and a local keyword blocklist (``MODERATION_BLOCKLIST`` — comma
    separated) works fully air-gapped. Fail-open like the reference: any
    transport error means "not flagged".
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import os
import sys
import urllib.request

server_error_msg = (
    "**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE REGENERATE OR REFRESH "
    "THIS PAGE.**"
)
moderation_msg = (
    "YOUR INPUT VIOLATES OUR CONTENT MODERATION GUIDELINES. "
    "PLEASE TRY AGAIN."
)

_handler: logging.Handler | None = None


class StreamToLogger:
    """File-like stream that forwards complete lines to a logger
    (ref utils.py:StreamToLogger)."""

    def __init__(self, logger: logging.Logger, log_level=logging.INFO):
        self.terminal = sys.stdout
        self.logger = logger
        self.log_level = log_level
        self.linebuf = ""

    def __getattr__(self, attr):
        return getattr(self.terminal, attr)

    def write(self, buf):
        temp = self.linebuf + buf
        self.linebuf = ""
        for line in temp.splitlines(True):
            if line.endswith("\n"):
                self.logger.log(self.log_level, line.rstrip())
            else:
                self.linebuf += line

    def flush(self):
        if self.linebuf:
            self.logger.log(self.log_level, self.linebuf.rstrip())
        self.linebuf = ""


def build_logger(logger_name: str, logger_filename: str,
                 log_dir: str = "logs",
                 redirect_streams: bool = True) -> logging.Logger:
    """Install a UTC daily-rotating file handler on all loggers and
    (optionally) route stdout/stderr through the logging stream."""
    global _handler

    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    logging.getLogger().handlers[0].setFormatter(formatter)

    if redirect_streams:
        stdout_logger = logging.getLogger("stdout")
        stdout_logger.setLevel(logging.INFO)
        sys.stdout = StreamToLogger(stdout_logger, logging.INFO)
        stderr_logger = logging.getLogger("stderr")
        stderr_logger.setLevel(logging.ERROR)
        sys.stderr = StreamToLogger(stderr_logger, logging.ERROR)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)

    if _handler is None:
        os.makedirs(log_dir, exist_ok=True)
        _handler = logging.handlers.TimedRotatingFileHandler(
            os.path.join(log_dir, logger_filename), when="D", utc=True
        )
        _handler.setFormatter(formatter)
        for item in logging.root.manager.loggerDict.values():
            if isinstance(item, logging.Logger):
                item.addHandler(_handler)
        logging.getLogger().addHandler(_handler)
    return logger


def violates_moderation(text: str) -> bool:
    """True when ``text`` is flagged. Local blocklist first; then the
    configured moderation endpoint if any. Fails open (ref utils.py:101)."""
    blocklist = os.environ.get("MODERATION_BLOCKLIST", "")
    if blocklist:
        lowered = text.lower()
        for term in blocklist.split(","):
            term = term.strip().lower()
            if term and term in lowered:
                return True

    url = os.environ.get("MODERATION_API_URL", "")
    if not url:
        return False
    headers = {"Content-Type": "application/json"}
    key = os.environ.get("MODERATION_API_KEY", "")
    if key:
        headers["Authorization"] = "Bearer " + key
    data = json.dumps({"input": text.replace("\n", "")}).encode("utf-8")
    try:
        req = urllib.request.Request(url, data=data, headers=headers)
        with urllib.request.urlopen(req, timeout=5) as resp:
            payload = json.loads(resp.read())
        return bool(payload["results"][0]["flagged"])
    except Exception:
        return False
