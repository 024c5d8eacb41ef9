"""Serving: the video-chat demo server and logging utilities (port of
``stair_tpu/serve/``; ``logutil.py`` is a copy)."""
