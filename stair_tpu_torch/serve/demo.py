"""Video-chat demo server (port of ``stair_tpu/serve/demo.py``).

Replaces the reference's gradio UI (yellow-binary-tree/STAIR
``video_chatgpt/demo/video_demo.py`` + ``demo/chat.py``) with a
dependency-free HTTP server: a minimal single-page UI plus a JSON API,
holding per-session conversation state exactly like the reference's
``Chat.answer`` flow — upload/select a video once, then multi-turn QA over
its cached spatio-temporal features.

Endpoints (the JAX demo's, with its JSON):
  GET  /                 — chat page
  POST /api/new_session  — {video_path} -> {session_id}
  POST /api/chat         — {session_id, message} -> {reply}
  GET  /api/sessions     — list active sessions
  GET  /api/stats        — request-latency percentiles (p50/p90/p99)

Moderation: incoming chat messages run through
``serve.logutil.violates_moderation`` (local blocklist + optional
configured endpoint — ref video_chatgpt/utils.py:101) and flagged
messages get the reference's moderation reply instead of a generation.

The model is the port's ``VideoChatModel`` on one device: a session's
video is encoded once (``videochat_infer.encode_video_batch``: CLIP tower +
pooling) and its tokens stay on the device; each turn is
``videochat_infer.video_chatgpt_infer_batch`` at batch 1 over those tokens,
one prefill through the attention kernel (one launch per decoder layer)
and a sampled decode. A turn samples at temperature 0.2
from a ``torch.Generator`` seeded with the turn's index, the counterpart of
the JAX demo's ``jax.random.PRNGKey(len(history))``: the two draw different
numbers, so their sampled replies differ.

Run: ``python -m stair_tpu_torch.serve.demo --port 7860 [--model-ckpt DIR]
[--log-dir DIR] [--device cuda|cpu]`` (``--log-dir`` installs the
daily-rotating file logger + stdout/stderr capture, ref
utils.py:build_logger); without ``--device`` it runs on the first CUDA
device, and exits where there is none.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from stair_tpu_torch.serve.logutil import moderation_msg, violates_moderation

logger = logging.getLogger("stair_tpu_torch.serve")


class LatencyTracker:
    """Per-endpoint request latencies -> percentile report (serving tail
    latency belongs next to every throughput number)."""

    def __init__(self, cap: int = 10000):
        self.cap = cap
        self.samples: dict[str, list[float]] = {}

    def record(self, endpoint: str, seconds: float):
        buf = self.samples.setdefault(endpoint, [])
        buf.append(seconds)
        if len(buf) > self.cap:
            del buf[: len(buf) - self.cap]

    def report(self) -> dict:
        out = {}
        for endpoint, buf in self.samples.items():
            if not buf:
                continue
            arr = np.sort(np.asarray(buf))
            out[endpoint] = {
                "count": int(arr.size),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p90_ms": float(np.percentile(arr, 90) * 1e3),
                "p99_ms": float(np.percentile(arr, 99) * 1e3),
                "max_ms": float(arr[-1] * 1e3),
            }
        return out

_PAGE = """<!doctype html><html><head><title>stair-tpu video chat</title>
<style>body{font-family:sans-serif;max-width:720px;margin:2em auto}
#log{border:1px solid #ccc;padding:1em;min-height:200px;white-space:pre-wrap}
input,button{font-size:1em;padding:.4em}</style></head><body>
<h2>stair-tpu video chat</h2>
<p>Video path: <input id=video size=40 value=""> <button onclick=newSession()>load</button></p>
<div id=log></div>
<p><input id=msg size=50 placeholder="ask about the video...">
<button onclick=send()>send</button></p>
<script>
let sid=null;
async function newSession(){
  const r=await fetch('/api/new_session',{method:'POST',
    body:JSON.stringify({video_path:document.getElementById('video').value})});
  const j=await r.json(); sid=j.session_id;
  log('system: '+(j.error||('session '+sid+' ready')));}
async function send(){
  const m=document.getElementById('msg').value;
  log('you: '+m);
  const r=await fetch('/api/chat',{method:'POST',
    body:JSON.stringify({session_id:sid,message:m})});
  const j=await r.json(); log('assistant: '+(j.reply||j.error));}
function log(s){document.getElementById('log').textContent+=s+'\\n';}
</script></body></html>"""


def _air_gapped_args(model_ckpt=None, device=None):
    class _A:
        model_path = None
        vision_path = None

    _A.model_ckpt = model_ckpt
    _A.device = device
    return _A()


class ChatBackend:
    """Holds the model and per-session state (video tokens on the device +
    history). ``params``, when given, is a params tree (numpy arrays or
    tensors under the JAX key paths) loaded into ``model``: the JAX
    backend holds its weights apart from its model, the port's model holds
    them."""

    def __init__(self, model=None, params=None, tokenizer=None,
                 conv_mode="video-chatgpt_v1", num_frames=100, device=None):
        if model is None:
            from stair_tpu_torch.llm.videochat_infer import initialize_model

            model, tokenizer = initialize_model(_air_gapped_args(
                device=device))
        if params is not None:
            from stair_tpu_torch.weights import flatten_tree

            leaves = flatten_tree(model.param_tree())
            with torch.no_grad():
                for key, val in flatten_tree(params).items():
                    leaves[key].copy_(torch.as_tensor(np.asarray(val)))
        self.model = model
        self.tokenizer = tokenizer
        self.conv_mode = conv_mode
        self.num_frames = num_frames
        self.sessions: dict[str, dict] = {}
        # one turn at a time on the device (the HTTP server is threaded)
        import threading

        self._lock = threading.Lock()

    @property
    def device(self):
        return self.model.decoder.embed.device

    def new_session(self, video_path: str) -> str:
        from stair_tpu_torch.llm.frames import load_video_frames

        frames = load_video_frames(video_path, self.num_frames)
        return self.open_frames(frames, video_path)

    def open_frames(self, frames, video_path: str = "") -> str:
        """Open a session on decoded ``[T, H, W, 3]`` uint8 frames (what
        ``new_session`` decodes from ``video_path``): preprocess, encode
        with the model's CLIP tower and pooling, and keep the video tokens
        on the device."""
        from stair_tpu_torch.llm.videochat_infer import encode_video_batch

        with self._lock:
            video_tokens = encode_video_batch(self.model, [frames])[0]
        sid = uuid.uuid4().hex[:8]
        self.sessions[sid] = {
            "video_path": video_path,
            "video_tokens": video_tokens,
            "history": [],
        }
        logger.info("session %s: %s", sid, video_path)
        return sid

    def chat(self, session_id: str, message: str) -> str:
        from stair_tpu_torch.llm.videochat_infer import (
            video_chatgpt_infer_batch,
        )

        sess = self.sessions[session_id]
        # Single-turn QA over the cached video (multi-turn history is kept
        # for the transcript; each question is answered independently, as
        # the reference demo effectively does for video QA).
        gen = torch.Generator(device=self.device).manual_seed(
            len(sess["history"]))
        with self._lock:
            reply = video_chatgpt_infer_batch(
                self.model, self.tokenizer, [message], None,
                conv_mode=self.conv_mode, max_new_tokens=64, temperature=0.2,
                generator=gen, video_tokens=sess["video_tokens"][None])[0]
        sess["history"].append((message, reply))
        return reply


def make_handler(backend: ChatBackend, latency: LatencyTracker | None = None):
    latency = latency or LatencyTracker()

    class Handler(BaseHTTPRequestHandler):
        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/":
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/api/sessions":
                self._json({
                    sid: {"video": s["video_path"],
                          "turns": len(s["history"])}
                    for sid, s in backend.sessions.items()
                })
            elif self.path == "/api/stats":
                self._json(latency.report())
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                return self._json({"error": "bad json"}, 400)
            try:
                t0 = time.perf_counter()
                if self.path == "/api/new_session":
                    path = payload.get("video_path", "")
                    if not os.path.exists(path):
                        return self._json(
                            {"error": f"video not found: {path}"}, 404
                        )
                    sid = backend.new_session(path)
                    latency.record("new_session", time.perf_counter() - t0)
                    return self._json({"session_id": sid})
                if self.path == "/api/chat":
                    sid = payload.get("session_id")
                    if sid not in backend.sessions:
                        return self._json({"error": "unknown session"}, 404)
                    message = payload.get("message", "")
                    if violates_moderation(message):
                        logger.info("moderation flagged message")
                        return self._json({"reply": moderation_msg,
                                           "flagged": True})
                    reply = backend.chat(sid, message)
                    latency.record("chat", time.perf_counter() - t0)
                    return self._json({"reply": reply})
                self._json({"error": "not found"}, 404)
            except Exception as err:  # surface errors to the client
                logger.exception("request failed")
                self._json({"error": repr(err)}, 500)

        def log_message(self, fmt, *args):
            logger.info("%s - " + fmt, self.client_address[0], *args)

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--model-ckpt", default=None)
    p.add_argument("--num-frames", type=int, default=100)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    p.add_argument("--log-dir", default=None,
                   help="install the rotating file logger + stdout/stderr "
                        "capture (ref utils.py:build_logger)")
    args = p.parse_args(argv)
    if args.log_dir:
        from stair_tpu_torch.serve.logutil import build_logger

        build_logger("stair_tpu_torch.serve", "demo.log",
                     log_dir=args.log_dir)
    else:
        logging.basicConfig(level=logging.INFO)

    from stair_tpu_torch.llm.videochat_infer import initialize_model

    model, tokenizer = initialize_model(_air_gapped_args(
        args.model_ckpt, args.device))
    backend = ChatBackend(model, tokenizer=tokenizer,
                          num_frames=args.num_frames)
    server = ThreadingHTTPServer(
        (args.host, args.port), make_handler(backend)
    )
    print(f"serving on http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
