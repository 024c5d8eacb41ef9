"""Port parity: the Video-ChatGPT demo server (``stair_tpu_torch/serve/``),
weight deltas (``llm/weight_delta.py``) and the utilization arithmetic
(``utils/mfu.py``).

The demo as ``tests/test_serve.py`` runs the JAX one, on the tiny
random-init model of the air-gapped CLI (``--device cpu``): a GIF written
here from a seed, sessions, chat, stats, moderation, unknown sessions and
videos, bad JSON; every answer's JSON keys and status equal to the JAX
demo's on the same requests; a chat turn's token ids and reply equal to
a direct ``model.generate`` with the same prompt and generator seed; ``new_session``
(decode) equal to ``open_frames`` on the decoded frames; ``build_logger``'s
rotating file and the fail-open moderation hook of the copied
``logutil.py``.

Weight deltas cross between the packages both ways (flax's
``serialization`` against the port's codec), byte for byte, with float32,
bf16, new and reshaped leaves, through the functions and the CLIs.

``flops_of`` counts ``2 M N K`` for a matmul (and the backward's two
products); ``mfu`` / ``format_mfu`` give the JAX package's figures for the
same peak; the peaks table answers the H100's name with the data sheet's
numbers and an unknown card with None.
"""

import json
import logging
import threading
import urllib.request

import numpy as np
import pytest
import torch

from stair_tpu_torch.llm import weight_delta as TWD
from stair_tpu_torch.serve import demo as TD
from stair_tpu_torch.serve import logutil as TLU
from stair_tpu_torch.train.checkpoint import from_bytes, to_bytes
from stair_tpu_torch.utils import mfu as TMFU

jax = pytest.importorskip("jax")

import ml_dtypes  # noqa: E402
from flax import serialization  # noqa: E402

from stair_tpu.llm import weight_delta as JWD  # noqa: E402
from stair_tpu.utils import mfu as JMFU  # noqa: E402


def _serve(backend):
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), TD.make_handler(
        backend, TD.LatencyTracker()) if isinstance(backend, TD.ChatBackend)
        else _jax_handler(backend))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd


def _jax_handler(backend):
    from stair_tpu.serve.demo import LatencyTracker, make_handler

    return make_handler(backend, LatencyTracker())


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    import imageio.v3 as iio

    from stair_tpu.serve.demo import ChatBackend as JChatBackend

    tmp = tmp_path_factory.mktemp("serve")
    rng = np.random.RandomState(0)
    clip = (rng.rand(8, 48, 64, 3) * 255).astype(np.uint8)
    video = str(tmp / "v.gif")
    iio.imwrite(video, clip, loop=0)
    port_backend = TD.ChatBackend(num_frames=4, device="cpu")
    both = {"port": _serve(port_backend),
            "jax": _serve(JChatBackend(num_frames=4))}
    yield {"ports": {k: s.server_address[1] for k, s in both.items()},
           "video": video, "backend": port_backend}
    for s in both.values():
        s.shutdown()


def _post(port, path, payload):
    data = payload if isinstance(payload, bytes) else json.dumps(
        payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="POST")
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as resp:
            body = resp.read()
            kind = resp.headers["Content-Type"]
            return resp.status, (json.loads(body) if kind ==
                                 "application/json" else body.decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _shape(obj):
    """The JSON's shape: its keys (recursively) and value types."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    return type(obj).__name__


def test_demo_http_flow_answers_as_the_jax_demo(servers, monkeypatch):
    monkeypatch.delenv("MODERATION_API_URL", raising=False)
    monkeypatch.delenv("MODERATION_BLOCKLIST", raising=False)
    video = servers["video"]
    seen = {}
    for name, port in servers["ports"].items():
        got = []
        code, out = _post(port, "/api/new_session", {"video_path": video})
        assert code == 200 and "session_id" in out
        sid = out["session_id"]
        got.append((code, _shape(out)))
        for msg in ("what did they do ?", "question video"):
            code, out = _post(port, "/api/chat",
                              {"session_id": sid, "message": msg})
            assert code == 200 and isinstance(out["reply"], str)
            got.append((code, _shape(out)))
        monkeypatch.setenv("MODERATION_BLOCKLIST", "forbiddenword, other")
        code, out = _post(port, "/api/chat",
                          {"session_id": sid, "message": "say ForbiddenWORD"})
        assert out == {"reply": TLU.moderation_msg, "flagged": True}
        got.append((code, _shape(out)))
        monkeypatch.delenv("MODERATION_BLOCKLIST")
        code, stats = _get(port, "/api/stats")
        assert stats["chat"]["count"] == 2
        assert stats["chat"]["p99_ms"] >= stats["chat"]["p50_ms"] > 0
        assert stats["new_session"]["count"] == 1
        got.append((code, _shape(stats)))
        code, sessions = _get(port, "/api/sessions")
        assert sessions[sid] == {"video": video, "turns": 2}
        got.append((code, {"sid": _shape(sessions[sid])}))
        for path, payload in (("/api/chat", {"session_id": "nope"}),
                              ("/api/new_session", {"video_path": "/no.mp4"}),
                              ("/api/nothing", {}), ("/api/chat", b"{bad")):
            code, out = _post(port, path, payload)
            got.append((code, _shape(out)))
        got.append(_get(port, "/api/nothing"))
        code, page = _get(port, "/")
        assert code == 200 and "video chat" in page
        seen[name] = got
    assert seen["port"] == seen["jax"]
    assert [c for c, _ in seen["port"][-5:]] == [404, 404, 404, 400, 404]


def test_chat_equals_a_direct_generate_and_open_frames_new_session(servers):
    from stair_tpu_torch.llm.frames import load_video_frames
    from stair_tpu_torch.llm.videochat import KeywordsStoppingCriteria
    from stair_tpu_torch.llm.videochat_infer import build_prompt_batch

    backend = servers["backend"]
    sid = backend.new_session(servers["video"])
    frames = load_video_frames(servers["video"], backend.num_frames)
    sid2 = backend.open_frames(frames, servers["video"])
    assert torch.equal(backend.sessions[sid]["video_tokens"],
                       backend.sessions[sid2]["video_tokens"])
    # the token ids each turn generates (the tiny tokenizer reads most of
    # the random model's ids as <unk>)
    served = []
    generate = backend.model.generate
    backend.model.generate = lambda *a, **k: served.append(
        generate(*a, **k)) or served[-1]
    try:
        replies = [backend.chat(sid, "what did they do ?") for _ in range(2)]
    finally:
        del backend.model.generate
    ids, start, plen, stop = build_prompt_batch(
        backend.model, backend.tokenizer, ["what did they do ?"])
    assert ids.shape[1] % 128 == 0 and int(plen) + 64 <= ids.shape[1]
    for turn, reply in enumerate(replies):
        toks = backend.model.generate(
            ids, backend.sessions[sid]["video_tokens"][None], start,
            prompt_len=plen, max_new_tokens=64, temperature=0.2,
            generator=torch.Generator().manual_seed(turn),
            eos_id=backend.tokenizer.eos_token_id)
        assert torch.equal(served[turn], toks)
        want = KeywordsStoppingCriteria([stop], backend.tokenizer, 0).truncate(
            backend.tokenizer.decode(toks[0].numpy()))
        assert reply == want
    assert backend.sessions[sid]["history"] == [
        ("what did they do ?", r) for r in replies]


def test_chat_hands_generate_what_the_jax_demo_hands_it():
    """Both demos' ``chat`` on the same session and messages: the prompt
    each hands ``generate`` (token ids with the placeholder block, splice
    start, prompt length, the Lmax rounding), its sampling options and the
    turn's seed, and the reply each decodes from the same generated ids."""
    from stair_tpu.serve.demo import ChatBackend as JChatBackend

    msgs = ("what did they do ?", "question answer video")
    sides = {"jax": JChatBackend(num_frames=4),
             "port": TD.ChatBackend(num_frames=4, device="cpu")}
    seen = {}
    for name, backend in sides.items():
        cfg = backend.model.config
        tok = backend.tokenizer
        out_ids = np.asarray([tok.encode("what did they do ? video")])
        if name == "port":
            out_ids = torch.from_numpy(out_ids)
        calls = []

        def generate(*a, _calls=calls, _out=out_ids, **k):
            a = a[-3:]                     # the JAX model takes params first
            token_ids, video, start = (np.asarray(x) for x in a)
            seed = (int(k["rng"][1]) if "rng" in k
                    else k["generator"].initial_seed())
            _calls.append((token_ids.astype(np.int64), video.shape,
                           start.astype(np.int64),
                           np.asarray(k["prompt_len"]).astype(np.int64),
                           k["max_new_tokens"], k["temperature"],
                           k["eos_id"], seed))
            return _out

        backend.model.generate = generate
        zeros = np.zeros((cfg.video_token_len, cfg.vision.d_model),
                         np.float32)
        backend.sessions["s"] = {
            "video_path": "", "history": [],
            "video_tokens": zeros if name == "jax" else torch.from_numpy(
                zeros)}
        replies = [backend.chat("s", m) for m in msgs]
        seen[name] = (calls, replies)
    (jcalls, jreplies), (pcalls, preplies) = seen["jax"], seen["port"]
    assert preplies == jreplies == ["what did they do ? video"] * 2
    assert len(pcalls) == len(jcalls) == len(msgs)
    for turn, (jc, pc) in enumerate(zip(jcalls, pcalls)):
        np.testing.assert_array_equal(pc[0], jc[0])     # token ids, Lmax
        assert pc[0].shape[1] % 128 == 0
        assert pc[1] == jc[1] == (1,) + zeros.shape
        np.testing.assert_array_equal(pc[2], jc[2])     # splice start
        np.testing.assert_array_equal(pc[3], jc[3])     # prompt length
        assert pc[4:] == jc[4:] == (64, 0.2, jc[6], turn)


def test_backend_loads_a_params_tree(servers):
    from stair_tpu_torch.weights import params_to_numpy

    model = servers["backend"].model
    other = TD.ChatBackend(num_frames=4, device="cpu")
    for p in other.model.parameters():
        torch.nn.init.zeros_(p)
    held = TD.ChatBackend(other.model, params=params_to_numpy(model),
                          tokenizer=other.tokenizer)
    for a, b in zip(held.model.parameters(), model.parameters()):
        assert torch.equal(a, b)


def test_build_logger_rotating_file(tmp_path):
    TLU._handler = None
    logger = TLU.build_logger("stair_tpu_torch.test", "t.log",
                              log_dir=str(tmp_path), redirect_streams=False)
    logger.info("hello rotating")
    for h in logging.getLogger().handlers:
        h.flush()
    content = (tmp_path / "t.log").read_text()
    assert "hello rotating" in content and "| INFO |" in content
    root = logging.getLogger()
    if TLU._handler is not None:
        for item in list(logging.root.manager.loggerDict.values()):
            if isinstance(item, logging.Logger):
                item.removeHandler(TLU._handler)
        root.removeHandler(TLU._handler)
        TLU._handler = None


def test_violates_moderation_fail_open(monkeypatch):
    from stair_tpu.serve.logutil import violates_moderation

    monkeypatch.delenv("MODERATION_API_URL", raising=False)
    for blocklist in ("", "forbiddenword, other"):
        monkeypatch.setenv("MODERATION_BLOCKLIST", blocklist)
        for text in ("anything at all", "say ForbiddenWORD now", "x OTHER"):
            assert TLU.violates_moderation(text) == violates_moderation(text)
    monkeypatch.delenv("MODERATION_BLOCKLIST")
    monkeypatch.setenv("MODERATION_API_URL", "http://127.0.0.1:1/x")
    assert TLU.violates_moderation("anything") is False


# ---------------------------------------------------------------------------
# weight deltas
# ---------------------------------------------------------------------------

def _trees(seed=0):
    rng = np.random.RandomState(seed)
    bf = ml_dtypes.bfloat16
    base = {"decoder": {"layers": {"0": {
                "q": {"w": rng.randn(4, 6).astype(np.float32)},
                "ln": {"scale": rng.randn(6).astype(bf)}}},
                "embed": rng.randn(10, 6).astype(np.float32)},
            "mm_projector": {"w": rng.randn(3, 6).astype(np.float32)}}
    tuned = {"decoder": {"layers": {"0": {
                "q": {"w": rng.randn(4, 6).astype(np.float32),
                      "lora_a": rng.randn(4, 2).astype(np.float32)},
                "ln": {"scale": rng.randn(6).astype(bf)}}},
                "embed": rng.randn(12, 6).astype(np.float32)},
             "mm_projector": {"w": rng.randn(3, 6).astype(np.float32)}}
    return serialization.msgpack_serialize(base), \
        serialization.msgpack_serialize(tuned)


def test_weight_delta_crosses_the_packages_both_ways():
    base, tuned = _trees()
    jr = serialization.msgpack_restore
    j_delta = serialization.msgpack_serialize(JWD.make_delta(jr(base),
                                                             jr(tuned)))
    t_delta = to_bytes(TWD.make_delta(from_bytes(base), from_bytes(tuned)))
    assert t_delta == j_delta
    # the port applies JAX's delta and JAX applies the port's: the
    # fine-tune back, byte for byte, either way
    t_back = to_bytes(TWD.apply_delta(from_bytes(base), from_bytes(j_delta)))
    j_back = serialization.msgpack_serialize(JWD.apply_delta(
        jr(base), jr(t_delta)))
    assert t_back == j_back
    want = jr(tuned)["decoder"]["layers"]["0"]["q"]["w"]
    got = from_bytes(t_back)["decoder"]["layers"]["0"]["q"]["w"]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert from_bytes(t_back)["decoder"]["embed"].shape == (12, 6)


def test_weight_delta_clis_cross(tmp_path):
    base, tuned = _trees(1)
    (tmp_path / "base.msgpack").write_bytes(base)
    (tmp_path / "tuned.msgpack").write_bytes(tuned)
    common = ["--base", str(tmp_path / "base.msgpack")]
    TWD.main(["--func", "make", *common, "--target",
              str(tmp_path / "tuned.msgpack"), "--output",
              str(tmp_path / "t.delta")])
    JWD.main(["--func", "make", *common, "--target",
              str(tmp_path / "tuned.msgpack"), "--output",
              str(tmp_path / "j.delta")])
    assert (tmp_path / "t.delta").read_bytes() == \
        (tmp_path / "j.delta").read_bytes()
    JWD.main(["--func", "apply", *common, "--target",
              str(tmp_path / "t.delta"), "--output", str(tmp_path / "j.out")])
    TWD.main(["--func", "apply", *common, "--target",
              str(tmp_path / "j.delta"), "--output", str(tmp_path / "t.out")])
    assert (tmp_path / "t.out").read_bytes() == \
        (tmp_path / "j.out").read_bytes()


def test_params_tree_of_a_module_writes_flax_layout():
    from stair_tpu_torch.llm.decoder import Decoder, DecoderConfig

    model = Decoder(DecoderConfig.llama(vocab_size=20, d_model=8,
                                        num_heads=2, num_layers=2, d_ff=16,
                                        max_len=16),
                    generator=torch.Generator().manual_seed(0))
    tree = TWD.params_tree(model)
    restored = serialization.msgpack_restore(to_bytes(tree))
    assert set(restored["layers"]) == {"0", "1"}
    delta = TWD.make_delta(tree, tree)
    assert all(not np.any(v) for v in TWD._flat(delta).values())


# ---------------------------------------------------------------------------
# utilization arithmetic
# ---------------------------------------------------------------------------

def test_flops_of_a_matmul_is_2mnk():
    M, K, N = 8, 16, 4
    a, b = torch.randn(M, K), torch.randn(K, N)
    assert TMFU.flops_of(torch.matmul, a, b) == 2 * M * N * K
    w = torch.randn(K, N, requires_grad=True)
    # forward and backward (the input needs no gradient: one product)
    assert TMFU.flops_of(lambda: (a @ w).sum().backward()) == 2 * (
        2 * M * N * K)
    assert TMFU.flops_of(lambda: a + 1) is None


def test_mfu_arithmetic_matches_jax(monkeypatch):
    h100 = "NVIDIA H100 80GB HBM3"
    assert TMFU.chip_peak_flops(h100) == 989e12
    assert TMFU.chip_peak_hbm_bw(h100) == 3.35e12
    assert TMFU.chip_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert TMFU.chip_peak_flops("some card") is None
    assert TMFU.chip_peak_flops(torch.device("cpu")) is None
    monkeypatch.setitem(JMFU._PEAK_BF16, h100, 989e12)

    class Dev:
        device_kind = h100

    for flops, secs in ((3.2e12, 0.01), (5e9, 2.5), (None, 1.0), (1e9, 0)):
        assert TMFU.mfu(flops, secs, h100) == JMFU.mfu(flops, secs, Dev())
        want = JMFU.format_mfu(flops, secs, Dev())
        got = TMFU.format_mfu(flops, secs, h100)
        assert got == want.replace("no cost analysis", "no flop count")
    assert TMFU.format_mfu(1e12, 1.0, "some card") == \
        "achieved 1.0 TFLOP/s (peak unknown)"
