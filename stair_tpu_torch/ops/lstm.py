"""Masked bidirectional LSTM (port of ``stair_tpu/ops/lstm.py``).

The input projection is hoisted out of the recurrence as one matmul
(``_prep``, as in the JAX package); only the ``[h, 4h]`` recurrent product
rides the time loop. Masked steps carry state through unchanged, so the
final forward carry is the state at the last valid token and the final
backward carry (run over reversed positions) the state at the first — the
sentence feature. Gate layout is torch's ``[i, f, g, o]``.

``bilstm`` is the kernel wrapper: for CPU tensors it runs
``bilstm_reference`` (the plain recurrence); for CUDA tensors it launches
the hand-written kernel ``csrc/bilstm.cu`` or raises.
"""

from __future__ import annotations

import math

import torch

from stair_tpu_torch.ops import _build
from stair_tpu_torch.utils.device import exact_f32


def init_lstm_params(gen, input_size: int, hidden_size: int,
                     device=None) -> dict:
    """One bidirectional layer, U(-1/sqrt(h), 1/sqrt(h)); weights stored
    ``[in, out]`` (wi [D, 4h], wh [h, 4h]) with torch's two biases."""
    bound = 1.0 / math.sqrt(hidden_size)

    def u(shape):
        x = torch.rand(shape, generator=gen, dtype=torch.float32)
        return (x * (2 * bound) - bound).to(device)

    def direction():
        return {
            "wi": u((input_size, 4 * hidden_size)),
            "wh": u((hidden_size, 4 * hidden_size)),
            "bi": u((4 * hidden_size,)),
            "bh": u((4 * hidden_size,)),
        }

    return {"fwd": direction(), "bwd": direction()}


def _prep(params, x, mask, mm_dtype=None):
    """Hoisted input projection (a plain matmul, as XLA ran it outside the
    TPU kernel).

    Returns ``(xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b)``: xp ``[B, L,
    4h]``, mask ``[B, L]`` float32, wh ``[h, 4h]``, bias ``[4h]`` float32.
    float32 mode folds both biases into xp (bias = 0); with ``mm_dtype``
    (bf16) xp is stored in bf16 WITHOUT bias and ``bi + bh`` is re-added in
    float32 at every step, so only the matmul output is rounded.
    """
    pf, pb = params["fwd"], params["bwd"]
    h = pf["wh"].shape[0]
    mask = mask.float().contiguous()
    if mm_dtype is None:
        xp_f = x @ pf["wi"] + pf["bi"] + pf["bh"]
        xp_b = x @ pb["wi"] + pb["bi"] + pb["bh"]
        zero = torch.zeros(4 * h, dtype=torch.float32, device=x.device)
        return (xp_f.contiguous(), xp_b.contiguous(), mask,
                pf["wh"].contiguous(), pb["wh"].contiguous(), zero, zero)
    xm = x.to(mm_dtype)
    xp_f = torch.matmul(xm, pf["wi"].to(mm_dtype))
    xp_b = torch.matmul(xm, pb["wi"].to(mm_dtype))
    return (xp_f.contiguous(), xp_b.contiguous(), mask,
            pf["wh"].to(mm_dtype).contiguous(),
            pb["wh"].to(mm_dtype).contiguous(),
            (pf["bi"] + pf["bh"]).float().contiguous(),
            (pb["bi"] + pb["bh"]).float().contiguous())


def bilstm_reference(xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b,
                     token_dtype=torch.float32):
    """The plain masked recurrence over ``_prep``'s outputs.

    Returns ``(tok_f, tok_b, sent)``: token halves ``[B, L, h]`` in
    ``token_dtype`` (zero at masked steps, in original position order for
    both directions) and the float32 sentence feature ``[B, 2h]`` = the two
    final carries. The recurrent matmul takes ``h`` cast to wh's dtype with
    float32 accumulation, as the JAX kernel's ``jnp.dot(h.astype(wh.dtype),
    wh, preferred_element_type=f32)``.
    """
    if xp_f.is_cuda:
        exact_f32()
    B, L, G = xp_f.shape
    h = G // 4
    valid = mask > 0
    halves, finals = [], []
    for xp, wh, bias, order in ((xp_f, wh_f, bias_f, range(L)),
                                (xp_b, wh_b, bias_b, range(L - 1, -1, -1))):
        whf = wh.float()
        hs = torch.zeros(B, h, dtype=torch.float32, device=xp.device)
        cs = torch.zeros_like(hs)
        tok = torch.empty(B, L, h, dtype=token_dtype, device=xp.device)
        for t in order:
            gates = (xp[:, t].float() + bias.float()
                     + hs.to(wh.dtype).float() @ whf)
            i, f, g, o = gates.split(h, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            g = torch.tanh(g)
            c_new = f * cs + i * g
            h_new = o * torch.tanh(c_new)
            v = valid[:, t, None]
            hs = torch.where(v, h_new, hs)
            cs = torch.where(v, c_new, cs)
            tok[:, t] = (hs * v).to(token_dtype)
        halves.append(tok)
        finals.append(hs)
    return halves[0], halves[1], torch.cat(finals, dim=-1)


def bilstm(xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b,
           token_dtype=torch.float32):
    """BiLSTM recurrence: plain version on CPU, CUDA kernel on the card.

    Same contract as ``bilstm_reference``. The kernel takes two modes:
    all-float32 (xp, wh, tokens), or all-bf16 with float32 state.
    """
    if xp_f.device.type == "cpu":
        return bilstm_reference(xp_f, xp_b, mask, wh_f, wh_b, bias_f,
                                bias_b, token_dtype)
    if not xp_f.is_cuda:
        raise ValueError(f"bilstm: unsupported device {xp_f.device}")
    dev = xp_f.device
    B, L, G = xp_f.shape
    h = G // 4
    dt = xp_f.dtype
    if dt not in (torch.float32, torch.bfloat16) or token_dtype != dt:
        raise ValueError("bilstm kernel: xp, wh and tokens must all be "
                         f"float32 or all bf16 (xp {dt}, tokens "
                         f"{token_dtype})")
    if G != 4 * h or h < 1 or h > 1024:
        raise ValueError(f"bilstm kernel: hidden size {h} not in 1..1024")
    for name, t, tdt, shape in (
        ("xp_f", xp_f, dt, (B, L, G)), ("xp_b", xp_b, dt, (B, L, G)),
        ("mask", mask, torch.float32, (B, L)),
        ("wh_f", wh_f, dt, (h, G)), ("wh_b", wh_b, dt, (h, G)),
        ("bias_f", bias_f, torch.float32, (G,)),
        ("bias_b", bias_b, torch.float32, (G,)),
    ):
        _build.check_tensor(f"bilstm {name}", t, tdt, shape, dev)
    tok_f = torch.empty(B, L, h, dtype=dt, device=dev)
    tok_b = torch.empty(B, L, h, dtype=dt, device=dev)
    sent = torch.empty(B, 2 * h, dtype=torch.float32, device=dev)
    if B == 0 or L == 0:
        return tok_f, tok_b, sent.zero_()
    lib = _build.build()
    err = lib.stair_bilstm_fwd(
        xp_f.data_ptr(), xp_b.data_ptr(), mask.data_ptr(),
        wh_f.data_ptr(), wh_b.data_ptr(), bias_f.data_ptr(),
        bias_b.data_ptr(), tok_f.data_ptr(), tok_b.data_ptr(),
        sent.data_ptr(), B, L, h, int(dt == torch.bfloat16),
        _build.stream_ptr(dev),
    )
    _build.check(err, "bilstm")
    _build.LAUNCHES["bilstm"] += 1
    return tok_f, tok_b, sent


def bilstm_forward(params, x, mask, mm_dtype=None,
                   token_dtype=torch.float32):
    """Batched BiLSTM over ``x`` [B, L, D] with ``mask`` [B, L] (the port of
    ``bilstm_pallas``). Returns ``(tokens [B, L, 2h] token_dtype, sentence
    [B, 2h] float32, (tok_f, tok_b))``."""
    tok_f, tok_b, sent = bilstm(*_prep(params, x, mask, mm_dtype),
                                token_dtype=token_dtype)
    return torch.cat([tok_f, tok_b], dim=-1), sent, (tok_f, tok_b)
