"""Port parity: the executor's training pair (stair_tpu_torch/ops/
mega_exec.py ``mega_exec_train_call``, stair_tpu_torch/ops/mega_grad.py).

``hash_keep`` is bit-exact against JAX's over shapes, seeds (near 2^31
too), examples, steps and sites. ``mega_exec_train`` (the autograd Function
over the training forward and the plain backward) is held against the JAX
package's ``mega_exec_train(..., interpret=True)`` (TPU kernels #5 and #6
under the Pallas interpreter) on the same numpy inputs and weights: at
dropout 0.25 with the same seed the masks are bit-exact, so the register
files match at float32 tolerance (rtol/atol 1e-4), and so do every data
cotangent and every weight gradient (rtol 1e-4 of each tensor's largest
value, with a 1e-6 floor for gradients that are 0 in exact arithmetic),
over every opcode, for both Filter modes and both temporal modes.
Two cases pin the |x| slope at 0 (XOR / XORFRAME with equal operands) and
the min tie split (AND_VEC / AND_ATTN). The CUDA kernels are held against
the plain versions on the card.
"""

import collections
import os
import re

import numpy as np
import pytest
import torch

from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN, tree_map
from stair_tpu_torch.ops import _build
from stair_tpu_torch.ops import mega_exec as TX
from stair_tpu_torch.ops import mega_grad as TG
from stair_tpu_torch.testing import workload as TW
from test_torch_mega_exec import FWD_ROUTE_CASES
from torch_port_util import cuda_device, port_model  # noqa: F401

try:
    import jax
    import jax.numpy as jnp

    from stair_tpu.ops import mega_exec as JX
    from stair_tpu.ops import mega_grad as JG
    from test_mega_exec import PROGRAMS, _batch, _build as _jbuild
except ImportError:  # the GPU machine has no JAX: only cuda tests run there
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="JAX not installed")


@needs_jax
@pytest.mark.parametrize("shape,b,t,site,seed0,seed1,rate", [
    ((16, 32), 3, 5, 0, 123, 456, 0.25),
    ((1, 64), 127, 12, 7, 2 ** 31 - 2, 2 ** 31 - 1, 0.5),
    ((48, 16), 0, 0, 3, -5, 7, 0.1),
    ((8, 512), 1023, 31, 2, 2 ** 31 - 1, -2 ** 31, 0.25),
])
def test_hash_keep_bit_exact_vs_jax(shape, b, t, site, seed0, seed1, rate):
    ref = np.asarray(JX.hash_keep(shape, jnp.int32(b), jnp.int32(t), site,
                                  jnp.int32(seed0), jnp.int32(seed1), rate))
    out = TX.hash_keep(shape, b, t, site, seed0, seed1, rate).numpy()
    assert ref.dtype == out.dtype and np.array_equal(ref, out)
    many = TX.hash_keep(shape, torch.tensor([b, 0]), t, site, seed0, seed1,
                        rate)
    assert np.array_equal(many[0].numpy(), ref)


def _train_parity(F, attention, programs, rate, seed_data=1):
    """Forward and every gradient of the port's training executor vs JAX's
    megakernel pair under the interpreter."""
    cfg, model, params = _jbuild(max_video_length=F,
                                 filter_attention=attention)
    batch, _ = _batch(cfg, programs, seed=seed_data)
    rng = np.random.RandomState(0)
    B, L = batch["video"].shape[0], batch["question"].shape[1]
    Hh = cfg.hidden_size // 2
    halves = [rng.randn(B, n, Hh).astype(np.float32) for n in (F, F, L, L)]
    seed = (12345, 2 ** 31 - 7)
    trace = batch["trace"]

    def jf(vfa, vfb, toka, tokb, mods):
        return JG.mega_exec_train(
            cfg, mods, model._fused_tables(mods),
            {k: jnp.asarray(v) for k, v in trace.items()}, (vfa, vfb),
            jnp.asarray(batch["video_mask"]), (toka, tokb),
            jnp.asarray(batch["question_mask"]), rate,
            jnp.asarray(seed, jnp.int32), interpret=True)

    outs, vjp = jax.vjp(jf, *[jnp.asarray(h) for h in halves],
                        params["modules"])
    cots = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))

    pm = port_model(cfg, params)
    mods = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                    pm.param_tree()["modules"])
    th = [torch.from_numpy(h).requires_grad_(True) for h in halves]
    tout = TG.mega_exec_train(
        pm.config, mods, pm._fused_tables(mods),
        {k: torch.from_numpy(v) for k, v in trace.items()}, (th[0], th[1]),
        torch.from_numpy(batch["video_mask"]), (th[2], th[3]),
        torch.from_numpy(batch["question_mask"]), rate, seed)
    for name, j, t in zip(("regs_vec", "regs_frames", "regs_attn"), outs,
                          tout):
        np.testing.assert_allclose(np.asarray(j), t.detach().numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    torch.autograd.backward(tout, [torch.from_numpy(c) for c in cots])

    def check(a, b, name):
        a = np.asarray(a)
        scale = max(np.abs(a).max(), 1e-6)
        # 1e-6 absolute floor: gradients that vanish in exact arithmetic
        # (the softmax Filter's keyword bias, a shift of every logit) are
        # float32 rounding noise of about 1e-8 on both sides.
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * scale + 1e-6, err_msg=name)

    for i, name in enumerate(("vf_a", "vf_b", "tok_a", "tok_b")):
        check(jgrads[i], th[i].grad.numpy(), name)

    def walk(j, t, path):
        if isinstance(j, dict):
            for k in j:
                walk(j[k], t[k], f"{path}/{k}")
        else:
            g = t.grad if t.grad is not None else torch.zeros_like(t)
            check(j, g.numpy(), path)

    walk(jgrads[4], mods, "modules")


@needs_jax
@pytest.mark.parametrize("F,attention", [(16, "parity"), (48, "softmax"),
                                         (150, "softmax")])
def test_mega_exec_train_matches_jax_at_dropout(F, attention):
    _train_parity(F, attention, PROGRAMS, rate=0.25)


@needs_jax
@pytest.mark.parametrize("F,attention", [(48, "parity"), (16, "softmax")])
def test_mega_exec_train_grads_match_jax_other_modes(F, attention):
    progs = PROGRAMS[12:21] if attention == "parity" else PROGRAMS[17:]
    _train_parity(F, attention, progs, rate=0.25, seed_data=2)


@needs_jax
def test_abs_slope_and_min_ties_follow_jax():
    """Equal operands: |x| takes slope +1 at 0 (XOR, XORFRAME) and min
    splits its cotangent 0.5 / 0.5 (AND_VEC, AND_ATTN); dropout off, so
    the two HasItem attentions are equal bit for bit."""
    progs = [
        (["Xor", "cup", "cup"], {}),
        (["And", "cup", "cup"], {}),
        (["Xor", "HasItem", "video", "HasItem", "video"], {}),
        (["And", "HasItem", "video", "HasItem", "video"], {}),
    ]
    _train_parity(16, "parity", progs, rate=0.0)


@needs_jax
@pytest.mark.parametrize("F,attention", [(16, "parity"), (48, "softmax"),
                                         (150, "parity")])
def test_mega_bwd_reference_at_files_matches_jax_kernel(F, attention):
    """The JAX backward kernel #6 (``backward_call``, interpreted) reads
    every register value from the files it is handed. Handed files that
    are not its forward's own (the plain forward's plus noise), it agrees
    with the plain backward ``at_files`` within 1e-4 of each gradient's
    scale, and not with the plain backward through its own forward."""
    cfg, model, params = _jbuild(max_video_length=F,
                                 filter_attention=attention)
    batch, _ = _batch(cfg, PROGRAMS, seed=1)
    rng = np.random.RandomState(0)
    B, L = batch["video"].shape[0], batch["question"].shape[1]
    Hh = cfg.hidden_size // 2
    halves = [rng.randn(B, n, Hh).astype(np.float32) for n in (F, F, L, L)]
    trace = batch["trace"]
    rate, seed = 0.25, (12345, 2 ** 31 - 7)
    jmeta, jargs = JX.prepare_args(
        cfg, params["modules"], model._fused_tables(params["modules"]),
        {k: jnp.asarray(v) for k, v in trace.items()},
        tuple(jnp.asarray(h) for h in halves[:2]),
        jnp.asarray(batch["video_mask"]),
        tuple(jnp.asarray(h) for h in halves[2:]),
        jnp.asarray(batch["question_mask"]))
    pm = port_model(cfg, params)
    mods = tree_map(lambda x: x.detach(), pm.param_tree()["modules"])
    meta, args = TX.prepare_args(
        pm.config, mods, pm._fused_tables(mods),
        {k: torch.from_numpy(v) for k, v in trace.items()},
        tuple(torch.from_numpy(h) for h in halves[:2]),
        torch.from_numpy(batch["video_mask"]),
        tuple(torch.from_numpy(h) for h in halves[2:]),
        torch.from_numpy(batch["question_mask"]))
    outs = TX.mega_exec_reference(meta, args, rate, seed)
    gen = torch.Generator().manual_seed(3)
    files = tuple(o + 0.05 * torch.randn(o.shape, generator=gen) * (o != 0)
                  for o in outs)
    cots = [torch.randn(o.shape, generator=gen) for o in outs]
    jg = JG.backward_call(jmeta, rate, jnp.asarray(seed, jnp.int32), jargs,
                          tuple(jnp.asarray(f.numpy()) for f in files),
                          tuple(jnp.asarray(c.numpy()) for c in cots),
                          interpret=True)
    names = ("dvf_a", "dvf_b", "dtok_a", "dtok_b", "daux") + \
        TX.ARG_NAMES[TG.N_DATA:]
    for at in (True, False):
        tg = TG.mega_exec_bwd_reference(meta, args, files, cots, rate, seed,
                                        at_files=at)
        close = []
        for name, j, t in zip(names, jg, tg):
            j, t = np.asarray(j), t.numpy()
            # the tolerance of _train_parity's check
            tol = dict(rtol=1e-4, atol=1e-4 * max(np.abs(j).max(), 1e-6)
                       + 1e-6)
            if at:
                np.testing.assert_allclose(j, t, err_msg=name, **tol)
            close.append(np.allclose(t, j, **tol))
        assert all(close) == at


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mega_bwd_reference_at_own_files_is_default(dtype):
    """Handed the forward's own files, the plain backward at the files
    gives the default's bits, over every opcode at dropout 0.25."""
    cfg = NMNConfig(
        hidden_size=32, video_size=12, text_size=10, answer_vocab_length=7,
        max_video_length=16, object_types=3, max_steps=16, num_vec=10,
        num_frames=6, num_attn=8,
        compute_dtype="float32" if dtype == torch.float32 else "bfloat16")
    model = TW.build_model(cfg, seed=1)
    batch = TW.to_device(TW.opcode_batch(cfg, TW.OPCODE_PROGRAMS, seed=8))
    gen = torch.Generator().manual_seed(0)
    B, L = batch["question"].shape[:2]
    halves = [torch.randn(B, n, 16, generator=gen).to(dtype)
              for n in (16, 16, L, L)]
    mods = tree_map(lambda x: x.detach().to(dtype),
                    model.param_tree()["modules"])
    meta, args = TX.prepare_args(
        cfg, mods, VideoNMN._fused_tables(mods), batch["trace"], halves[:2],
        batch["video_mask"], halves[2:], batch["question_mask"])
    seed = (123, 456)
    out = TX.mega_exec_train_call(meta, args, 0.25, seed)
    for a, b in zip(out, TX.mega_exec_reference(meta, args, 0.25, seed,
                                                files=out)):
        assert torch.equal(a, b)
    cots = [torch.randn(o.shape, generator=gen) for o in out]
    ref = TG.mega_exec_bwd_reference(meta, args, out, cots, 0.25, seed)
    at = TG.mega_exec_bwd_reference(meta, args, out, cots, 0.25, seed,
                                    at_files=True)
    for a, b in zip(ref, at):
        assert torch.equal(a, b)


def test_mega_train_wrappers_route_cpu_to_plain_and_reject_others():
    cfg = NMNConfig(hidden_size=16, video_size=8, text_size=6,
                    max_video_length=8, max_steps=16, num_vec=10,
                    num_frames=6, num_attn=8)
    model = TW.build_model(cfg, seed=0)
    batch = TW.to_device(TW.opcode_batch(cfg, TW.OPCODE_PROGRAMS[:6]))
    B, L = batch["question"].shape[:2]
    halves = [torch.randn(B, n, 8) for n in (8, 8, L, L)]
    mods = tree_map(lambda x: x.detach(), model.param_tree()["modules"])
    meta, args = TX.prepare_args(
        cfg, mods, model._fused_tables(mods), batch["trace"], halves[:2],
        batch["video_mask"], halves[2:], batch["question_mask"])
    seed = (3, 4)
    out = TX.mega_exec_train_call(meta, args, 0.25, seed)
    for a, b in zip(out, TX.mega_exec_reference(meta, args, 0.25, seed)):
        assert torch.equal(a, b)
    cots = [torch.ones_like(o) for o in out]
    grads = TG.mega_exec_bwd_call(meta, args, out, cots, 0.25, seed)
    ref = TG.mega_exec_bwd_reference(meta, args, out, cots, 0.25, seed)
    assert len(grads) == 5 + len(TX.ARG_NAMES) - TG.N_DATA
    for a, b in zip(grads, ref):
        assert torch.equal(a, b)
    on_meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError):
        TX.mega_exec_train_call(meta, on_meta, 0.25, seed)
    with pytest.raises(ValueError):
        TG.mega_exec_bwd_call(meta, on_meta, out, cots, 0.25, seed)


def test_kernels_take_detached_tensors_only():
    """The wrappers' tensor check refuses a tensor that requires grad, and
    says that gradients go through the autograd Functions."""
    dev = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="expected a tensor on cuda"):
        _build.check_tensor("x", torch.zeros(2), torch.float32, (2,), dev)
    # A CUDA tensor that requires grad, stood in for on a CPU-only machine.
    fake = type("T", (), {"is_cuda": True, "device": dev,
                          "dtype": torch.float32, "shape": (2,),
                          "is_contiguous": lambda self: True,
                          "requires_grad": True})()
    with pytest.raises(ValueError, match="autograd Functions"):
        _build.check_tensor("x", fake, torch.float32, (2,), dev)


def test_executor_size_limits_have_one_home():
    """MAX_H / MAX_F / MAX_L, and the tensor-core route's two frame limits
    (TC_MAX_F, the rows a CTA's bf16 tiles hold, 64; TC_ROUTE_MAX_F, the
    largest F it takes, 256) with its smallest F, live in
    csrc/mega_limits.cuh only; the Python wrappers read them from there, and
    no kernel source redefines them."""
    csrc = os.path.join(os.path.dirname(_build.__file__), "csrc")
    with open(os.path.join(csrc, "mega_limits.cuh")) as f:
        text = f.read()
    header = dict(re.findall(r"constexpr int (MAX_\w+) = (\d+);", text))
    assert {k: int(v) for k, v in header.items()} == {
        "MAX_H": TX.MAX_H, "MAX_F": TX.MAX_F, "MAX_L": TX.MAX_L}
    tc = dict(re.findall(r"constexpr int (TC_\w*_F) = (\d+);", text))
    assert {k: int(v) for k, v in tc.items()} == {
        "TC_MAX_F": TX.TC_MAX_F, "TC_MIN_F": TX.TC_MIN_F,
        "TC_ROUTE_MAX_F": TX.TC_ROUTE_MAX_F}
    assert (TX.TC_MIN_F, TX.TC_MAX_F, TX.TC_ROUTE_MAX_F) == (16, 64, 256)
    for name in os.listdir(csrc):
        if name.endswith((".cu", ".cuh")) and name != "mega_limits.cuh":
            with open(os.path.join(csrc, name)) as f:
                src = f.read()
            assert not re.search(r"constexpr int MAX_[HFL]\b", src), name
            assert not re.search(r"constexpr int TC_\w*_F\b", src), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F,attention", [(16, "parity"), (48, "softmax")])
def test_mega_train_kernels_vs_plain_on_card(cuda_device, dtype, F,
                                             attention):
    """Training forward and backward kernels vs the plain versions over
    every opcode at dropout 0.25; the backward twice gives identical bits.
    float32 at 1e-4 of each gradient's scale; bf16 within 1e-1 (the kernel
    rounds cotangents at the JAX kernel's sites, autograd at the
    forward's casts); the softmax Filter's fltk/fltb gradients, 0 in exact
    arithmetic, within 1e-3 of the fltw gradient's scale."""
    cfg = NMNConfig(
        hidden_size=64, video_size=24, text_size=20, answer_vocab_length=7,
        max_video_length=F, object_types=3, max_steps=16, num_vec=10,
        num_frames=6, num_attn=8, filter_attention=attention,
        compute_dtype="float32" if dtype == torch.float32 else "bfloat16")
    model = TW.build_model(cfg, seed=1, device=cuda_device)
    batch = TW.to_device(TW.opcode_batch(cfg, TW.OPCODE_PROGRAMS, seed=8),
                         cuda_device)
    gen = torch.Generator().manual_seed(0)
    B, L = batch["question"].shape[:2]
    halves = [torch.randn(B, n, 32, generator=gen).to(cuda_device, dtype)
              for n in (F, F, L, L)]
    mods = tree_map(lambda x: x.detach().to(dtype),
                    model.param_tree()["modules"])
    meta, args = TX.prepare_args(
        cfg, mods, VideoNMN._fused_tables(mods), batch["trace"], halves[:2],
        batch["video_mask"], halves[2:], batch["question_mask"])
    seed = (123, 456)
    out = TX.mega_exec_train_call(meta, args, 0.25, seed)
    ref = TX.mega_exec_reference(meta, args, 0.25, seed)
    ftol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 3e-2)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=ftol[0],
                                   atol=ftol[1])
    cots = [torch.randn(o.shape, generator=gen).to(cuda_device) for o in out]
    k1 = TG.mega_exec_bwd_call(meta, args, out, cots, 0.25, seed)
    k2 = TG.mega_exec_bwd_call(meta, args, out, cots, 0.25, seed)
    rb = TG.mega_exec_bwd_reference(meta, args, out, cots, 0.25, seed)
    bound = 1e-4 if dtype == torch.float32 else 1e-1
    names = ("dvf_a", "dvf_b", "dtok_a", "dtok_b", "daux") + \
        TX.ARG_NAMES[TG.N_DATA:]
    grads = dict(zip(names, rb))
    for name, a, b, r in zip(names, k1, k2, rb):
        assert torch.equal(a, b), name
        if attention == "softmax" and name in ("fltk", "fltb"):
            # a shift of every logit of one softmax: 0 in exact arithmetic,
            # float32 noise on both sides, bounded against the Filter
            # logit weights' gradient
            ref = float(grads["fltw"].float().abs().max())
            assert float(a.float().abs().max()) <= 1e-3 * ref, name
            continue
        scale = max(float(r.float().abs().max()), 1e-12)
        assert float((a.float() - r.float()).abs().max()) <= bound * scale, \
            name


# The backward's route, chosen before any launch: the tensor-core walk and
# weight-gradient kernels take bf16 at the widths mega_exec.tc_route_shape
# takes (H a multiple of 64 in [64, 512], any F in [16, 256]); the
# "fma32" kernels take float32 at the widths mega_exec.fma32_shape takes (H
# a multiple of 128 in [128, 512], any F in [16, 256]); every other width
# takes the general kernels.
BWD_ROUTE_CASES = [
    (torch.bfloat16, 512, 64, "tc"), (torch.float32, 512, 64, "fma32"),
    (torch.bfloat16, 64, 16, "tc"), (torch.bfloat16, 192, 48, "tc"),
    (torch.bfloat16, 32, 16, "general"), (torch.bfloat16, 160, 16, "general"),
    (torch.bfloat16, 576, 64, "general"), (torch.bfloat16, 512, 24, "tc"),
    (torch.bfloat16, 512, 80, "tc"), (torch.float32, 64, 16, "general"),
    (torch.float32, 128, 16, "fma32"), (torch.float32, 256, 48, "fma32"),
    (torch.float32, 96, 16, "general"), (torch.float32, 1024, 64, "general"),
    (torch.float32, 512, 8, "general"), (torch.float32, 512, 100, "fma32"),
    (torch.float32, 320, 64, "general"), (torch.float32, 512, 150, "fma32"),
    (torch.float32, 512, 256, "fma32"), (torch.float32, 512, 257, "general"),
    (torch.float32, 256, 72, "fma32"), (torch.bfloat16, 512, 150, "tc"),
    (torch.bfloat16, 512, 72, "tc"), (torch.bfloat16, 512, 256, "tc"),
    (torch.bfloat16, 512, 257, "general"), (torch.bfloat16, 512, 8, "general"),
    (torch.bfloat16, 1024, 150, "general"),
]


@pytest.mark.parametrize(
    "dtype,H,F,route", BWD_ROUTE_CASES,
    ids=[f"{str(d)[6:]}-H{h}-F{f}" for d, h, f, _ in BWD_ROUTE_CASES])
def test_mega_bwd_route_choice(dtype, H, F, route):
    assert TG.bwd_route(dtype, H, F) == route


#: the widths of the forward's route cases
FWD_WIDTHS = sorted({(h, f) for _, h, f, _, _ in FWD_ROUTE_CASES})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,F", FWD_WIDTHS,
                         ids=[f"H{h}-F{f}" for h, f in FWD_WIDTHS])
def test_mega_bwd_route_follows_fwd_route(dtype, H, F):
    """The backward takes the training forward's route at every width, so
    that each walk is handed (and recomputes) its own route's forward."""
    assert TG.bwd_route(dtype, H, F) == TX.fwd_route(dtype, H, F, True)


def test_mega_bwd_tc_shared_memory_fits():
    """The walk's shared memory on the tensor-core route (its vectors, laid
    out at the route's largest H and F, then a row slice's bf16 operand
    tile, ``tc_slice_rows(F)`` rows, with tc_gemm's ring or vecmat_tc's
    partials, whichever is larger) fits one block's 227 KB at every width
    the route takes (every F from 16 to 256: its products run over slices
    of at most 64 rows), and holds the partials at the smallest; the
    general route's is unchanged (37,216 bytes at F 64, H 512). The source
    lays the vectors out at ``TC_ROUTE_MAX_F`` and the tile at
    ``tc_slice_rows(F)``, as the mirror does."""
    for H in range(64, TX.TC_MAX_H + 1, 64):
        for F in range(TX.TC_MIN_F, TX.TC_ROUTE_MAX_F + 1):
            assert TG.bwd_smem_bytes(F, H, "tc") <= TX.SMEM_MAX, (F, H)
    t = TX._TILES
    g = _build.header_ints("mega_grad_tc.cu")
    vectors = 4 * ((g["NHV"] * TX.TC_MAX_H
                    + (g["NFV"] + 5) * TX.TC_ROUTE_MAX_F
                    + t["BK"] * (t["BM"] + 1) + t["BK"] * t["BN"]
                    + t["THREADS"] // 32 + 3) & ~3)
    for H in range(64, TX.TC_MAX_H + 1, 64):
        for F in range(TX.TC_MIN_F, TX.TC_ROUTE_MAX_F + 1):
            scratch = TG.bwd_smem_bytes(F, H, "tc") - vectors
            rows = TX.tc_slice_rows(F)
            assert rows % 16 == 0 and F <= rows or rows == TX.TC_MAX_F
            assert scratch >= 2 * rows * (H + t["TC_PAD"]), (F, H)
            assert scratch >= 4 * t["THREADS"] * 8, (F, H)
    assert TG.bwd_smem_bytes(64, 512, "general") == 37216
    assert TG.bwd_smem_bytes(64, 512, "tc") == 144480
    assert TG.bwd_smem_bytes(150, 512, "tc") == 144480
    assert TG.bwd_smem_bytes(72, 64, "tc") == TG.bwd_smem_bytes(64, 64, "tc")
    with open(os.path.join(os.path.dirname(_build.__file__), "csrc",
                           "mega_grad_tc.cu")) as f:
        src = f.read()
    body = src[src.index("inline long bwd_smem_floats(int F, int H) {"):]
    body = " ".join(body[:body.index("\n}\n")].split())
    assert "(long)(NFV + 5) * stair::TC_ROUTE_MAX_F" in body
    assert "(long)tc_slice_rows(F) * (H + TC_PAD) + tc_ring<TC_BN>()" in body
    ws = src[src.index("struct Ws {"):]
    ws = ws[:ws.index("};")]
    assert "const int S = stair::TC_ROUTE_MAX_F * stair::TC_MAX_H;" in ws


def test_mega_bwd_fma32_shared_memory_fits():
    """The "fma32" walk's shared memory is the general route's (its vectors
    and gemm's tiles, which the m1 products keep using), 16 bytes of room
    to align gemm32's ring, and the ring at the walk's column tile (three
    stages of the A tile and of B transposed, the larger layout); it fits one block's 227 KB at every
    width the route takes, every F from 16 to the largest, 256 (the
    source's static_assert at the largest), and the launch sizes it with
    the function ``bwd_smem_bytes`` mirrors."""
    t = TX._TILES
    ring = 4 * t["G32_STAGES"] * (t["G32_BM"] + t["G32_WALK_BN"]) * (
        t["G32_BK"] + t["G32_PAD"])
    assert ring == 55296
    assert (TX.FMA32_MIN_F, TX.FMA32_MAX_F) == (16, 256) == (16, TX.MAX_F)
    for H in range(128, TX.FMA32_MAX_H + 1, 128):
        for F in range(TX.FMA32_MIN_F, TX.FMA32_MAX_F + 1):
            assert TX.fma32_shape(H, F)
            got = TG.bwd_smem_bytes(F, H, "fma32")
            assert got == TG.bwd_smem_bytes(F, H, "general") + 16 + ring
            assert got <= TX.SMEM_MAX, (F, H)
    assert TG.bwd_smem_bytes(64, 512, "fma32") == 92528
    assert TG.bwd_smem_bytes(150, 512, "fma32") == 98376
    assert TG.bwd_smem_bytes(256, 512, "fma32") == 105584
    with open(os.path.join(os.path.dirname(_build.__file__), "csrc",
                           "mega_grad.cu")) as f:
        src = f.read()
    launch = src[src.index("template <typename T, bool G32 = false>\n"
                           "int launch_bwd("):]
    launch = launch[:launch.index("\n}\n")]
    assert "const size_t smem = bwd_smem_bytes(F, H, G32);" in launch
    assert "mega_bwd_kernel<T, false><<<B, THREADS, smem, stream>>>" in launch
    # the "fma32" walk: one launch of an example's cluster (one CTA too)
    assert ("launch_clusters(mega_bwd_kernel<T, true>, B, a.C, smem, "
            "stream, a)") in launch


def test_mega_wgrad_slots_and_rows_room_follow_the_source():
    """``SLOTS`` is ``TB_SLOT`` of ``csrc/mega_grad.cu`` (and ``TABLES``' experts
    and input widths its ``TB_E`` and ``TB_K``), so ``wgrad_rows_room``
    gives the "fma32" weight gradients' index the room ``job_rows`` lays out:
    every record's rows for each table's expert, F in the ``[F, H]`` slots,
    1 in the vec slots."""
    with open(os.path.join(os.path.dirname(_build.__file__), "csrc",
                           "mega_grad.cu")) as f:
        src = f.read()

    def table(name):
        body = re.search(name + r"\[NTABLES\] = \{([^}]*)\}", src).group(1)
        return tuple(int(x) for x in body.split(","))

    assert table("TB_SLOT") == TG.SLOTS
    assert table("TB_E") == tuple(E for _, _, E, _ in TG.TABLES)
    assert table("TB_K") == tuple(K for _, _, _, K in TG.TABLES)
    assert TG.wgrad_rows_room(128, 13, 64) == 128 * 13 * (26 * 64 + 10)
    assert TG.wgrad_rows_room(2, 3, 16) == 6 * (26 * 16 + 10)


def test_mega_bwd_workspace_slots_start_on_16_bytes():
    """The general and "fma32" walks' workspace pads its ``[Na, F]`` and two
    ``[F, F]`` slots to 4 floats, so that every ``[F, H]`` slot, which the
    "fma32" walk reads with cp.async, and every example's workspace start
    on 16 bytes at any F the route takes (F 150: the NMN CLIs' default);
    at F a multiple of 4 the layout is the unpadded one."""
    for F in range(TX.FMA32_MIN_F, TX.FMA32_MAX_F + 1):
        for Na in (1, 3, 8, 11):
            n = TG.workspace_floats(10, 6, Na, F, 512, 16, 13)
            assert n % 4 == 0, (F, Na)
            if F % 4 == 0:
                assert n == (10 * 512 + Na * F + 6 * F * 512 + 16 * 512
                             + 13 * 512 + 7 * F * 512 + 2 * F * F)
    src = open(os.path.join(os.path.dirname(_build.__file__), "csrc",
                            "mega_grad.cu")).read()
    ws = src[src.index("struct WsT {"):]
    ws = ws[:ws.index("};")]
    assert "gra = o; o += pad4((long)Na * F);" in ws
    assert ws.count("o += pad4((long)F * F);") == 2


def test_mega_bwd_tc_workspace_adds_the_dy_rows():
    """The tensor-core walk keeps its five slots' float32 dY rows in the
    workspace (three [F, H], two [H]) until a step's records are written,
    and lays its [F, H], [F, F] and [H] slots out at the route's largest F
    and H (``TC_ROUTE_MAX_F``, ``TC_MAX_H``): at those widths it is the
    general layout plus the dY rows."""
    args = (10, 6, 8, TX.TC_ROUTE_MAX_F, TX.TC_MAX_H, 16, 13)
    F, H = TX.TC_ROUTE_MAX_F, TX.TC_MAX_H
    assert (TG.workspace_floats(*args, tc=True)
            - TG.workspace_floats(*args)) == 3 * F * H + 2 * H
    small = (10, 6, 8, 16, 64, 16, 13)
    assert (TG.workspace_floats(*small, tc=True)
            > TG.workspace_floats(*small))


def test_mega_bwd_tc_workspace_slots_start_on_16_bytes():
    """The tensor-core walk pads its ``[Na, F]`` slot to 4 floats, so that
    every later slot and every example's workspace start on 16 bytes at any
    F the route takes (the walk stages its float32 dY rows as float4: at
    the NMN CLIs' F 150 an odd Na left them misaligned)."""
    for F in range(TX.TC_MIN_F, TX.TC_ROUTE_MAX_F + 1):
        for Na in (1, 3, 8, 11):
            assert TG.workspace_floats(10, 6, Na, F, 512, 16, 13,
                                       tc=True) % 4 == 0, (F, Na)
    src = open(os.path.join(os.path.dirname(_build.__file__), "csrc",
                            "mega_grad_tc.cu")).read()
    ws = src[src.index("struct Ws {"):]
    ws = ws[:ws.index("\n};\n")]
    assert "gra = o; o += ((long)Na * F + 3) & ~3L;" in ws


def _bwd_case(dev, H, F, attention, copies):
    """Prepared bf16 args over the all-opcode programs (``copies`` times),
    the training forward's files at dropout 0.25 and seeded cotangents."""
    cfg = NMNConfig(
        hidden_size=H, video_size=24, text_size=20, answer_vocab_length=7,
        max_video_length=F, object_types=3, max_steps=16, num_vec=10,
        num_frames=6, num_attn=8, filter_attention=attention,
        compute_dtype="bfloat16")
    model = TW.build_model(cfg, seed=1, device=dev)
    batch = TW.to_device(
        TW.opcode_batch(cfg, TW.OPCODE_PROGRAMS * copies, seed=8), dev)
    gen = torch.Generator().manual_seed(F)
    B, L = batch["question"].shape[:2]
    halves = [torch.randn(B, n, H // 2, generator=gen)
              .to(dev, torch.bfloat16) for n in (F, F, L, L)]
    mods = tree_map(lambda x: x.detach().to(torch.bfloat16),
                    model.param_tree()["modules"])
    meta, args = TX.prepare_args(
        cfg, mods, VideoNMN._fused_tables(mods), batch["trace"], halves[:2],
        batch["video_mask"], halves[2:], batch["question_mask"])
    out = TX.mega_exec_train_call(meta, args, 0.25, (123, 456))
    cots = [torch.randn(o.shape, generator=gen).to(dev) for o in out]
    return meta, args, out, cots


GRAD_NAMES = ("dvf_a", "dvf_b", "dtok_a", "dtok_b", "daux") + \
    TX.ARG_NAMES[TG.N_DATA:]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["tc", "general"])
@pytest.mark.parametrize("F,attention", [(16, "parity"), (16, "softmax"),
                                         (64, "parity"), (64, "softmax")])
def test_mega_bwd_bf16_routes_vs_plain_on_card(cuda_device, monkeypatch,
                                               route, F, attention):
    """Both bf16 backward routes against the plain backward over every
    opcode at dropout 0.25, at the widths of the bf16 check above (H 64),
    within 1e-1 of each gradient's scale, each handed its own route's
    training forward (the general route's forward and backward both sent
    there: ``bwd_route`` follows ``fwd_route``); two runs give identical
    bits; one launch of each of the route's two keys and none of the other
    route's."""
    if route == "general":
        monkeypatch.setattr(TX, "fwd_route", lambda *a: "general")
    seed = (123, 456)
    meta, args, out, cots = _bwd_case(cuda_device, 64, F, attention, 1)
    _build.reset_launches()
    k1 = TG.mega_exec_bwd_call(meta, args, out, cots, 0.25, seed)
    k2 = TG.mega_exec_bwd_call(meta, args, out, cots, 0.25, seed)
    torch.cuda.synchronize()
    keys = ("mega_exec_bwd_tc", "mega_exec_wgrad_tc")
    gen_keys = ("mega_exec_bwd", "mega_exec_wgrad")
    want, other = (keys, gen_keys) if route == "tc" else (gen_keys, keys)
    assert all(_build.LAUNCHES[k] == 2 for k in want)
    assert not any(_build.LAUNCHES[k] for k in other)
    rb = TG.mega_exec_bwd_reference(meta, args, out, cots, 0.25, seed)
    grads = dict(zip(GRAD_NAMES, rb))
    for name, a, b, r in zip(GRAD_NAMES, k1, k2, rb):
        assert torch.equal(a, b), name
        if attention == "softmax" and name in ("fltk", "fltb"):
            ref = float(grads["fltw"].float().abs().max())
            assert float(a.float().abs().max()) <= 1e-3 * ref, name
            continue
        scale = max(float(r.float().abs().max()), 1e-12)
        assert float((a.float() - r.float()).abs().max()) <= 1e-1 * scale, \
            name


@pytest.mark.cuda
@pytest.mark.parametrize("attention", ["parity", "softmax"])
def test_mega_bwd_tc_route_equals_general_route_on_card(cuda_device,
                                                        monkeypatch,
                                                        attention):
    """The tensor-core backward against the general one at H 192 (ragged
    128-column chunks) and F 64 over the all-opcode programs twice, each
    route handed its own route's training forward (the walk recomputes its
    own forward's values bit for bit, so every relu mask and rounding site
    it uses is that forward's): the two forwards differ only in the order
    of their products' sums, and so do the backwards, so every gradient
    agrees within 1e-2 of its scale. (At these widths both routes differ
    from the plain version's supb by ~0.18 of its scale: the JAX kernel's
    SUPF backward recomputes the cosine scores unrounded where the forward
    rounds them, stair_tpu/ops/mega_grad.py:710-713, and the port's kernels
    keep that.)"""
    seed = (123, 456)
    meta, args, out, cots = _bwd_case(cuda_device, 192, 64, attention, 2)
    tc = TG.mega_exec_bwd_call(meta, args, out, cots, 0.25, seed)
    monkeypatch.setattr(TX, "fwd_route", lambda *a: "general")
    out_gen = TX.mega_exec_train_call(meta, args, 0.25, seed)
    gen = TG.mega_exec_bwd_call(meta, args, out_gen, cots, 0.25, seed)
    torch.cuda.synchronize()
    grads = dict(zip(GRAD_NAMES, gen))
    for name, a, g in zip(GRAD_NAMES, tc, gen):
        if attention == "softmax" and name in ("fltk", "fltb"):
            # 0 in exact arithmetic: float32 noise on both routes, bounded
            # as above against the Filter logit weights' gradient
            ref = float(grads["fltw"].float().abs().max())
            assert float(a.float().abs().max()) <= 1e-3 * ref, name
            continue
        scale = max(float(g.float().abs().max()), 1e-12)
        assert float((a.float() - g.float()).abs().max()) <= 1e-2 * scale, \
            name


#: the walk's product shapes (M, K, N): [F, H] @ [H, H] at F 64 and 16,
#: ragged 128-column chunks at H 192, and [F, H] @ [H, F]; in the row-slice
#: mode the NMN CLIs' F 150 (slices of 64, 64 and 22 rows), F 72 and 24
#: (ragged 16-row tiles) and 256; the vec-level product takes the same K
#: and N over ``VEC_SEGMENTS`` segments
RECOMPUTE_SHAPES = [(64, 512, 512), (16, 512, 512), (48, 192, 192),
                    (64, 512, 64), (150, 512, 512), (72, 192, 192),
                    (24, 512, 512), (256, 128, 128), (150, 512, 64)]
VEC_SEGMENTS = {(64, 512, 512): 3, (16, 512, 512): 1, (48, 192, 192): 2,
                (64, 512, 64): 3, (150, 512, 512): 3, (72, 192, 192): 2,
                (24, 512, 512): 1, (256, 128, 128): 3, (150, 512, 64): 2}


@pytest.mark.cuda
@pytest.mark.parametrize("product", ["matrix", "vec"])
@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("M,K,N", RECOMPUTE_SHAPES)
def test_recompute_products_equal_forward_on_card(cuda_device, M, K, N,
                                                  chain, product):
    """The tensor-core walk's recompute products give the bits of the
    training forward's own calls on the same operands (``recompute_check``):
    the matrix product (``walk_gemm``, 64-column chunks, A's bf16 rows from
    global memory in slices of 64, against ``fwd_gemm``, 128-column chunks,
    A in a shared-memory tile) and the vec-level product (``vecmat_tc``,
    partials at each kernel's place), alone and as stage 1's chained pair
    (the hidden rounded to bf16, kept in shared memory by the forward and
    in global memory by the walk); at M above 64 or not a multiple of 16,
    the row-slice mode's ``fwd_rows`` against ``walk_gemm`` over slices of
    64 rows (the hidden as bf16 rows in global memory on both sides). Both are
    the float32 sums of the bf16 products within 1e-3; the walk's shared
    memory is what ``bwd_smem_bytes`` says."""
    vec = product == "vec"
    gen = torch.Generator().manual_seed(M + K + N)
    S = VEC_SEGMENTS[(M, K, N)]
    A = torch.randn(S if vec else M, K, generator=gen).to(
        cuda_device, torch.bfloat16)
    if vec:     # the executor's vectors: float32 holding bf16 values
        A = A.float()
    Bm = (torch.randn(S * K if vec else K, N, generator=gen) / K ** 0.5).to(
        cuda_device, torch.bfloat16)
    fwd, walk = TG.recompute_check(A, Bm, vec, chain)
    torch.cuda.synchronize()
    assert torch.equal(fwd, walk)
    Bd = Bm.double()
    if vec:
        want = sum(A[s].double() @ Bd[s * K:(s + 1) * K] for s in range(S))
    else:
        want = A.double() @ Bd
    if chain:
        h = want.float().clamp_min(0).to(torch.bfloat16).double()
        want = h @ Bd[:N, :N]
    assert float((fwd.double() - want).abs().max()) < 1e-3 * max(
        float(want.abs().max()), 1.0)
    # the walk's shared memory at (F, H) = (M, K), as bwd_smem_bytes says
    assert (_build.build().stair_mega_exec_bwd_tc_smem(M, K)
            == TG.bwd_smem_bytes(M, K, "tc"))


#: gemm32's card check: the walk's product shapes, and M past one row tile
#: of 64 (the NMN CLIs' default F 150, and 72 and 256, the last row tile
#: ragged at 72 and 150)
F32_PRODUCT_SHAPES = RECOMPUTE_SHAPES + [(72, 512, 512), (150, 512, 512),
                                         (256, 512, 512), (150, 512, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [64, 128, 256])
@pytest.mark.parametrize("nk", [False, True])
@pytest.mark.parametrize("M,K,N", F32_PRODUCT_SHAPES)
def test_f32_product_check_equal_bits_on_card(cuda_device, M, K, N, nk, bn):
    """``gemm32`` (the "fma32" route's product helper, at each column tile
    timed) gives ``stair::mega::gemm``'s bits on the same float32 operands
    in both B layouts (W as stored, and W^T as the walk's gradient products
    read it), at the walk's product shapes, including ragged 128-column
    tiles at H 192, an N of 64 and M over several row tiles of 64 with a
    ragged last one; both within 1e-5 of the float64 product.
    Each block reports a positive ``clock64()`` span. The walk's shared
    memory on both float32 routes is what ``bwd_smem_bytes`` says."""
    gen = torch.Generator().manual_seed(M + K + N + nk)
    A = torch.randn(M, K, generator=gen).to(cuda_device)
    W = (torch.randn(*((N, K) if nk else (K, N)), generator=gen)
         / K ** 0.5).to(cuda_device)
    outg, out32, clk = TG.f32_product_check(A, W, nk, bn, reps=2)
    torch.cuda.synchronize()
    assert torch.equal(outg, out32)
    want = A.double() @ (W.double().T if nk else W.double())
    assert float((out32.double() - want).abs().max()) < 1e-5 * max(
        float(want.abs().max()), 1.0)
    assert int(clk[0]) > 0 and int(clk[1]) > 0
    lib = _build.build()
    for route, flag in (("general", 0), ("fma32", 1)):
        assert (lib.stair_mega_exec_bwd_smem(M, K, flag)
                == TG.bwd_smem_bytes(M, K, route))


@pytest.mark.cuda
@pytest.mark.parametrize("F,attention", [(16, "parity"), (16, "softmax"),
                                         (64, "parity"), (64, "softmax"),
                                         (72, "parity"), (150, "parity"),
                                         (150, "softmax"), (256, "softmax")])
def test_mega_bwd_fma32_equals_general_on_card(cuda_device, monkeypatch, F,
                                               attention):
    """The float32 "fma32" backward (the walk on ``gemm32`` and the
    register-blocked weight gradients) at H 128 over the all-opcode
    programs twice at dropout 0.25, handed its own forward's files (equal
    to the general forward's bit for bit): every data cotangent and weight
    gradient equals the general route's bit for bit, a second launch gives
    the same bits, and each is within phase 7's float32 bound (5e-2 of its
    scale) of the plain backward at those files. Launches: one
    ``mega_exec_train_fma32``, one ``mega_exec_bwd_fma32`` and one
    ``mega_exec_wgrad_fma32``, none of the general route's."""
    cfg = NMNConfig(
        hidden_size=128, video_size=24, text_size=20, answer_vocab_length=7,
        max_video_length=F, object_types=3, max_steps=16, num_vec=10,
        num_frames=6, num_attn=8, filter_attention=attention)
    assert TG.bwd_route(torch.float32, 128, F) == "fma32"
    model = TW.build_model(cfg, seed=1, device=cuda_device)
    batch = TW.to_device(
        TW.opcode_batch(cfg, TW.OPCODE_PROGRAMS * 2, seed=8), cuda_device)
    gen = torch.Generator().manual_seed(F)
    B, L = batch["question"].shape[:2]
    halves = [torch.randn(B, n, 64, generator=gen).to(cuda_device)
              for n in (F, F, L, L)]
    mods = tree_map(lambda x: x.detach(), model.param_tree()["modules"])
    meta, args = TX.prepare_args(
        cfg, mods, VideoNMN._fused_tables(mods), batch["trace"], halves[:2],
        batch["video_mask"], halves[2:], batch["question_mask"])
    seed = (123, 456)
    _build.reset_launches()
    out = TX.mega_exec_train_call(meta, args, 0.25, seed)
    cots = [torch.randn(o.shape, generator=gen).to(cuda_device) for o in out]
    k1 = TG.mega_exec_bwd_call(meta, args, out, cots, 0.25, seed)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "mega_exec_train_fma32": 1, "mega_exec_bwd_fma32": 1,
        "mega_exec_wgrad_fma32": 1}
    k2 = TG.mega_exec_bwd_call(meta, args, out, cots, 0.25, seed)
    monkeypatch.setattr(TX, "fwd_route", lambda *a: "general")
    out_gen = TX.mega_exec_train_call(meta, args, 0.25, seed)
    gen_b = TG.mega_exec_bwd_call(meta, args, out_gen, cots, 0.25, seed)
    rb = TG.mega_exec_bwd_reference(meta, args, out, cots, 0.25, seed,
                                    at_files=True)
    torch.cuda.synchronize()
    for a, g in zip(out, out_gen):
        assert torch.equal(a, g)
    grads = dict(zip(GRAD_NAMES, rb))
    for name, a, b, g, r in zip(GRAD_NAMES, k1, k2, gen_b, rb):
        assert torch.equal(a, b), name
        assert torch.equal(a, g), name
        if attention == "softmax" and name in ("fltk", "fltb"):
            # 0 in exact arithmetic: float32 noise, bounded against the
            # Filter logit weights' gradient
            ref = float(grads["fltw"].float().abs().max())
            assert float(a.float().abs().max()) <= 1e-3 * ref, name
            continue
        scale = max(float(r.float().abs().max()), 1e-12)
        assert float((a.float() - r.float()).abs().max()) <= 5e-2 * scale, \
            name


def test_mega_bwd_fma32_cluster_takes_the_forward_rule():
    """The "fma32" walk and forward pick their cluster with the one
    ``pick_cluster`` (``csrc/mega_common.cuh``: ``mega32_cluster`` over the
    card's slots and fits, each kernel's own), so that #5 and #6 of a step
    split alike; on CPU tensors ``cluster`` leaves the plain backward as it
    is and launches nothing."""
    from torch_port_util import fma32_case

    csrc = os.path.join(os.path.dirname(_build.__file__), "csrc")
    with open(os.path.join(csrc, "mega_grad.cu")) as f:
        grad = f.read()
    with open(os.path.join(csrc, "mega_exec.cu")) as f:
        fwd = f.read()
    assert ("pick_cluster(mega_bwd_kernel<T, true>, smem, B, H, cluster, "
            "&a.C)") in grad
    assert ("pick_cluster(mega_exec_kernel<T, true>, smem, B, H, cluster, "
            "&a.C)") in fwd
    meta, args = fma32_case(torch.device("cpu"), 128, 24, "parity", 3)
    out = TX.mega_exec_reference(meta, args, rate=0.25, seed=(1, 2))
    gen = torch.Generator().manual_seed(3)
    cots = [torch.randn(o.shape, generator=gen) for o in out]
    _build.reset_launches()
    want = TG.mega_exec_bwd_reference(meta, args, out, cots, 0.25, (1, 2))
    got = TG.mega_exec_bwd_call(meta, args, out, cots, 0.25, (1, 2),
                                cluster=1)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert not any(_build.LAUNCHES.values())


#: the cluster card tests' widths (H, F) and batches (as the forward's in
#: tests/test_torch_mega_exec.py)
CLUSTER_WIDTHS = [(256, 72), (512, 72), (256, 150), (512, 150), (256, 256),
                  (512, 256)]
CLUSTER_BATCHES = (1, 29, 32, 33, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("H,F", CLUSTER_WIDTHS,
                         ids=[f"H{h}-F{f}" for h, f in CLUSTER_WIDTHS])
def test_mega_bwd_fma32_clusters_equal_one_cta_on_card(cuda_device,
                                                       monkeypatch, H, F):
    """#6 on the "fma32" route (the walk at every cluster size the width
    takes: 1, 2, H / 128; then the weight gradients) at every batch of
    CLUSTER_BATCHES over the all-opcode programs at dropout 0.25, handed
    the training forward's files: every data cotangent and weight gradient
    equals one CTA an example's and the general route's bit for bit. The
    launch's own pick is the library's (``fma32_launch_cluster`` with F),
    ``fma32_cluster`` over the walk's slots and fits, counted under it in
    ``_build.CLUSTERS``."""
    from torch_port_util import fma32_case

    most = H // TX._TILES["G32_BN"]
    sizes = sorted({1, 2, most})
    fits = {c: TX.fma32_fit(c, F, H) for c in sizes}
    seed = (123, 456)
    for B in CLUSTER_BATCHES:
        meta, args = fma32_case(cuda_device, H, F, "parity", B)
        out = TX.mega_exec_train_call(meta, args, 0.25, seed)
        gen = torch.Generator().manual_seed(B)
        cots = [torch.randn(o.shape, generator=gen).to(cuda_device)
                for o in out]
        pick = TX.fma32_launch_cluster(B, H, F)
        assert pick == TX.fma32_cluster(
            B, H, fits[1], fits[2] if most > 2 else 0,
            fits[most] if most > 1 else 0), B
        _build.reset_launches()
        want = TG.mega_exec_bwd_call(meta, args, out, cots, 0.25, seed)
        assert _build.CLUSTERS["mega_exec_bwd_fma32"] == {pick: 1}
        for c in sizes:
            got = TG.mega_exec_bwd_call(meta, args, out, cots, 0.25, seed,
                                        cluster=c)
            for name, a, b in zip(GRAD_NAMES, want, got):
                assert torch.equal(a, b), (B, c, name)
        with monkeypatch.context() as m:
            m.setattr(TX, "fwd_route", lambda *a: "general")
            gen_out = TX.mega_exec_train_call(meta, args, 0.25, seed)
            gen_b = TG.mega_exec_bwd_call(meta, args, gen_out, cots, 0.25,
                                          seed)
        torch.cuda.synchronize()
        for a, b in zip(out, gen_out):
            assert torch.equal(a, b), (B, "general files")
        for name, a, b in zip(GRAD_NAMES, want, gen_b):
            assert torch.equal(a, b), (B, "general", name)


@needs_jax
@pytest.mark.parametrize("F,attention", [(150, "softmax"), (72, "parity")])
def test_mega_exec_train_bf16_matches_jax(F, attention):
    """bf16 at the NMN CLIs' default F 150 and at F 72 (the tensor-core
    route's row-slice widths on the card), H 64, every program, dropout 0:
    the port's training executor (the plain forward and its autograd
    backward) against the JAX megakernel pair (#5 and its backward #6)
    under the Pallas interpreter, on the same numpy inputs, weights and
    cotangents cast to bf16. The files within atol 3e-2 plus rtol 1e-2 (the
    executor's bf16 bound); every gradient within 1e-1 of its largest
    magnitude (the bf16 backward bound of the card checks: the JAX kernel
    rounds cotangents at its own sites, autograd at the forward's casts;
    measured <= 4.3e-2, the Temporal tables')."""
    cfg, model, params = _jbuild(max_video_length=F, hidden=64,
                                 filter_attention=attention)
    batch, _ = _batch(cfg, PROGRAMS, seed=7)
    rng = np.random.RandomState(0)
    B, L = batch["video"].shape[0], batch["question"].shape[1]
    halves = [rng.randn(B, n, 32).astype(np.float32) for n in (F, F, L, L)]
    bf = jnp.bfloat16
    seed = (12345, 2 ** 31 - 7)
    trace = batch["trace"]

    def jf(vfa, vfb, toka, tokb, mods):
        return JG.mega_exec_train(
            cfg, mods, model._fused_tables(mods),
            {k: jnp.asarray(v) for k, v in trace.items()}, (vfa, vfb),
            jnp.asarray(batch["video_mask"]), (toka, tokb),
            jnp.asarray(batch["question_mask"]), 0.0,
            jnp.asarray(seed, jnp.int32), interpret=True)

    jmods = jax.tree_util.tree_map(lambda x: x.astype(bf), params["modules"])
    outs, vjp = jax.vjp(jf, *[jnp.asarray(h, bf) for h in halves], jmods)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    jgrads = vjp(tuple(jnp.asarray(c, bf) for c in cots))

    pm = port_model(cfg, params)
    mods = tree_map(
        lambda x: x.detach().to(torch.bfloat16).requires_grad_(True),
        pm.param_tree()["modules"])
    th = [torch.from_numpy(h).to(torch.bfloat16).requires_grad_(True)
          for h in halves]
    tout = TG.mega_exec_train(
        pm.config, mods, pm._fused_tables(mods),
        {k: torch.from_numpy(v) for k, v in trace.items()}, (th[0], th[1]),
        torch.from_numpy(batch["video_mask"]), (th[2], th[3]),
        torch.from_numpy(batch["question_mask"]), 0.0, seed)
    assert TG.bwd_route(torch.bfloat16, 512, F) == "tc"
    for name, j, t in zip(("regs_vec", "regs_frames", "regs_attn"), outs,
                          tout):
        assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(np.asarray(j, np.float32),
                                   t.detach().float().numpy(), rtol=1e-2,
                                   atol=3e-2, err_msg=name)
    torch.autograd.backward(
        tout, [torch.from_numpy(c).to(torch.bfloat16) for c in cots])

    def check(a, b, name):
        a = np.asarray(a, np.float32)
        b = b.float().numpy()
        scale = max(np.abs(a).max(), 1e-6)
        assert np.abs(a - b).max() <= 1e-1 * scale, name

    for i, name in enumerate(("vf_a", "vf_b", "tok_a", "tok_b")):
        check(jgrads[i], th[i].grad, name)
    n = 0

    def walk(j, t, path):
        nonlocal n
        if isinstance(j, dict):
            for k in j:
                walk(j[k], t[k], f"{path}/{k}")
        else:
            n += 1
            check(j, t.grad if t.grad is not None else torch.zeros_like(t),
                  path)

    walk(jgrads[4], mods, "modules")
    assert n > 40


#: bf16 widths (H, F) of the walk's row-slice checks on the card
TC_SLICED_WALK = [(64, 72), (64, 150), (192, 100), (128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("attention", ["parity", "softmax"])
@pytest.mark.parametrize("H,F", TC_SLICED_WALK,
                         ids=[f"H{h}-F{f}" for h, f in TC_SLICED_WALK])
def test_mega_bwd_tc_sliced_vs_plain_at_files_on_card(cuda_device, H, F,
                                                      attention):
    """#6 on the tensor-core route in the row-slice mode (the walk on the
    forward's cluster, ``tc_launch_cluster``), handed its own route's
    training forward at dropout 0.25, against the plain VJP at those files
    (``mega_exec_bwd_reference(at_files=True)``: the function the kernel
    computes) within 1e-1 of each gradient's scale; two runs give equal
    bits; one launch of the walk (counted under the forward's cluster) and
    of the weight gradients, none on the general route."""
    seed = (123, 456)
    meta, args, out, cots = _bwd_case(cuda_device, H, F, attention, 1)
    C = TX.tc_launch_cluster(meta[0], F, H, walk=True)
    assert C == TX.tc_launch_cluster(meta[0], F, H, meta[8])
    _build.reset_launches()
    k1 = TG.mega_exec_bwd_call(meta, args, out, cots, 0.25, seed)
    assert _build.LAUNCHES["mega_exec_bwd_tc"] == 1
    assert _build.LAUNCHES["mega_exec_wgrad_tc"] == 1
    assert not _build.LAUNCHES["mega_exec_bwd"]
    assert _build.CLUSTERS["mega_exec_bwd_tc"] == {C: 1}
    k2 = TG.mega_exec_bwd_call(meta, args, out, cots, 0.25, seed)
    torch.cuda.synchronize()
    rb = TG.mega_exec_bwd_reference(meta, args, out, cots, 0.25, seed,
                                    at_files=True)
    grads = dict(zip(GRAD_NAMES, rb))
    for name, a, b, r in zip(GRAD_NAMES, k1, k2, rb):
        assert torch.equal(a, b), name
        if attention == "softmax" and name in ("fltk", "fltb"):
            ref = float(grads["fltw"].float().abs().max())
            assert float(a.float().abs().max()) <= 1e-3 * ref, name
            continue
        scale = max(float(r.float().abs().max()), 1e-12)
        assert float((a.float() - r.float()).abs().max()) <= 1e-1 * scale, \
            name


#: (H, F, cluster sizes) of the walk's bit checks, as the forward's
TC_WALK_CLUSTERS = [(64, 64, (2, 4)), (192, 48, (3,)), (192, 72, (1, 2, 3)),
                    (512, 150, (1, 2, 3)), (128, 256, (1, 4, 8))]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "H,F,sizes", TC_WALK_CLUSTERS,
    ids=[f"H{h}-F{f}" for h, f, _ in TC_WALK_CLUSTERS])
def test_mega_bwd_tc_clusters_equal_one_cta_on_card(cuda_device, H, F,
                                                    sizes):
    """#6 on the tensor-core route at every cluster size of ``sizes`` (the
    walk's frame rows split over the CTAs of an example's cluster; at F 64
    and 48 against one CTA an example, the launch's pick there), handed the
    training forward's files at dropout 0.25 over the all-opcode programs:
    every data cotangent and weight gradient equals the launch's pick's bit
    for bit, and each launch is counted under its size."""
    from torch_port_util import tc_case

    seed = (123, 456)
    meta, args = tc_case(cuda_device, H, F, "parity", 33)
    out = TX.mega_exec_train_call(meta, args, 0.25, seed)
    gen = torch.Generator().manual_seed(F)
    cots = [torch.randn(o.shape, generator=gen).to(cuda_device)
            for o in out]
    pick = TX.tc_launch_cluster(33, F, H, walk=True)
    _build.reset_launches()
    want = TG.mega_exec_bwd_call(meta, args, out, cots, 0.25, seed)
    for c in sizes:
        got = TG.mega_exec_bwd_call(meta, args, out, cots, 0.25, seed,
                                    cluster=c)
        for name, a, b in zip(GRAD_NAMES, want, got):
            assert torch.equal(a, b), (c, name)
    torch.cuda.synchronize()
    assert _build.CLUSTERS["mega_exec_bwd_tc"] == collections.Counter(
        (pick,) + tuple(sizes))
