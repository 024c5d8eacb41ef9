"""Reversible executor scan: a register machine with a hand-written
backward, for training (port of ``stair_tpu/models/rev_exec.py``).

The executor's registers are SSA (``ir/lowering.py``: every real register
is written exactly once; the scratch slot only ever receives values no one
reads), which makes the instruction scan *reversible*: the register files
BEFORE step ``t`` are recovered from the files AFTER it by re-zeroing the
slots step ``t`` wrote. So the backward needs no stored carries and no
stored residuals: it walks the trace in reverse, rebuilds each step's input
registers exactly (zeroing is exact in any float dtype), replays the step
under autograd on the gathered operands, and scatters the operand
cotangents back.

``rev_exec`` is a ``torch.autograd.Function``. Its forward runs the loop
under ``no_grad`` with the four writes of a step in one set; its backward
reads out and zeroes the four output cotangents in reverse write order and
rebuilds the input files by zeroing the written slots, all in one zero,
replays the step with ``torch.enable_grad`` and ``torch.autograd.grad``,
and adds the seven operand cotangents in one add. Each of the three is a
``regslots.SlotPlan`` over the trace's ``[T, B]`` index tables, built once
per scan (CUDA kernels on the card: one launch a step each; index
assignment on the CPU). Forward and backward allocate or clone every file
they update, so the in-place slot updates never touch a tensor the caller
holds. The step must give the same result
when it is replayed: its dropout masks are a function of ``(seed, step)``,
not of a generator's running state (``models/nmn.py``).
"""

from __future__ import annotations

import torch

from stair_tpu_torch.ops import regslots


class RevCore:
    """What a run of the scan is made of: ``step(operands, consts, t,
    aux_t) -> (new_vec, new_frames, new_attn, new_attn_b)``, the ``[T, B]``
    integer trace ``fields`` (register indices per step), and the register
    files' geometry."""

    def __init__(self, step, fields, num_vec, num_frames, num_attn):
        self.step = step
        self.fields = fields
        self.num_vec = num_vec
        self.num_frames = num_frames
        self.num_attn = num_attn


def take(file, idx):
    """file [B, N, ...], idx [B] -> [B, ...] (slot gather, a copy)."""
    return file[torch.arange(file.shape[0], device=file.device), idx]


def gather_operands(regs, f, t):
    """The 7 register reads of step ``t``, for the whole batch."""
    rv, rf, ra = regs
    return (
        take(rv, f["va"][t]), take(rv, f["vb"][t]), take(rv, f["vc"][t]),
        take(rf, f["fa"][t]), take(rf, f["fb"][t]),
        take(ra, f["aa"][t]), take(ra, f["ab"][t]),
    )


def init_regs(core, video0):
    """Zero register files with frames register 0 <- the masked video."""
    B, F, H = video0.shape
    kw = dict(dtype=video0.dtype, device=video0.device)
    rv0 = torch.zeros(B, core.num_vec + 1, H, **kw)
    rf0 = torch.zeros(B, core.num_frames + 1, F, H, **kw)
    rf0[:, 0] = video0
    ra0 = torch.zeros(B, core.num_attn + 1, F, **kw)
    return rv0, rf0, ra0


def _flatten(tree):
    """Nested tuples/lists/dicts of tensors -> (leaves, rebuild)."""
    if torch.is_tensor(tree):
        return [tree], lambda leaves: leaves[0]
    items = list(tree.items()) if isinstance(tree, dict) else list(
        enumerate(tree))
    parts = [_flatten(v) for _, v in items]
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, o = [], 0
        for (k, _), (_, rb), n in zip(items, parts, sizes):
            out.append((k, rb(leaves[o:o + n])))
            o += n
        if isinstance(tree, dict):
            return dict(out)
        return type(tree)(v for _, v in out)

    return [x for p in parts for x in p[0]], rebuild


class _RevExec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, core, rebuild, video0, aux, *leaves):
        f = core.fields
        T = aux.shape[0]
        with torch.no_grad():
            consts = rebuild(leaves)
            rv, rf, ra = init_regs(core, video0)
            # order matters: attn_b last, as in the autograd route
            write = regslots.SlotPlan("set", zip(
                (rv, rf, ra, ra),
                (f[k] for k in ("out_vec", "out_frames", "out_attn",
                                "out_attn_b"))))
            for t in range(T):
                ops = gather_operands((rv, rf, ra), f, t)
                write(t, core.step(ops, consts, t, aux[t]))
        ctx.core, ctx.rebuild = core, rebuild
        # Residuals: the final registers and the raw inputs, nothing per step.
        ctx.save_for_backward(rv, rf, ra, aux, *leaves)
        return rv, rf, ra

    @staticmethod
    def backward(ctx, g_rv, g_rf, g_ra):
        core, f = ctx.core, ctx.core.fields
        saved = ctx.saved_tensors
        aux, leaves = saved[3], saved[4:]
        # own copies: the walk updates the files and their cotangents in place
        rv, rf, ra = (x.detach().clone() for x in saved[:3])
        d_rv, d_rf, d_ra = (
            torch.zeros_like(x) if g is None
            else g.to(x.dtype).clone(memory_format=torch.contiguous_format)
            for g, x in zip((g_rv, g_rf, g_ra), (rv, rf, ra)))
        T = aux.shape[0]
        need = ctx.needs_input_grad[4:]
        leaf_in = [x.detach().requires_grad_(n) for x, n in zip(leaves, need)]
        consts = ctx.rebuild(leaf_in)
        live = [x for x, n in zip(leaf_in, need) if n]
        d_live = [torch.zeros_like(x) for x in live]
        d_aux = torch.zeros_like(aux)

        # Output cotangents, read out and zeroed in reverse write order so
        # that an attn slot written twice in one step (out_attn ==
        # out_attn_b, only via scratch) credits the surviving write; then
        # the step's INPUT files: SSA slots were zero before their write,
        # and the scratch slot is never read, so zero serves there.
        outs = [f[k] for k in ("out_attn_b", "out_attn", "out_frames",
                               "out_vec")]
        d_new_attn_b, d_new_attn, d_new_frames, d_new_vec = d_new = [
            x.new_empty((x.shape[0], *x.shape[2:]))
            for x in (d_ra, d_ra, d_rf, d_rv)]
        unwrite = regslots.SlotPlan("zero", [
            *zip((d_ra, d_ra, d_rf, d_rv), outs, d_new),
            *zip((ra, ra, rf, rv), outs)])
        # in read order: an instruction that reads one register twice adds
        # twice to its slot, in turn
        scatter = regslots.SlotPlan("add", zip(
            (d_rv, d_rv, d_rv, d_rf, d_rf, d_ra, d_ra),
            (f[k] for k in ("va", "vb", "vc", "fa", "fb", "aa", "ab"))))

        for t in reversed(range(T)):
            unwrite(t)
            ops = [o.requires_grad_(True)
                   for o in gather_operands((rv, rf, ra), f, t)]
            aux_t = aux[t].detach().requires_grad_(True)
            with torch.enable_grad():
                new = core.step(tuple(ops), consts, t, aux_t)
            pairs = [(o, g) for o, g in zip(
                new, (d_new_vec, d_new_frames, d_new_attn, d_new_attn_b))
                if o.requires_grad]
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [*ops, aux_t, *live],
                [g.to(o.dtype) for o, g in pairs], allow_unused=True)
            d_ops = [torch.zeros_like(o) if g is None else g
                     for o, g in zip(ops, grads[:7])]

            scatter(t, d_ops)

            if grads[7] is not None:
                d_aux[t] = grads[7]
            for acc, g in zip(d_live, grads[8:]):
                if g is not None:
                    acc += g

        # rf slot 0 held the masked video; the other initial slots were
        # internal zeros, so their cotangents are dropped.
        d_leaves = iter(d_live)
        return (None, None, d_rf[:, 0], d_aux,
                *(next(d_leaves) if n else None for n in need))


def rev_exec(core: RevCore, video0, consts, aux):
    """Run the executor scan with the reversible backward.

    ``video0`` [B, F, H] is the masked encoded video (frames register 0);
    ``consts`` any nested tuple/dict of tensors the step reads (weights,
    tables, token features, masks); ``aux`` [T, B, H] the per-step text
    encodings. Differentiable w.r.t. ``video0``, ``aux`` and every float
    leaf of ``consts`` that requires grad. Returns the final ``(rv, rf,
    ra)``."""
    leaves, rebuild = _flatten(consts)
    return _RevExec.apply(core, rebuild, video0, aux, *leaves)
