"""Register-file slot updates, in place (port of
``stair_tpu/ops/regslots.py``).

The executor's register files are ``[B, N, ...]`` with one slot index per
example. ``slot_set``, ``slot_zero`` and ``slot_add`` update slot ``(b,
idx[b])`` of every example and touch nothing else, so a step's register
traffic is the size of the slots, not of the file. They **write into the
file they are given** and return it: the caller must own it. The reversible
training executor (``models/rev_exec.py``) does: its forward runs under
``no_grad`` on files it allocated, and its backward owns the cotangent
files.

For CUDA tensors each is one launch of ``csrc/regslots.cu`` (TPU kernels
``_set_kernel``, ``_zero_kernel``, ``_add_kernel``); for CPU tensors the
plain versions ``slot_*_reference`` (advanced-index assignment) run. ``idx``
holds values in ``[0, N)``; ``val`` is ``[B, ...]`` in the file's dtype
(``slot_add`` adds in that dtype, one rounding, as the TPU kernel does).
``slot_add_many`` makes up to ``MAX_ADDS`` adds in one launch, in the
order given, with the result of ``slot_add`` on each in turn (entries may
share a file and a slot).
"""

from __future__ import annotations

import ctypes
import math

import torch

from stair_tpu_torch.ops import _build


def _rows(file):
    return torch.arange(file.shape[0], device=file.device)


def slot_set_reference(file, idx, val):
    """``file[b, idx[b]] = val[b]``, in place; returns ``file``."""
    file[_rows(file), idx.long()] = val
    return file


def slot_zero_reference(file, idx):
    """``file[b, idx[b]] = 0``, in place; returns ``file``."""
    file[_rows(file), idx.long()] = 0
    return file


def slot_add_reference(file, idx, val):
    """``file[b, idx[b]] += val[b]``, in place; returns ``file``. The
    ``(b, idx[b])`` pairs are unique, so the read-add-write is exact."""
    rows, idx = _rows(file), idx.long()
    file[rows, idx] = file[rows, idx] + val
    return file


def slot_add_many_reference(entries):
    """``slot_add_reference`` on each ``(file, idx, val)`` of ``entries``
    in turn; returns the files."""
    return tuple(slot_add_reference(f, i, v) for f, i, v in entries)


#: entries one ``slot_add_many`` launch takes (``csrc/regslots.cu``)
MAX_ADDS = _build.header_ints("regslots.cu")["MAX_ADDS"]


def _checked(key, file, idx, val):
    """Raise unless the kernel takes ``file`` / ``idx`` / ``val`` (``val``
    None for a zero); returns the slot's element count."""
    if file.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{key} kernel: unsupported dtype {file.dtype}")
    if file.dim() < 3:
        raise ValueError(f"{key}: file must be [B, N, ...], got "
                         f"{tuple(file.shape)}")
    dev = file.device
    B = file.shape[0]
    _build.check_tensor(f"{key} file", file, file.dtype, file.shape, dev)
    _build.check_tensor(f"{key} idx", idx, torch.int32, (B,), dev)
    if val is not None:
        _build.check_tensor(f"{key} val", val, file.dtype,
                            (B, *file.shape[2:]), dev)
    return math.prod(file.shape[2:])


def _launch(key, file, idx, val):
    slot = _checked(key, file, idx, val)
    B, N = file.shape[:2]
    if B == 0 or slot == 0:
        return file
    fn = getattr(_build.build(), f"stair_{key}")
    vals = () if val is None else (val.data_ptr(),)
    err = fn(file.data_ptr(), idx.data_ptr(), *vals, B, N, slot,
             int(file.dtype == torch.bfloat16),
             _build.stream_ptr(file.device))
    _build.check(err, key)
    _build.LAUNCHES[key] += 1
    return file


def _idx32(idx):
    return idx if idx.dtype == torch.int32 else idx.to(torch.int32)


def slot_set(file, idx, val):
    """``file[b, idx[b]] = val[b]`` in place; returns ``file``."""
    if _build.on_cpu("slot_set", file):
        return slot_set_reference(file, idx, val)
    return _launch("slot_set", file, _idx32(idx), val.contiguous())


def slot_zero(file, idx):
    """``file[b, idx[b]] = 0`` in place; returns ``file``."""
    if _build.on_cpu("slot_zero", file):
        return slot_zero_reference(file, idx)
    return _launch("slot_zero", file, _idx32(idx), None)


def slot_add(file, idx, val):
    """``file[b, idx[b]] += val[b]`` in place; returns ``file``."""
    if _build.on_cpu("slot_add", file):
        return slot_add_reference(file, idx, val)
    return _launch("slot_add", file, _idx32(idx), val.contiguous())


def slot_add_many(entries):
    """``file[b, idx[b]] += val[b]`` for each ``(file, idx, val)`` of
    ``entries`` in the order given, in place; returns the files. Entries
    may share a file (the same tensor) and a slot: the adds happen in turn,
    each rounded on its own, so the result is that of ``slot_add`` on each
    entry in turn. On CUDA tensors one launch for up to ``MAX_ADDS``
    entries of one dtype and one batch; on CPU tensors the plain
    version."""
    entries = [(f, i, v) for f, i, v in entries]
    if not entries:
        return ()
    if _build.on_cpu("slot_add_many", entries[0][0]):
        return slot_add_many_reference(entries)
    key = "slot_add_many"
    if len(entries) > MAX_ADDS:
        raise ValueError(f"{key}: {len(entries)} entries, the kernel takes "
                         f"at most {MAX_ADDS}")
    file0 = entries[0][0]
    dt, dev, B = file0.dtype, file0.device, file0.shape[0]
    live = []
    for file, idx, val in entries:
        if file.dtype != dt or file.device != dev or file.shape[0] != B:
            raise ValueError(f"{key}: every file must be {dt} on {dev} with "
                             f"batch {B}, got {file.dtype} on {file.device} "
                             f"of shape {tuple(file.shape)}")
        idx, val = _idx32(idx), val.contiguous()
        if _checked(key, file, idx, val) and file.shape[1]:
            live.append((file, idx, val))
    files = tuple(f for f, _, _ in entries)
    if B == 0 or not live:
        return files
    n = len(live)
    P = ctypes.c_void_p * n
    err = _build.build().stair_slot_add_many(
        P(*[f.data_ptr() for f, _, _ in live]),
        P(*[i.data_ptr() for _, i, _ in live]),
        P(*[v.data_ptr() for _, _, v in live]),
        (ctypes.c_long * n)(*[math.prod(f.shape[2:]) for f, _, _ in live]),
        (ctypes.c_int * n)(*[f.shape[1] for f, _, _ in live]), n, B,
        int(dt == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(err, key)
    _build.LAUNCHES[key] += 1
    return files
