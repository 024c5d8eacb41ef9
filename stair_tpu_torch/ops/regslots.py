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
"""

from __future__ import annotations

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


def _launch(key, file, idx, val):
    if file.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{key} kernel: unsupported dtype {file.dtype}")
    if file.dim() < 3:
        raise ValueError(f"{key}: file must be [B, N, ...], got "
                         f"{tuple(file.shape)}")
    dev = file.device
    B, N = file.shape[:2]
    _build.check_tensor(f"{key} file", file, file.dtype, file.shape, dev)
    _build.check_tensor(f"{key} idx", idx, torch.int32, (B,), dev)
    slot = math.prod(file.shape[2:])
    if val is not None:
        _build.check_tensor(f"{key} val", val, file.dtype,
                            (B, *file.shape[2:]), dev)
    if B == 0 or slot == 0:
        return file
    fn = getattr(_build.build(), f"stair_{key}")
    vals = () if val is None else (val.data_ptr(),)
    err = fn(file.data_ptr(), idx.data_ptr(), *vals, B, N, slot,
             int(file.dtype == torch.bfloat16), _build.stream_ptr(dev))
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
