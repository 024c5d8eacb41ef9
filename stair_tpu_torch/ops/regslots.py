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

For CUDA tensors every update runs in ``csrc/regslots.cu`` (TPU kernels
``_set_kernel``, ``_zero_kernel``, ``_add_kernel``); for CPU tensors the
plain versions ``slot_*_reference`` (advanced-index assignment) run. ``idx``
holds values in ``[0, N)``; ``val`` is ``[B, ...]`` in the file's dtype
(``slot_add`` adds in that dtype, one rounding, as the TPU kernel does).

``SlotPlan`` is the scan's route: a fixed list of up to ``MAX_ENTRIES``
updates of one kind, each a file and a ``[T, B]`` index table, checked and
described once; calling it with a step ``t`` makes that step's updates in
one launch, in the order given, with the result of the single updates on
each entry in turn (entries may share a file and a slot). A zero may read
the slot out into a ``[B, ...]`` tensor first. ``slot_set_many``,
``slot_zero_many`` and ``slot_add_many`` do the same for one list of
``[B]`` indices, and the single updates are their one-entry case.
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


def slot_set_many_reference(entries):
    """``slot_set_reference`` on each ``(file, idx, val)`` of ``entries``
    in turn; returns the files."""
    return tuple(slot_set_reference(f, i, v) for f, i, v in entries)


def slot_zero_many_reference(entries, outs=None):
    """For each ``(file, idx)`` of ``entries`` in turn: ``out[b] = file[b,
    idx[b]]`` where ``outs`` (parallel to ``entries``) names a tensor, then
    ``slot_zero_reference``; returns the files."""
    entries = list(entries)
    outs = [None] * len(entries) if outs is None else list(outs)
    for (f, i), o in zip(entries, outs, strict=True):
        if o is not None:
            o.copy_(f[_rows(f), i.long()])
        slot_zero_reference(f, i)
    return tuple(f for f, _ in entries)


def slot_add_many_reference(entries):
    """``slot_add_reference`` on each ``(file, idx, val)`` of ``entries``
    in turn; returns the files."""
    return tuple(slot_add_reference(f, i, v) for f, i, v in entries)


_INTS = _build.header_ints("regslots.cu")
#: entries one launch takes (``csrc/regslots.cu``)
MAX_ENTRIES = _INTS["MAX_ENTRIES"]
_KINDS = {"add": _INTS["KIND_ADD"], "set": _INTS["KIND_SET"],
          "zero": _INTS["KIND_ZERO"]}
_PLAIN = {"set": slot_set_many_reference, "add": slot_add_many_reference}


class _Launch(ctypes.Structure):
    """``SlotLaunch`` of ``csrc/regslots.cu``, field for field."""

    _fields_ = [("file", ctypes.c_void_p * MAX_ENTRIES),
                ("idx", ctypes.c_void_p * MAX_ENTRIES),
                ("buf", ctypes.c_void_p * MAX_ENTRIES),
                ("slot", ctypes.c_long * MAX_ENTRIES),
                ("N", ctypes.c_int * MAX_ENTRIES),
                ("n", ctypes.c_int), ("B", ctypes.c_int),
                ("kind", ctypes.c_int), ("bf16", ctypes.c_int)]


class SlotPlan:
    """Updates of one ``kind`` ("set", "zero" or "add") on a fixed list of
    ``entries``, made for one scan step ``t`` at a time.

    Each entry is ``(file, table)``: a ``[B, N, ...]`` file, updated in
    place, and a ``[T, B]`` int32 index table whose row ``t`` names the
    slots of step ``t``; a "zero" entry may add a ``[B, ...]`` tensor
    ``out`` of the file's dtype, ``(file, table, out)``, into which the slot
    is read before it is zeroed. ``plan(t, vals)`` ("set", "add": one
    ``[B, ...]`` value per entry) or ``plan(t)`` ("zero") makes the
    updates of step ``t`` on each entry in the order given and returns the
    files. The plan holds every tensor it was given: their storage must
    outlive it, and the read-outs are overwritten by the next call.

    On CUDA tensors everything but the values is checked when the plan is
    built (one dtype, device and batch; contiguous; at most
    ``MAX_ENTRIES`` entries) and described once for the kernel: a call
    passes ``t``, the values' pointers and the stream, and makes one
    launch, counted under ``key`` (``slot_<kind>_many`` unless given). On
    CPU tensors a call runs the plain versions in turn (``reference``).
    """

    def __init__(self, kind, entries, key=None):
        if kind not in _KINDS:
            raise ValueError(f"SlotPlan: unknown kind {kind!r}")
        self.kind = kind
        self.key = key or f"slot_{kind}_many"
        entries = [tuple(e) for e in entries]
        if any(len(e) not in ((2, 3) if kind == "zero" else (2,))
               for e in entries):
            raise ValueError(f"{self.key}: entries are (file, table)"
                             + (" or (file, table, out)"
                                if kind == "zero" else ""))
        self.files = tuple(e[0] for e in entries)
        self.tables = tuple(e[1] for e in entries)
        self.outs = tuple(e[2] if len(e) > 2 else None for e in entries)
        self.cpu = not entries or _build.on_cpu(self.key, entries[0][0])
        if not self.cpu:
            self._describe()

    def _describe(self):
        """Check the entries once and fill the kernel's description."""
        key, files = self.key, self.files
        if len(files) > MAX_ENTRIES:
            raise ValueError(f"{key}: {len(files)} entries, the kernel takes "
                             f"at most {MAX_ENTRIES}")
        f0 = files[0]
        dt, dev, B = f0.dtype, f0.device, f0.shape[0]
        if dt not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{key} kernel: unsupported dtype {dt}")
        T = self.tables[0].shape[0] if self.tables[0].dim() == 2 else -1
        d = _Launch()
        live, self._shapes = [], []
        for e, (file, table, out) in enumerate(zip(files, self.tables,
                                                   self.outs)):
            if file.dtype != dt or file.device != dev or file.shape[0] != B:
                raise ValueError(
                    f"{key}: every file must be {dt} on {dev} with batch "
                    f"{B}, got {file.dtype} on {file.device} of shape "
                    f"{tuple(file.shape)}")
            if file.dim() < 3:
                raise ValueError(f"{key}: file must be [B, N, ...], got "
                                 f"{tuple(file.shape)}")
            shape = (B, *file.shape[2:])
            _build.check_tensor(f"{key} file {e}", file, dt, file.shape, dev)
            _build.check_tensor(f"{key} table {e}", table, torch.int32,
                                (T, B), dev)
            if out is not None:
                _build.check_tensor(f"{key} out {e}", out, dt, shape, dev)
            self._shapes.append(shape)
            slot = math.prod(file.shape[2:])
            if not (slot and file.shape[1] and B):
                continue
            i = len(live)
            d.file[i], d.idx[i] = file.data_ptr(), table.data_ptr()
            d.buf[i] = None if out is None else out.data_ptr()
            d.slot[i], d.N[i] = slot, file.shape[1]
            live.append(e)
        d.n, d.B, d.kind = len(live), B, _KINDS[self.kind]
        d.bf16 = int(dt == torch.bfloat16)
        self._live, self._T, self._dt, self._dev = live, T, dt, dev
        self._launch = d
        self._fn = _build.build().stair_slot_launch

    def reference(self, t, vals=()):
        """The plain versions of step ``t``'s updates on each entry in
        turn; returns the files."""
        idx = [table[t] for table in self.tables]
        if self.kind == "zero":
            return slot_zero_many_reference(zip(self.files, idx), self.outs)
        return _PLAIN[self.kind](zip(self.files, idx, vals, strict=True))

    def __call__(self, t, vals=()):
        if self.cpu:
            return self.reference(t, vals)
        key, d = self.key, self._launch
        if not 0 <= t < self._T:
            raise IndexError(f"{key}: step {t} outside [0, {self._T})")
        if self.kind != "zero":
            vals = list(vals)
            if len(vals) != len(self.files):
                raise ValueError(f"{key}: {len(vals)} values for "
                                 f"{len(self.files)} entries")
            for i, e in enumerate(self._live):
                v = vals[e] = vals[e].contiguous()
                if (v.dtype != self._dt or v.device != self._dev
                        or v.shape != self._shapes[e] or v.requires_grad):
                    raise ValueError(
                        f"{key}: value {e} must be a detached "
                        f"{self._shapes[e]} {self._dt} tensor on "
                        f"{self._dev}, got {tuple(v.shape)} {v.dtype} on "
                        f"{v.device}")
                d.buf[i] = v.data_ptr()
        if d.n:
            _build.check(self._fn(ctypes.addressof(d), t,
                                  _build.stream_ptr(self._dev)), key)
            _build.LAUNCHES[key] += 1
        return self.files


def _idx32(idx):
    return idx if idx.dtype == torch.int32 else idx.to(torch.int32)


def _table(idx):
    """``[B]`` indices as the one-row table of a plan."""
    return _idx32(idx).contiguous().view(1, -1)


def slot_set_many(entries):
    """``file[b, idx[b]] = val[b]`` for each ``(file, idx, val)`` of
    ``entries`` in the order given, in place (a slot set twice keeps the
    last value); returns the files. On CUDA tensors one launch for up to
    ``MAX_ENTRIES`` entries of one dtype and one batch; on CPU tensors the
    plain version."""
    entries = [tuple(e) for e in entries]
    return SlotPlan("set", [(f, _table(i)) for f, i, _ in entries])(
        0, [v for _, _, v in entries])


def slot_zero_many(entries, outs=None):
    """For each ``(file, idx)`` of ``entries`` in the order given, in
    place: ``out[b] = file[b, idx[b]]`` where ``outs`` (parallel to
    ``entries``) names a ``[B, ...]`` tensor, then ``file[b, idx[b]] = 0``
    (a second read-out of one slot reads 0); returns the files. One launch
    on CUDA tensors, as ``slot_set_many``."""
    entries = list(entries)
    outs = [None] * len(entries) if outs is None else list(outs)
    return SlotPlan("zero", [
        (f, _table(i)) if o is None else (f, _table(i), o)
        for (f, i), o in zip(entries, outs, strict=True)])(0)


def slot_add_many(entries):
    """``file[b, idx[b]] += val[b]`` for each ``(file, idx, val)`` of
    ``entries`` in the order given, in place; returns the files. Entries
    may share a file (the same tensor) and a slot: the adds happen in turn,
    each rounded on its own, so the result is that of ``slot_add`` on each
    entry in turn. One launch on CUDA tensors, as ``slot_set_many``."""
    entries = [tuple(e) for e in entries]
    return SlotPlan("add", [(f, _table(i)) for f, i, _ in entries])(
        0, [v for _, _, v in entries])


def slot_set(file, idx, val):
    """``file[b, idx[b]] = val[b]`` in place; returns ``file``."""
    SlotPlan("set", [(file, _table(idx))], "slot_set")(0, [val])
    return file


def slot_zero(file, idx):
    """``file[b, idx[b]] = 0`` in place; returns ``file``."""
    SlotPlan("zero", [(file, _table(idx))], "slot_zero")(0)
    return file


def slot_add(file, idx, val):
    """``file[b, idx[b]] += val[b]`` in place; returns ``file``."""
    SlotPlan("add", [(file, _table(idx))], "slot_add")(0, [val])
    return file
