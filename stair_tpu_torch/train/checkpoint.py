"""Parameter checkpoints in the JAX package's format (``params.msgpack``).

The JAX trainers write ``flax.serialization.to_bytes(params)``: a msgpack
document of nested maps with string keys (a list becomes a map keyed
``"0", "1", ...``), every array an ext object of type 1 that holds the
msgpack tuple ``(shape, dtype name, row-major bytes)``; an array above
2**30 bytes is split into a ``__msgpack_chunked_array__`` map of flat
chunks. This module reads and writes that format with the standard library
and numpy alone (the codec: ``to_bytes`` / ``from_bytes``), so a checkpoint
of either package loads into the other, and bridges it to the port's
modules (``save_params`` / ``load_params``; these import torch).

numpy has no bfloat16: the codec carries such an array as ``Bfloat16Array``
(its uint16 bit patterns) and ``save_params`` / ``load_params`` convert to
and from ``torch.bfloat16``.

``load_params`` has the tolerance of the JAX package's: leaves present in
both are restored (shapes must match), leaves only in the model keep their
initialisation, leaves only in the checkpoint are ignored, and both cases
are reported.

A trainer checkpoint directory holds what the JAX trainer's does
(``save_checkpoint``): ``params.msgpack``, ``config.json``,
``opt_state.msgpack`` and ``trainer_state.json`` (``step``, ``best_acc``,
``rng``). The optimizer state is written in optax's tree layout, as
``flax.serialization.to_bytes`` writes ``optax.adam(schedule)``'s state
(``{"0": {count, mu, nu}, "1": {count}}``) or ``optax.adamw``'s (``{"0":
{count, mu, nu}, "1": {}, "2": {count}}``), counts as int32 scalars and the
moments as float32 trees under the params' key paths. ``torch.optim.Adam``
/ ``AdamW``'s ``exp_avg``, ``exp_avg_sq`` and ``step`` and the scheduler's
``last_epoch`` map onto those leaves (``opt_state_tree`` /
``restore_opt_state``), so either package resumes the other's run.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


class Bfloat16Array:
    """A bfloat16 array as its uint16 bit patterns (``bits``)."""

    def __init__(self, bits: np.ndarray):
        self.bits = np.ascontiguousarray(bits, dtype=np.uint16)

    @property
    def shape(self):
        return self.bits.shape

    def to_float32(self) -> np.ndarray:
        return (self.bits.astype(np.uint32) << 16).view(np.float32)


# ---------------------------------------------------------------------------
# msgpack encoder
# ---------------------------------------------------------------------------

def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -32 <= n < 0:
        return struct.pack("b", n)
    for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                             (0xFFFFFFFF, 0xCE, ">I"),
                             (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
        if 0 <= n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    for bits, code, fmt in ((7, 0xD0, ">b"), (15, 0xD1, ">h"),
                            (31, 0xD2, ">i"), (63, 0xD3, ">q")):
        if -(1 << bits) <= n < 0:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_len(n, fix, fix_max, codes):
    """A length header: the fix form below ``fix_max``, else the 8/16/32-bit
    forms of ``codes`` (None where the type has no such form)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, limit, fmt in zip(codes, (0xFF, 0xFFFF, 0xFFFFFFFF),
                                (">B", ">H", ">I")):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack_ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    if fix is not None:
        head = bytes([fix])
    else:
        head = _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack("b", code) + data


def _array_payload(shape, dtype_name: str, raw: bytes) -> bytes:
    return b"".join([
        _pack_len(3, 0x90, 15, (None, 0xDC, 0xDD)),
        _pack(list(shape)), _pack(dtype_name), _pack(raw)])


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): int(n) for i, n in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(x) -> bytes:
    if x is None:
        return b"\xc0"
    if isinstance(x, bool):
        return b"\xc3" if x else b"\xc2"
    if isinstance(x, int):
        return _pack_int(x)
    if isinstance(x, float):
        return b"\xcb" + struct.pack(">d", x)
    if isinstance(x, str):
        raw = x.encode("utf-8")
        return _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(x, (bytes, bytearray, memoryview)):
        return _pack_len(len(x), None, 0, (0xC4, 0xC5, 0xC6)) + bytes(x)
    if isinstance(x, dict):
        out = [_pack_len(len(x), 0x80, 15, (None, 0xDE, 0xDF))]
        for k, v in x.items():
            out.append(_pack(str(k)))
            out.append(_pack(v))
        return b"".join(out)
    if isinstance(x, (list, tuple)):
        # inside an array payload only (a shape); trees never reach here
        # with a list: ``to_bytes`` turns those into maps first
        return _pack_len(len(x), 0x90, 15, (None, 0xDC, 0xDD)) + b"".join(
            _pack(int(v)) for v in x)
    if isinstance(x, Bfloat16Array):
        return _pack_ext(EXT_NDARRAY, _array_payload(
            x.shape, "bfloat16", x.bits.tobytes("C")))
    if isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.fields is not None:
            raise ValueError("object and structured arrays are not "
                             "supported in a checkpoint")
        if x.size * x.dtype.itemsize > MAX_CHUNK_SIZE:
            return _pack(_chunk(x))
        return _pack_ext(EXT_NDARRAY, _array_payload(
            x.shape, x.dtype.name, x.tobytes("C")))
    if isinstance(x, np.generic):
        a = np.asarray(x)
        return _pack_ext(EXT_NPSCALAR, _array_payload(
            a.shape, a.dtype.name, a.tobytes("C")))
    raise TypeError(f"cannot serialize {type(x).__name__}")


def _state_dict(tree):
    """Lists and tuples become maps keyed by their decimal index."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def to_bytes(tree) -> bytes:
    """Nested dicts / lists of numpy arrays (``Bfloat16Array`` for bf16),
    numpy scalars and python scalars -> the msgpack bytes
    ``flax.serialization.to_bytes`` writes for the same tree."""
    return _pack(_state_dict(tree))


# ---------------------------------------------------------------------------
# msgpack decoder
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _array_from_payload(data) -> object:
    r = _Reader(data)
    shape, name, raw = _unpack(r)
    if isinstance(name, bytes):
        name = name.decode()
    shape = tuple(int(n) for n in shape)
    if name == "bfloat16":
        return Bfloat16Array(
            np.frombuffer(raw, dtype=np.uint16).reshape(shape).copy())
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()


def _unpack_ext(code: int, data):
    if code == EXT_NDARRAY:
        return _array_from_payload(data)
    if code == EXT_NPSCALAR:
        return _array_from_payload(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_NUMS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
         0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",       # bin
         0xD9: ">B", 0xDA: ">H", 0xDB: ">I",       # str
         0xDC: ">H", 0xDD: ">I",                   # array
         0xDE: ">H", 0xDF: ">I",                   # map
         0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}       # ext


def _unpack(r: _Reader):
    b = r.num("B")
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _unpack_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _NUMS:
        return r.num(_NUMS[b])
    if b in _FIXEXT:
        code = r.num("b")
        return _unpack_ext(code, r.take(_FIXEXT[b]))
    if b in _LENS:
        n = r.num(_LENS[b])
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(r.take(n))
        if b in (0xD9, 0xDA, 0xDB):
            return bytes(r.take(n)).decode("utf-8")
        if b in (0xDC, 0xDD):
            return [_unpack(r) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return _unpack_map(r, n)
        code = r.num("b")
        return _unpack_ext(code, r.take(n))
    raise ValueError(f"unsupported msgpack byte 0x{b:02x}")


def _unpack_map(r: _Reader, n: int):
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    if _CHUNKED in out:
        shape = tuple(out["shape"][str(i)] for i in range(len(out["shape"])))
        chunks = [out["chunks"][str(i)] for i in range(len(out["chunks"]))]
        if isinstance(chunks[0], Bfloat16Array):
            return Bfloat16Array(np.concatenate(
                [c.bits for c in chunks]).reshape(shape))
        return np.concatenate(chunks).reshape(shape)
    return out


def from_bytes(data: bytes):
    """The inverse of ``to_bytes`` (``flax.serialization.msgpack_restore``):
    nested dicts with string keys, a saved list as a dict keyed ``"0",
    "1", ...``; arrays as numpy arrays, bf16 as ``Bfloat16Array``."""
    r = _Reader(data)
    out = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack document")
    return out


# ---------------------------------------------------------------------------
# the port's modules
# ---------------------------------------------------------------------------

def _leaf_from_tensor(t):
    import torch

    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return Bfloat16Array(t.view(torch.int16).numpy().view(np.uint16))
    return t.numpy()


def _tensor_from_leaf(x):
    import torch

    if isinstance(x, Bfloat16Array):
        return torch.from_numpy(x.bits.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(x, copy=True))


def save_params(out_dir, tree):
    """Write ``<out_dir>/params.msgpack`` from a tree of tensors (a module's
    ``param_tree()`` or a part of it)."""
    from stair_tpu_torch.weights import tree_map

    os.makedirs(out_dir, exist_ok=True)
    data = to_bytes(tree_map(_leaf_from_tensor, tree))
    with open(os.path.join(out_dir, "params.msgpack"), "wb") as f:
        f.write(data)


def load_params(ckpt_dir, model):
    """Copy ``<ckpt_dir>/params.msgpack`` into the parameters of ``model``
    (anything with ``param_tree()``), in place, leaf by leaf by key path;
    values are cast to each parameter's dtype. Returns ``(missing, extra)``
    key paths and prints both when there are any."""
    import torch

    from stair_tpu_torch.weights import flatten_tree

    with open(os.path.join(ckpt_dir, "params.msgpack"), "rb") as f:
        raw = from_bytes(f.read())
    flat_t = flatten_tree(model.param_tree())
    flat_r = flatten_tree(raw)
    missing = sorted(set(flat_t) - set(flat_r))
    extra = sorted(set(flat_r) - set(flat_t))
    if missing:
        print(f"checkpoint missing {len(missing)} leaves "
              f"(kept fresh init): {missing[:4]}...")
    if extra:
        print(f"checkpoint has {len(extra)} unused leaves: {extra[:4]}...")
    with torch.no_grad():
        for key, param in flat_t.items():
            if key not in flat_r:
                continue
            value = _tensor_from_leaf(flat_r[key])
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(
                    f"checkpoint leaf {key}: shape {tuple(value.shape)} "
                    f"does not match the model's {tuple(param.shape)}")
            param.copy_(value.to(device=param.device, dtype=param.dtype))
    return missing, extra


# ---------------------------------------------------------------------------
# trainer checkpoints: config, optimizer state in optax's layout, trainer
# state
# ---------------------------------------------------------------------------

def save_checkpoint(out_dir, model, config_dict, opt_state=None,
                    trainer_state=None):
    """Write ``params.msgpack`` (``model.param_tree()``) and ``config.json``,
    and ``opt_state.msgpack`` (a tree from ``opt_state_tree``) and
    ``trainer_state.json`` when given: the JAX trainer's four files."""
    save_params(out_dir, model.param_tree())
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config_dict, f, indent=2)
    if opt_state is not None:
        with open(os.path.join(out_dir, "opt_state.msgpack"), "wb") as f:
            f.write(to_bytes(opt_state))
    if trainer_state is not None:
        with open(os.path.join(out_dir, "trainer_state.json"), "w") as f:
            json.dump(trainer_state, f)


def load_config(ckpt_dir) -> dict:
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        return json.load(f)


def load_trainer_state(ckpt_dir) -> dict | None:
    path = os.path.join(ckpt_dir, "trainer_state.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _is_adamw(optimizer) -> bool:
    import torch

    return isinstance(optimizer, torch.optim.AdamW)


def opt_state_tree(model, optimizer, scheduler) -> dict:
    """The state of ``optimizer`` (``torch.optim.Adam``, or ``AdamW`` for
    ``optax.adamw``) over ``model``'s parameters and of its ``scheduler``
    as the tree ``flax.serialization.to_state_dict`` gives for the optax
    state: Adam's count, ``mu`` (``exp_avg``) and ``nu`` (``exp_avg_sq``)
    under the params' key paths (zeros for a parameter that has no state
    yet), and the schedule's count (``last_epoch``)."""
    from stair_tpu_torch.weights import tree_map

    count = np.asarray(scheduler.last_epoch, np.int32)

    def moment(name):
        def leaf(p):
            st = optimizer.state.get(p)
            if not st:
                return np.zeros(tuple(p.shape), np.float32)
            return st[name].detach().float().cpu().numpy()
        return tree_map(leaf, model.param_tree())

    adam = {"count": count, "mu": moment("exp_avg"),
            "nu": moment("exp_avg_sq")}
    sched = {"count": count.copy()}
    if _is_adamw(optimizer):
        return {"0": adam, "1": {}, "2": sched}
    return {"0": adam, "1": sched}


def restore_opt_state(tree, model, optimizer, scheduler):
    """Load an optax-layout state tree (``opt_state_tree``'s, or the JAX
    trainer's ``opt_state.msgpack``) into ``optimizer`` and ``scheduler``,
    in place. The tree must be the layout of this optimizer (``adam`` or
    ``adamw``), with a moment of the parameter's shape at every key path of
    the model; the scheduler resumes at the saved count."""
    import torch

    from stair_tpu_torch.weights import flatten_tree

    want = ["0", "1", "2"] if _is_adamw(optimizer) else ["0", "1"]
    if sorted(tree) != want:
        raise ValueError(f"optimizer state holds chain entries {sorted(tree)}"
                         f", expected {want} for {type(optimizer).__name__}")
    adam, sched = tree["0"], tree[want[-1]]
    count = int(np.asarray(adam["count"]))
    if int(np.asarray(sched["count"])) != count:
        raise ValueError(f"optimizer state: Adam count {count} and schedule "
                         f"count {int(np.asarray(sched['count']))} differ")
    params = flatten_tree(model.param_tree())
    moments = {k: flatten_tree(adam[k]) for k in ("mu", "nu")}
    for k in ("mu", "nu"):
        if set(moments[k]) != set(params):
            missing = sorted(set(params) - set(moments[k]))
            extra = sorted(set(moments[k]) - set(params))
            raise ValueError(f"optimizer state {k}: missing {missing[:4]}, "
                             f"extra {extra[:4]}")
    for key, p in params.items():
        st = {"step": torch.tensor(float(count), dtype=torch.float32)}
        for k, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            value = _tensor_from_leaf(moments[k][key])
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"optimizer state {k}/{key}: shape "
                                 f"{tuple(value.shape)}, parameter "
                                 f"{tuple(p.shape)}")
            st[name] = value.to(device=p.device, dtype=p.dtype)
        optimizer.state[p] = st
    scheduler.set_step(count)
    return count


def load_opt_state(ckpt_dir, model, optimizer, scheduler):
    """``restore_opt_state`` from ``opt_state.msgpack`` in ``ckpt_dir``;
    returns the restored step count, or None when the file is not
    there."""
    path = os.path.join(ckpt_dir, "opt_state.msgpack")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return restore_opt_state(from_bytes(f.read()), model, optimizer,
                                 scheduler)
