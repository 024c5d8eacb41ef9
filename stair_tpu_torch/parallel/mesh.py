"""Data-parallel ranks and the placement rules for the NMN training step
(port of ``stair_tpu/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` of ``dp x tp`` devices and
runs the NMN step under ``jax.shard_map`` on it: every example-axis batch
array is cut into ``dp`` contiguous shards, each shard runs the Pallas
kernels on its local batch, and the gradients are averaged with a
``pmean``. The ``tp`` axis replicates the NMN step (nothing in it is worth
tensor-sharding), and only the LLM family shards its weights over ``tp``.

The port runs the same data-parallel step as ``dp`` processes with a
``torch.distributed`` group each (``launch``): one card per rank with NCCL,
or ``--device cpu`` ranks with gloo; a caller may hand its own device list
and backend (two ranks sharing ``cuda:0`` over gloo, where a machine has one
card). Each rank takes its shard of the batch (``shard_batch``), runs the
kernels on it, and the ranks sum their gradients and metrics in one
all-reduce of a flat buffer in a fixed order (``DataParallel``). A ``tp``
axis adds no rank: it replicates the step, so its numbers are those of
``tp`` 1. ``param_sharding`` and ``llm_param_sharding`` are the JAX rules as
placement tables (for each leaf, the axis sharded over ``tp``, or None).

Where the JAX trainer would drop to its GSPMD route with the kernels off (a
batch that ``dp`` does not divide, a contrastive window that does not
divide the per-rank batch, a ``tp`` axis without ``dp``), the port has no
such route and refuses (``use_data_parallel``, ``plan``).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
import traceback
from dataclasses import dataclass

import torch

#: Batch-dict keys whose leading axis is NOT the example axis (shared
#: tables / sparse slot arrays) — replicated rather than dp-sharded.
REPLICATED_BATCH_KEYS = frozenset({
    "class_emb", "class_emb_mask", "class_valid", "class_token_ids",
    "ff_index", "ff_gold", "ff_valid",
})

#: seconds a rank waits in a collective or for its peers to join
TIMEOUT_S = 600


# ---------------------------------------------------------------------------
# placement rules
# ---------------------------------------------------------------------------

def mesh_shape(dp: int = 0, tp: int = 1, n_devices: int | None = None
               ) -> tuple[int, int]:
    """``make_mesh``'s arithmetic: ``dp`` 0 means every device over ``tp``
    (one where the device count is not bounded, as on the CPU); raises
    ``ValueError`` where ``dp x tp`` exceeds ``n_devices``."""
    if dp <= 0:
        dp = max(1, n_devices // tp) if n_devices is not None else 1
    need = dp * tp
    if n_devices is not None and need > n_devices:
        raise ValueError(
            f"mesh {dp}x{tp} needs {need} devices, have {n_devices}")
    return dp, tp


def _names(path):
    return [str(k) for k in path]


def _tree_map_with_path(rule, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(rule, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map_with_path(rule, v, path + (i,))
                for i, v in enumerate(tree)]
    return rule(_names(path), tree)


def param_sharding(params, tp: int):
    """The NMN's placement table: the decoder's vocab projection (``l2``)
    sharded over ``tp`` on its output axis where ``tp`` divides it, every
    other leaf replicated. Returns the params tree with each leaf replaced
    by the sharded axis or None."""
    def rule(names, leaf):
        if "decoder" in names and "l2" in names:
            if "w" in names and leaf.shape[1] % tp == 0:
                return 1
            if "b" in names and leaf.shape[0] % tp == 0:
                return 0
        return None

    return _tree_map_with_path(rule, params)


def llm_param_sharding(params, tp: int):
    """Megatron-style placement for the decoder-only LLM family: q/k/v and
    up/gate projections shard their output axis over ``tp``, o and down
    their input axis; ``lm_head`` its vocab axis where ``tp`` divides it;
    the embedding, norms and biases replicate. Returns the params tree with
    each leaf replaced by the sharded axis or None."""
    def rule(names, leaf):
        def ok(axis):
            return leaf.ndim >= 1 and leaf.shape[axis] % tp == 0

        if "layers" in names and "w" in names:
            if any(n in names for n in ("q", "k", "v", "up", "gate")):
                if ok(1):
                    return 1
            if any(n in names for n in ("o", "down")):
                if ok(0):
                    return 0
        if names[-1:] == ["embed"] or "lm_head" in names:
            if (leaf.ndim == 2 and leaf.shape[-1] % tp == 0
                    and "embed" not in names):
                return 1
        return None

    return _tree_map_with_path(rule, params)


def shard_batch(batch: dict, rank: int, dp: int) -> dict:
    """Rank ``rank``'s part of a batch dict (numpy arrays or tensors): an
    array whose leading axis has the length of ``answer`` (the example
    axis) is cut into ``dp`` contiguous equal shards when ``dp`` divides
    it; ``REPLICATED_BATCH_KEYS`` and every other array are replicated. A
    nested dict (``trace``) follows the same rule key by key."""
    bsz = batch["answer"].shape[0]
    per = bsz // dp

    def part(key, x):
        if key in REPLICATED_BATCH_KEYS:
            return x
        if (getattr(x, "ndim", 0) >= 1 and x.shape[0] == bsz
                and bsz % dp == 0):
            return x[rank * per:(rank + 1) * per]
        return x

    return {key: ({k: part(k, v) for k, v in val.items()}
                  if isinstance(val, dict) else part(key, val))
            for key, val in batch.items()}


def use_data_parallel(args, dp: int) -> bool:
    """Whether the step runs on ``dp`` ranks: True for ``dp`` > 1 when the
    batch splits into equal contiguous shards and the contrastive window
    divides the per-rank batch (``use_shard_map``'s rule); False for one
    rank. Where the rule fails the JAX trainer falls back to its GSPMD
    route with the kernels off; the port has no such route, and this
    raises ``ValueError`` naming the rule."""
    if dp <= 1:
        return False
    bsz = getattr(args, "batch_size", None)
    if bsz is not None and bsz % dp != 0:
        raise ValueError(
            f"--batch-size {bsz} does not split into {dp} equal shards: "
            f"data parallel needs batch_size % dp == 0 (the JAX trainer "
            f"would fall back to GSPMD with its kernels off; the port has "
            f"no such route)")
    window = getattr(args, "contrastive_window", 0) or 0
    if window and bsz is not None and (bsz // dp) % window != 0:
        raise ValueError(
            f"--contrastive-window {window} does not divide the per-rank "
            f"batch {bsz // dp}: data parallel needs (batch_size / dp) % "
            f"window == 0 (the JAX trainer would fall back to GSPMD with "
            f"its kernels off; the port has no such route)")
    return True


def plan(args, device: torch.device):
    """The CLIs' rule (``--mesh-dp``, ``--mesh-tp`` on ``device``): None for
    one device, else ``(dp, devices, backend)``: one card per rank with
    NCCL, or ``dp`` CPU ranks with gloo. Prints the JAX trainer's lines;
    where the mesh needs more cards than there are, prints its message and
    runs on one device, as the JAX trainer does."""
    if args.mesh_dp == 1 and args.mesh_tp == 1:
        return None
    n = torch.cuda.device_count() if device.type == "cuda" else None
    try:
        dp, tp = mesh_shape(args.mesh_dp, args.mesh_tp, n)
    except ValueError as err:
        print("mesh unavailable, running single-device:", err)
        return None
    if dp * tp == 1:
        return None
    print("mesh:", {"dp": dp, "tp": tp})
    if dp == 1:
        raise ValueError(
            f"mesh 1x{tp}: a tp axis alone takes the JAX trainer's GSPMD "
            f"route with its kernels off, which the port does not have; the "
            f"NMN step only replicates over tp, so pass --mesh-tp 1")
    use_data_parallel(args, dp)
    backend = "nccl" if device.type == "cuda" else "gloo"
    print("mesh: data-parallel route, kernels enabled"
          + (f" (the tp axis replicates the NMN step: {dp} ranks run, and "
             f"the numbers are those of --mesh-tp 1)" if tp > 1 else "")
          + ("; NCCL across cards is unverified: this route has not yet "
             "run on more than one card" if backend == "nccl" else ""))
    from stair_tpu_torch.utils.device import pick_device

    devices = [pick_device(device.type, r) for r in range(dp)]
    return dp, devices, backend


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

@dataclass
class DataParallel:
    """One rank of a data-parallel group: its index, the group's size, its
    device and the ``torch.distributed`` backend. gloo takes no collective
    but ``all_reduce`` and ``broadcast`` on CUDA tensors, so under gloo the
    collectives stage through host memory."""

    rank: int
    size: int
    device: torch.device
    backend: str

    def _host(self, t):
        return t.cpu() if self.backend == "gloo" and t.is_cuda else t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (equal bits on every rank)."""
        import torch.distributed as dist

        buf = self._host(t.contiguous()).clone()
        dist.all_reduce(buf)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated on axis 0 in rank order."""
        import torch.distributed as dist

        buf = self._host(t.contiguous())
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf)
        return torch.cat(parts).to(t.device)

    def broadcast_(self, tensors, src: int = 0):
        """Copy rank ``src``'s ``tensors`` into every rank's, in place, in
        one collective."""
        import torch.distributed as dist

        tensors = list(tensors)
        flat = self._host(torch.cat([
            t.detach().reshape(-1).float() for t in tensors]))
        dist.broadcast(flat, src)
        off = 0
        with torch.no_grad():
            for t in tensors:
                t.copy_(flat[off:off + t.numel()].view(t.shape))
                off += t.numel()

    def average_gradients(self, params, means=(), sums=()):
        """JAX's ``pmean`` of the gradients (and of the scalar ``means``)
        and ``psum`` of ``sums``, in one all-reduce of a flat float32
        buffer in parameter order: every ``p.grad`` is replaced by the mean
        over the ranks. Returns ``(means, sums)`` reduced."""
        params = list(params)
        means = [torch.as_tensor(m).reshape(-1).float() for m in means]
        sums = [torch.as_tensor(s).reshape(-1).float() for s in sums]
        flat = torch.cat([p.grad.reshape(-1).float() for p in params]
                         + means + sums)
        flat = self.all_reduce_sum(flat)
        n_mean = sum(p.numel() for p in params) + sum(m.numel() for m in means)
        flat[:n_mean] /= self.size
        off = 0
        for p in params:
            p.grad.copy_(flat[off:off + p.numel()].view(p.shape))
            off += p.numel()
        out_means, out_sums = [], []
        for src, dst in ((means, out_means), (sums, out_sums)):
            for m in src:
                dst.append(flat[off:off + m.numel()])
                off += m.numel()
        return out_means, out_sums


def free_port() -> int:
    """A TCP port on the loopback interface that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, dp, devices, backend, port, threads, fn, args, queue):
    import torch.distributed as dist

    torch.set_num_threads(threads)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        with open(os.devnull, "w") as null, contextlib.ExitStack() as quiet:
            if rank != 0:   # rank 0 alone prints
                quiet.enter_context(contextlib.redirect_stdout(null))
            dist.init_process_group(
                backend, init_method=f"tcp://127.0.0.1:{port}",
                world_size=dp, rank=rank,
                timeout=datetime.timedelta(seconds=TIMEOUT_S))
            try:
                result = fn(DataParallel(rank, dp, device, backend), *args)
            finally:
                dist.destroy_process_group()
        queue.put((rank, True, result))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, dp: int, devices, backend: str, args: tuple = ()) -> list:
    """Run ``fn(DataParallel, *args)`` on ``dp`` ranks, each a spawned
    process on its entry of ``devices`` with a ``torch.distributed`` group
    of ``backend`` on the loopback interface, and return their results in
    rank order. ``plan`` picks the devices and backend for the CLIs; a
    caller may hand its own (two ranks may share a card under gloo). ``fn``
    and ``args`` travel by pickle (``fn`` by its import path). The ranks
    split this process's torch threads between them. Raises with the rank's
    traceback when a rank fails, or after ``TIMEOUT_S`` without a result."""
    import multiprocessing as mp
    import queue as queue_mod

    devices = [str(d) for d in devices]
    if len(devices) != dp:
        raise ValueError(f"{dp} ranks need {dp} devices, got {devices}")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    threads = max(1, torch.get_num_threads() // dp)
    procs = [ctx.Process(target=_rank_main, args=(
        r, dp, devices, backend, port, threads, fn, args, queue))
        for r in range(dp)]
    for p in procs:
        p.start()
    results, errors, done = [None] * dp, [], set()
    try:
        waited = 0.0
        while len(done) < dp and not errors:
            try:
                rank, ok, payload = queue.get(timeout=1.0)
            except queue_mod.Empty:
                waited += 1.0
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"ranks {dead} exited with "
                                  f"{[procs[r].exitcode for r in dead]}")
                elif waited > TIMEOUT_S:
                    errors.append(f"no result for {TIMEOUT_S} s")
                continue
            waited = 0.0
            done.add(rank)
            if ok:
                results[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
    finally:
        for p in procs:
            if errors or len(done) < dp:
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("a data-parallel rank failed\n" + "\n".join(errors))
    return results
