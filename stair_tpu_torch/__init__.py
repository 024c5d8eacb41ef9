"""stair_tpu_torch — the PyTorch + CUDA (Hopper) port of ``stair_tpu``.

The JAX package ``stair_tpu`` is the reference; this package mirrors its
paths and names so each module has an obvious counterpart:

  * ``models/modules.py`` ↔ ``stair_tpu/models/modules.py`` (helpers, init)
  * ``models/nmn.py``     ↔ ``stair_tpu/models/nmn.py`` (``VideoNMN``)
  * ``ops/lstm.py``       ↔ ``stair_tpu/ops/lstm.py`` (BiLSTM recurrence)
  * ``ops/mega_exec.py``  ↔ ``stair_tpu/ops/mega_exec.py`` (executor)
  * ``ops/attention.py``   ↔ ``stair_tpu/ops/attention.py`` (flash attention)
  * ``llm/``              ↔ ``stair_tpu/llm/`` (decoder, CLIP, Video-ChatGPT)
  * ``testing/workload.py`` ↔ ``stair_tpu/testing/workload.py``

Every Pallas kernel on the ported path is a hand-written CUDA C++ kernel
under ``ops/csrc/``, built with ``nvcc`` for ``sm_90a`` at first use
(``ops/_build.py``). Each kernel wrapper runs its plain PyTorch version for
CPU tensors and launches the kernel (or raises) for CUDA tensors.

Nothing here imports ``jax`` or ``stair_tpu``: the host layers a ported
path needs (``programs/``, ``ir/``, ``runtime/`` with the C++ parser,
lowerer and tokenizer, ``train/args.py``, ``data/dataset.py``,
``testing/synthetic.py``, ``utils/snapshot.py``) are the port's own copies
at the same relative paths.
"""

from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN  # noqa: F401

__version__ = "0.1.0"
