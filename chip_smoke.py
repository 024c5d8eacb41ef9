#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU: the NMN serving
forward and train step (on the megakernel route, and on the scan
executor's per-step and reversible routes), the NMN's trainer and
evaluate CLIs, the program parser, Video-ChatGPT serving and its demo
server, data-parallel NMN training and evaluation, and LLM training.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. device: refuse to run without CUDA; print the card's name and power
   limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them;
2. build: compile the CUDA kernels from ``stair_tpu_torch/ops/csrc``, print
   every kernel's ptxas registers and spills, and fail on a spill in the
   tensor-core kernels (the attention backward's and the executor's), the
   BiLSTM's float32 cluster kernels (forward, walk, dwh) and the
   executor's float32 "fma32" kernels (forward, walk, weight gradients and
   their row index, the step kernel), and on more than 128 registers a
   thread in the "fma32" step kernel (two CTAs an SM);
3. BiLSTM forward kernels vs their plain version at the slice's shapes (B
   = 1024, h = 256; video L = 64 / D = 1024, question L = 16 / D = 300),
   with non-suffix masks and an all-padding row: float32 on the float32
   cluster route and the general route (equal bits on every output), bf16
   on the cluster route and the general route, both dtypes also at the
   batches whose tiles ``lstm.fwd_tile`` picks
   otherwise (the train step's 128, the class table's 64, a ragged 125);
   two launches of each with identical bits;
4. executor kernel vs its plain version over the all-opcode program set at
   H = 512, both Filter modes and both temporal modes (F = 16 linear,
   F = 64 conv), float32 on both of its routes (the "fma32" kernel and the
   general one: equal bits in every file, each timed, ``[f32]``) and bf16
   on both of its routes (the tensor-core kernel and the general one);
5. the slice end to end at the bench configuration (H = 512, video 1024,
   text 300, F = 64, 172 answers, bf16, B = 1024, the 128-program pool):
   native parse/lower with span linking, tokenization to ids, pinned H2D,
   device embedding gather, ``VideoNMN.forward``, logits fetch — for a few
   batches, with launch counters proving both kernels ran (the BiLSTM on
   its cluster route and the executor on its tensor-core route, none on
   the general routes), kernel vs plain route on one batch, and both
   executor routes against the plain version on the main path's inputs;
6. BiLSTM training kernels (forward with state stacks, backward and its
   dwh/dbias reduction) vs their plain versions at the training shapes
   (B = 128, h = 256; video L = 64 / D = 1024, question L = 16 / D = 300),
   float32 and bf16, with holes and an all-padding row; the forward and
   the backward each on both of their routes (bf16: the cluster route and
   the general route; float32: the float32 cluster routes and the
   general routes, the forward's equal bits, the backward's within 1e-4 of
   each other and equal bits in dxp at each row's first valid walk step),
   the backward on the cluster forward's stacks (float32: the same bits on
   the general forward's), two runs of each with identical bits; float32
   timed (``[f32]`` lines: #3 on both routes beside ``nn.LSTM``);
7. executor training kernels (forward with dropout 0.25, backward and its
   weight-gradient reduction) vs their plain versions over the all-opcode
   programs at H = 512, both Filter modes and both temporal modes, float32
   on both routes ("fma32" and general: equal bits in every file and
   gradient; three runs, the last two on inputs moved by 1e-4 to move ReLU
   kinks: all within 5e-2, two of three within 1e-4; #5 and #6 timed on
   both, #6 as walk and weight gradients too) and bf16 on both routes
   (tensor-core and general: the forward within atol 3e-2 + rtol 1e-2, the
   backward within 1e-1, each backward handed its own route's forward);
   two backward runs must give identical bits; the tensor-core walk's
   recompute products against the training forward's own calls at the
   walk's shapes (the matrix and the vec-level products, alone and as
   stage 1's chained pair): equal bits;
8. the training slice at ``scripts/bench_train_step.py``'s configuration
   (H = 512, video 1024, text 300, F = 64, 172 answers, 64 object types,
   bf16, dropout 0.25, B = 128, fake supervision, Adam at lr 2e-4 with the
   trainer's 1.0 -> 0.1 schedule): 10 steps on the kernel route with launch
   counts per step (the BiLSTM forward and backward on their cluster
   routes, the executor forward and backward on their tensor-core routes,
   none on the general routes) and a falling loss, one step kernel vs
   plain route (the loss in bf16; the gradients leaf by leaf in float32,
   where rounding sites agree; the float32 step's launches exactly
   ``TRAIN_LAUNCHES_F32``), the float32 step's ms on its main path, with
   the executor on its general routes and with the BiLSTM backward on its
   general route, in turns; ``F32_STEPS`` counted float32 steps and one
   counted float32 eval forward (``EVAL_LAUNCHES_F32``), whose "fma32"
   kernels (#4, #5, #6) are held against their plain versions and the
   general route (equal bits) and timed on both routes at B 128 (``[f32]``
   and three ``kernels`` entries), ms per step on both routes, each
   training
   kernel against
   its plain version on the step's own inputs (the executor backward on
   each route handed that route's forward's register files, as the step
   hands them, against autograd at those files, within 1e-1; and on the
   plain forward's files against autograd through the plain forward,
   within 1e-1) and its time beside its plain version's at these shapes
   (the BiLSTM forward and backward and the executor forward and backward
   also on their general routes);
9. the attention kernel vs its plain version: B = 4, H = 32, D = 128 at
   L = 640 and a ragged L = 611 (strided views), grouped heads 32 / 8,
   D = 64 with mixed ``prefix_len``, non-causal with Lq != Lkv, a head_dim
   the tensor-core kernels refuse, ``valid_len`` from 0 to L and at 1,
   127, 128, 129 (edges of the tensor-core kernels' query tiles), rows
   one element off 16 bytes and rows of D + 1 elements; each case on the
   route ``attention.route`` picks (bf16 ``"mma"``, float32 ``"mma32"``
   where the rows are aligned and D is 64 or 128, else ``"simple"``; the
   route tally shows it), out and lse, float32 within 1e-4 and bf16 within
   2e-2; float32 also against ``flash_fwd_simple`` (1e-4, the same +inf
   pattern) and against itself on a second launch (equal bits); a forced
   tensor-core route on the unaligned rows must raise; float32 at the LLM
   trainer CLIs' shapes (``with_video_lm``'s reply and video forwards, the
   SFT step's) and at L = 640, D = 128, each checked as above on
   ``"mma32"`` at its timed lengths and with ragged ``valid_len``, then
   timed on ``"mma32"`` and ``"simple"`` beside the plain version, SDPA
   float32 and the bound (bytes against three TF32 products a product at
   495 TFLOP/s, with the 67 TFLOP/s float32 figure beside); bf16 timed beside the plain
   version's and ``scaled_dot_product_attention``'s (a yardstick only),
   the kernel's and the yardstick's as device time over calls replayed
   from a CUDA graph (``graph_ms``: the wrapper's host time exceeds the
   kernel's), as in phase 10's kernel entry;
10. Video-ChatGPT serving at full width: Llama-7B (32 layers, d 4096) and
   CLIP ViT-L/14 in bf16 with weights made on the card from a seed, batch
   4, 100 frames per video, 64 new tokens, greedy: ``encode_video_batch``
   then ``video_chatgpt_infer_batch``, with 32 attention launches per
   prefill, finite logits and four strings; then at 2 decoder + 2 tower
   layers of the same widths the kernel route against the plain route
   (prefill hidden states below ``prompt_len``, first greedy token); then
   one ``VideoPrefixLM.forward`` at GPT-2 widths with the video-visible
   prefix mask against its plain route;
11. the attention backward kernels (dQ; dK/dV) vs their plain version over
   the mask cases of phase 9 plus grouped heads with one kv head and D = 32,
   float32 (within 2e-4 of each gradient's largest value) and bf16 (within
   2e-2), on strided q/k/v and a non-contiguous dO, each on the route
   ``attention.route`` picks (bf16 ``"mma"``, float32 ``"mma32"`` at D 64
   and 128, else ``"simple"``; the backward's route tally shows it):
   identical bits on a second launch, padding rows exactly 0, no NaN at
   ``valid_len`` 0, the ``di`` that the dQ launch writes against the plain
   version's (1e-5 of each row's sum of |O dO|, 0 on padding rows), and
   exactly two CUDA launches in one backward, the route's two kernels
   (``torch.profiler``'s device events); a float32 case on ``"mma32"`` also
   against the forced ``"simple"`` backward (2e-4); float32 rows one
   element off 16 bytes and dO rows of D + 1 floats, on which a forced
   ``"mma32"`` backward must raise; float32 at the LLM trainer CLIs' shapes
   and at L = 640, D = 128, each checked as above on ``"mma32"`` at its
   timed lengths and with ragged ``valid_len``, then the dQ launch, the
   dK/dV launch and the whole backward on ``"mma32"``, the whole backward
   on ``"simple"``, SDPA float32's autograd backward (its kernels named)
   timed by CUDA-graph replay, the plain version by CUDA events, beside
   the bounds (bytes against three TF32 products a product at 495 TFLOP/s,
   and the 67 TFLOP/s float32 figure); the build's ptxas lines for every
   kernel, with no spill allowed in the backward's tensor-core kernels;
12. the SFT train step at full width: phase 10's Llama-7B in bf16 with the
   projector alone tuned (in float32), batch 8 x 512 tokens with ragged
   ``valid_len``, through ``videochat_train.make_sft_step``: a finite loss
   that falls on the repeated batch, 32 + 32 + 32 attention launches per
   step, ms per step and peak memory without remat and with
   ``remat='full'``; then at 2 decoder layers of full width every gradient
   leaf of the kernel route against the plain route in float32, and the
   bf16 loss of both routes; on the step's own q, k, v the backward
   kernels against their plain version, and their times (each kernel and
   the whole backward, ``di`` included, by CUDA-graph replay) beside the
   plain version's and autograd through ``scaled_dot_product_attention``
   (a yardstick only);
13. both trainers as entry points on the card at their CLI defaults, on
   seeded tiny data: ``videochat_train.main`` then ``videochat_infer`` on
   the checkpoint it saved; ``with_video_lm.main`` for the GPT-2 family
   with the video loss and for Llama with LoRA, each then ``--func test``
   on what it saved; every attention forward and backward launch of these
   float32 runs on the ``"mma32"`` route (``attention.ROUTE_LAUNCHES``,
   ``attention.BWD_ROUTE_LAUNCHES``), and the ``kernels`` line gets phase
   9's float32 ``flash_attn`` entry and phase 11's float32
   ``flash_attn_bwd_dq`` and ``flash_attn_bwd_dkv`` entries (``"dtype":
   "float32"``) with the VideoGPT run's launches;
14. the register-slot kernels (set, zero, add) vs their plain versions on
   the three register files at the training shapes (B = 128: vec
   ``[128, 25, 512]``, frames ``[128, 9, 64, 512]``, attn ``[128, 11, 64]``),
   float32 and bf16, random slots including the scratch slot: equal bits,
   and every other slot equal to what it was; ``slot_add_many`` on the
   seven adds of a ``"rev"`` step (repeated slots: vb = va, fb = fa, ab =
   aa on some examples) in one launch: equal bits to the seven plain adds
   and to seven ``slot_add`` launches in turn; its time beside the seven
   launches', seven ``index_put_(accumulate=True)`` and the bound; in the
   same way ``slot_set_many`` on the four sets of a step and
   ``slot_zero_many`` on its eight reads-and-zeros (four output cotangents
   read out, then zeroed, then the same slots of the register files; the
   two attn entries on one slot for half the examples): equal bits, the
   read-outs included, to the plain versions and to the one-entry
   launches in turn (a gather before each zero that reads out), and each
   one launch's time as the executor makes it (one ``SlotPlan`` call)
   back to back and by CUDA-graph replay, beside the one-entry launches'
   (both ways), the plain versions', ``index_put_``'s and the bound;
15. the fused executor-step kernel vs its plain version at every step of
   the all-opcode programs at H = 512 (F = 16 linear and F = 64 conv
   temporal, and the NMN CLIs' F = 150, where both routes below run over
   frame-row tiles: "fma32" over ``gemm32``'s row tiles, the tensor-core
   route in its row-slice mode), float32 on both of its routes (the
   "fma32" kernel, which ``step_route`` picks, and the general one) within
   1e-4, each "fma32"
   call also against the general route on clones (equal bits in every
   output and the whole frames file), and bf16 on both of its routes (the
   tensor-core kernel, which ``step_route`` picks, and the general one)
   within atol 3e-2 + rtol 1e-2: every output and the whole frames file,
   ``T`` launches of the route's key; the float32 forward's 16 launches at F
   64 timed on both float32 routes (``[f32]``);
16. the serving path at full width on the scan executor (phase 5's
   configuration and batches through ``VideoNMN(executor="step")``): per
   batch ``T`` launches of the tensor-core step kernel, none of the
   general one, 2 of the BiLSTM kernel and none of the megakernel; logits
   and the three register files against the megakernel route on one batch
   (an example whose Choose step saw two cosines tie within bf16 rounding,
   and kept another keyword on each route, is held to that tie and left
   out of the file comparison); q/s and device ms per batch beside that
   route's; the 13 launches of the batch on both routes against the plain
   version, with their times and bound. Then the same in float32
   (``compute_dtype="float32"``, the same weights): per batch ``T``
   launches of the "fma32" step kernel, none of the other two, 2 of the
   BiLSTM's float32 cluster kernel and no megakernel; the logits against
   the float32 megakernel route (its "fma32" #4; argmax agreement >= 0.98,
   the register files' max abs errors printed) and the plain route (>=
   0.98); q/s and device ms per batch beside the bf16 step route's and the
   float32 megakernel's; the batch's 13 calls on the "fma32" route against
   the general route (equal bits) and the plain version (1e-4), timed on
   both routes (``[f32]``);
17. the train step on the reversible executor (phase 8's configuration with
   ``executor="rev"``): per step ``T`` launches each of ``slot_set_many``
   (a step's four sets), ``slot_zero_many`` (its eight reads-and-zeros)
   and ``slot_add_many`` (its seven adds), none of the single updates, the
   BiLSTM training kernels as in phase 8 and no megakernel; a warm-up step
   whose every slot launch is held to its plain version (equal bits, the
   read-outs included); a finite, falling loss over 10 steps; one step's
   loss and every gradient leaf in float32 against ``executor="step"``
   under the same seed; ms per step beside phase 8's;
18. the NMN trainer and evaluate CLIs at full width: a synthetic AGQA world
   (``testing/agqa_world.py``: 48 videos x 8 questions, 64 frames of 1024
   features, 300-wide GloVe; preprocessed and split 70 / 15 / 15) and
   ``train.loop.main`` with the JAX trainer's flags at phase 8's widths
   (H 512, video 1024, text 300, F 64, B 128, dropout 0.25, window 32,
   device tables, bf16 through ``--config-filename``) for 3 epochs,
   evaluating once an epoch: per train step the launches of phase 8
   (``TRAIN_LAUNCHES``), per eval batch ``EVAL_LAUNCHES`` (three encodes
   on the BiLSTM's cluster route and one executor forward on its
   tensor-core route), nothing else; a finite loss, and the answer loss
   and the mean module-family loss falling from the first report to the
   last; ``best_model/`` and ``latest/`` with their
   four files; the JAX trainer's metric names; ms per step by the host
   clock and by CUDA events beside phase 8's; a resume from ``latest/``
   for one epoch (optimizer state restored, the step count adding up, the
   learning rate of every report after it ``lr_schedule(step)``); then
   ``train.evaluate.main`` on ``best_model/`` over the valid split, whose
   accuracy must equal the trainer's best exactly, and its Filter audit;
19. the program parser on phase 18's world: ``seq2seq.train`` (``--arch
   lstm`` at the CLI's widths: embed 256, hidden 256, so the BiLSTM
   encoder runs at h 128, S 32, T 48, float32) for 2 epochs of B 64, then
   ``--func predict`` over the valid split in chunks of 256 at beam 5,
   ``check_valid``, ``preprocess --func upgrade`` and ``train.evaluate``
   with phase 18's checkpoint on the generated programs; exact launch
   counts (per train step one ``bilstm_train_f32c``, ``bilstm_bwd_f32c``,
   ``bilstm_dwh_f32c`` and ``bilstm_dwh_sum``, per decode chunk one
   ``bilstm_f32c``: the forward's and the backward's float32 cluster
   routes; per evaluate batch ``EVAL_LAUNCHES``; nothing else); #2 + #3 on
   the CLI's first training batch and #1 on a decode chunk of 256 against
   their plain versions (float32, 1e-4) with equal bits on a second
   launch, #1 and #2 also equal to their general route bit for bit, #3
   within 1e-4 of its general route with equal bits at the first valid
   walk steps (and equal on either forward's stacks), timed beside the
   general route and ``nn.LSTM``; ms
   a parser train step (host clock and CUDA events) and decode
   questions/s;
20. the demo server at full width, on phase 10's Llama-7B + ViT-L/14
   (before phase 12 frees it): ``serve/demo.py make_handler(ChatBackend)``
   on ``127.0.0.1:0`` in a thread, a session opened through
   ``open_frames`` on 100 seeded frames, three turns through ``POST
   /api/chat`` (each: status 200 and a string reply, exactly one
   ``flash_attn`` launch per decoder layer for its prefill and nothing
   else, the token ids and the reply equal to a direct ``model.generate``
   with the same prompt and generator seed), a message flagged through
   ``MODERATION_BLOCKLIST`` (the moderation reply and no launch), ``GET
   /api/sessions`` and ``GET /api/stats``; the encode time and each turn's
   time by the host clock;
21. data parallel on the card: two ranks share ``cuda:0`` over gloo
   (``parallel.mesh.launch`` with an explicit device list, as the machine
   has one card), phase 8's training configuration at dropout 0 (B 128
   global, 64 a rank, window 32), three steps: per rank per step exactly
   ``TRAIN_LAUNCHES`` (the float32 step ``TRAIN_LAUNCHES_F32``), the
   ranks' parameters equal bit for bit after every
   step, the first step's loss (bf16) and float32 gradient leaves against
   one process's step on the global batch by phase 8's kernel-vs-plain
   bounds, the eval step's gathered predictions against one process's
   (equal accuracy); the evaluate CLI's ranks (``train/evaluate.py``'s
   rank body) on phase 18's checkpoint: accuracy and result file equal to
   the one-device evaluate; ms a step per rank (host clock);
22. the NMN trainer and evaluate CLIs at their own defaults (H 512, video
   2048, text 300, F 150, B 32, dropout 0.25, float32: ``train/args.py``
   and ``models/nmn.py``; no flag or config file sets them) on a world of
   24 videos x 8 questions of 300 saved frames (150 after the loader's
   stride), ``train.loop.main`` for 3 epochs with an evaluation each, then
   ``train.evaluate.main`` on ``best_model``: launches exactly
   ``TRAIN_LAUNCHES_F32`` a step and ``CLI_EVAL_LAUNCHES_F32`` an eval
   batch (the executor on its "fma32" keys only, which now take F 150 over
   ``gemm32``'s row tiles; no general launch), a finite loss whose answer
   loss and mean module-family loss fall, evaluate's accuracy equal to the
   trainer's best; on the CLI's padded last train batch (best_model's
   weights) #4, #5's files and #6's outputs equal to the general route's
   (forced) bit for bit and within phase 8's float32 bounds of the plain
   versions, one step's loss and every gradient leaf equal on both routes
   (deterministic algorithms) and within phase 8's bounds of the plain
   route; ms a step of the CLI's inner loop and one train step at B 32
   and B 128, each beside the general route; #4, #5, #6 at B 32 and B 128
   by graph replay on both routes beside the plain versions and their
   bounds; three ``kernels`` entries at F 150.
23. the same CLIs at the same defaults in bf16, on phase 22's world:
   ``--config-filename`` names the config the port's ``train/loop.py
   build_model`` makes for that world with only ``compute_dtype`` set to
   "bfloat16" (the JAX trainer's way to bf16); launches exactly
   ``TRAIN_LAUNCHES`` a step and ``EVAL_LAUNCHES`` an eval batch (every
   BiLSTM launch on its bf16 cluster route, every executor launch on the
   tensor-core route's row-slice mode: #4, #5 and #6's walk on clusters
   of 3 CTAs an example at F 150 and B 32, counted by size in
   ``_build.CLUSTERS``; no general launch), falling answer and mean
   module-family losses, evaluate's accuracy equal to the trainer's best;
   on the CLI's padded last train batch and the evaluate CLI's batch #4,
   #5's files and #6's outputs equal to one CTA an example's and a second
   run's bit for bit, #4 and #5 within atol 3e-2 + rtol 1e-2 of the plain
   versions, #6 within 1e-1 of each gradient's scale at its own files,
   the walk's recompute products at F 150 equal to the forward's, the
   eval step's predictions in agreement >= 0.98 with the plain route, one
   step's loss within 1e-4 of the plain route's and every gradient leaf
   equal bit for bit twice; the inner loop on both routes, one train step
   at B 32, 64 and 128 and #4-#6 there by graph replay on the cluster, one
   CTA an example and the general route beside the plain versions and
   their bounds; three ``kernels`` entries at F 150 in bf16.
24. the evaluate CLI on ``--executor step`` at the same defaults, on phase
   22's float32 and phase 23's bf16 ``best_model`` over phase 22's world
   (the CLI's one eval batch of 32, ``T`` scan steps): per eval batch
   exactly ``T`` launches of the step route's key (``executor_step_fma32``
   on clusters of H / 128 CTAs, ``executor_step_tc`` in the row-slice mode
   on clusters of 3, counted by size in ``_build.CLUSTERS``), none of the
   general ``executor_step``, no megakernel, and the eval batch's three
   BiLSTM encodes; argmax agreement >= 0.98 with ``--executor mega`` on the
   same checkpoint (the CLI's predictions on the valid split and both eval
   steps' on the train split; both accuracies printed); the eval batch's
   ``T`` ``fused_step`` calls on clones, float32 equal to the general route
   bit for bit and within 1e-4 of the plain version, bf16 equal to one CTA
   a tile and to a second run bit for bit and within atol 3e-2 + rtol 1e-2
   of the plain version, every output and the whole frames file; a batch's
   calls by graph replay at B 32, 128 and 1024 on the route and the general
   route beside the plain version and the bound; two ``kernels`` entries,
   #10 at F 150 in each dtype.

A line before the phases gives ``utils/mfu.py``'s peaks for the card's
name (not None on an H100, equal to the peaks the bounds use on the H100
SXM).

Each path is driven with the launch counts set to 0 just before it and
read just after. The last two lines are ``{"kernels": [...]}`` (per
kernel: launches on its main path, error against the plain version on the
main path's inputs, its time, the plain version's, the bound the card's
peaks allow for this run's inputs, and a library call's time where one
computes the same function) and ``{"ok": true, "device": {...}}``. The
step kernel's "fma32" route (``executor_step_fma32``) counts the launches
of phase 16's float32 serving run; its general route (``executor_step``),
which no main path takes any more, those of phase 15's float32 forward at
F = 64 with the general route forced; ``slot_set``,
``slot_zero`` and ``slot_add`` show 0, as the ``"rev"`` path makes its
updates through the many-entry launches. Phase 19's three entries
(``"path": "parser"``) are #1-#3 again at the parser's shapes on the float32
cluster routes (``bilstm_f32c``, ``bilstm_train_f32c``,
``bilstm_bwd_f32c``: its walk, dwh slices and their sum timed together),
with the general route's time beside and the parser path's launches.
Phase 22's three entries (``"path"`` naming the NMN CLIs' defaults) are
#4-#6 again at F 150 on the "fma32" route, timed at the CLI's B 32 (and
B 128 under ``b128_*``) with the general route beside, with the launches of
phase 22's trainer and evaluate runs. Before them a line ``[f32 routes]``
gathers the float32 times of #2, #3 (phase 6's shapes), #4 (phase 4), #5,
#6 (phase 7, phase 8's B 128, and phase 22's F 150 at B 32 and 128) and #10
(phase 15, F 64, and phase 16's float32 serving batch) with their bounds.
Phase 24's two entries are #10 again at the NMN CLIs' F 150 (float32
``executor_step_fma32``, bf16 ``executor_step_tc``), timed at the evaluate
CLI's B 32 (B 128 and 1024 under ``b128_*``, ``b1024_*``) with the general
route beside, with the launches of the evaluate CLI's ``--executor step``
run.
Every time printed is measured in this run, on the card named above it.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

NUM_BATCHES = 8
BATCH = 1024
QUESTION_LEN = 16
#: the training phases' widths: scripts/bench_train_step.py's configuration
HIDDEN, VIDEO_D, TEXT_D, FRAMES = 512, 1024, 300, 64
TRAIN_BATCH = 128
TRAIN_STEPS = 10
#: per training step: video + question encoders through the train pair
#: (forward and backward on their bf16 cluster routes: the forward, the
#: backward's walk, dwh slices and their sum; none on the general routes),
#: the class table through the eval kernel's cluster route, one executor
#: training forward (#5) and its backward (the walk and the weight
#: gradients), both on their tensor-core routes (none on the general
#: routes)
TRAIN_LAUNCHES = {"bilstm": 0, "bilstm_train": 0, "bilstm_tc": 1,
                  "bilstm_train_tc": 2, "bilstm_bwd": 0, "bilstm_dwh": 0,
                  "bilstm_bwd_tc": 2, "bilstm_dwh_tc": 2, "bilstm_dwh_sum": 2,
                  "mega_exec": 0, "mega_exec_tc": 0, "mega_exec_train": 0,
                  "mega_exec_train_tc": 1, "mega_exec_bwd": 0,
                  "mega_exec_wgrad": 0, "mega_exec_bwd_tc": 1,
                  "mega_exec_wgrad_tc": 1}
#: the same step in float32: the encoders' forward and backward on the
#: BiLSTM's float32 cluster routes (and the class table's eval forward;
#: the backward's walk, dwh slices and their sum), the executor's kernels
#: on the float32 "fma32" routes (the training forward, the walk and the
#: weight gradients; none on the general routes)
TRAIN_LAUNCHES_F32 = {"bilstm_f32c": 1, "bilstm_train_f32c": 2,
                      "bilstm_bwd_f32c": 2, "bilstm_dwh_f32c": 2,
                      "bilstm_dwh_sum": 2, "mega_exec_train_fma32": 1,
                      "mega_exec_bwd_fma32": 1, "mega_exec_wgrad_fma32": 1}
#: a float32 eval forward of phase 8's model: the two encoders on the
#: BiLSTM's float32 cluster route, the executor on its "fma32" route
EVAL_LAUNCHES_F32 = {"bilstm_f32c": 2, "mega_exec_fma32": 1}
#: float32 train steps in phase 8's counted float32 run
F32_STEPS = 3


#: what an earlier phase measured and a later one prints beside its own
SEEN = {}
STEP_BATCHES = 4
#: two cosines closer than this (about four bf16 steps below 1) are a tie
#: that the executor routes may break differently
CHOOSE_TIE = 1.6e-2

#: phase 20: the demo's turns, and the moderation blocklist it sets
DEMO_TURNS = ("what is the person doing ?", "where is the laptop ?",
              "what did the person do after they opened the door of the "
              "kitchen ?")
DEMO_BLOCKED = "forbiddenword"
#: phase 21: data-parallel ranks sharing the one card, and steps
DP_RANKS, DP_STEPS = 2, 3

#: the SFT step: videochat_train.py's defaults (batch 8, 512 tokens)
SFT_BATCH, SFT_LEN, SFT_STEPS, SFT_LR = 8, 512, 6, 3e-4


#: the card's published peaks (NVIDIA H100 SXM data sheet): dense FLOP/s by
#: input type, and device-memory bytes/s
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12


def log(msg):
    print(msg, flush=True)


def tensor_bytes(*trees):
    """Bytes of every tensor in nested tuples/lists/dicts."""
    total = 0
    for t in trees:
        if torch.is_tensor(t):
            total += t.numel() * t.element_size()
        elif isinstance(t, dict):
            total += tensor_bytes(*t.values())
        elif isinstance(t, (list, tuple)):
            total += tensor_bytes(*t)
    return total


def bound(flops, nbytes, dtype):
    """The least time the card could take: the larger of operations over
    the peak rate of their input type and compulsory bytes over the memory
    rate. Returns ``{"bound_ms", "bound_by"}``."""
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    mem_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, mem_ms),
            "bound_by": "operations" if ops_ms >= mem_ms else "bytes"}


def add_bounds(*bs):
    """The bound of several launches timed as one entry."""
    ms = sum(b["bound_ms"] for b in bs)
    by = max(bs, key=lambda b: b["bound_ms"])["bound_by"]
    return {"bound_ms": ms, "bound_by": by}


def counted_flops(fn):
    """Matrix-product operations of one call of ``fn`` (a plain version on
    this run's inputs), counted by ``torch.utils.flop_counter``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn()
    torch.cuda.synchronize()
    return fc.get_total_flops()


def lstm_bound(args, outs, passes=1, extra=()):
    """BiLSTM recurrence: per live step and direction one ``[B, h] @ [h,
    4h]`` product (three in the backward: the gate recompute, ``dgates @
    wh^T`` and ``h^T dgates``); every argument read and every output
    written once."""
    xp_f, mask = args[0], args[2]
    h = xp_f.shape[-1] // 4
    flops = passes * 2 * 2 * 4 * h * h * float(mask.sum())
    return bound(flops, tensor_bytes(args, outs, extra), xp_f.dtype)


def lstm_library_ms(B, L, D, h, dev, dtype, train=False):
    """``torch.nn.LSTM(bidirectional=True)`` at the same B, L, D, h on
    full-length sequences (it has no per-step mask and includes the input
    projection that the port leaves to a matmul outside its kernel): the
    nearest single PyTorch call, timed as a yardstick and used nowhere.
    Returns (forward ms, backward ms or None)."""
    from stair_tpu_torch.utils.device import cuda_time_ms

    lstm = torch.nn.LSTM(D, h, batch_first=True, bidirectional=True).to(
        dev, dtype)
    x = torch.randn(B, L, D, device=dev, dtype=dtype)
    if not train:
        with torch.no_grad():
            return cuda_time_ms(lambda: lstm(x), iters=5), None
    lstm.train()
    x.requires_grad_(True)
    fwd = cuda_time_ms(lambda: lstm(x), iters=5)
    g = torch.randn(B, L, 2 * h, device=dev, dtype=dtype)
    both = cuda_time_ms(lambda: lstm(x)[0].backward(g), iters=5)
    return fwd, max(both - fwd, 0.0)


def graph_ms(fn, iters=20):
    """Device milliseconds per call of ``fn`` by CUDA-graph replay
    (``utils.device.graph_ms``)."""
    from stair_tpu_torch.utils import device

    return device.graph_ms(fn, iters)


def quiet(fn, *a, **kw):
    """``fn(*a, **kw)`` with its standard output captured: (result, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*a, **kw)
    return res, buf.getvalue()


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def require_launches(what, got, want):
    """Fail unless the launch counts ``got`` are exactly ``want`` (0 for
    every key not named)."""
    wrong = {k: (v, want.get(k, 0)) for k, v in got.items()
             if v != want.get(k, 0)}
    require(not wrong, f"{what} launches (got, want): {wrong}")


@contextlib.contextmanager
def plain_route():
    """Route every kernel call of the model (serving and training) to its
    plain PyTorch version (on the same CUDA tensors) for a comparison run;
    fails if a kernel was launched inside it all the same."""
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import attention as TA
    from stair_tpu_torch.ops import executor_step as TE
    from stair_tpu_torch.ops import lstm as TL
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.ops import regslots as TR

    def attention(q, k, v, prefix_len, valid_len, causal=True,
                  sm_scale=None, return_lse=False):
        out, lse = TA.reference_attention(
            q, k, v, prefix_len.to(torch.int32), valid_len.to(torch.int32),
            causal, sm_scale)
        return (out, lse) if return_lse else out

    def lstm_train(*args, token_dtype=torch.float32):
        return TL.bilstm_reference(*args, token_dtype=token_dtype,
                                   return_stacks=True)

    def mega_train(meta, args, rate, seed):
        return TX.mega_exec_reference(meta, args, rate=rate, seed=seed)

    swaps = [(TL, "bilstm", TL.bilstm_reference),
             (TL, "bilstm_train_call", lstm_train),
             (TL, "bilstm_bwd_call", TL.bilstm_bwd_reference),
             (TX, "mega_exec_call", TX.mega_exec_reference),
             (TX, "mega_exec_train_call", mega_train),
             (TG, "mega_exec_bwd_call", TG.mega_exec_bwd_reference),
             (TA, "flash_attention", attention),
             (TE, "fused_step", TE.fused_step_reference),
             # every slot update goes through a plan's call
             (TR.SlotPlan, "__call__", TR.SlotPlan.reference)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    _build.reset_launches()
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    require(not any(_build.LAUNCHES.values()),
            f"the plain route launched kernels: {_build.LAUNCHES}")


@contextlib.contextmanager
def general_lstm_fwd():
    """Send the BiLSTM forward (eval and training) through its general
    route (``bilstm`` / ``bilstm_train``) whatever ``lstm.fwd_route``
    picks."""
    from stair_tpu_torch.ops import lstm as TL

    pick = TL.fwd_route
    TL.fwd_route = lambda dtype, h: "general"
    try:
        yield
    finally:
        TL.fwd_route = pick


#: the BiLSTM forward's routes: name, launch-key suffix, context (the
#: cluster routes run as ``lstm.fwd_route`` picks them)
FWD_ROUTES = (("cluster", "_tc", contextlib.nullcontext),
              ("cluster32", "_f32c", contextlib.nullcontext),
              ("general", "", general_lstm_fwd))


@contextlib.contextmanager
def general_lstm_bwd():
    """Send the BiLSTM backward through its general route
    (``bilstm_bwd`` + ``bilstm_dwh``) whatever ``lstm.bwd_route`` picks."""
    from stair_tpu_torch.ops import lstm as TL

    pick = TL.bwd_route
    TL.bwd_route = lambda dtype, h: "general"
    try:
        yield
    finally:
        TL.bwd_route = pick


#: the BiLSTM backward's routes: name, walk launch key, context (the
#: cluster routes run as ``lstm.bwd_route`` picks them)
BWD_ROUTES = (("cluster", "bilstm_bwd_tc", contextlib.nullcontext),
              ("cluster32", "bilstm_bwd_f32c", contextlib.nullcontext),
              ("general", "bilstm_bwd", general_lstm_bwd))


def check_f32_bwd(what, kb, gb, mask):
    """The float32 cluster backward ``kb`` against the general route's
    ``gb`` on the same inputs: each output within 1e-4 (max |a - b| / max
    |b|; the dh sums run in another order), and dxp at each row's first
    valid step of the walk, where no adjoint partial has entered, equal bit
    for bit. Returns the worst error."""
    from stair_tpu_torch.scripts.bilstm_bwd_tiles import first_steps_equal

    err = max(rel_err(x, y) for x, y in zip(kb, gb))
    require(err <= 1e-4, f"{what}: the float32 cluster backward against the "
            f"general route {err:.3e} (bound 1e-4)")
    require(first_steps_equal(kb, gb, mask),
            f"{what}: dxp at the rows' first valid walk steps differs from "
            "the general route's bits")
    log(f"[lstm bwd f32] {what}: the float32 cluster route against the "
        f"general route max rel err {err:.3e} (bound 1e-4); dxp at each "
        "row's first valid walk step equal bit for bit ok")
    return err


@contextlib.contextmanager
def general_mega():
    """Send the executor's forward (eval and training) and backward through
    their general routes (``mega_exec``, ``mega_exec_train``;
    ``mega_exec_bwd`` + ``mega_exec_wgrad``) whatever
    ``mega_exec.fwd_route`` and ``mega_grad.bwd_route`` pick."""
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG

    picks = TX.fwd_route, TG.bwd_route
    TX.fwd_route = lambda *a: "general"
    TG.bwd_route = lambda *a: "general"
    try:
        yield
    finally:
        TX.fwd_route, TG.bwd_route = picks


@contextlib.contextmanager
def one_cta():
    """Launch the executor's "fma32" and tensor-core kernels (#4, #5, #6's
    walk) one CTA an example, whatever cluster size their launches would
    pick (``mega_exec.fma32_cluster``, ``mega_exec.tc_launch_cluster``;
    above 64 frames the tensor-core kernels keep their row-slice mode, all
    slices on the one CTA): the wrappers' ``cluster`` argument, forced to 1
    on every call that does not give it."""
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG

    fwd, bwd = TX._launch, TG._launch_bwd

    def fwd1(key, meta, args, drop, cluster=None):
        return fwd(key, meta, args, drop, cluster or 1)

    def bwd1(meta, args, outs, gouts, drop, cluster=None):
        return bwd(meta, args, outs, gouts, drop, cluster or 1)

    TX._launch, TG._launch_bwd = fwd1, bwd1
    try:
        yield
    finally:
        TX._launch, TG._launch_bwd = fwd, bwd


#: the bf16 executor's routes: name, eval launch key, context
MEGA_ROUTES = (("tc", "mega_exec_tc", contextlib.nullcontext),
               ("general", "mega_exec", general_mega))
#: the float32 executor's routes at the widths "fma32" takes (H a multiple
#: of 128 up to 512, any F from 16 to 256): the two give equal bits
F32_ROUTES = (("fma32", "mega_exec_fma32", contextlib.nullcontext),
              ("general", "mega_exec", general_mega))
#: the training forward's launch key on each route
TRAIN_KEYS = {"tc": "mega_exec_train_tc", "fma32": "mega_exec_train_fma32",
              "general": "mega_exec_train"}
#: every eval launch key of the executor forward
EVAL_KEYS = ("mega_exec_tc", "mega_exec_fma32", "mega_exec")


def executor_routes(dtype):
    """The executor's routes a phase drives in ``dtype``, the route the
    main paths take first."""
    return MEGA_ROUTES if dtype == torch.bfloat16 else F32_ROUTES


@contextlib.contextmanager
def kernel_route(keys):
    """Fail unless every kernel named in ``keys`` was launched inside the
    block; yields a dict that holds the block's launches once it ends."""
    from stair_tpu_torch.ops import _build

    _build.reset_launches()
    seen = {}
    yield seen
    seen.update({k: v for k, v in _build.LAUNCHES.items() if v})
    require(all(_build.LAUNCHES[k] for k in keys),
            f"the kernel route skipped a kernel: {_build.LAUNCHES}")


def max_err(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def lstm_inputs(gen, dev, B, L, D, h, dtype):
    from stair_tpu_torch.ops import lstm as TL

    p = TL.init_lstm_params(gen, D, h, device=dev)
    x = torch.randn(B, L, D, generator=gen).to(dev)
    lens = torch.randint(1, L + 1, (B,), generator=gen)
    mask = (torch.arange(L)[None] < lens[:, None]).float()
    mask *= (torch.rand(B, L, generator=gen) > 0.2).float()  # holes
    mask[:, 0] = 1.0
    mask[5] = 0.0                                             # all padding
    mm = None if dtype == torch.float32 else dtype
    return TL._prep(p, x, mask.to(dev), mm)


#: phase 3's BiLSTM cases: name, B, L, D. Serving's two encoders at B
#: 1024, then the batches whose tiles ``lstm.fwd_tile`` picks otherwise:
#: the train step's B 128, the class table's 64, a ragged B
LSTM_CASES = (("video", BATCH, 64, 1024), ("question", BATCH, 16, 300),
              ("video", TRAIN_BATCH, 64, 1024),
              ("question", TRAIN_BATCH, 16, 300),
              ("class table", 64, 16, 300), ("ragged", 125, 16, 300))


def lstm_flat(out):
    """A BiLSTM forward's outputs as one tuple: tokens, sentence and (in
    training) the four state stacks."""
    return (*out[:3], *out[3]) if len(out) == 4 else tuple(out)


def lstm_tile(dev, route, B, h):
    """The batch tile the BiLSTM forward's ``route`` launches at B, h."""
    from stair_tpu_torch.ops import lstm as TL

    if route == "general":
        return None
    return TL.fwd_tile(B, TL._clusters_held(dev, h, route), route)


def run_lstm_routes(dev, args, dtype, key, call, check):
    """``call()`` on the route the BiLSTM forward picks for ``dtype`` (bf16:
    the cluster route, float32: the float32 cluster route, at the widths
    they take) and on the general route: twice each, with identical bits
    and two launches of ``key`` plus the route's suffix and none of another
    route's; ``check(route, out)`` holds each against the plain version.
    The float32 cluster route must equal the general route bit for bit on
    every output. Returns {route: (out, batch tile or None)}."""
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import lstm as TL

    B, h = args[0].shape[0], args[0].shape[-1] // 4
    outs = {}
    for route, sfx, ctx in FWD_ROUTES:
        if route != "general" and TL.fwd_route(dtype, h) != route:
            continue
        with ctx():
            _build.reset_launches()
            out, out2 = call(), call()
            torch.cuda.synchronize()
        others = [key + s for _, s, _ in FWD_ROUTES if s != sfx]
        require(_build.LAUNCHES[key + sfx] == 2
                and not any(_build.LAUNCHES[k] for k in others),
                f"{key} {route} route launches {_build.LAUNCHES}")
        require(all(torch.equal(x, y)
                    for x, y in zip(lstm_flat(out), lstm_flat(out2))),
                f"{key} {route} route: two launches differ")
        require(out[0][5].abs().max().item() == 0.0,
                f"{key} {route} route: all-padding row has nonzero tokens")
        check(route, out)
        outs[route] = (out, lstm_tile(dev, route, B, h))
    if "cluster32" in outs:
        a, g = (lstm_flat(outs[r][0]) for r in ("cluster32", "general"))
        require(all(torch.equal(x, y) for x, y in zip(a, g)),
                f"{key}: the float32 cluster route differs from the general "
                f"route at B {B}, h {h}")
    return outs


def phase_lstm(dev):
    from stair_tpu_torch.ops import lstm as TL

    gen = torch.Generator().manual_seed(0)
    errs = {}
    for name, B, L, D in LSTM_CASES:
        for dtype, tol in ((torch.float32, (1e-4, 1e-4)),
                           (torch.bfloat16, (0.0, 2e-2))):
            args = lstm_inputs(gen, dev, B, L, D, 256, dtype)
            ref = TL.bilstm_reference(*args, token_dtype=dtype)

            def check(route, out):
                for o, r, what in zip(out, ref, ("tok_f", "tok_b", "sent")):
                    torch.testing.assert_close(
                        o.float(), r.float(), rtol=tol[0], atol=tol[1],
                        msg=f"{name} B={B} {dtype} {route} route {what}")

            outs = run_lstm_routes(
                dev, args, dtype, "bilstm",
                lambda: TL.bilstm(*args, token_dtype=dtype), check)
            for route, (out, tile) in outs.items():
                e = max_err(out, ref)
                errs[(name, B, str(dtype), route)] = e
                same = (", equal to the general route bit for bit"
                        if route == "cluster32" else "")
                log(f"[lstm] {name} B={B} L={L} D={D} h=256 {dtype} {route} "
                    f"route{f' (batch tile {tile})' if tile else ''}: "
                    f"max_abs_err {e:.3e} (rtol {tol[0]}, atol {tol[1]}), "
                    f"two launches bit-identical{same} ok")
    return errs


def phase_mega(dev):
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN, tree_map
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.testing import workload as W
    from stair_tpu_torch.utils.device import cuda_time_ms

    errs = {}
    for F, attention in ((16, "parity"), (64, "softmax"), (64, "parity")):
        for dtype in (torch.float32, torch.bfloat16):
            cfg = NMNConfig(
                hidden_size=512, video_size=1024, text_size=300,
                max_video_length=F, object_types=3, max_steps=16,
                num_vec=10, num_frames=6, num_attn=8,
                filter_attention=attention,
                compute_dtype="float32" if dtype == torch.float32
                else "bfloat16")
            model = W.build_model(cfg, seed=3, device=dev)
            programs = W.OPCODE_PROGRAMS * 8
            batch = W.to_device(W.opcode_batch(cfg, programs, seed=F), dev)
            B, L = batch["question"].shape[:2]
            gen = torch.Generator().manual_seed(F)
            halves = [torch.randn(B, n, 256, generator=gen).to(dev, dtype)
                      for n in (F, F, L, L)]
            mods = tree_map(lambda x: x.detach().to(dtype),
                            model.param_tree()["modules"])
            meta, args = TX.prepare_args(
                cfg, mods, VideoNMN._fused_tables(mods), batch["trace"],
                halves[:2], batch["video_mask"], halves[2:],
                batch["question_mask"])
            ref = TX.mega_exec_reference(meta, args)
            if dtype == torch.float32:
                tol = (1e-4, 1e-4)
            else:
                # a bf16 step is 2^-7 to 2^-8 of the value (0.0625 in
                # [8, 16)), so rtol 1e-2 allows about 1.3 to 2.6 steps; the
                # float32 check at 1e-4 is what catches logic errors
                tol = (1e-2, 3e-2)
            # both routes of the dtype: bf16 tensor-core and general,
            # float32 "fma32" and general (equal bits)
            outs = {}
            if dtype == torch.float32:
                plain_ms = cuda_time_ms(lambda: TX.mega_exec_reference(
                    meta, args), iters=2, warmup=1)
                bnd = bound(counted_flops(lambda: TX.mega_exec_reference(
                    meta, args)), tensor_bytes(args, ref), dtype)
            for route, key, ctx in executor_routes(dtype):
                if TX.fwd_route(dtype, 512, F, False) != route and (
                        route != "general"):
                    continue
                with ctx():
                    _build.reset_launches()
                    out = TX.mega_exec_call(meta, args)
                    torch.cuda.synchronize()
                    outs[route] = out
                require(_build.LAUNCHES[key] == 1
                        and sum(_build.LAUNCHES[k] for k in EVAL_KEYS) == 1,
                        f"mega_exec {route} route launches {_build.LAUNCHES}")
                for o, r, what in zip(out, ref, ("regs_vec", "regs_frames",
                                                 "regs_attn")):
                    torch.testing.assert_close(
                        o.float(), r.float(), rtol=tol[0], atol=tol[1],
                        msg=f"{route} route {what}")
                agree = np.mean([
                    (o.float().argmax(-1) == r.float().argmax(-1)).float()
                    .mean().item() for o, r in zip(out, ref)])
                if dtype == torch.bfloat16:
                    require(agree >= 0.98,
                            f"{route} route register argmax agreement {agree}")
                e = max_err(out, ref)
                errs[(F, attention, str(dtype), route)] = e
                same = ""
                if dtype == torch.float32:
                    with ctx():
                        f32_record(
                            "#4", f"opcode programs x8, B {B} H 512 F {F} "
                            f"{attention}", route,
                            cuda_time_ms(lambda: TX.mega_exec_call(
                                meta, args), iters=5), plain_ms, bnd)
                    if route == "general":
                        require(all(torch.equal(a, g) for a, g in zip(
                            outs["fma32"], out)),
                            f"mega_exec fma32 route != general route F={F} "
                            f"{attention}")
                        same = "; equal bits to the fma32 route"
                log(f"[mega_exec] all {len(W.OPCODE_PROGRAMS)} opcode "
                    f"programs x8 H=512 F={F} {attention} "
                    f"{'conv' if cfg.conv_temporal else 'linear'}-temporal "
                    f"{dtype} {route} route: max_abs_err {e:.3e}, row argmax "
                    f"agreement {agree:.4f} (rtol {tol[0]}, atol {tol[1]})"
                    f"{same} ok")
    return errs


def phase_slice(dev, card):
    from stair_tpu_torch.models.nmn import VideoNMN, tree_map
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import lstm as TL
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.testing import workload as W
    from stair_tpu_torch.utils.device import cuda_time_ms

    serving = W.ServingBatches(dev, batch_size=BATCH,
                               question_len=QUESTION_LEN)
    cfg = serving.cfg
    log(f"[slice] config {json.dumps(cfg.to_dict())}")
    model = W.build_model(cfg, seed=0, device=dev)
    host_batch, device_batch = serving.host_batch, serving.device_batch

    def forward(b):
        return model(b)["logits"]

    # Warm-up (allocator, cuBLAS handles) outside the counted run.
    hb0 = host_batch(NUM_BATCHES)
    warm = forward(device_batch(hb0))
    torch.cuda.synchronize()
    require(warm.shape == (BATCH, cfg.answer_vocab_length), "logits shape")

    # ---- the counted main-path run ------------------------------------
    _build.reset_launches()
    t0 = time.perf_counter()
    host_s = 0.0
    fetched = []
    for i in range(NUM_BATCHES):
        th = time.perf_counter()
        hb = host_batch(i)
        host_s += time.perf_counter() - th
        fetched.append(forward(device_batch(hb)).float().cpu())
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    require(launches["bilstm_tc"] == 2 * NUM_BATCHES
            and launches["bilstm"] == 0,
            f"bilstm_tc launches {launches['bilstm_tc']} != "
            f"{2 * NUM_BATCHES} (general route {launches['bilstm']})")
    require(launches["mega_exec_tc"] == NUM_BATCHES
            and launches["mega_exec"] == 0,
            f"mega_exec_tc launches {launches['mega_exec_tc']} != "
            f"{NUM_BATCHES} (general route {launches['mega_exec']})")
    for lg in fetched:
        require(lg.shape == (BATCH, cfg.answer_vocab_length), "logits shape")
        require(bool(torch.isfinite(lg).all()), "non-finite logits")
    qps = NUM_BATCHES * BATCH / wall
    log(f"[slice] {NUM_BATCHES} batches x {BATCH} questions: {qps:.1f} q/s "
        f"end to end (host parse/lower/tokenize {host_s * 1e3:.1f} ms total, "
        f"sequential with the device), launches {launches}; card {card}")

    # ---- kernel route vs plain route on one batch -------------------------
    b0 = device_batch(hb0)
    with kernel_route(("bilstm_tc", "mega_exec_tc")):
        kern = forward(b0).float()
    with plain_route():
        plain = forward(b0).float()
    torch.cuda.synchronize()
    agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
    require(agree >= 0.98, f"kernel/plain argmax agreement {agree}")
    with kernel_route(("bilstm_tc", "mega_exec_tc")):
        dev_ms = cuda_time_ms(lambda: forward(b0), iters=5, warmup=1)
    with plain_route():
        plain_dev_ms = cuda_time_ms(lambda: forward(b0), iters=3, warmup=1)
    log(f"[slice] kernel vs plain route argmax agreement {agree:.4f}; "
        f"logits max_abs_err {float((kern - plain).abs().max()):.3e}")
    log(f"[slice] device forward per batch of {BATCH} (CUDA events): "
        f"kernel route {dev_ms:.3f} ms, plain route {plain_dev_ms:.3f} ms; "
        f"card {card}")
    SEEN.update(serving=serving, mega_model=model, mega_qps=qps,
                mega_dev_ms=dev_ms)

    # ---- each kernel on the main path's own inputs ----------------------
    dt = model.compute_dtype
    p = tree_map(lambda x: x.detach(), model.param_tree())
    vargs = TL._prep(p["video_encoder"], b0["video"], b0["video_mask"], dt)
    qargs = TL._prep(p["text_encoder"], b0["question"], b0["question_mask"],
                     dt)
    kv, kq = TL.bilstm(*vargs, token_dtype=dt), TL.bilstm(*qargs,
                                                        token_dtype=dt)
    rvv = TL.bilstm_reference(*vargs, token_dtype=dt)
    rqq = TL.bilstm_reference(*qargs, token_dtype=dt)
    lstm_err = max(max_err(kv, rvv), max_err(kq, rqq))
    require(lstm_err <= 2e-2, f"bilstm main-path max_abs_err {lstm_err}")
    mods = tree_map(lambda x: x.to(dt), p["modules"])
    meta, args = TX.prepare_args(
        cfg, mods, VideoNMN._fused_tables(mods), b0["trace"], kv[:2],
        b0["video_mask"].to(dt), kq[:2], b0["question_mask"])
    rm = TX.mega_exec_reference(meta, args)
    mega_errs = {}
    for route, _, ctx in MEGA_ROUTES:
        with ctx():
            km = TX.mega_exec_call(meta, args)
        mega_errs[route] = max_err(km, rm)
        for o, r in zip(km, rm):
            torch.testing.assert_close(o.float(), r.float(), rtol=1e-2,
                                       atol=3e-2, msg=f"{route} route")
    mega_err = mega_errs["tc"]
    log(f"[main-path inputs] bilstm max_abs_err {lstm_err:.3e} (atol 2e-2); "
        f"mega_exec max_abs_err tensor-core route {mega_err:.3e}, general "
        f"route {mega_errs['general']:.3e} (rtol 1e-2, atol 3e-2) ok")

    def both():
        return (TL.bilstm(*vargs, token_dtype=dt),
                TL.bilstm(*qargs, token_dtype=dt))

    with general_lstm_fwd():
        general_ms = cuda_time_ms(both, iters=3)

    def general_ms_of(fn):
        with general_mega():
            return cuda_time_ms(fn, iters=3)

    t = {
        "bilstm_video": cuda_time_ms(lambda: TL.bilstm(*vargs,
                                                       token_dtype=dt)),
        "bilstm_question": cuda_time_ms(lambda: TL.bilstm(*qargs,
                                                          token_dtype=dt)),
        "bilstm_general": general_ms,
        "bilstm_video_plain": cuda_time_ms(
            lambda: TL.bilstm_reference(*vargs, token_dtype=dt), iters=3),
        "bilstm_question_plain": cuda_time_ms(
            lambda: TL.bilstm_reference(*qargs, token_dtype=dt), iters=3),
        "mega_exec": cuda_time_ms(lambda: TX.mega_exec_call(meta, args),
                                  iters=5),
        "mega_exec_general": general_ms_of(
            lambda: TX.mega_exec_call(meta, args)),
        "mega_exec_plain": cuda_time_ms(
            lambda: TX.mega_exec_reference(meta, args), iters=3),
    }
    for k, v in t.items():
        log(f"[kernel time] {k}: {v:.3f} ms per call (CUDA events, bf16, "
            f"main-path shapes); card {card}")
    lstm_b = add_bounds(lstm_bound(vargs, kv), lstm_bound(qargs, kq))
    lstm_lib = sum(lstm_library_ms(BATCH, L, D, cfg.hidden_size // 2, dev,
                                   dt)[0]
                   for L, D in ((cfg.max_video_length, cfg.video_size),
                                (QUESTION_LEN, cfg.text_size)))
    mega_b = bound(counted_flops(lambda: TX.mega_exec_reference(meta, args)),
                   tensor_bytes(args, km), dt)
    log(f"[bound] bilstm {lstm_b}, nn.LSTM (full length, with its input "
        f"projection) {lstm_lib:.3f} ms; mega_exec {mega_b}; card {card}")
    log(f"[kernel time] bilstm, both encoders: cluster route "
        f"{t['bilstm_video'] + t['bilstm_question']:.4f} ms (batch tile "
        f"{TL.fwd_tile(BATCH, TL._clusters_held(dev, 256))}), general route "
        f"{general_ms:.4f} ms, nn.LSTM {lstm_lib:.4f} ms; card {card}")
    return [
        {"name": "bilstm", "route": "cuda",
         "source": "stair_tpu_torch/ops/csrc/bilstm.cu",
         "replaces": "stair_tpu/ops/lstm.py:136",
         "launches": launches["bilstm_tc"], "max_abs_err": lstm_err,
         "ms": t["bilstm_video"] + t["bilstm_question"],
         "general_ms": general_ms,
         "plain_ms": t["bilstm_video_plain"] + t["bilstm_question_plain"],
         **lstm_b, "library_ms": lstm_lib},
        {"name": "mega_exec", "route": "cuda",
         "source": "stair_tpu_torch/ops/csrc/mega_exec.cu",
         "replaces": "stair_tpu/ops/mega_exec.py:123",
         "executor_route": "tc",
         "launches": launches["mega_exec_tc"], "max_abs_err": mega_err,
         "ms": t["mega_exec"], "general_ms": t["mega_exec_general"],
         "plain_ms": t["mega_exec_plain"], **mega_b, "library_ms": None},
    ]


def rel_err(a, b):
    """max |a - b| over max |b| (float32), the gradient comparisons'
    measure: one bound per tensor whatever its scale."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)


def phase_lstm_train(dev):
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import lstm as TL

    gen = torch.Generator().manual_seed(1)
    errs = {}
    for name, L, D in (("video", FRAMES, VIDEO_D), ("question", QUESTION_LEN,
                                                       TEXT_D)):
        for dtype, ftol, btol in ((torch.float32, 1e-4, 1e-4),
                                  (torch.bfloat16, 2e-2, 2e-2)):
            args = lstm_inputs(gen, dev, TRAIN_BATCH, L, D, HIDDEN // 2, dtype)
            ref = TL.bilstm_reference(*args, token_dtype=dtype,
                                      return_stacks=True)
            fwd_errs = {}

            def check(route, out):
                fwd_errs[route] = max(max_err(out[:3], ref[:3]),
                                      max_err(out[3], ref[3]))
                require(fwd_errs[route] <= ftol,
                        f"bilstm_train {name} {dtype} {route} route: "
                        f"{fwd_errs[route]}")

            outs = run_lstm_routes(
                dev, args, dtype, "bilstm_train",
                lambda: TL.bilstm_train_call(*args, token_dtype=dtype), check)
            # the backward runs on the stacks of the route the main path
            # takes (bf16: the cluster forward's; float32: the float32
            # cluster forward's, equal to the general route's)
            out = outs[TL.fwd_route(dtype, HIDDEN // 2)][0]
            fwd = max(fwd_errs.values())
            B, h = TRAIN_BATCH, HIDDEN // 2
            dtok = [torch.randn(B, L, h, generator=gen).to(dev, dtype)
                    for _ in range(2)]
            dsent = torch.randn(B, 2 * h, generator=gen).to(dev)
            rb = TL.bilstm_bwd_reference(*args, ref[3], *dtok, dsent)
            same_bwd = ("; the same bits on the general forward's stacks"
                        if "cluster32" in outs else "")
            kbs = {}
            for route, key, ctx in BWD_ROUTES:
                if route != "general" and TL.bwd_route(dtype, h) != route:
                    continue
                with ctx():
                    _build.reset_launches()
                    kb = TL.bilstm_bwd_call(*args, out[3], *dtok, dsent)
                    kb2 = TL.bilstm_bwd_call(*args, out[3], *dtok, dsent)
                    torch.cuda.synchronize()
                    others = [k for _, k, _ in BWD_ROUTES if k != key]
                    require(_build.LAUNCHES[key] == 2
                            and not any(_build.LAUNCHES[k] for k in others),
                            f"bilstm backward {route} route launches "
                            f"{_build.LAUNCHES}")
                    require(all(torch.equal(x, y) for x, y in zip(kb, kb2)),
                            f"bilstm backward ({route}) is not "
                            "deterministic")
                    if "cluster32" in outs:
                        # the same bits on the general forward's stacks
                        kg = TL.bilstm_bwd_call(
                            *args, outs["general"][0][3], *dtok, dsent)
                        require(all(torch.equal(x, y)
                                    for x, y in zip(kb, kg)),
                                f"bilstm backward ({route}): the float32 "
                                "cluster forward's stacks give other bits "
                                "than the general's")
                kbs[route] = kb
                bwd = {n: rel_err(x, y) for n, x, y in zip(
                    ("dxp_f", "dxp_b", "dwh_f", "dwh_b", "dbias_f",
                     "dbias_b"), kb, rb)}
                worst = max(bwd.values())
                require(worst <= btol,
                        f"bilstm_bwd {route} {name} {dtype}: {bwd}")
                errs[(name, str(dtype), route)] = (fwd, max_err(kb, rb))
                ferr = ", ".join(f"{k} route {v:.3e}"
                                 for k, v in fwd_errs.items())
                log(f"[lstm train] {name} B={B} L={L} D={D} h={h} {dtype}: "
                    f"forward+stacks max_abs_err {ferr} (atol {ftol}; batch "
                    f"tile {outs[TL.fwd_route(dtype, h)][1]}; two launches "
                    "of each bit-identical); "
                    f"backward on the {route} route ({key}) max rel err "
                    f"{worst:.3e} (bound {btol}: "
                    f"{', '.join(f'{k} {v:.2e}' for k, v in bwd.items())}); "
                    f"two backward runs bit-identical{same_bwd} ok")
            if "cluster32" in kbs:
                check_f32_bwd(f"{name} {dtype}", kbs["cluster32"],
                              kbs["general"], args[2])
                time_f32_lstm(dev, name, args, outs, dtok, dsent, D)
    return errs


def f32_record(kernel, shape, route, ms, plain_ms, bnd, library_ms=None,
               **extra):
    """One float32 kernel timing for the summary line ``[f32 routes]``
    that ``main`` prints (``SEEN["f32"]``), logged as it is taken."""
    from stair_tpu_torch.utils.device import card_identity

    entry = {"kernel": kernel, "shape": shape, "route": route, "ms": ms,
             "plain_ms": plain_ms, **bnd, "library_ms": library_ms, **extra}
    SEEN.setdefault("f32", []).append(entry)
    log(f"[f32] {json.dumps(entry)}; card "
        f"{card_identity().splitlines()[0]}")


def time_f32_lstm(dev, name, args, outs, dtok, dsent, D):
    """#2 and #3 (each on its float32 cluster route, beside its general
    route) at the float32 train step's shapes, beside the plain versions,
    nn.LSTM in float32 and their bounds."""
    from stair_tpu_torch.ops import lstm as TL
    from stair_tpu_torch.utils.device import cuda_time_ms

    B, L, G = args[0].shape
    h = G // 4
    out = outs["cluster32"][0]
    shape = f"{name} B {B} L {L} D {D} h {h}"
    lib_fwd, lib_bwd = lstm_library_ms(B, L, D, h, dev, torch.float32,
                                       train=True)
    with general_lstm_fwd():
        general_ms = cuda_time_ms(lambda: TL.bilstm_train_call(*args),
                                  iters=3)
    f32_record("#2", shape, "cluster32", cuda_time_ms(
        lambda: TL.bilstm_train_call(*args), iters=10),
        cuda_time_ms(lambda: TL.bilstm_reference(*args, return_stacks=True),
                     iters=2, warmup=1),
        lstm_bound(args, out[:3], extra=out[3]), lib_fwd,
        general_ms=general_ms, batch_tile=outs["cluster32"][1])
    with general_lstm_bwd():
        general_bwd_ms = cuda_time_ms(
            lambda: TL.bilstm_bwd_call(*args, out[3], *dtok, dsent), iters=3)
    f32_record("#3", shape, "cluster32", cuda_time_ms(
        lambda: TL.bilstm_bwd_call(*args, out[3], *dtok, dsent), iters=10),
        cuda_time_ms(lambda: TL.bilstm_bwd_reference(*args, out[3], *dtok,
                                                     dsent), iters=2,
                     warmup=1),
        lstm_bound(args, TL.bilstm_bwd_call(*args, out[3], *dtok, dsent),
                   passes=3, extra=(out[3], dtok, dsent)), lib_bwd,
        general_ms=general_bwd_ms,
        batch_tile=TL.bwd_tile(B, TL._bwd_clusters_held(dev, h)))


def time_f32_mega(meta, args, gouts, rate, seed, shape):
    """#5 and #6 in float32 on both float32 routes ("fma32", then
    "general"), each backward handed its own route's forward files, beside
    their plain versions (the backward's VJP at the files) and their bounds
    (``[f32]`` lines; #6 also its walk and weight-gradient launches apart,
    ``mega_grad.bwd_launches`` timed by CUDA events: ``torch.profiler``
    here would leave phase 11's profiler without device events). Returns
    ``{route: {"fwd_ms", "bwd_ms", "walk_ms", "wgrad_ms"}}`` and ``{"fwd",
    "bwd"}``: each kernel's plain ms and bound."""
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.utils.device import cuda_time_ms

    f32 = torch.float32
    out = TX.mega_exec_train_call(meta, args, rate, seed)
    kb = TG.mega_exec_bwd_call(meta, args, out, gouts, rate, seed)

    def plain():
        return TG.mega_exec_bwd_reference(meta, args, out, gouts, rate, seed,
                                          at_files=True)

    ref = {"fwd": (cuda_time_ms(lambda: TX.mega_exec_reference(
        meta, args, rate=rate, seed=seed), iters=2, warmup=1),
        bound(counted_flops(lambda: TX.mega_exec_reference(
            meta, args, rate=rate, seed=seed)), tensor_bytes(args, out), f32)),
        "bwd": (cuda_time_ms(plain, iters=1, warmup=1),
                bound(counted_flops(plain),
                      tensor_bytes(args, out, gouts, kb), f32))}
    res = {}
    for route, _, ctx in F32_ROUTES:
        with ctx():
            o = TX.mega_exec_train_call(meta, args, rate, seed)

            def bwd():
                return TG.mega_exec_bwd_call(meta, args, o, gouts, rate,
                                             seed)

            walk, wgrad, _ = TG.bwd_launches(
                meta, args, o, gouts, TX.dropout_params(rate, seed))
            r = {"fwd_ms": cuda_time_ms(lambda: TX.mega_exec_train_call(
                meta, args, rate, seed), iters=5),
                "bwd_ms": cuda_time_ms(bwd, iters=3),
                "walk_ms": cuda_time_ms(walk, iters=3),
                "wgrad_ms": cuda_time_ms(wgrad, iters=3)}
        res[route] = r
        # the "fma32" launches' cluster sizes (mega_exec.fma32_cluster)
        more = {} if route != "fma32" else {
            "cluster": TX.fma32_launch_cluster(meta[0], meta[6]),
            "walk_cluster": TX.fma32_launch_cluster(meta[0], meta[6],
                                                    meta[5])}
        f32_record("#5", shape, route, r["fwd_ms"], *ref["fwd"],
                   **{k: v for k, v in more.items() if k == "cluster"})
        f32_record("#6", shape, route, r["bwd_ms"], *ref["bwd"],
                   walk_ms=r["walk_ms"], wgrad_ms=r["wgrad_ms"],
                   **{k: v for k, v in more.items() if k == "walk_cluster"})
    return res, ref


def phase_mega_train(dev):
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN, tree_map
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.testing import workload as W
    from stair_tpu_torch.utils.device import cuda_time_ms

    rate, seed = 0.25, (1234567, 2 ** 31 - 5)
    names = (("dvf_a", "dvf_b", "dtok_a", "dtok_b", "daux")
             + TX.ARG_NAMES[TG.N_DATA:])
    errs = {}
    for F, attention in ((16, "parity"), (FRAMES, "softmax"),
                         (FRAMES, "parity")):
        for dtype in (torch.float32, torch.bfloat16):
            cfg = NMNConfig(
                hidden_size=HIDDEN, video_size=VIDEO_D, text_size=TEXT_D,
                max_video_length=F, object_types=3, max_steps=16,
                num_vec=10, num_frames=6, num_attn=8,
                filter_attention=attention,
                compute_dtype="float32" if dtype == torch.float32
                else "bfloat16")
            model = W.build_model(cfg, seed=4, device=dev)
            batch = W.to_device(W.opcode_batch(
                cfg, W.OPCODE_PROGRAMS * 2, seed=F + 1), dev)
            B, L = batch["question"].shape[:2]
            gen = torch.Generator().manual_seed(F + 1)
            halves = [torch.randn(B, n, HIDDEN // 2, generator=gen)
                      .to(dev, dtype)
                      for n in (F, F, L, L)]
            mods = tree_map(lambda x: x.detach().to(dtype),
                            model.param_tree()["modules"])
            gouts = None
            ftol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 3e-2)
            # The softmax Filter's keyword weights and bias shift every
            # logit of one softmax alike, so their exact gradient is 0 and
            # both sides hold float32 rounding noise: bound their size
            # against the Filter logit weights' gradient instead.
            vanish = ("fltk", "fltb") if attention == "softmax" else ()
            # float32: a ReLU pre-activation within rounding of 0 can take
            # the other side under the kernel's summation order, and its
            # whole cotangent moves (up to ~2e-2 of a gradient at F = 64,
            # H = 512). So the inputs are run three times, as drawn and
            # twice with 1e-4 relative noise, which moves such kinks and
            # leaves a logic error in place: every run within 5e-2, and
            # two of three within 1e-4. bf16: one run within 1e-1.
            runs = 3 if dtype == torch.float32 else 1
            tight, loose = (1e-4, 5e-2) if runs == 3 else (1e-1, 1e-1)
            worsts, fwd_err = [], {}
            for k in range(runs):
                hk = halves if k == 0 else [
                    h * (1 + 1e-4 * torch.randn(
                        h.shape, generator=gen).to(dev, dtype))
                    for h in halves]
                meta, args = TX.prepare_args(
                    cfg, mods, VideoNMN._fused_tables(mods), batch["trace"],
                    hk[:2], batch["video_mask"], hk[2:],
                    batch["question_mask"])
                ref = TX.mega_exec_reference(meta, args, rate=rate, seed=seed)
                if gouts is None:
                    gouts = [torch.randn(r.shape, generator=gen).to(dev)
                             for r in ref]
                rb = TG.mega_exec_bwd_reference(meta, args, ref, gouts, rate,
                                                seed)
                plain = dict(zip(names, rb))
                # both routes of the dtype, the main paths' first (its worst
                # error is the run's): bf16 tensor-core and general, float32
                # "fma32" and general (equal bits: files and gradients). Each
                # route's forward against the plain version, and its backward
                # handed that forward's files (the walk recomputes its own
                # route's forward values bit for bit)
                first = {}
                for route, _, ctx in executor_routes(dtype):
                    if route != "general":
                        require(TX.fwd_route(dtype, HIDDEN, F, True) == route,
                                f"{dtype} F={F} not on the {route} route")
                    with ctx():
                        _build.reset_launches()
                        out = TX.mega_exec_train_call(meta, args, rate, seed)
                        torch.cuda.synchronize()
                        require(_build.LAUNCHES[TRAIN_KEYS[route]] == 1 and
                                sum(_build.LAUNCHES[key] for key in
                                    TRAIN_KEYS.values()) == 1,
                                f"mega_exec_train {route} route launches "
                                f"{_build.LAUNCHES}")
                        for o, r, what in zip(out, ref, ("regs_vec",
                                                         "regs_frames",
                                                         "regs_attn")):
                            torch.testing.assert_close(
                                o.float(), r.float(), rtol=ftol[0],
                                atol=ftol[1], msg=f"{route} route {what}")
                        fwd_err[route] = max_err(out, ref)
                        kb = TG.mega_exec_bwd_call(meta, args, out, gouts,
                                                   rate, seed)
                        if k == 0:
                            kb2 = TG.mega_exec_bwd_call(meta, args, out,
                                                        gouts, rate, seed)
                            torch.cuda.synchronize()
                            require(all(torch.equal(x, y)
                                        for x, y in zip(kb, kb2)),
                                    f"executor backward ({route} route) is "
                                    "not deterministic")
                    if dtype == torch.float32 and route == "general":
                        require(all(torch.equal(x, y) for x, y in zip(
                            first["out"], out)) and all(
                            torch.equal(x, y) for x, y in zip(
                                first["kb"], kb)),
                            f"float32 F={F} {attention} run {k}: the fma32 "
                            "route's files or gradients differ from the "
                            "general route's")
                    first.setdefault("out", out)
                    first.setdefault("kb", kb)
                    grads = dict(zip(names, kb))
                    ref_scale = max(float(plain["fltw"].float().abs().max()),
                                    1e-12)
                    noise = max((float(t[n].float().abs().max()) / ref_scale
                                 for t in (grads, plain) for n in vanish),
                                default=0.0)
                    require(noise <= 1e-3,
                            f"mega_exec_bwd {route} route {vanish} not ~0: "
                            f"{noise}")
                    bwd = {n: rel_err(grads[n], plain[n]) for n in names
                           if n not in vanish}
                    worst = max(bwd, key=bwd.get)
                    require(bwd[worst] <= loose,
                            f"mega_exec_bwd {route} route F={F} {attention} "
                            f"{dtype} run {k}: bound {loose}: {bwd}")
                    if route == "general":
                        general_worst = (bwd[worst], worst)
                        continue
                    worsts.append((bwd[worst], worst))
                    if k == 0:
                        e0 = (fwd_err[route], max_err(kb, rb))
                if k == 0 and dtype == torch.float32:
                    time_f32_mega(meta, args, gouts, rate, seed,
                                  f"opcode programs x2, B {B} H {HIDDEN} F "
                                  f"{F} {attention}")
            n_tight = sum(w <= tight for w, _ in worsts)
            require(2 * n_tight > runs,
                    f"mega_exec_bwd F={F} {attention} {dtype}: only "
                    f"{n_tight} of {runs} runs within {tight}: {worsts}")
            errs[(F, attention, str(dtype))] = e0
            routes = ("tensor-core route" if dtype == torch.bfloat16
                      else "fma32 route")
            ferr = ", ".join(f"{r} route {e:.3e}" for r, e in fwd_err.items())
            log(f"[mega_exec train] all {len(W.OPCODE_PROGRAMS)} opcode "
                f"programs x2 H={HIDDEN} F={F} {attention} rate {rate} {dtype}: "
                f"forward max_abs_err {ferr} (rtol {ftol[0]}, atol "
                f"{ftol[1]}); backward ({routes}) over {len(bwd)} gradients "
                f"max rel err per run {[(f'{w:.2e}', n) for w, n in worsts]} "
                f"({n_tight} of {runs} within {tight}, all within {loose})"
                + (f"; general route {general_worst[0]:.2e} at "
                   f"{general_worst[1]}" if dtype == torch.bfloat16 else
                   "; the general route's files and gradients equal bit for "
                   "bit in every run")
                + (f"; {'/'.join(vanish)} (0 in exact arithmetic) at "
                   f"{noise:.2e} of the fltw gradient (bound 1e-3)"
                   if vanish else "")
                + "; two backward runs bit-identical ok")
    # The tensor-core walk recomputes the training forward's values with the
    # forward's own product code (walk_gemm, vecmat_tc); each must give the
    # bits of the forward's call at the walk's shapes ([F, H] @ [H, H],
    # [F, H] @ [H, F], and the vec-level product over 1-3 segments), alone
    # and as stage 1's chained pair (the hidden kept as each kernel keeps
    # it).
    gen = torch.Generator().manual_seed(9)
    for i, (M, K, N) in enumerate(((FRAMES, HIDDEN, HIDDEN),
                                   (16, HIDDEN, HIDDEN),
                                   (FRAMES, HIDDEN, FRAMES))):
        for vec in (False, True):
            S = 1 + i   # segments of the vec-level product
            rows = S * K if vec else K
            A = torch.randn(S if vec else M, K, generator=gen).to(
                dev, torch.bfloat16)
            if vec:     # the executor's vectors: float32 holding bf16 values
                A = A.float()
            Bm = (torch.randn(rows, N, generator=gen) / K ** 0.5).to(
                dev, torch.bfloat16)
            for chain in (False, True):
                fwd, walk = TG.recompute_check(A, Bm, vec, chain)
                torch.cuda.synchronize()
                require(torch.equal(fwd, walk),
                        f"walk's recompute != #5's product at M={M} K={K} "
                        f"N={N} vec={vec} chain={chain}: max diff "
                        f"{float((fwd - walk).abs().max())}")
        log(f"[recompute] the walk's products equal #5's bit for bit at "
            f"[{M}, {K}] @ [{K}, {N}] and the vec-level [{S} x {K}] @ "
            f"[{S * K}, {N}], alone and chained ok")
    return errs


def step_grads(m, batch, window, seed=7):
    """One train step's loss and every gradient leaf of ``m`` on ``batch``
    (a materialized batch), the dropout masks from ``seed``; ``m`` keeps
    its weights."""
    from stair_tpu_torch.train.losses import total_loss

    m.zero_grad(set_to_none=True)
    loss, _ = total_loss(m, batch, torch.Generator().manual_seed(seed),
                         1.0, 1.0, 1.0, 1.0, contrastive_window=window)
    loss.backward()
    return float(loss.detach()), {
        k: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
        for k, p in m.weights.items()}


def hold_step_routes(tag, models, batch, window, seed=7):
    """One train step of each ``(model, dtype)`` in ``models`` on ``batch``
    (a materialized batch), on the kernel route against the plain route:
    the same weights, batch and dropout masks. Returns each kernel-route
    run's launches by dtype.

    Gradients are held leaf by leaf in float32: in bf16 the two routes
    round at different sites and ReLUs take different sides, so leaves
    move by up to ~0.17 (max) and ~0.09 (norm) with no logic at fault. In
    float32 a ReLU pre-activation within rounding of 0 still moves a leaf
    by up to ~2e-3 in norm (a logic error moves it by O(1)): bound 1e-2 on
    ||kernel - plain|| / ||plain|| per leaf. The loss agrees within 1e-4
    in both dtypes. float32 takes the BiLSTM's float32 cluster routes."""
    def grads_of(m):
        return step_grads(m, batch, window, seed)

    def norm_rel(a, b):
        return float((a - b).norm()) / max(float(b.norm()), 1e-30)

    keys = tuple(k for k, v in TRAIN_LAUNCHES.items() if v)
    keys32 = tuple(TRAIN_LAUNCHES_F32)
    launched = {}
    for m, dtype in models:
        with kernel_route(keys32 if dtype == "float32" else keys) as seen:
            lk, gk = grads_of(m)
        launched[dtype] = seen
        if dtype == "float32":
            require_launches(f"{tag} float32 step", seen, TRAIN_LAUNCHES_F32)
        with plain_route():
            lp, gp = grads_of(m)
        require(abs(lk - lp) <= 1e-4 * abs(lp),
                f"{dtype} step loss kernel {lk} vs plain {lp}")
        if dtype == "float32":
            live = [k for k in gk if gp[k].abs().max() > 0]
            rels = {k: norm_rel(gk[k], gp[k]) for k in live}
            worst = sorted(rels.items(), key=lambda kv: -kv[1])[:4]
            mx = max(rel_err(gk[k], gp[k]) for k in live)
            require(worst[0][1] <= 1e-2, f"kernel vs plain gradients {worst}")
            log(f"{tag} one step's float32 gradients, kernel vs plain route"
                f" over {len(live)} leaves: worst norm rel err "
                f"{[(k, f'{v:.2e}') for k, v in worst]} (bound 1e-2), median "
                f"{float(np.median(list(rels.values()))):.2e}, max-based "
                f"worst {mx:.2e}; loss {lk:.6f} vs {lp:.6f}")
        else:
            log(f"{tag} one bf16 step's loss, kernel vs plain route: "
                f"{lk:.6f} vs {lp:.6f} (bound 1e-4 relative)")
    return launched


def executor_inputs(model, batch, train):
    """The executor's ``(meta, args)`` on ``batch`` (materialized) and
    ``model``'s weights: the video and question encodes (the BiLSTM eval
    forward #1, or with ``train`` the training forward #2), then
    ``prepare_args``, as the model's forward makes them in its compute
    dtype (bf16: the projections' matmul and the tokens in bf16, the
    modules and the video mask cast)."""
    from stair_tpu_torch.models.nmn import VideoNMN, tree_map
    from stair_tpu_torch.ops import lstm as TL
    from stair_tpu_torch.ops import mega_exec as TX

    dt = model.compute_dtype
    mm = dt if dt != torch.float32 else None
    p = tree_map(lambda x: x.detach(), model.param_tree())
    enc = TL.bilstm_train_call if train else TL.bilstm
    kv = enc(*TL._prep(p["video_encoder"], batch["video"],
                       batch["video_mask"], mm), token_dtype=dt)
    kq = enc(*TL._prep(p["text_encoder"], batch["question"],
                       batch["question_mask"], mm), token_dtype=dt)
    mods = tree_map(lambda x: x.to(dt), p["modules"])
    return TX.prepare_args(
        model.config, mods, VideoNMN._fused_tables(mods), batch["trace"],
        kv[:2], batch["video_mask"].to(dt), kq[:2], batch["question_mask"])


def hold_f32_executor(dev, model, batch, rate, seed=(11, 22)):
    """#4 on ``batch``'s eval inputs, #5 and #6 on its training inputs
    (``executor_inputs``), on the "fma32" route (one launch of each of its
    keys, #4, #5 and #6's walk each on the cluster size its launch picks,
    ``mega_exec.fma32_launch_cluster``) against the same kernels one CTA an
    example and the general route forced (equal bits: the three files,
    every data cotangent and weight gradient) and the plain versions
    (phase 8's float32 bounds: files within 1e-4, #6 within 5e-2 of each
    gradient's largest value). Returns the errors, the cluster sizes and
    what the timings reuse."""
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG

    ins = {"eval": executor_inputs(model, batch, train=False),
           "train": executor_inputs(model, batch, train=True)}
    meta4, a4 = ins["eval"]
    meta5, a5 = ins["train"]
    B, F, H = meta4[0], meta4[5], meta4[6]
    clusters = {"#4": TX.fma32_launch_cluster(B, H),
                "#5": TX.fma32_launch_cluster(B, H),
                "#6": TX.fma32_launch_cluster(B, H, F)}
    with kernel_route(("mega_exec_fma32",)) as l4:
        k4 = TX.mega_exec_call(meta4, a4)
    require_launches("float32 #4", l4, {"mega_exec_fma32": 1})
    seen = {"#4": dict(_build.CLUSTERS["mega_exec_fma32"])}
    keys = ("mega_exec_train_fma32", "mega_exec_bwd_fma32",
            "mega_exec_wgrad_fma32")
    gen = torch.Generator().manual_seed(6)
    with kernel_route(keys) as l56:
        k5 = TX.mega_exec_train_call(meta5, a5, rate, seed)
        gouts = [torch.randn(o.shape, generator=gen).to(dev) for o in k5]
        k6 = TG.mega_exec_bwd_call(meta5, a5, k5, gouts, rate, seed)
    require_launches("float32 #5 + #6", l56, dict.fromkeys(keys, 1))
    seen["#5"] = dict(_build.CLUSTERS["mega_exec_train_fma32"])
    seen["#6"] = dict(_build.CLUSTERS["mega_exec_bwd_fma32"])
    require(seen == {k: {c: 1} for k, c in clusters.items()},
            f"float32 #4-#6 B {B} H {H} F {F}: cluster launches {seen}, "
            f"the launches' picks {clusters}")
    with one_cta():
        o4 = TX.mega_exec_call(meta4, a4)
        o5 = TX.mega_exec_train_call(meta5, a5, rate, seed)
        o6 = TG.mega_exec_bwd_call(meta5, a5, o5, gouts, rate, seed)
    with general_mega(), kernel_route(("mega_exec", "mega_exec_train",
                                       "mega_exec_bwd", "mega_exec_wgrad")):
        g4 = TX.mega_exec_call(meta4, a4)
        g5 = TX.mega_exec_train_call(meta5, a5, rate, seed)
        g6 = TG.mega_exec_bwd_call(meta5, a5, g5, gouts, rate, seed)
    torch.cuda.synchronize()
    for what, k, o, g in (("#4 files", k4, o4, g4), ("#5 files", k5, o5, g5),
                          ("#6 gradients", k6, o6, g6)):
        require(all(torch.equal(a, b) for a, b in zip(k, o)),
                f"float32 {what}: the fma32 route on its cluster "
                f"{clusters} differs from one CTA an example")
        require(all(torch.equal(a, b) for a, b in zip(k, g)),
                f"float32 {what}: the fma32 route differs from the "
                "general route")
    r4 = TX.mega_exec_reference(meta4, a4)
    r5 = TX.mega_exec_reference(meta5, a5, rate=rate, seed=seed)
    for what, k, r in (("#4", k4, r4), ("#5", k5, r5)):
        for o, p in zip(k, r):
            torch.testing.assert_close(o, p, rtol=1e-4, atol=1e-4,
                                       msg=f"float32 {what} vs plain")
    r6 = TG.mega_exec_bwd_reference(meta5, a5, k5, gouts, rate, seed,
                                    at_files=True)
    rel6 = max(rel_err(x, y) for x, y in zip(k6, r6))
    require(rel6 <= 5e-2, f"float32 #6 vs plain: rel err {rel6}")
    return dict(e4=max_err(k4, r4), e5=max_err(k5, r5), e6=max_err(k6, r6),
                rel6=rel6, ins=ins, gouts=gouts, seed=seed, rate=rate,
                outs={"#4": k4, "#5": k5, "#6": k6}, clusters=clusters)


def time_f32_step(dev, card, model32, batch, args):
    """The float32 train step at phase 8's configuration (B 128): ms a step
    (CUDA events) on the main path (the executor on its "fma32" routes, the
    BiLSTM on its float32 cluster routes), with the executor on its general
    routes, and with the BiLSTM backward on its general route, in turns;
    then ``F32_STEPS`` counted steps (``TRAIN_LAUNCHES_F32`` each) and one
    counted eval forward (``EVAL_LAUNCHES_F32``); then #4 (on the eval
    forward's inputs), #5 and #6 (on the step's) on both float32 routes,
    with their bounds and plain versions (``[f32]`` lines). Updates
    ``model32``. Returns the kernel entries of the "fma32" route."""
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.train.loop import make_train_step
    from stair_tpu_torch.utils.device import cuda_time_ms

    step = make_train_step(model32, args)
    gens = iter(range(400, 500))

    def one():
        step(batch, torch.Generator().manual_seed(next(gens)), 1.0, 1.0)

    turns = {"main": contextlib.nullcontext, "executor general": general_mega,
             "BiLSTM backward general": general_lstm_bwd}
    ms = {k: [] for k in turns}
    for name in (*turns, *reversed(turns)):
        with turns[name]():
            ms[name].append(cuda_time_ms(one, iters=5, warmup=1))
    log(f"[train] float32 step B={TRAIN_BATCH} ms (CUDA events, 5 steps "
        f"after one, in turns): "
        + "; ".join(f"{k} {[round(x, 4) for x in v]}" for k, v in ms.items())
        + f"; card {card}")
    SEEN["f32_step_ms"] = ms

    # ---- the counted float32 runs: train steps, one eval forward --------
    torch.cuda.synchronize()
    _build.reset_launches()
    for _ in range(F32_STEPS):
        one()
    torch.cuda.synchronize()
    f32_launches = dict(_build.LAUNCHES)
    require_launches(f"[train] {F32_STEPS} float32 steps", f32_launches,
                     {k: v * F32_STEPS for k, v in TRAIN_LAUNCHES_F32.items()})
    _build.reset_launches()
    with torch.no_grad():
        logits = model32(batch)["logits"]
    torch.cuda.synchronize()
    eval_launches = dict(_build.LAUNCHES)
    require_launches("[train] float32 eval forward", eval_launches,
                     EVAL_LAUNCHES_F32)
    require(bool(torch.isfinite(logits).all()), "non-finite float32 logits")
    log(f"[train] float32 counted runs: {F32_STEPS} steps, launches "
        f"{ {k: v for k, v in f32_launches.items() if v} }; one eval "
        f"forward, launches { {k: v for k, v in eval_launches.items() if v} }"
        f"; card {card}")

    cfg = model32.config
    shape = (f"train step B {TRAIN_BATCH} H {cfg.hidden_size} F "
             f"{cfg.max_video_length}")
    # #4 on the eval forward's inputs, #5 and #6 on the step's
    h = hold_f32_executor(dev, model32, batch, cfg.dropout)
    e4, e5, e6, r6 = h["e4"], h["e5"], h["e6"], h["rel6"]
    meta, margs = h["ins"]["eval"]
    with general_mega():
        ms4g = cuda_time_ms(lambda: TX.mega_exec_call(meta, margs), iters=5)
    ms4 = cuda_time_ms(lambda: TX.mega_exec_call(meta, margs), iters=5)
    p4 = cuda_time_ms(lambda: TX.mega_exec_reference(meta, margs), iters=2,
                      warmup=1)
    b4 = bound(counted_flops(lambda: TX.mega_exec_reference(meta, margs)),
               tensor_bytes(margs, h["outs"]["#4"]), torch.float32)
    f32_record("#4", f"eval forward B {TRAIN_BATCH} H {cfg.hidden_size} F "
               f"{cfg.max_video_length}", "fma32", ms4, p4, b4,
               cluster=h["clusters"]["#4"], general_ms=ms4g)
    log(f"[train] float32 executor on the step's inputs: #4 max_abs_err "
        f"{e4:.3e}, #5 {e5:.3e} (atol 1e-4), #6 max rel err {r6:.3e} "
        f"(max_abs_err {e6:.3e}; bound 5e-2) against the plain versions; "
        f"fma32 and general routes equal bit for bit (#4, #5 files, #6 "
        f"gradients); card {card}")
    meta, margs = h["ins"]["train"]
    res, ref = time_f32_mega(meta, margs, h["gouts"], cfg.dropout, h["seed"],
                             shape)
    fma, gen_ = res["fma32"], res["general"]
    base = {"route": "cuda", "path": f"float32 train step and eval forward, "
            f"B {TRAIN_BATCH} (phase 8)", "executor_route": "fma32",
            "library_ms": None}
    return [
        {"name": "mega_exec_fma32", **base,
         "source": "stair_tpu_torch/ops/csrc/mega_exec.cu",
         "replaces": "stair_tpu/ops/mega_exec.py:123",
         "launches": eval_launches["mega_exec_fma32"], "max_abs_err": e4,
         "ms": ms4, "general_ms": ms4g, "plain_ms": p4, **b4},
        {"name": "mega_exec_train_fma32", **base,
         "source": "stair_tpu_torch/ops/csrc/mega_exec.cu",
         "replaces": "stair_tpu/ops/mega_grad.py:1016",
         "launches": f32_launches["mega_exec_train_fma32"],
         "max_abs_err": e5, "ms": fma["fwd_ms"], "general_ms": gen_["fwd_ms"],
         "plain_ms": ref["fwd"][0], **ref["fwd"][1]},
        {"name": "mega_exec_bwd_fma32", **base,
         "source": "stair_tpu_torch/ops/csrc/mega_grad.cu",
         "replaces": "stair_tpu/ops/mega_grad.py:111",
         "launches": f32_launches["mega_exec_bwd_fma32"],
         "wgrad_launches": f32_launches["mega_exec_wgrad_fma32"],
         "max_abs_err": e6, "ms": fma["bwd_ms"], "walk_ms": fma["walk_ms"],
         "wgrad_ms": fma["wgrad_ms"], "general_ms": gen_["bwd_ms"],
         "general_walk_ms": gen_["walk_ms"],
         "general_wgrad_ms": gen_["wgrad_ms"], "plain_ms": ref["bwd"][0],
         **ref["bwd"][1]},
    ]


def phase_train(dev, card):
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN, tree_map
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import lstm as TL
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.testing import workload as W
    from stair_tpu_torch.train.loop import make_train_step, trainer_defaults
    from stair_tpu_torch.utils.device import cuda_time_ms

    base = W.workload_config(hidden_size=HIDDEN, video_size=VIDEO_D,
                             text_size=TEXT_D, max_video_length=FRAMES)
    cfg = NMNConfig(**{**base.to_dict(), "compute_dtype": "bfloat16",
                       "dropout": 0.25})
    log(f"[train] config {json.dumps(cfg.to_dict())}")
    batch = W.add_fake_supervision(
        W.make_batch(cfg, batch_size=TRAIN_BATCH,
                     question_len=QUESTION_LEN), cfg)
    batch = W.to_device(batch, dev)
    args = trainer_defaults()    # lr 2e-4, schedule 1.0 -> 0.1, window 32
    model = W.build_model(cfg, seed=0, device=dev)

    # ---- one step, kernel route vs plain route ---------------------------
    model32 = W.build_model(NMNConfig(**{**cfg.to_dict(),
                                         "compute_dtype": "float32"}),
                            seed=0, device=dev)
    hold_step_routes("[train]", ((model32, "float32"), (model, "bfloat16")),
                     batch, args.contrastive_window)
    f32_entries = time_f32_step(dev, card, model32, batch, args)
    del model32

    # ---- the counted main-path run: 10 steps on the kernel route --------
    step = make_train_step(model, args)
    step(batch, torch.Generator().manual_seed(100), 1.0, 1.0)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        m = step(batch, torch.Generator().manual_seed(i), 1.0, 1.0)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    losses = [float(x) for x in losses]
    for k, n in TRAIN_LAUNCHES.items():
        require(launches[k] == n * TRAIN_STEPS,
                f"{k} launches {launches[k]} != {n * TRAIN_STEPS}")
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    require(np.mean(losses[-3:]) < np.mean(losses[:3]),
            f"loss did not fall: {losses}")
    log(f"[train] {TRAIN_STEPS} steps B={TRAIN_BATCH}: losses "
        f"{[round(x, 4) for x in losses]}; launches {launches}; "
        f"{wall * 1e3 / TRAIN_STEPS:.3f} ms per step (host clock, "
        f"synchronized); card {card}")
    k_ms = cuda_time_ms(lambda: step(batch, torch.Generator().manual_seed(
        200), 1.0, 1.0), iters=5, warmup=1)
    with plain_route():
        p_ms = cuda_time_ms(lambda: step(
            batch, torch.Generator().manual_seed(300), 1.0, 1.0),
            iters=2, warmup=1)
    log(f"[train] ms per step (CUDA events): kernel route {k_ms:.3f}, plain "
        f"route {p_ms:.3f}; card {card}")
    SEEN.update(train_cfg=cfg, train_batch=batch, train_args=args,
                mega_train_ms=k_ms)

    # ---- each training kernel at these shapes, and its plain version ----
    dt = model.compute_dtype
    p = tree_map(lambda x: x.detach(), model.param_tree())
    vargs = TL._prep(p["video_encoder"], batch["video"], batch["video_mask"],
                     dt)
    qargs = TL._prep(p["text_encoder"], batch["question"],
                     batch["question_mask"], dt)
    kv = TL.bilstm_train_call(*vargs, token_dtype=dt)
    kq = TL.bilstm_train_call(*qargs, token_dtype=dt)
    rv_ = TL.bilstm_reference(*vargs, token_dtype=dt, return_stacks=True)
    rq_ = TL.bilstm_reference(*qargs, token_dtype=dt, return_stacks=True)
    e_lt = max(max_err(kv[:3], rv_[:3]), max_err(kq[:3], rq_[:3]))
    gen = torch.Generator().manual_seed(5)

    def cot(a):
        return torch.randn(a.shape, generator=gen).to(dev, a.dtype)

    vcot = (cot(kv[0]), cot(kv[1]), cot(kv[2]))
    qcot = (cot(kq[0]), cot(kq[1]), cot(kq[2]))
    kbv = TL.bilstm_bwd_call(*vargs, kv[3], *vcot)
    rbv = TL.bilstm_bwd_reference(*vargs, kv[3], *vcot)
    kbq = TL.bilstm_bwd_call(*qargs, kq[3], *qcot)
    rbq = TL.bilstm_bwd_reference(*qargs, kq[3], *qcot)
    e_lb = max(max_err(kbv, rbv), max_err(kbq, rbq))

    def general_fwd_ms():
        """The two training-forward calls on the general route."""
        with general_lstm_fwd():
            return cuda_time_ms(
                lambda: (TL.bilstm_train_call(*vargs, token_dtype=dt),
                         TL.bilstm_train_call(*qargs, token_dtype=dt)),
                iters=3)

    def general_bwd_ms():
        """The same two calls on the backward's general route (the
        kernels the cluster route replaced on the main path)."""
        with general_lstm_bwd():
            return cuda_time_ms(
                lambda: (TL.bilstm_bwd_call(*vargs, kv[3], *vcot),
                         TL.bilstm_bwd_call(*qargs, kq[3], *qcot)), iters=3)
    def general_mega_ms(fn):
        """``fn`` on the executor's general routes (the kernels the
        tensor-core routes replaced on the main path)."""
        with general_mega():
            return cuda_time_ms(fn, iters=3)
    r_lb = max(max(rel_err(x, y) for x, y in zip(kbv, rbv)),
               max(rel_err(x, y) for x, y in zip(kbq, rbq)))
    require(e_lt <= 2e-2 and r_lb <= 2e-2,
            f"bilstm train main-path errors {e_lt} {r_lb}")
    mods = tree_map(lambda x: x.to(dt), p["modules"])
    meta, margs = TX.prepare_args(
        cfg, mods, VideoNMN._fused_tables(mods), batch["trace"], kv[:2],
        batch["video_mask"].to(dt), kq[:2], batch["question_mask"])
    seed = (11, 22)
    km = TX.mega_exec_train_call(meta, margs, cfg.dropout, seed)
    rm = TX.mega_exec_reference(meta, margs, rate=cfg.dropout, seed=seed)
    e_mt = max_err(km, rm)
    for o, r in zip(km, rm):
        torch.testing.assert_close(o.float(), r.float(), rtol=1e-2, atol=3e-2)
    mcot = [cot(o) for o in km]
    # The train step hands the backward the kernel forward's register files
    # (km), and the walk reads every register value from them, as the JAX
    # kernel #6 does: its plain version is autograd at those files
    # (at_files), the main-path check, bound 1e-1. The general route is held
    # the same way on its own forward's files (kmg): each route's walk
    # recomputes its own forward's values bit for bit. The kernel handed
    # the plain forward's files (rm) is held to the plain backward through
    # the plain forward, whose files are rm, within the same bound. Printed
    # beside: the kernel on km against the plain backward through the plain
    # forward, and the plain VJP at km against it too; the two read alike
    # when the gap is the forwards' bf16 steps moving a relu's side, not
    # the backward.
    names = ("dvf_a", "dvf_b", "dtok_a", "dtok_b", "daux") + tuple(
        TX.ARG_NAMES[TG.N_DATA:])

    def worst(out, ref):
        rels = sorted(((rel_err(x, y), n) for n, x, y in zip(names, out, ref)),
                      reverse=True)
        return rels[0][0], [(n, f"{r:.3e}") for r, n in rels[:3]]

    rmb = TG.mega_exec_bwd_reference(meta, margs, km, mcot, cfg.dropout,
                                     seed, at_files=True)
    rrb = TG.mega_exec_bwd_reference(meta, margs, rm, mcot, cfg.dropout,
                                     seed)
    kmb = TG.mega_exec_bwd_call(meta, margs, km, mcot, cfg.dropout, seed)
    e_mb = max_err(kmb, rmb)
    r_mb, w_mb = worst(kmb, rmb)
    with general_mega():
        kmg = TX.mega_exec_train_call(meta, margs, cfg.dropout, seed)
        e_mtg = max_err(kmg, rm)
        r_gen, w_gen = worst(TG.mega_exec_bwd_call(
            meta, margs, kmg, mcot, cfg.dropout, seed),
            TG.mega_exec_bwd_reference(meta, margs, kmg, mcot, cfg.dropout,
                                       seed, at_files=True))
    r_rm, w_rm = worst(TG.mega_exec_bwd_call(meta, margs, rm, mcot,
                                             cfg.dropout, seed), rrb)
    r_fwd, w_fwd = worst(kmb, rrb)
    r_pf, w_pf = worst(rmb, rrb)
    log(f"[main-path inputs] bilstm_train max_abs_err {e_lt:.3e}; "
        f"bilstm_bwd max_abs_err {e_lb:.3e} (max rel {r_lb:.2e}); "
        f"mega_exec_train max_abs_err {e_mt:.3e} (general route "
        f"{e_mtg:.3e}); mega_exec_bwd max rel err (bound 1e-1) on the "
        f"kernel forward's files {r_mb:.3e} (max_abs_err {e_mb:.3e}; worst "
        f"{w_mb}), the general route on its forward's files {r_gen:.3e} "
        f"({w_gen}), on the plain forward's files {r_rm:.3e} "
        f"({w_rm}); through the plain forward instead: the kernel on km "
        f"{r_fwd:.3e} ({w_fwd}), the plain VJP at km {r_pf:.3e} ({w_pf})")
    require(r_mb <= 1e-1 and r_gen <= 1e-1,
            f"mega_exec_bwd main-path rel err {r_mb} {w_mb}, general route "
            f"{r_gen} {w_gen} (bound 1e-1)")
    require(r_rm <= 1e-1,
            f"mega_exec_bwd on the plain forward's files rel err {r_rm} "
            f"{w_rm} (bound 1e-1)")
    t = {
        "bilstm_train": cuda_time_ms(
            lambda: (TL.bilstm_train_call(*vargs, token_dtype=dt),
                     TL.bilstm_train_call(*qargs, token_dtype=dt)), iters=5),
        "bilstm_train_general": general_fwd_ms(),
        "bilstm_train_plain": cuda_time_ms(
            lambda: (TL.bilstm_reference(*vargs, token_dtype=dt,
                                         return_stacks=True),
                     TL.bilstm_reference(*qargs, token_dtype=dt,
                                         return_stacks=True)), iters=2),
        "bilstm_bwd": cuda_time_ms(
            lambda: (TL.bilstm_bwd_call(*vargs, kv[3], *vcot),
                     TL.bilstm_bwd_call(*qargs, kq[3], *qcot)), iters=5),
        "bilstm_bwd_general": general_bwd_ms(),
        "bilstm_bwd_plain": cuda_time_ms(
            lambda: (TL.bilstm_bwd_reference(*vargs, kv[3], *vcot),
                     TL.bilstm_bwd_reference(*qargs, kq[3], *qcot)),
            iters=2),
        "mega_exec_train": cuda_time_ms(
            lambda: TX.mega_exec_train_call(meta, margs, cfg.dropout, seed),
            iters=5),
        "mega_exec_train_general": general_mega_ms(
            lambda: TX.mega_exec_train_call(meta, margs, cfg.dropout, seed)),
        "mega_exec_train_plain": cuda_time_ms(
            lambda: TX.mega_exec_reference(meta, margs, rate=cfg.dropout,
                                           seed=seed), iters=2),
        "mega_exec_bwd": cuda_time_ms(
            lambda: TG.mega_exec_bwd_call(meta, margs, km, mcot,
                                          cfg.dropout, seed), iters=3),
        "mega_exec_bwd_general": general_mega_ms(
            lambda: TG.mega_exec_bwd_call(meta, margs, kmg, mcot, cfg.dropout,
                                          seed)),
        "mega_exec_bwd_plain": cuda_time_ms(
            lambda: TG.mega_exec_bwd_reference(meta, margs, km, mcot,
                                               cfg.dropout, seed,
                                               at_files=True),
            iters=1, warmup=1),
    }
    for k, v in t.items():
        log(f"[kernel time] {k}: {v:.3f} ms per call (CUDA events, bf16, "
            f"train-step shapes B={TRAIN_BATCH}); card {card}")
    b_lt = add_bounds(lstm_bound(vargs, kv), lstm_bound(qargs, kq))
    b_lb = add_bounds(lstm_bound(vargs, kbv, 3, (kv[3], vcot)),
                      lstm_bound(qargs, kbq, 3, (kq[3], qcot)))
    lib = [lstm_library_ms(TRAIN_BATCH, L, D, HIDDEN // 2, dev, dt,
                           train=True)
           for L, D in ((FRAMES, VIDEO_D), (QUESTION_LEN, TEXT_D))]
    lib_fwd, lib_bwd = (sum(x[i] for x in lib) for i in (0, 1))
    b_mt = bound(counted_flops(lambda: TX.mega_exec_reference(
        meta, margs, rate=cfg.dropout, seed=seed)),
        tensor_bytes(margs, km), dt)
    b_mb = bound(counted_flops(lambda: TG.mega_exec_bwd_reference(
        meta, margs, km, mcot, cfg.dropout, seed, at_files=True)),
        tensor_bytes(margs, km, mcot, kmb), dt)
    log(f"[bound] bilstm_train {b_lt}, bilstm_bwd {b_lb}, nn.LSTM (full "
        f"length, with its input projection) forward {lib_fwd:.3f} ms / "
        f"backward {lib_bwd:.3f} ms; mega_exec_train {b_mt}; mega_exec_bwd "
        f"{b_mb}; card {card}")
    extra = {"bilstm_train": {**b_lt, "library_ms": lib_fwd},
             "bilstm_bwd": {**b_lb, "library_ms": lib_bwd},
             "mega_exec_train": {**b_mt, "library_ms": None},
             "mega_exec_bwd": {**b_mb, "library_ms": None}}
    return [dict(k, **extra[k["name"]]) for k in [
        {"name": "bilstm_train", "route": "cuda",
         "source": "stair_tpu_torch/ops/csrc/bilstm.cu",
         "replaces": "stair_tpu/ops/lstm.py:583",
         "launches": launches["bilstm_train_tc"], "max_abs_err": e_lt,
         "ms": t["bilstm_train"], "general_ms": t["bilstm_train_general"],
         "plain_ms": t["bilstm_train_plain"]},
        {"name": "bilstm_bwd", "route": "cuda",
         "source": "stair_tpu_torch/ops/csrc/bilstm.cu",
         "replaces": "stair_tpu/ops/lstm.py:390",
         "launches": launches["bilstm_bwd_tc"], "max_abs_err": e_lb,
         "ms": t["bilstm_bwd"], "general_ms": t["bilstm_bwd_general"],
         "plain_ms": t["bilstm_bwd_plain"]},
        {"name": "mega_exec_train", "route": "cuda",
         "source": "stair_tpu_torch/ops/csrc/mega_exec.cu",
         "replaces": "stair_tpu/ops/mega_grad.py:1016",
         "executor_route": "tc",
         "launches": launches["mega_exec_train_tc"], "max_abs_err": e_mt,
         "ms": t["mega_exec_train"],
         "general_ms": t["mega_exec_train_general"],
         "plain_ms": t["mega_exec_train_plain"]},
        {"name": "mega_exec_bwd", "route": "cuda",
         "source": "stair_tpu_torch/ops/csrc/mega_grad_tc.cu",
         "replaces": "stair_tpu/ops/mega_grad.py:111",
         "executor_route": "tc",
         "launches": launches["mega_exec_bwd_tc"], "max_abs_err": e_mb,
         "ms": t["mega_exec_bwd"], "general_ms": t["mega_exec_bwd_general"],
         "plain_ms": t["mega_exec_bwd_plain"]},
    ]] + f32_entries


def attention_work(q, k, v, valid_len, prefix_len, causal=True):
    """Attention forward on these inputs, as (operations, bytes): 4 D
    operations per live (row, column) pair and head (two products); q, k
    and v rows below ``valid_len`` read once, out written once."""
    from stair_tpu_torch.ops.attention import attention_mask

    B, H, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    pairs = float(attention_mask(prefix_len, valid_len, Lq, Lkv,
                                 causal).sum())
    rows_q = float(valid_len.clamp(max=Lq).sum())
    rows_kv = float(valid_len.clamp(max=Lkv).sum())
    es = q.element_size()
    nbytes = es * D * (H * rows_q + 2 * Hkv * rows_kv + B * H * Lq)
    return 4.0 * D * H * pairs, nbytes


def attention_bound(q, k, v, valid_len, prefix_len, causal=True):
    """``attention_work`` at the peak rate of q's type."""
    return bound(*attention_work(q, k, v, valid_len, prefix_len, causal),
                 q.dtype)


#: dense TF32 tensor-core rate of the H100 SXM (NVIDIA's data sheet)
PEAK_TF32 = 495e12


def attention_bound_mma32(q, k, v, valid_len, prefix_len, causal=True):
    """The float32 "mma32" route's bound: ``attention_work``'s bytes
    against its operations as three TF32 products each (split TF32) at
    ``PEAK_TF32``; ``fma32_bound_ms`` is the float32 FMA figure (67
    TFLOP/s) beside it."""
    flops, nbytes = attention_work(q, k, v, valid_len, prefix_len, causal)
    ops_ms = 3 * flops / PEAK_TF32 * 1e3
    mem_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, mem_ms),
            "bound_by": "operations" if ops_ms >= mem_ms else "bytes",
            "fma32_bound_ms": bound(flops, nbytes,
                                    torch.float32)["bound_ms"]}


#: phase 9's timed float32 forwards (causal): the LLM trainer CLIs' at
#: full lengths (phase 13 runs the CLIs) and phase 9's head_dim 128 case;
#: name, B, heads, L, head_dim, prefix_len, valid_len (None: L)
F32_ATTENTION_SHAPES = (
    ("with_video_lm reply", 32, 8, 214, 64, 0, None),
    ("with_video_lm video", 32, 8, 214, 64, 150, None),
    ("videochat_train SFT", 8, 4, 512, 64, 0, None),
    ("L640 D128", 4, 32, 640, 128, 0, (531, 560, 548, 537)),
)


def time_f32_attention(TA, dev, card, gen):
    """Phase 9's float32 block, at each of ``F32_ATTENTION_SHAPES``:
    ``check_attention`` on the "mma32" route at the timed lengths and with
    ragged ``valid_len``, then "mma32" and "simple" (with lse, as training
    calls them) and SDPA float32 with the boolean mask by CUDA-graph
    replay, the plain version by CUDA events, and the bound
    (``attention_bound_mma32``). Keeps the ``kernels`` entry of the video
    forward (the heaviest CLI call) in ``SEEN["flash_attn_f32"]`` for
    phase 13 to give its launches."""
    from stair_tpu_torch.utils.device import cuda_time_ms

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, B, H, L, D, prefix, valid in F32_ATTENTION_SHAPES:
        q, k, v = (torch.randn(B, L, H, D, generator=gen, device=dev)
                   .transpose(1, 2) for _ in range(3))
        pl = torch.full((B,), prefix, dtype=torch.int32, device=dev)
        vl = torch.tensor(valid or [L] * B, dtype=torch.int32, device=dev)
        ragged = torch.tensor([L - (37 * i) % L for i in range(B)],
                              dtype=torch.int32, device=dev)
        require(TA._route_of(q, k, v) == "mma32",
                f"attention {name} float32: not on \"mma32\"")
        err = lse_err = 0.0
        for lens, what in ((vl, "timed lengths"), (ragged, "ragged")):
            e_out, e_lse, note = check_attention(
                TA, f"{name} {what}", q, k, v, pl, lens, True, 1e-4,
                "mma32")
            err, lse_err = max(err, e_out), max(lse_err, e_lse)
            log(f"[flash_attn] float32 {name} {what} B={B} H={H} L={L} "
                f"D={D} prefix {prefix} route mma32: out max_abs_err "
                f"{e_out:.3e}, lse {e_lse:.3e} (atol 1e-4) ok{note}")
        mask = TA.attention_mask(pl, vl, L, L)[:, None]

        def on(route):
            return lambda: TA._launch(q, k, v, pl, vl, True, D ** -0.5, True,
                                      route=route)

        def library():
            with torch.no_grad():
                sdpa(q, k, v, attn_mask=mask)

        t = {"ms": graph_ms(on("mma32")), "simple_ms": graph_ms(on("simple")),
             "plain_ms": cuda_time_ms(
                 lambda: TA.reference_attention(q, k, v, pl, vl), iters=5),
             "library_ms": graph_ms(library)}
        b = attention_bound_mma32(q, k, v, vl, pl)
        log(f"[flash_attn] float32 {name} B={B} H={H} L={L} D={D} prefix "
            f"{prefix}: \"mma32\" {t['ms']:.4f} ms, \"simple\" "
            f"{t['simple_ms']:.4f} ms (both with lse, CUDA graph replay), "
            f"plain version {t['plain_ms']:.3f} ms, "
            f"scaled_dot_product_attention float32 with the boolean mask "
            f"{t['library_ms']:.4f} ms (yardstick only), bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']} (split-TF32 products "
            f"at 495 TFLOP/s, 3.35 TB/s; at the 67 TFLOP/s float32 FMA rate "
            f"{b['fma32_bound_ms']:.4f} ms); max_abs_err {err:.3e}; "
            f"card {card}")
        if name == "with_video_lm video":
            SEEN["flash_attn_f32"] = {
                "name": "flash_attn", "route": "cuda", "dtype": "float32",
                "attention_route": "mma32",
                "source": "stair_tpu_torch/ops/csrc/flash_attn.cu",
                "replaces": "stair_tpu/ops/attention.py:73",
                "shape": f"B {B} H {H} L {L} D {D} prefix {prefix} "
                         "(with_video_lm video forward)",
                "max_abs_err": err, "lse_err": lse_err, **t, **b}
        del q, k, v, mask
        torch.cuda.empty_cache()


def f32_route_checks(TA, name, q, k, v, pl, vl, causal, out, lse, route):
    """A float32 case's route against ``flash_fwd_simple`` (out and lse
    within 1e-4, the same +inf pattern) and against itself on a second
    launch (equal bits); returns the largest difference from the simple
    kernel."""
    scale = q.shape[-1] ** -0.5
    again = TA._launch(q, k, v, pl, vl, causal, scale, True, route=route)
    simple = TA._launch(q, k, v, pl, vl, causal, scale, True,
                        route="simple")
    torch.cuda.synchronize()
    require(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
            f"attention {name} float32 {route}: bits differ between two "
            "launches")
    fin = torch.isfinite(simple[1])
    require(torch.equal(torch.isfinite(lse), fin),
            f"attention {name} float32 {route}: lse +inf pattern differs "
            "from flash_fwd_simple's")
    e = max(float((out - simple[0]).abs().max()),
            float((lse[fin] - simple[1][fin]).abs().max()) if bool(
                fin.any()) else 0.0)
    require(e <= 1e-4, f"attention {name} float32 {route}: {e} from "
            "flash_fwd_simple")
    return e


def check_attention(TA, name, q, k, v, pl, vl, causal, atol, route):
    """One case through ``flash_attention``: one launch, on ``route``; out
    within ``atol`` and lse within 1e-4 of the plain version (all rows:
    below valid_len the function, at and past it the port's rule, 0 and
    +inf, that kernel and plain version share), the same +inf pattern,
    padding rows exactly 0; a float32 case also against flash_fwd_simple
    and itself (``f32_route_checks``). Returns (out error, lse error, a
    note for the log)."""
    TA.reset_route_launches()
    out, lse = TA.flash_attention(q, k, v, pl, vl, causal=causal,
                                  return_lse=True)
    torch.cuda.synchronize()
    require(TA.ROUTE_LAUNCHES[route] == 1
            and sum(TA.ROUTE_LAUNCHES.values()) == 1,
            f"attention {name} {q.dtype}: {TA.ROUTE_LAUNCHES} for route "
            f"{route}")
    ref, ref_lse = TA.reference_attention(q, k, v, pl, vl, causal)
    e_out = float((out.float() - ref.float()).abs().max())
    fin = torch.isfinite(ref_lse)
    require(torch.equal(torch.isfinite(lse), fin),
            f"attention {name} {q.dtype}: lse +inf pattern differs")
    e_lse = float((lse[fin] - ref_lse[fin]).abs().max()) if bool(
        fin.any()) else 0.0
    require(e_out <= atol and e_lse <= 1e-4,
            f"attention {name} {q.dtype}: out {e_out} lse {e_lse}")
    Lq = q.shape[2]
    for b, n in enumerate(vl.tolist()):
        require(n >= Lq or float(out[b, :, n:].abs().max()) == 0.0,
                f"attention {name}: padding rows not zero")
    note = ""
    if q.dtype == torch.float32:
        e_simple = f32_route_checks(TA, name, q, k, v, pl, vl, causal, out,
                                    lse, route)
        note = (f"; {e_simple:.3e} from flash_fwd_simple (bound 1e-4), "
                "same bits twice")
    return e_out, e_lse, note


def phase_attention(dev, card):
    from stair_tpu_torch.ops import attention as TA
    from stair_tpu_torch.utils.device import cuda_time_ms

    gen = torch.Generator(device=dev).manual_seed(9)
    L = 640
    # layout: 0 [B, heads, L, D]; 1 [B, L, heads, D] memory (the decoder's);
    # 2 one element past a 16-byte boundary; 3 rows of D + 1 elements (2
    # and 3 are unaligned: no tensor-core route takes them)
    # name, B, H, Hkv, Lq, Lkv, D, prefix_len, valid_len, causal, layout
    cases = [
        ("L640", 4, 32, 32, L, L, 128, [0] * 4, [L, 500, 0, 611], True, 0),
        ("ragged L611", 4, 32, 32, 611, 611, 128, [0] * 4, [611, 300, 1, 64],
         True, 1),
        ("GQA 32/8", 4, 32, 8, L, L, 128, [0, 100, 0, 0], [L, 333, 17, L],
         True, 1),
        ("D64 mixed prefix", 4, 12, 12, 128, 128, 64, [64, 10, 0, 128],
         [128, 100, 70, 128], True, 0),
        ("prefix > valid", 2, 12, 12, 200, 200, 64, [150, 300], [100, 200],
         True, 0),
        ("non-causal Lq != Lkv", 2, 4, 4, 100, 333, 64, [0, 0], [333, 90],
         False, 0),
        ("D40 (scalar kernel)", 2, 3, 3, 77, 91, 40, [5, 0], [91, 60], True,
         0),
        ("valid at query-tile edges", 4, 8, 8, 300, 300, 128,
         [0, 0, 5, 0], [1, 127, 128, 129], True, 1),
        ("unaligned (offset 1 element)", 2, 4, 4, 100, 100, 64, [0, 10],
         [100, 77], True, 2),
        ("row stride D + 1", 2, 4, 4, 100, 100, 64, [0, 10], [100, 77], True,
         3),
    ]
    tensor_route = {torch.float32: "mma32", torch.bfloat16: "mma"}
    for name, B, H, Hkv, Lq, Lkv, D, prefix, valid, causal, layout in cases:
        for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            def draw(heads, n):
                if layout == 1:
                    return torch.randn(B, n, heads, D, generator=gen,
                                       device=dev).to(dtype).transpose(1, 2)
                if layout == 2:
                    flat = torch.randn(B * heads * n * D + 1, generator=gen,
                                       device=dev).to(dtype)
                    return flat[1:].view(B, heads, n, D)
                x = torch.randn(B, heads, n, D + (layout == 3),
                                generator=gen, device=dev).to(dtype)
                return x[..., :D]

            q, k, v = draw(H, Lq), draw(Hkv, Lkv), draw(Hkv, Lkv)
            pl = torch.tensor(prefix, dtype=torch.int32, device=dev)
            vl = torch.tensor(valid, dtype=torch.int32, device=dev)
            route = TA._route_of(q, k, v)
            require(route == ("simple" if layout >= 2 or D == 40
                              else tensor_route[dtype]),
                    f"attention {name} {dtype}: route {route}")
            e_out, e_lse, extra = check_attention(
                TA, name, q, k, v, pl, vl, causal, atol, route)
            if layout >= 2 and D in (64, 128):
                try:
                    TA._launch(q, k, v, pl, vl, causal, D ** -0.5, True,
                               route=tensor_route[dtype])
                except ValueError:
                    extra += f"; a forced {tensor_route[dtype]!r} raised"
                else:
                    raise AssertionError(
                        f"attention {name} {dtype}: a forced "
                        f"{tensor_route[dtype]!r} launch ran on unaligned "
                        "rows")
            log(f"[flash_attn] {name} B={B} H={H}/{Hkv} L={Lq}/{Lkv} D={D} "
                f"{dtype} route {route}: out max_abs_err {e_out:.3e} (atol "
                f"{atol}), lse {e_lse:.3e} (atol 1e-4) ok{extra}")

    time_f32_attention(TA, dev, card, gen)

    # ---- time at B 4, H 32, D 128, L 640, bf16 -----------------------------
    q, k, v = (torch.randn(4, L, 32, 128, generator=gen, device=dev)
               .to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    pl = torch.zeros(4, dtype=torch.int32, device=dev)
    vl = torch.tensor([531, 560, 548, 537], dtype=torch.int32, device=dev)
    mask = TA.attention_mask(pl, vl, L, L)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = graph_ms(lambda: TA.flash_attention(q, k, v, pl, vl))
    plain = cuda_time_ms(lambda: TA.reference_attention(q, k, v, pl, vl),
                         iters=5)
    lib = graph_ms(lambda: sdpa(q, k, v, attn_mask=mask))
    b = attention_bound(q, k, v, vl, pl)
    log(f"[flash_attn] B=4 H=32 L={L} D=128 bf16, valid 531-560: kernel "
        f"{ms:.4f} ms (CUDA graph replay), plain version {plain:.3f} ms, "
        f"scaled_dot_product_attention with the boolean mask {lib:.4f} ms "
        f"(yardstick only), bound {b['bound_ms']:.4f} ms by {b['bound_by']}; "
        f"card {card}")


def phase_videochat(dev, card):
    from stair_tpu_torch.llm import videochat_infer as VI
    from stair_tpu_torch.llm.decoder import DecoderConfig, _norm
    from stair_tpu_torch.llm.video_prefix import (
        VideoPrefixConfig, VideoPrefixLM,
    )
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import attention as TA
    from stair_tpu_torch.testing import videochat as VW
    from stair_tpu_torch.utils.device import cuda_time_ms

    bf16 = torch.bfloat16
    tokenizer = VW.tokenizer()
    frame_sets = VW.frame_sets()

    # ---- full width: Llama-7B + ViT-L/14 -----------------------------------
    t0 = time.perf_counter()
    model = VW.build_model(dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    log(f"[videochat] Llama-7B + CLIP ViT-L/14, {n_par / 1e9:.3f}e9 "
        f"parameters in bf16 made on the card in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    # Warm-up (cuBLAS handles, allocator) outside the counted run.
    VI.video_chatgpt_infer_batch(
        model, tokenizer, VW.QUESTIONS, [f[:2] for f in frame_sets],
        max_new_tokens=2, temperature=0.0)
    torch.cuda.synchronize()

    # ---- the counted main-path run -----------------------------------------
    _build.reset_launches()
    t0 = time.perf_counter()
    video_tokens = VI.encode_video_batch(model, frame_sets)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    answers = VI.video_chatgpt_infer_batch(
        model, tokenizer, VW.QUESTIONS, frame_sets,
        max_new_tokens=VW.NEW_TOKENS, temperature=0.0,
        video_tokens=video_tokens)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(_build.LAUNCHES)
    n_layers = model.config.decoder.num_layers
    require(launches["flash_attn"] == n_layers,
            f"flash_attn launches {launches['flash_attn']} != {n_layers} "
            "for one prefill")
    require(len(answers) == VW.BATCH
            and all(isinstance(a, str) for a in answers), "answers")
    require(video_tokens.shape == (VW.BATCH, 356, 1024)
            and bool(torch.isfinite(video_tokens.float()).all()),
            "video tokens")

    # the same prompt batch again, piece by piece, for the times and checks
    ids, start, plen, _ = VI.build_prompt_batch(
        model, tokenizer, VW.QUESTIONS, max_new_tokens=VW.NEW_TOKENS)
    Lmax = ids.shape[1]
    zeros = torch.zeros(VW.BATCH, dtype=torch.int32, device=dev)
    with torch.no_grad():
        embeds = model.splice_embeds(ids, video_tokens, start)
        hidden, _ = model.decoder.prefill(embeds, zeros, plen)
        last = hidden[torch.arange(VW.BATCH, device=dev), plen.long() - 1]
        logits = model.decoder.logits_from_hidden(last).float()
    require(logits.shape == (VW.BATCH, 32000)
            and bool(torch.isfinite(logits).all()), "non-finite logits")
    prefill_ms = cuda_time_ms(
        lambda: model.decoder.prefill(embeds, zeros, plen), iters=3, warmup=1)
    gen_ms = (t2 - t1) * 1e3
    tok_ms = (gen_ms - prefill_ms) / VW.NEW_TOKENS
    log(f"[videochat] batch {VW.BATCH} x {VW.FRAMES} frames, prompt_len "
        f"{plen.tolist()}, L {Lmax}, {VW.NEW_TOKENS} new tokens, greedy: "
        f"CLIP + pooling {(t1 - t0) * 1e3:.1f} ms (host clock, with the "
        f"resize of {VW.BATCH * VW.FRAMES} frames), prefill {prefill_ms:.1f} "
        f"ms (CUDA events), generation {gen_ms:.1f} ms (host clock, "
        f"synchronized) = {tok_ms:.2f} ms per decoded token, "
        f"{VW.BATCH * VW.NEW_TOKENS / (gen_ms / 1e3):.1f} tokens/s; launches "
        f"{launches['flash_attn']} flash_attn; answers "
        f"{[a[:24] for a in answers]}; card {card}")

    # ---- the kernel on the main path's own q, k, v (layer 0) ---------------
    with torch.no_grad():
        p = model.decoder.param_tree()
        layer = p["layers"][0]
        pos = torch.arange(Lmax, device=dev)[None, :].expand(VW.BATCH, Lmax)
        q, k, v = model.decoder._project_qkv(
            layer, _norm(layer["ln1"], embeds, "rms",
                         model.config.decoder.rms_eps),
            model.decoder._rope_of(pos))
    out, lse = TA.flash_attention(q, k, v, zeros, plen, return_lse=True)
    ref, ref_lse = TA.reference_attention(q, k, v, zeros, plen)
    err = float((out.float() - ref.float()).abs().max())
    fin = torch.isfinite(ref_lse)
    # The model's own v reaches |v| ~ 6, where one bf16 step is 3.1e-2: the
    # bound is atol 2e-2 plus rtol 1e-2 (about two and a half steps).
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2,
                               atol=2e-2)
    require(torch.equal(torch.isfinite(lse), fin)
            and float((lse[fin] - ref_lse[fin]).abs().max()) <= 1e-4,
            "flash_attn main-path lse")
    mask = TA.attention_mask(zeros, plen, Lmax, Lmax)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t = {
        "ms": graph_ms(lambda: TA.flash_attention(q, k, v, zeros, plen)),
        "plain_ms": cuda_time_ms(
            lambda: TA.reference_attention(q, k, v, zeros, plen), iters=5),
        "library_ms": graph_ms(lambda: sdpa(q, k, v, attn_mask=mask)),
    }
    entry = {"name": "flash_attn", "route": "cuda", "dtype": "bfloat16",
             "attention_route": "mma",
             "source": "stair_tpu_torch/ops/csrc/flash_attn.cu",
             "replaces": "stair_tpu/ops/attention.py:73",
             "launches": launches["flash_attn"], "max_abs_err": err, **t,
             **attention_bound(q, k, v, plen, zeros)}
    log(f"[main-path inputs] flash_attn B={VW.BATCH} H=32 L={Lmax} D=128 "
        f"bf16: max_abs_err {err:.3e} (rtol 1e-2, atol 2e-2); {t['ms']:.4f} "
        f"ms, plain {t['plain_ms']:.3f} ms, scaled_dot_product_attention "
        f"{t['library_ms']:.4f} ms (kernel and SDPA by CUDA graph replay), "
        f"bound {entry['bound_ms']:.4f} ms by "
        f"{entry['bound_by']}; card {card}")
    del p, layer, embeds, hidden, q, k, v, out, ref, mask
    torch.cuda.empty_cache()

    # ---- 2 decoder + 2 tower layers: kernel route vs plain route -----------
    # After the final RMSNorm the hidden states have unit RMS (|x| up to
    # ~5, where one bf16 step is 3.1e-2; 3.9e-3 at |x| ~ 1), and the two
    # routes round the attention output at different sites: bounds of about
    # five steps of the largest values (max abs 1.5e-1) and two and a half
    # steps of a typical one (mean abs 1e-2). A masking or indexing fault
    # moves whole rows by O(1).
    small = VW.build_model(dev, 2, 2, seed=1)
    vt = VI.encode_video_batch(small, frame_sets)
    ids, start, plen, _ = VI.build_prompt_batch(
        small, tokenizer, VW.QUESTIONS, max_new_tokens=VW.NEW_TOKENS)

    def prefill():
        with torch.no_grad():
            h, _ = small.decoder.prefill(
                small.splice_embeds(ids, vt, start), zeros, plen)
            last = h[torch.arange(VW.BATCH, device=dev), plen.long() - 1]
            return h.float(), small.decoder.logits_from_hidden(last).argmax(-1)

    with kernel_route(("flash_attn",)):
        hk, tk = prefill()
    with plain_route():
        hp, tp = prefill()
    rows = (torch.arange(ids.shape[1], device=dev)[None, :]
            < plen[:, None])[..., None]
    diff = ((hk - hp).abs() * rows)
    e_max = float(diff.max())
    e_mean = float(diff.sum() / (rows.sum() * hk.shape[-1]))
    same = int((tk == tp).sum())
    require(e_max <= 1.5e-1 and e_mean <= 1e-2,
            f"videochat kernel vs plain hidden states: max {e_max} mean "
            f"{e_mean}")
    require(same >= VW.BATCH - 1,
            f"first greedy token equal on {same} of {VW.BATCH}")
    log(f"[videochat] 2 decoder + 2 tower layers, kernel vs plain route: "
        f"prefill hidden states below prompt_len max_abs_err {e_max:.3e} "
        f"(bound 1.5e-1), mean {e_mean:.3e} (bound 1e-2); first greedy token "
        f"equal on {same} of {VW.BATCH} (bound {VW.BATCH - 1})")
    del small, vt, hk, hp
    torch.cuda.empty_cache()

    # ---- VideoPrefixLM at GPT-2 widths, prefix mask (prefix_len > 0) -------
    # float32: summation order only. bf16: twelve layers of roundings at
    # different sites on unit-variance states whose largest values sit where
    # one bf16 step is 3.1e-2: six steps.
    F, Lt, B = 64, 64, 8
    for dtype, tol in ((torch.float32, 1e-4), (bf16, 2e-1)):
        lm = VideoPrefixLM(
            VideoPrefixConfig(video_size=1024, decoder=DecoderConfig.gpt2(),
                              max_video_length=F, max_text_length=Lt),
            generator=torch.Generator(device=dev).manual_seed(2), device=dev,
            dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(3)
        batch = {
            "video": torch.randn(B, F, 1024, generator=gen, device=dev)
            .to(dtype),
            "video_len": torch.randint(1, F + 1, (B,), generator=gen,
                                       device=dev).int(),
            "token_ids": torch.randint(0, 50257, (B, Lt), generator=gen,
                                       device=dev),
            "text_len": torch.randint(1, Lt + 1, (B,), generator=gen,
                                      device=dev).int(),
        }
        with torch.no_grad():
            with kernel_route(("flash_attn",)):
                _, hk = lm.forward(batch, video_visible=True)
                n_launch = _build.LAUNCHES["flash_attn"]
            with plain_route():
                _, hp = lm.forward(batch, video_visible=True)
        require(n_launch == 12, f"VideoPrefixLM launches {n_launch} != 12")
        total = (batch["video_len"] + batch["text_len"])[:, None]
        rows = (torch.arange(F + Lt, device=dev)[None, :] < total)[..., None]
        e = float(((hk.float() - hp.float()).abs() * rows).max())
        require(e <= tol, f"VideoPrefixLM {dtype} kernel vs plain: {e}")
        log(f"[video_prefix] GPT-2 widths (d 768, 12 heads, 12 layers), "
            f"F={F} + {Lt} text tokens, video visible (prefix_len = "
            f"video_len), {dtype}: hidden states max_abs_err {e:.3e} "
            f"(bound {tol}), 12 flash_attn launches ok")
        del lm
    torch.cuda.empty_cache()
    return [entry], model


def attention_bwd_work(q, k, v, valid_len, prefix_len, causal=True):
    """The two backward kernels on these inputs, as (operations, bytes)
    each. dQ: three products per live (row, column) pair and head (``Q
    K^T``, ``dO V^T``, ``dS K``), 6 D operations; q, O, dO, k, v rows below
    ``valid_len`` and lse read, dQ and di written. dK/dV: four products
    (the first two again, ``P^T dO``, ``dS^T Q``), 8 D operations; q, dO,
    k, v rows below ``valid_len``, lse and di read, dK and dV written."""
    from stair_tpu_torch.ops.attention import attention_mask

    B, H, Lq, D = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    pairs = float(attention_mask(prefix_len, valid_len, Lq, Lkv,
                                 causal).sum())
    rows_q = float(valid_len.clamp(max=Lq).sum())
    rows_kv = float(valid_len.clamp(max=Lkv).sum())
    es = q.element_size()
    reads = es * D * (2 * H * rows_q + 2 * Hkv * rows_kv) + 4 * B * H * Lq
    stat = 4 * B * H * Lq                       # di, written then read
    return ((6.0 * D * H * pairs,
             reads + es * D * H * rows_q + es * D * B * H * Lq + stat),
            (8.0 * D * H * pairs,
             reads + stat + 2 * es * D * B * Hkv * Lkv))


def attention_bwd_bounds(q, k, v, valid_len, prefix_len, causal=True):
    """``attention_bwd_work`` of the dQ and the dK/dV kernel at the peak
    rate of q's type."""
    return tuple(bound(*w, q.dtype) for w in attention_bwd_work(
        q, k, v, valid_len, prefix_len, causal))


def attention_bwd_bounds_mma32(q, k, v, valid_len, prefix_len, causal=True):
    """The float32 "mma32" backward's bounds, dQ and dK/dV: each kernel's
    bytes against its operations as three TF32 products each at
    ``PEAK_TF32`` (as ``attention_bound_mma32``); ``fma32_bound_ms`` is
    the float32 FMA figure (67 TFLOP/s) beside it."""
    out = []
    for flops, nbytes in attention_bwd_work(q, k, v, valid_len, prefix_len,
                                            causal):
        ops_ms = 3 * flops / PEAK_TF32 * 1e3
        mem_ms = nbytes / PEAK_BYTES * 1e3
        out.append({"bound_ms": max(ops_ms, mem_ms),
                    "bound_by": "operations" if ops_ms >= mem_ms
                    else "bytes",
                    "fma32_bound_ms": bound(flops, nbytes,
                                            torch.float32)["bound_ms"]})
    return tuple(out)


def check_di(TA, q, k, v, out, lse, dout, pl, vl, causal, scale, valid):
    """``di`` as the dQ launch writes it against ``reference_di``: within
    1e-5 of each live row's ``sum |f32(O) f32(dO)|`` (float32 sums in
    another order), exactly 0 on padding rows. Returns the largest
    relative error."""
    args, _, keep = TA._backward_args(q, k, v, out, lse, dout, pl, vl,
                                      causal, scale)
    TA._launch_dq(args, q.device)
    want = TA.reference_di(out, dout, vl)
    scale_ = TA.reference_di(out.float().abs(), dout.float().abs(), vl)
    got = keep["di"]
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), "di not finite")
    rel = float(((got - want).abs() / scale_.clamp(min=1e-30)).max())
    require(rel <= 1e-5, f"di of the dQ launch: {rel} of its row's scale")
    for b, n in enumerate(valid):
        require(float(got[b, :, n:].abs().sum()) == 0.0,
                "di not 0 on padding rows")
    return rel


def backward_launches(TA, q, k, v, out, lse, dout, pl, vl, causal, scale,
                      route):
    """CUDA launches (kernels, copies, fills) of one ``_launch_backward``
    call, from ``torch.profiler``'s device events; fails unless they are
    exactly the dQ and the dK/dV kernels of ``route``."""
    names = device_kernels(lambda: TA._launch_backward(
        q, k, v, out, lse, dout, pl, vl, causal, scale), ordered=True)
    require(len(names) == 2
            and all(on_route(n, kernel, route) for n, kernel in
                    zip(names, ("flash_bwd_dq", "flash_bwd_dkv"))),
            f"one attention backward on {route!r} launched {names}")
    return len(names)


def device_kernels(fn, ordered=False):
    """Names of the device kernels one call of ``fn`` launches
    (``torch.profiler``'s device events): in launch order, or the set of
    them sorted. Every ``fn`` given launches at least one kernel, so a
    session that records no device event at all lost the card's trace (an
    H100's profiler did, now and then, after CUDA graph replays, while
    Kineto still tore CUPTI down between sessions; ``main`` now keeps it
    set up): it is logged and run again, up to three sessions."""
    from torch.profiler import ProfilerActivity, profile

    for session in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if events:
            break
        log(f"[profiler] session {session + 1} of 3 recorded no device "
            "event; run again")
    names = [e.name for e in events]
    return names if ordered else sorted(set(names))


def on_route(name, kernel, route):
    """``name`` (a device kernel's) is ``kernel``'s variant of ``route``:
    ``flash_bwd_dq_mma32``, ``flash_bwd_dq_mma`` (not ``..._mma32``) or
    ``flash_bwd_dq_simple``."""
    return f"{kernel}_{route}" in name and (
        route != "mma" or f"{kernel}_mma32" not in name)


def check_backward(TA, name, q, k, v, dout, pl, vl, causal, tol, route):
    """One backward case on the route ``route`` picks (``_launch_backward``'s
    default, checked by the backward's route tally): dQ, dK, dV within
    ``tol`` of the plain version (``max|a-b| / max|b|``), identical bits
    on a second launch, finite, in ``[B, L, heads, D]`` memory, padding rows
    exactly 0; ``di`` of the dQ launch against ``reference_di``; exactly two
    CUDA launches, the route's two kernels; a float32 case on ``"mma32"``
    also against the forced ``"simple"`` backward (2e-4). Returns
    (relative errors of dq, dk, dv, their absolute errors, di error,
    launches, error against ``"simple"`` or None)."""
    from stair_tpu_torch.ops import _build

    scale = q.shape[-1] ** -0.5
    Lq, Lkv = q.shape[2], k.shape[2]
    valid = vl.tolist()
    out, lse = TA.flash_attention(q, k, v, pl, vl, causal=causal,
                                  return_lse=True)
    TA.reset_route_launches()
    with kernel_route(("flash_attn_bwd_dq", "flash_attn_bwd_dkv")):
        got = TA._launch_backward(q, k, v, out, lse, dout, pl, vl, causal,
                                  scale)
    require(TA.BWD_ROUTE_LAUNCHES[route] == 2
            and sum(TA.BWD_ROUTE_LAUNCHES.values()) == 2,
            f"attention backward {name} {q.dtype}: "
            f"{TA.BWD_ROUTE_LAUNCHES} for route {route}")
    again = TA._launch_backward(q, k, v, out, lse, dout, pl, vl, causal,
                                scale)
    torch.cuda.synchronize()
    _build.reset_launches()
    want = TA.flash_backward_reference(q, k, v, out, lse, dout, pl, vl,
                                       causal, scale)
    require(not any(_build.LAUNCHES.values()),
            "the plain backward launched a kernel")
    di_err = check_di(TA, q, k, v, out, lse, dout, pl, vl, causal, scale,
                      valid)
    n_launch = backward_launches(TA, q, k, v, out, lse, dout, pl, vl, causal,
                                 scale, route)

    def rel(a, b):
        return (float((a.float() - b.float()).abs().max())
                / max(float(b.float().abs().max()), 1e-30))

    errs, abs_errs = [], []
    for g, g2, w, n_rows in zip(got, again, want, (Lq, Lkv, Lkv)):
        require(torch.equal(g, g2),
                f"attention backward {name} {q.dtype}: bits differ "
                "between two launches")
        require(bool(torch.isfinite(g.float()).all()),
                f"attention backward {name} {q.dtype}: not finite")
        require(g.transpose(1, 2).is_contiguous(),
                "gradient not in [B, L, heads, D] memory")
        for b, n in enumerate(valid):
            require(n >= n_rows
                    or float(g[b, :, n:].float().abs().max()) == 0.0,
                    f"attention backward {name}: padding rows not 0")
        errs.append(rel(g, w))
        abs_errs.append(float((g.float() - w.float()).abs().max()))
    require(max(errs) <= tol,
            f"attention backward {name} {q.dtype}: dq/dk/dv {errs}")
    e_simple = None
    if route == "mma32":
        simple = TA._launch_backward(q, k, v, out, lse, dout, pl, vl,
                                     causal, scale, route="simple")
        e_simple = max(rel(g, w) for g, w in zip(got, simple))
        require(e_simple <= 2e-4, f"attention backward {name}: \"mma32\" "
                f"{e_simple} from the forced \"simple\" backward")
    return errs, abs_errs, di_err, n_launch, e_simple


def backward_note(errs, abs_errs, di_err, n_launch, e_simple, tol):
    """The log's account of ``check_backward``'s checks."""
    note = (f"max|a-b|/max|b| dq {errs[0]:.3e} dk {errs[1]:.3e} dv "
            f"{errs[2]:.3e} (bound {tol}; max|a-b| {max(abs_errs):.3e}), "
            "same bits twice, padding rows 0 "
            f"ok; di from the dQ launch {di_err:.3e} of its row's sum "
            f"|O dO| (bound 1e-5), 0 on padding rows; {n_launch} CUDA "
            "launches in one backward")
    if e_simple is not None:
        note += (f"; {e_simple:.3e} from the forced \"simple\" backward "
                 "(bound 2e-4)")
    return note


def time_f32_attention_bwd(TA, dev, card, gen):
    """Phase 11's float32 block, at each of ``F32_ATTENTION_SHAPES``:
    ``check_backward`` on the "mma32" route at the timed lengths and with
    ragged ``valid_len``, then by CUDA-graph replay the dQ launch, the
    dK/dV launch and the whole backward on "mma32", the whole backward on
    "simple", and SDPA float32's autograd backward with the boolean mask
    (forward + backward less forward, a yardstick only; its kernels named
    by ``torch.profiler``), the plain version by CUDA events, and both
    bounds (``attention_bwd_bounds_mma32``). Keeps the ``kernels`` entries
    of the video backward (the heaviest CLI call) in
    ``SEEN["flash_attn_bwd_f32"]`` for phase 13 to give their launches."""
    from stair_tpu_torch.utils.device import cuda_time_ms

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, B, H, L, D, prefix, valid in F32_ATTENTION_SHAPES:
        q, k, v, dout = (torch.randn(B, L, H, D, generator=gen, device=dev)
                         .transpose(1, 2) for _ in range(4))
        pl = torch.full((B,), prefix, dtype=torch.int32, device=dev)
        vl = torch.tensor(valid or [L] * B, dtype=torch.int32, device=dev)
        ragged = torch.tensor([L - (37 * i) % L for i in range(B)],
                              dtype=torch.int32, device=dev)
        scale = D ** -0.5
        errs, abs_errs = [0.0] * 3, [0.0] * 3
        for lens, what in ((vl, "timed lengths"), (ragged, "ragged")):
            require(TA._route_of(q, k, v, dout) == "mma32",
                    f"attention backward {name} float32: not on \"mma32\"")
            checked = check_backward(TA, f"{name} {what}", q, k, v, dout, pl,
                                     lens, True, 2e-4, "mma32")
            errs = [max(a, b) for a, b in zip(errs, checked[0])]
            abs_errs = [max(a, b) for a, b in zip(abs_errs, checked[1])]
            log(f"[flash_attn_bwd] float32 {name} {what} B={B} H={H} L={L} "
                f"D={D} prefix {prefix} route mma32: "
                + backward_note(*checked, 2e-4))
        out, lse = TA._launch(q, k, v, pl, vl, True, scale, True)
        mask = TA.attention_mask(pl, vl, L, L)[:, None]

        def whole(route):
            return lambda: TA._launch_backward(q, k, v, out, lse, dout, pl,
                                               vl, True, scale, route=route)

        def library_forward():
            with torch.no_grad():
                sdpa(q, k, v, attn_mask=mask)

        def library():
            a, b, c = (x.detach().requires_grad_() for x in (q, k, v))
            sdpa(a, b, c, attn_mask=mask).backward(dout)

        # the dK/dV launch reads the di that the dQ launch wrote: one dQ
        # launch first
        args, _, keep = TA._backward_args(q, k, v, out, lse, dout, pl, vl,
                                          True, scale)
        TA._launch_dq(args, dev)
        t = {"dq": graph_ms(lambda: TA._launch_dq(args, dev)),
             "dkv": graph_ms(lambda: TA._launch_dkv(args, dev)),
             "whole": graph_ms(whole("mma32")),
             "simple": graph_ms(whole("simple")),
             "plain": cuda_time_ms(
                 lambda: TA.flash_backward_reference(
                     q, k, v, out, lse, dout, pl, vl, True, scale),
                 iters=3, warmup=1)}
        lib = max(graph_ms(library) - graph_ms(library_forward), 0.0)
        fwd_kernels = device_kernels(library_forward)
        lib_kernels = [n.split("(")[0] for n in device_kernels(library)
                       if n not in fwd_kernels]
        b_dq, b_dkv = attention_bwd_bounds_mma32(q, k, v, vl, pl)
        log(f"[flash_attn_bwd] float32 {name} B={B} H={H} L={L} D={D} "
            f"prefix {prefix}: \"mma32\" dQ {t['dq']:.4f} ms (bound "
            f"{b_dq['bound_ms']:.4f} by {b_dq['bound_by']}; at 67 TFLOP/s "
            f"{b_dq['fma32_bound_ms']:.4f}), dK/dV {t['dkv']:.4f} ms (bound "
            f"{b_dkv['bound_ms']:.4f} by {b_dkv['bound_by']}; at 67 TFLOP/s "
            f"{b_dkv['fma32_bound_ms']:.4f}), whole backward {t['whole']:.4f}"
            f" ms; \"simple\" whole {t['simple']:.4f} ms (all by CUDA "
            f"graph replay); plain version {t['plain']:.3f} ms; "
            f"scaled_dot_product_attention float32 backward through "
            f"autograd with the boolean mask {lib:.4f} ms for dQ, dK and dV "
            f"together (yardstick only; its backward's kernels "
            f"{lib_kernels}); bounds at split-TF32 products (495 TFLOP/s, "
            f"3.35 TB/s); max|a-b|/max|b| dq {errs[0]:.3e} dk {errs[1]:.3e} "
            f"dv {errs[2]:.3e}; card {card}")
        if name == "with_video_lm video":
            src = "stair_tpu_torch/ops/csrc/flash_attn_bwd.cu"
            common = {"route": "cuda", "dtype": "float32",
                      "attention_route": "mma32", "source": src,
                      "shape": f"B {B} H {H} L {L} D {D} prefix {prefix} "
                               "(with_video_lm video backward)",
                      "whole_ms": t["whole"], "simple_whole_ms": t["simple"],
                      "plain_ms": t["plain"], "library_ms": lib}
            SEEN["flash_attn_bwd_f32"] = [
                {"name": "flash_attn_bwd_dq",
                 "replaces": "stair_tpu/ops/attention.py:238",
                 "max_abs_err": abs_errs[0], "max_rel_err": errs[0],
                 "ms": t["dq"], **common, **b_dq},
                {"name": "flash_attn_bwd_dkv",
                 "replaces": "stair_tpu/ops/attention.py:292",
                 "max_abs_err": max(abs_errs[1:]),
                 "max_rel_err": max(errs[1:]), "ms": t["dkv"], **common,
                 **b_dkv},
            ]
        del q, k, v, dout, out, lse, mask, args, keep
        torch.cuda.empty_cache()


def phase_attention_bwd(dev, card):
    from stair_tpu_torch.ops import attention as TA

    gen = torch.Generator(device=dev).manual_seed(11)
    L = 640
    # name, B, H, Hkv, Lq, Lkv, D, prefix_len, valid_len, causal
    cases = [
        ("causal L640", 4, 32, 32, L, L, 128, [0] * 4, [L, 500, 0, 611], True),
        ("ragged L611", 4, 32, 32, 611, 611, 128, [0] * 4, [611, 300, 1, 64],
         True),
        ("GQA 32/8", 4, 32, 8, L, L, 128, [0, 100, 0, 0], [L, 333, 17, L],
         True),
        ("GQA 8/1 D64", 2, 8, 1, 130, 130, 64, [0, 30], [130, 99], True),
        ("D64 mixed prefix", 4, 12, 12, 128, 128, 64, [64, 10, 0, 128],
         [128, 100, 70, 128], True),
        ("prefix > valid", 2, 12, 12, 200, 200, 64, [150, 300], [100, 200],
         True),
        ("non-causal Lq != Lkv", 2, 4, 4, 100, 333, 64, [0, 0], [333, 90],
         False),
        ("causal Lq != Lkv GQA", 2, 4, 2, 100, 160, 64, [20, 0], [160, 90],
         True),
        ("D32 odd lengths", 2, 3, 3, 77, 77, 32, [5, 0], [77, 60], True),
        ("D40 (scalar kernels)", 2, 3, 3, 77, 91, 40, [5, 0], [91, 60], True),
    ]
    tensor_route = {torch.float32: "mma32", torch.bfloat16: "mma"}
    for name, B, H, Hkv, Lq, Lkv, D, prefix, valid, causal in cases:
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
            def draw(heads, n):       # [B, L, H, D] seen as [B, H, L, D]
                return torch.randn(B, n, heads, D, generator=gen,
                                   device=dev).to(dtype).transpose(1, 2)

            q, k, v = draw(H, Lq), draw(Hkv, Lkv), draw(Hkv, Lkv)
            dout = torch.randn(B, H, Lq, D + 8, generator=gen,
                               device=dev).to(dtype)[..., :D]
            pl = torch.tensor(prefix, dtype=torch.int32, device=dev)
            vl = torch.tensor(valid, dtype=torch.int32, device=dev)
            route = ("simple" if D not in (64, 128) else tensor_route[dtype])
            note = backward_note(*check_backward(
                TA, name, q, k, v, dout, pl, vl, causal, tol, route), tol)
            log(f"[flash_attn_bwd] {name} B={B} H={H}/{Hkv} L={Lq}/{Lkv} "
                f"D={D} {dtype} route {route}: {note}")

    # float32 rows a tensor-core kernel cannot take: q, k, v one element
    # past 16 bytes; dO rows of D + 1 floats. The route is "simple", and a
    # forced "mma32" raises before any launch.
    B, H, Lq, D = 2, 4, 100, 64
    pl = torch.tensor([0, 10], dtype=torch.int32, device=dev)
    vl = torch.tensor([100, 77], dtype=torch.int32, device=dev)
    for name in ("q, k, v offset 1 element", "dO row stride D + 1"):
        def draw(extra=0, offset=0):
            flat = torch.randn(B * H * Lq * (D + extra) + offset,
                               generator=gen, device=dev)
            return flat[offset:].view(B, H, Lq, D + extra)[..., :D]

        off = 1 if name.startswith("q") else 0
        q, k, v = draw(offset=off), draw(offset=off), draw(offset=off)
        dout = draw(extra=1 - off)
        out, lse = TA.flash_attention(q, k, v, pl, vl, return_lse=True)
        require(TA._route_of(q, k, v, out, dout) == "simple",
                f"attention backward {name}: not on \"simple\"")
        try:
            TA._launch_backward(q, k, v, out, lse, dout, pl, vl, True,
                                D ** -0.5, route="mma32")
        except ValueError:
            pass
        else:
            raise AssertionError(f"attention backward {name}: a forced "
                                 "\"mma32\" backward ran on unaligned rows")
        note = backward_note(*check_backward(
            TA, name, q, k, v, dout, pl, vl, True, 2e-4, "simple"), 2e-4)
        log(f"[flash_attn_bwd] {name} B={B} H={H} L={Lq} D={D} float32 "
            f"route simple: a forced \"mma32\" raised; {note}")

    time_f32_attention_bwd(TA, dev, card, gen)


def sft_attention_entries(dev, card, model, batch, launches):
    """Kernels #8 and #9 on the SFT step's own q, k, v (layer 0 of the
    full-width model) and a seeded cotangent: error against the plain
    version, time, bound, and autograd through
    ``scaled_dot_product_attention`` as the yardstick. ``launches`` are the
    counts read after the counted SFT run."""
    from stair_tpu_torch.llm.decoder import _norm
    from stair_tpu_torch.ops import attention as TA
    from stair_tpu_torch.utils.device import cuda_time_ms

    B, L = batch["token_ids"].shape
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    vl = batch["valid_len"]
    with torch.no_grad():
        p = model.decoder.param_tree()
        layer = p["layers"][0]
        embeds = model.splice_embeds(batch["token_ids"],
                                     batch["video_tokens"],
                                     batch["splice_start"])
        pos = torch.arange(L, device=dev)[None, :].expand(B, L)
        q, k, v = model.decoder._project_qkv(
            layer, _norm(layer["ln1"], embeds, "rms",
                         model.config.decoder.rms_eps),
            model.decoder._rope_of(pos))
    D = q.shape[-1]
    scale = D ** -0.5
    gen = torch.Generator(device=dev).manual_seed(12)
    dout = torch.randn(B, L, q.shape[1], D, generator=gen, device=dev).to(
        q.dtype).transpose(1, 2)
    out, lse = TA.flash_attention(q, k, v, zeros, vl, return_lse=True)
    got = TA._launch_backward(q, k, v, out, lse, dout, zeros, vl, True, scale)
    want = TA.flash_backward_reference(q, k, v, out, lse, dout, zeros, vl,
                                       True, scale)
    errs = [float((g.float() - w.float()).abs().max()) for g, w in
            zip(got, want)]
    rel = [e / max(float(w.float().abs().max()), 1e-30)
           for e, w in zip(errs, want)]
    require(max(rel) <= 2e-2, f"attention backward on the SFT step's inputs: "
            f"max|a-b|/max|b| {rel}")
    args, _, keep = TA._backward_args(q, k, v, out, lse, dout, zeros, vl,
                                      True, scale)
    mask = TA.attention_mask(zeros, vl, L, L)[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        a, b, c = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa(a, b, c, attn_mask=mask).backward(dout)

    def library_forward():
        with torch.no_grad():
            sdpa(q, k, v, attn_mask=mask)

    # the dK/dV launch reads the di that the dQ launch wrote: one dQ launch
    # first, then each kernel and the whole backward by graph replay
    TA._launch_dq(args, dev)
    t = {
        "dq": graph_ms(lambda: TA._launch_dq(args, dev)),
        "dkv": graph_ms(lambda: TA._launch_dkv(args, dev)),
        "whole": graph_ms(
            lambda: TA._launch_backward(q, k, v, out, lse, dout, zeros, vl,
                                        True, scale)),
        "plain": cuda_time_ms(
            lambda: TA.flash_backward_reference(q, k, v, out, lse, dout,
                                                zeros, vl, True, scale),
            iters=3, warmup=1),
        "forward": cuda_time_ms(
            lambda: TA.flash_attention(q, k, v, zeros, vl, return_lse=True),
            iters=30, warmup=3),
    }
    lib = max(graph_ms(library) - graph_ms(library_forward), 0.0)
    b_dq, b_dkv = attention_bwd_bounds(q, k, v, vl, zeros)
    log(f"[main-path inputs] flash_attn backward B={B} H={q.shape[1]} L={L} "
        f"D={D} bf16, valid {vl.tolist()}: max_abs_err dq {errs[0]:.3e} dk "
        f"{errs[1]:.3e} dv {errs[2]:.3e} (max|a-b|/max|b| {max(rel):.3e}, "
        f"bound 2e-2); dQ kernel {t['dq']:.4f} ms (bound "
        f"{b_dq['bound_ms']:.4f} ms by {b_dq['bound_by']}), dK/dV kernel "
        f"{t['dkv']:.4f} ms (bound {b_dkv['bound_ms']:.4f} ms by "
        f"{b_dkv['bound_by']}), the whole backward (both launches, di "
        f"included) {t['whole']:.4f} ms, all three by CUDA-graph replay; "
        f"forward with lse {t['forward']:.4f} ms; plain backward "
        f"{t['plain']:.3f} ms; scaled_dot_product_attention backward "
        f"through autograd (boolean mask, forward + backward less forward, "
        f"by CUDA-graph replay) {lib:.4f} ms for dQ, dK and dV together "
        f"(yardstick only); card {card}")
    # the plain version and the library call compute all three gradients at
    # once: their times stand in both rows
    src = "stair_tpu_torch/ops/csrc/flash_attn_bwd.cu"
    return [
        {"name": "flash_attn_bwd_dq", "route": "cuda", "source": src,
         "replaces": "stair_tpu/ops/attention.py:238",
         "launches": launches["flash_attn_bwd_dq"], "max_abs_err": errs[0],
         "ms": t["dq"], "whole_ms": t["whole"], "plain_ms": t["plain"],
         "library_ms": lib, **b_dq},
        {"name": "flash_attn_bwd_dkv", "route": "cuda", "source": src,
         "replaces": "stair_tpu/ops/attention.py:292",
         "launches": launches["flash_attn_bwd_dkv"],
         "max_abs_err": max(errs[1:]), "ms": t["dkv"],
         "whole_ms": t["whole"], "plain_ms": t["plain"], "library_ms": lib,
         **b_dkv},
    ]


def phase_sft(dev, card, model):
    import dataclasses

    from stair_tpu_torch.llm import optim as TO
    from stair_tpu_torch.llm import videochat_train as VT
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.testing import videochat as VW

    n_layers = model.config.decoder.num_layers
    batch = VW.sft_batch(seed=0, batch=SFT_BATCH, length=SFT_LEN, device=dev)
    n_targets = int((batch["labels"][:, 1:] >= 0).sum())

    # ---- full width, projector-only: the decoder is frozen in bf16, the
    # projector is tuned in float32; the backward crosses every layer
    for key, p in model.weights.items():
        p.data = p.data.float()
    step = VT.make_sft_step(model, TO.make_adamw(
        VT.trainable_parameters(model, projector_only=True),
        TO.warmup_cosine_decay_schedule(0.0, SFT_LR, 1, 2 * SFT_STEPS),
        weight_decay=0.0))

    def run(steps):
        """``steps`` steps; returns (losses, ms per step after the first,
        peak GiB, launches)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        losses = [step(batch)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps - 1):
            losses.append(step(batch))
        end.record()
        torch.cuda.synchronize()
        return ([float(x) for x in losses],
                start.elapsed_time(end) / (steps - 1),
                torch.cuda.max_memory_allocated() / 2**30,
                dict(_build.LAUNCHES))

    losses, ms, peak, launches = run(SFT_STEPS)
    require(all(np.isfinite(losses)), f"SFT loss not finite: {losses}")
    # the schedule's first rate is 0: the loss can fall from step 2 on
    require(losses[-1] < losses[1], f"SFT loss does not fall: {losses}")
    for key in ("flash_attn", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        require(launches[key] == n_layers * SFT_STEPS,
                f"{key}: {launches[key]} launches in {SFT_STEPS} steps of "
                f"{n_layers} layers")
    require(all(p.grad is None for p in model.decoder.parameters()),
            "a frozen decoder parameter got a gradient")
    per_step = {k: v // SFT_STEPS for k, v in launches.items() if v}
    log(f"[sft] Llama-7B bf16, projector-only (float32 projector), batch "
        f"{SFT_BATCH} x {SFT_LEN} tokens, valid_len "
        f"{batch['valid_len'].tolist()}, {n_targets} targets, AdamW peak lr "
        f"{SFT_LR}: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{SFT_STEPS} steps on a repeated batch ({[round(x, 4) for x in losses]}); "
        f"{ms:.1f} ms per step (CUDA events), peak memory {peak:.2f} GiB "
        f"without remat; launches per step {per_step}; card {card}")

    model.decoder.config = dataclasses.replace(
        model.decoder.config, remat=True, remat_policy="full")
    r_losses, r_ms, r_peak, r_launches = run(3)
    model.decoder.config = dataclasses.replace(
        model.decoder.config, remat=False)
    require(all(np.isfinite(r_losses)), f"SFT loss with remat: {r_losses}")
    require(r_launches["flash_attn"] == 2 * n_layers * 3
            and r_launches["flash_attn_bwd_dq"] == n_layers * 3
            and r_launches["flash_attn_bwd_dkv"] == n_layers * 3,
            f"launches with remat='full': {r_launches}")
    require(r_peak < peak, "remat='full' did not lower the peak memory")
    log(f"[sft] the same with remat='full': {r_ms:.1f} ms per step, peak "
        f"memory {r_peak:.2f} GiB, {2 * n_layers} flash_attn + {n_layers} + "
        f"{n_layers} backward launches per step (each layer's forward runs "
        f"again in the backward); loss {r_losses[0]:.4f} -> {r_losses[-1]:.4f}")

    return sft_attention_entries(dev, card, model, batch, launches)


def phase_sft_routes(dev):
    """2 decoder layers of full width: every gradient leaf of the kernel
    route against the plain route (autograd through the dense attention) in
    float32, and the bf16 loss of both."""
    from stair_tpu_torch.testing import videochat as VW
    from stair_tpu_torch.weights import flatten_tree

    batch = VW.sft_batch(seed=1, batch=4, length=SFT_LEN, device=dev)
    keys = ("flash_attn", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
    for dtype in (torch.float32, torch.bfloat16):
        small = VW.build_model(dev, 2, 2, seed=1, dtype=dtype)

        def loss_and_grads():
            small.zero_grad(set_to_none=True)
            loss = small.sft_loss(batch)
            loss.backward()
            return float(loss.detach()), {
                k: p.grad.clone() for k, p in
                flatten_tree(small.param_tree()).items()
                if p.grad is not None}

        with kernel_route(keys):
            loss_k, grads_k = loss_and_grads()
        with plain_route():
            loss_p, grads_p = loss_and_grads()
        rel_loss = abs(loss_k - loss_p) / abs(loss_p)
        if dtype == torch.bfloat16:
            # both routes round the attention output to bf16, at different
            # sites; the loss is a mean over some 500 targets
            require(rel_loss <= 5e-3, f"bf16 SFT loss kernel {loss_k} vs "
                    f"plain {loss_p}")
            log(f"[sft] 2 layers of full width, bf16: loss kernel route "
                f"{loss_k:.5f} vs plain route {loss_p:.5f}, relative "
                f"{rel_loss:.3e} (bound 5e-3)")
            continue
        require(grads_k.keys() == grads_p.keys() and len(grads_k) >= 22,
                "the routes gave gradients to different leaves")
        worst = ("", 0.0)
        for key, g in grads_p.items():
            err = float((grads_k[key] - g).norm() / g.norm().clamp(min=1e-30))
            if err > worst[1]:
                worst = (key, err)
        # float32 on both routes: only the order of the sums differs
        require(rel_loss <= 1e-5 and worst[1] <= 1e-3,
                f"float32 SFT routes: loss {rel_loss}, worst leaf {worst}")
        log(f"[sft] 2 layers of full width, float32, batch 4 x {SFT_LEN}: "
            f"loss kernel route {loss_k:.6f} vs plain route {loss_p:.6f}; "
            f"{len(grads_k)} gradient leaves, worst ||kernel - plain|| / "
            f"||plain|| {worst[1]:.3e} at {worst[0]} (bound 1e-3)")
        del grads_k, grads_p
        del small
        torch.cuda.empty_cache()


def on_mma32(what, launches):
    """Fail unless every forward and every backward launch of the block just
    ended (``launches`` its ``_build.LAUNCHES``) ran on the float32
    tensor-core route; returns the forward launches."""
    from stair_tpu_torch.ops import attention as TA

    n = launches.get("flash_attn", 0)
    n_bwd = (launches.get("flash_attn_bwd_dq", 0)
             + launches.get("flash_attn_bwd_dkv", 0))
    require(TA.ROUTE_LAUNCHES == {"simple": 0, "mma": 0, "mma32": n},
            f"{what}: forward routes {TA.ROUTE_LAUNCHES}, {n} launches")
    require(TA.BWD_ROUTE_LAUNCHES == {"simple": 0, "mma": 0, "mma32": n_bwd},
            f"{what}: backward routes {TA.BWD_ROUTE_LAUNCHES}, {n_bwd} "
            "launches")
    return n


def phase_trainers(dev):
    """Both trainer CLIs on the card at their defaults, on seeded tiny data
    written to a temporary directory; their float32 forwards and backwards
    on the "mma32" route. Returns phase 9's float32 ``flash_attn`` entry
    and phase 11's float32 ``flash_attn_bwd_dq`` and
    ``flash_attn_bwd_dkv`` entries with the launches of the
    ``with_video_lm`` VideoGPT run."""
    import argparse
    import shutil
    import tempfile

    from stair_tpu_torch.llm import videochat_infer as VI
    from stair_tpu_torch.llm import videochat_train as VT
    from stair_tpu_torch.llm import with_video_lm as WL
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import attention as TA
    from stair_tpu_torch.testing import videochat as VW

    root = tempfile.mkdtemp(prefix="stair_smoke_")
    entry = dict(SEEN["flash_attn_f32"])
    bwd_entries = [dict(e) for e in SEEN["flash_attn_bwd_f32"]]
    try:
        paths = VW.write_tiny_data(root)
        keys = ("flash_attn", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")

        out = f"{root}/sft"
        TA.reset_route_launches()
        with kernel_route(keys):
            loss = VT.main(["--data-path", paths["conv"], "--features-dir",
                            paths["chat_features"], "--output", out,
                            "--num-epochs", "1", "--report-interval", "1"])
            launches = dict(_build.LAUNCHES)
        on_mma32("videochat_train", launches)
        # 16 conversations, batch 8: 2 steps of 4 layers
        require(np.isfinite(loss) and all(launches[k] == 8 for k in keys),
                f"videochat_train: loss {loss}, launches {launches}")
        model, tok = VI.initialize_model(argparse.Namespace(
            model_path=None, vision_path=None, model_ckpt=out, device=None))
        require(model.decoder.embed.is_cuda
                and model.config.decoder.d_model == 256, "reloaded model")
        TA.reset_route_launches()
        with kernel_route(("flash_attn",)) as seen:
            answers = VI.video_chatgpt_infer_batch(
                model, tok, VW.QUESTIONS, VW.frame_sets(frames=8),
                max_new_tokens=8)
        on_mma32("videochat_infer", seen)
        require(len(answers) == 4 and all(isinstance(a, str)
                                          for a in answers), "answers")
        log(f"[trainers] videochat_train.main (defaults: d 256, 4 layers, "
            f"head_dim 64, float32, batch 8 x 512), 1 epoch = 2 steps: loss "
            f"{loss:.4f}, launches {({k: launches[k] for k in keys})}, "
            f"every forward and backward on \"mma32\"; "
            f"videochat_infer --model-ckpt on what it saved answered "
            f"{[a[:16] for a in answers]}")

        common = ["--rgb-path", paths["rgb"], "--train-filename",
                  paths["train"], "--valid-filename", paths["valid"],
                  "--test-filename", paths["test"],
                  "--gpt-filter-result-path", paths["filter"],
                  "--report-interval", "1"]
        for family, extra in (("VideoGPT", []), ("Llama", ["--llm-lora"])):
            out = f"{root}/{family}"
            TA.reset_route_launches()
            with kernel_route(keys):
                best = WL.main([*common, "--lm-model", family, "--output",
                                out, "--num-epochs", "1",
                                "--gpt-video-loss-weight", "1", *extra])
                launches = dict(_build.LAUNCHES)
            n = on_mma32(f"with_video_lm {family}", launches)
            if family == "VideoGPT":
                entry["launches"] = n
                for e in bwd_entries:
                    e["launches"] = launches[e["name"]]
            TA.reset_route_launches()
            with kernel_route(("flash_attn",)) as seen:
                acc = WL.main([*common, "--func", "test", "--model-ckpt",
                               out])
            on_mma32(f"with_video_lm {family} --func test", seen)
            require(0.0 <= best <= 1.0 and acc == best,
                    f"with_video_lm {family}: valid {best} test {acc} (the "
                    "same records)")
            log(f"[trainers] with_video_lm.main --lm-model {family} "
                f"{' '.join(extra)} (defaults: d 512, 4 layers, head_dim 64, "
                f"float32) with the video loss (prefix_len > 0), 1 epoch: "
                f"launches {({k: launches[k] for k in keys})}, every forward "
                f"and backward on \"mma32\"; --func test on what it saved: "
                f"acc {acc:.4f}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return [entry, *bwd_entries]


def slot_files(dev, dtype, gen):
    """The three register files at the training shapes with random values,
    and per file a slot index per example (the scratch slot among them) and
    a value block."""
    B = TRAIN_BATCH
    shapes = {"rv": (B, 25, HIDDEN), "rf": (B, 9, FRAMES, HIDDEN),
              "ra": (B, 11, FRAMES)}
    out = {}
    for name, shape in shapes.items():
        file = torch.randn(shape, generator=gen).to(dev, dtype)
        val = torch.randn(shape[0], *shape[2:], generator=gen).to(dev, dtype)
        idx = torch.randint(0, shape[1], (B,), generator=gen).to(
            dev, torch.int32)
        idx[:4] = shape[1] - 1
        out[name] = (file, idx, val)
    return out


#: the slot calls of one step of the reversible executor, by file
SLOT_CALLS = {"slot_set": ("rv", "rf", "ra", "ra"),
              "slot_zero": ("ra", "ra", "rf", "rv") * 2,
              "slot_add": ("rv", "rv", "rv", "rf", "rf", "ra", "ra")}
#: the same step's four sets and eight reads-and-zeros as ``rev_exec``
#: makes them, one launch each: the zero reads the four output cotangents
#: out of the cotangent files (``d_``) and zeroes them, then the same slots
#: of the register files
STEP_SLOTS = {"set": SLOT_CALLS["slot_set"],
              "zero": ("d_ra", "d_ra", "d_rf", "d_rv", "ra", "ra", "rf",
                       "rv")}


def step_adds(dev, dtype, gen):
    """The three register files at the training shapes, and the seven adds
    of one step of the reversible executor on them (``SLOT_CALLS``'s
    files), each with its own slot index per example: vb == va on half the
    examples, vc == va on a quarter, fb == fa and ab == aa on half, as an
    instruction that reads one register twice makes them."""
    files = {n: f for n, (f, _, _) in slot_files(dev, dtype, gen).items()}
    entries = []
    for n in SLOT_CALLS["slot_add"]:
        f = files[n]
        idx = torch.randint(0, f.shape[1], (f.shape[0],), generator=gen).to(
            dev, torch.int32)
        val = torch.randn(f.shape[0], *f.shape[2:], generator=gen).to(
            dev, dtype)
        entries.append((n, idx, val))
    half = TRAIN_BATCH // 2
    for first, later, rows in ((0, 1, half), (0, 2, half // 2),
                               (3, 4, half), (5, 6, half)):
        entries[later][1][:rows] = entries[first][1][:rows]
    return files, entries


def step_slots(dev, dtype, gen, kind):
    """The register files at the training shapes (for "zero" also their
    cotangent files ``d_rv``, ``d_rf``, ``d_ra``), and one step's
    ``STEP_SLOTS[kind]`` on them in order: ``(name, idx, val)`` for a set,
    ``(name, idx, out)`` for a zero, ``out`` a ``[B, ...]`` read-out on the
    cotangent files and None on the others. The two attn entries name one
    slot on half the examples (out_attn == out_attn_b through the scratch
    slot), and the zeros' last four entries the first four's slots."""
    files = {n: f for n, (f, _, _) in slot_files(dev, dtype, gen).items()}
    if kind == "zero":
        files.update({"d_" + n: torch.randn(f.shape, generator=gen).to(
            dev, dtype) for n, f in list(files.items())})
    names = STEP_SLOTS[kind]
    idx = []
    for n in names[:4]:
        f = files[n]
        i = torch.randint(0, f.shape[1], (f.shape[0],), generator=gen).to(
            dev, torch.int32)
        i[:4] = f.shape[1] - 1
        idx.append(i)
    a, ab = (k for k, n in enumerate(names[:4]) if n.endswith("ra"))
    idx[ab][:TRAIN_BATCH // 2] = idx[a][:TRAIN_BATCH // 2]
    idx += idx[:len(names) - 4]
    extra = [
        torch.randn(TRAIN_BATCH, *files[n].shape[2:], generator=gen).to(
            dev, dtype) if kind == "set"
        else torch.empty((TRAIN_BATCH, *files[n].shape[2:]), dtype=dtype,
                         device=dev) if n.startswith("d_") else None
        for n in names]
    return files, list(zip(names, idx, extra))


def slot_bytes(kind, files, entries):
    """Compulsory bytes of one launch's ``(name, idx, val or out)``
    entries: each value block read once and each read-out written once;
    each slot the entries name written once however many name it, and read
    once for an add or for a zero that reads it out; the indices."""
    nbytes = 0
    for n, f in files.items():
        mine = [(i, v) for m, i, v in entries if m == n]
        if not mine:
            continue

        def unique(idxs):
            if not idxs:
                return 0
            return torch.unique(torch.stack([
                torch.arange(f.shape[0], device=f.device) * f.shape[1]
                + i.long() for i in idxs])).numel()

        touched = unique([i for i, _ in mine])
        read = {"add": touched, "set": 0,
                "zero": unique([i for i, o in mine if o is not None])}[kind]
        per = f[0, 0].numel() * f.element_size()
        nbytes += per * (touched + read) + sum(
            i.numel() * i.element_size()
            + (0 if v is None else v.numel() * v.element_size())
            for i, v in mine)
    return nbytes


def phase_slots(dev, card):
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import regslots as TR
    from stair_tpu_torch.utils.device import cuda_time_ms

    gen = torch.Generator().manual_seed(14)
    ops = {"slot_set": (TR.slot_set, TR.slot_set_reference, True),
           "slot_zero": (TR.slot_zero, TR.slot_zero_reference, False),
           "slot_add": (TR.slot_add, TR.slot_add_reference, True)}
    SEEN["slot_err"] = dict.fromkeys(ops, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        files = slot_files(dev, dtype, gen)
        for key, (kern, plain, takes_val) in ops.items():
            for name, (file, idx, val) in files.items():
                args = (idx, val) if takes_val else (idx,)
                _build.reset_launches()
                got = kern(file.clone(), *args)
                torch.cuda.synchronize()
                require(_build.LAUNCHES[key] == 1, f"{key} did not launch")
                want = plain(file.clone(), *args)
                require(torch.equal(got, want),
                        f"{key} {name} {dtype}: kernel != plain version")
                SEEN["slot_err"][key] = max(SEEN["slot_err"][key], float(
                    (got.float() - want.float()).abs().max()))
                keep = torch.ones(file.shape[:2], dtype=torch.bool,
                                  device=dev)
                keep[torch.arange(file.shape[0], device=dev),
                     idx.long()] = False
                require(torch.equal(got[keep], file[keep]),
                        f"{key} {name} {dtype}: an untouched slot changed")
                require(not torch.equal(got[~keep], file[~keep]),
                        f"{key} {name} {dtype}: the indexed slots kept "
                        "their values")
        log(f"[slots] set / zero / add on rv {tuple(files['rv'][0].shape)}, "
            f"rf {tuple(files['rf'][0].shape)}, ra "
            f"{tuple(files['ra'][0].shape)} {dtype}: equal bits to the plain "
            "versions, untouched slots unchanged ok")
        # the seven adds of a step in one launch, repeated slots included
        base, entries = step_adds(dev, dtype, gen)
        outs = {}
        for how in ("many", "kernel", "plain"):
            fs = {n: f.clone() for n, f in base.items()}
            _build.reset_launches()
            if how == "many":
                TR.slot_add_many((fs[n], i, v) for n, i, v in entries)
            else:
                add = TR.slot_add if how == "kernel" else \
                    TR.slot_add_reference
                for n, i, v in entries:
                    add(fs[n], i, v)
            torch.cuda.synchronize()
            want = {"many": {"slot_add_many": 1},
                    "kernel": {"slot_add": len(entries)}, "plain": {}}[how]
            require({k: v for k, v in _build.LAUNCHES.items() if v} == want,
                    f"slot_add_many check, {how}: {_build.LAUNCHES}")
            outs[how] = fs
        for n, f in base.items():
            require(torch.equal(outs["many"][n], outs["plain"][n])
                    and torch.equal(outs["many"][n], outs["kernel"][n]),
                    f"slot_add_many {n} {dtype}: not the seven adds in turn")
            keep = torch.ones(f.shape[:2], dtype=torch.bool, device=dev)
            for m, i, _ in entries:
                if m == n:
                    keep[torch.arange(f.shape[0], device=dev),
                         i.long()] = False
            require(torch.equal(outs["many"][n][keep], f[keep]),
                    f"slot_add_many {n} {dtype}: an untouched slot changed")
        log(f"[slots] slot_add_many, the {len(entries)} adds of a step in "
            f"one launch (files {'/'.join(SLOT_CALLS['slot_add'])}, vb = va "
            f"on half the examples, vc = va on a quarter, fb = fa and ab = "
            f"aa on half) {dtype}: equal bits to the seven plain adds and to "
            "seven slot_add launches in turn, untouched slots unchanged ok")
        for kind in ("set", "zero"):
            check_step_slots(dev, dtype, gen, kind)

    # ---- times at the train step's shapes (bf16), per step of the scan --
    files = slot_files(dev, torch.bfloat16, gen)
    rows = torch.arange(TRAIN_BATCH, device=dev)
    zero = torch.zeros((), dtype=torch.bfloat16, device=dev)

    def library(key, file, idx, val):
        """One PyTorch call that computes the same function."""
        ix = (rows, idx.long())
        if key == "slot_set":
            return file.index_put_(ix, val)
        if key == "slot_zero":
            return file.index_put_(ix, zero)
        return file.index_put_(ix, val, accumulate=True)

    entries = {}
    for key, (kern, plain, takes_val) in ops.items():
        calls = [files[n] for n in SLOT_CALLS[key]]

        def run(fn, with_key=False):
            for file, idx, val in calls:
                a = (idx, val) if takes_val else (idx,)
                fn(key, file, idx, val) if with_key else fn(file, *a)

        ms = cuda_time_ms(lambda: run(kern), iters=20)
        plain_ms = cuda_time_ms(lambda: run(plain), iters=20)
        lib_ms = cuda_time_ms(lambda: run(library, True), iters=20)
        nbytes = 0
        for file, idx, val in calls:
            slot = val.numel() * val.element_size()
            moved = {"slot_set": 2, "slot_zero": 1, "slot_add": 3}[key]
            nbytes += moved * slot + idx.numel() * idx.element_size()
        b = bound(0.0, nbytes, torch.bfloat16)
        entries[key] = {"ms": ms, "plain_ms": plain_ms, **b,
                        "library_ms": lib_ms}
        log(f"[kernel time] {key}: the {len(calls)} calls of one executor "
            f"step (files {'/'.join(SLOT_CALLS[key])}) {ms:.4f} ms, plain "
            f"version {plain_ms:.4f} ms, index_put_ {lib_ms:.4f} ms, bound "
            f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({nbytes} bytes) "
            f"(CUDA events, bf16, B={TRAIN_BATCH}); card {card}")

    # one launch for the seven adds, beside the seven slot_add launches
    base, adds = step_adds(dev, torch.bfloat16, gen)
    many = [(base[n], i, v) for n, i, v in adds]

    def each(fn):
        for f, i, v in many:
            fn(f, i, v)

    def library():
        for f, i, v in many:
            f.index_put_((rows, i.long()), v, accumulate=True)

    ms = cuda_time_ms(lambda: TR.slot_add_many(many), iters=20)
    seven_ms = cuda_time_ms(lambda: each(TR.slot_add), iters=20)
    plain_ms = cuda_time_ms(lambda: TR.slot_add_many_reference(many),
                            iters=20)
    lib_ms = cuda_time_ms(library, iters=20)
    # the device's own time, without the wrappers' Python between launches
    dev_ms = graph_ms(lambda: TR.slot_add_many(many))
    seven_dev_ms = graph_ms(lambda: each(TR.slot_add))
    nbytes = slot_bytes("add", base, adds)
    b = bound(0.0, nbytes, torch.bfloat16)
    entries["slot_add_many"] = {"ms": ms, "plain_ms": plain_ms, **b,
                                "library_ms": lib_ms, "seven_ms": seven_ms,
                                "graph_ms": dev_ms,
                                "seven_graph_ms": seven_dev_ms}
    log(f"[kernel time] slot_add_many: the {len(many)} adds of one executor "
        f"step in one launch {ms:.4f} ms, the same as {len(many)} slot_add "
        f"launches {seven_ms:.4f} ms (back to back: the wrappers' Python "
        f"paces both); by CUDA-graph replay {dev_ms:.4f} ms and "
        f"{seven_dev_ms:.4f} ms; plain version {plain_ms:.4f} ms, "
        f"{len(many)} index_put_(accumulate=True) {lib_ms:.4f} ms, bound "
        f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({nbytes} bytes: repeated "
        f"slots read and written once) (CUDA events, bf16, B={TRAIN_BATCH}); "
        f"card {card}")
    for kind in ("set", "zero"):
        entries[f"slot_{kind}_many"] = time_step_slots(dev, card, gen, kind)
    return entries


def one_entry_sequence(kind, ents, keep=True):
    """A step's updates as the reversible executor made them before they
    were planned: one single-update launch per entry, each read-out an
    index gather before its zero (copied into the entry's ``out`` where
    ``keep``). ``ents``: ``(file, idx, val or out)``."""
    from stair_tpu_torch.models.rev_exec import take
    from stair_tpu_torch.ops import regslots as TR

    for f, i, x in ents:
        if kind == "set":
            TR.slot_set(f, i, x)
            continue
        if x is not None:
            g = take(f, i)
            if keep:
                x.copy_(g)
        TR.slot_zero(f, i)


def check_step_slots(dev, dtype, gen, kind):
    """One launch of a step's four sets or eight reads-and-zeros (repeated
    slots included) against the plain versions in turn and the one-entry
    launches in turn: equal bits in every file and read-out, and every
    slot no entry names unchanged."""
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import regslots as TR

    base, entries = step_slots(dev, dtype, gen, kind)
    key = f"slot_{kind}_many"
    got = {}
    for how in ("many", "one", "plain"):
        fs = {n: f.clone() for n, f in base.items()}
        ents = [(fs[n], i, x if kind == "set" or x is None
                 else torch.full_like(x, 7.0)) for n, i, x in entries]
        _build.reset_launches()
        if how == "one":
            one_entry_sequence(kind, ents)
        elif kind == "set":
            (TR.slot_set_many if how == "many"
             else TR.slot_set_many_reference)(ents)
        else:
            (TR.slot_zero_many if how == "many"
             else TR.slot_zero_many_reference)(
                [(f, i) for f, i, _ in ents], [o for _, _, o in ents])
        torch.cuda.synchronize()
        want = {"many": {key: 1}, "one": {f"slot_{kind}": len(ents)},
                "plain": {}}[how]
        require({k: v for k, v in _build.LAUNCHES.items() if v} == want,
                f"{key} check, {how}: {_build.LAUNCHES}")
        got[how] = (fs, [x for _, _, x in ents] if kind == "zero" else [])
    for how in ("one", "plain"):
        for n in base:
            require(torch.equal(got["many"][0][n], got[how][0][n]),
                    f"{key} {n} {dtype}: not the {how} updates in turn")
        for a, b in zip(got["many"][1], got[how][1]):
            require(a is None or torch.equal(a, b),
                    f"{key} {dtype}: a read-out differs from the {how} "
                    "updates'")
    for n, f in base.items():
        keep = torch.ones(f.shape[:2], dtype=torch.bool, device=dev)
        for m, i, _ in entries:
            if m == n:
                keep[torch.arange(f.shape[0], device=dev), i.long()] = False
        require(torch.equal(got["many"][0][n][keep], f[keep]),
                f"{key} {n} {dtype}: an untouched slot changed")
    if kind == "zero":
        # out_attn == out_attn_b: the second read-out sees the first's zero
        rows = (entries[0][1] == entries[1][1]).nonzero()[:, 0]
        require(rows.numel() > 0 and not got["many"][1][1][rows].any(),
                f"{key} {dtype}: the repeated slot's second read-out is "
                "not 0")
    log(f"[slots] {key}, the {len(entries)} "
        f"{'sets' if kind == 'set' else 'reads-and-zeros'} of a step in one "
        f"launch (files {'/'.join(STEP_SLOTS[kind])}, the two attn entries "
        f"on one slot for half the examples) {dtype}: equal bits to the "
        f"plain versions and to {len(entries)} one-entry launches in turn"
        f"{', read-outs included' if kind == 'zero' else ''}, untouched "
        "slots unchanged ok")


def time_step_slots(dev, card, gen, kind):
    """A step's four sets or eight reads-and-zeros at the train step's
    shapes (bf16), made as the reversible executor makes them (one call of
    a ``SlotPlan``): back to back and by CUDA-graph replay, beside the
    one-entry launches in turn (the route the plan replaced, gathers
    included), the plain versions, ``index_put_`` and the bound."""
    from stair_tpu_torch.ops import regslots as TR
    from stair_tpu_torch.utils.device import cuda_time_ms

    base, entries = step_slots(dev, torch.bfloat16, gen, kind)
    key = f"slot_{kind}_many"
    plan = TR.SlotPlan(kind, [
        (base[n], i.view(1, -1)) if kind == "set" or x is None
        else (base[n], i.view(1, -1), x) for n, i, x in entries])
    vals = [x for _, _, x in entries] if kind == "set" else ()
    ents = [(base[n], i, x) for n, i, x in entries]
    rows = torch.arange(TRAIN_BATCH, device=dev)
    zero = torch.zeros((), dtype=torch.bfloat16, device=dev)

    def library():
        for f, i, x in ents:
            ix = (rows, i.long())
            if kind == "set":
                f.index_put_(ix, x)
            else:
                if x is not None:
                    f[ix]
                f.index_put_(ix, zero)

    ms = cuda_time_ms(lambda: plan(0, vals), iters=20)
    one_ms = cuda_time_ms(lambda: one_entry_sequence(kind, ents, False),
                          iters=20)
    plain_ms = cuda_time_ms(lambda: plan.reference(0, vals), iters=20)
    lib_ms = cuda_time_ms(library, iters=20)
    dev_ms = graph_ms(lambda: plan(0, vals))
    one_dev_ms = graph_ms(lambda: one_entry_sequence(kind, ents, False))
    nbytes = slot_bytes(kind, base, entries)
    b = bound(0.0, nbytes, torch.bfloat16)
    what = "sets" if kind == "set" else "reads-and-zeros"
    log(f"[kernel time] {key}: the {len(entries)} {what} of one executor "
        f"step in one launch {ms:.4f} ms, the same as {len(entries)} "
        f"one-entry launches{' and 4 gathers' if kind == 'zero' else ''} "
        f"{one_ms:.4f} ms (back to back); by CUDA-graph replay {dev_ms:.4f} "
        f"ms and {one_dev_ms:.4f} ms (the files stay in the 50 MB L2); "
        f"plain version {plain_ms:.4f} ms, index_put_"
        f"{' and gathers' if kind == 'zero' else ''} {lib_ms:.4f} ms, bound "
        f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({nbytes} bytes) (CUDA "
        f"events, bf16, B={TRAIN_BATCH}); card {card}")
    return {"ms": ms, "plain_ms": plain_ms, **b, "library_ms": lib_ms,
            "one_entry_ms": one_ms, "graph_ms": dev_ms,
            "one_entry_graph_ms": one_dev_ms}


def step_bound(args, dtype):
    """One launch of the fused step on these inputs: the products of the
    live tiles (two [F, H] @ [H, H] per live stage 1, one per stage-2
    projection, two [H] @ [H, H] per Localize tile) over the peak rate,
    against every operand row read once (the frames operand, two vec rows,
    the masks and schedule), the weights of each expert present read once,
    and every output written once."""
    from stair_tpu_torch.ops import executor_step as TE

    scal, rv, rf = args[0], args[1], args[2]
    B, _, F, H = rf.shape
    es = rf.element_size()
    e1, e2 = scal[TE.S_E1], scal[TE.S_E2]
    stage1 = e1 != TE.E1_NULL
    proj = (e2 == TE.E2_FF) | (e2 == TE.E2_TEMPORAL)
    writes = proj | (e2 == TE.E2_ATTNVIDEO)
    loc = e1 == TE.E1_LOCALIZE
    n1, n2 = int(stage1.sum()), int(proj.sum())
    flops = 2.0 * F * H * H * (2 * n1 + n2) + 4.0 * H * H * int(loc.sum())
    experts1 = len(torch.unique(e1[stage1]))
    experts2 = len(torch.unique(e2[proj]))
    nbytes = (
        B * (F * H + 2 * H + 2 * F) * es + scal.numel() * 4 + B * 4
        + int((e2 == TE.E2_ATTNVIDEO).sum()) * F * es
        + (experts1 * 2 + experts2 + bool(loc.any())) * (H * H + H) * es
        + int(writes.sum()) * F * H * es
        + B * H * es + 2 * B * F * es + 2 * B * F * 4)
    return bound(flops, nbytes, dtype)


@contextlib.contextmanager
def step_route(route):
    """Send the fused step through ``route`` (``"tc"``, ``"fma32"`` or
    ``"general"``) whatever ``executor_step.step_route`` picks; ``None``: as
    it picks. A route that does not take the call's dtype or widths makes
    ``fused_step`` raise."""
    from stair_tpu_torch.ops import executor_step as TE

    pick = TE.step_route
    if route is not None:
        TE.step_route = lambda *a: route
    try:
        yield
    finally:
        TE.step_route = pick


#: the fused step's routes a phase drives in each dtype, the route
#: ``step_route`` picks first (the bf16 loops never force "fma32")
STEP_ROUTES = {torch.float32: ("fma32", "general"),
               torch.bfloat16: ("tc", "general")}


def phase_step_kernel(dev):
    """Kernel #10 against its plain version at every step of the all-opcode
    programs at F 16, 64 and 150 (the NMN CLIs' default, where both
    redesigned routes run over frame-row tiles): the model runs on the
    ``"step"`` executor and each call of ``fused_step`` is made twice,
    kernel and plain version, on clones; bf16 on the tensor-core and the
    general route, float32 on the "fma32" and the general route, each
    "fma32" call also against the general route on clones (equal bits).
    Returns the launches of the float32 forward at F = 64 on the forced
    general route."""
    from stair_tpu_torch.models.nmn import NMNConfig
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import executor_step as TE
    from stair_tpu_torch.testing import workload as W
    from stair_tpu_torch.utils.device import cuda_time_ms

    names = ("rf", "pooled", "hasitem", "existsframe", "loc_a", "loc_b")
    real = TE.fused_step
    general_launches = 0
    calls32 = []     # the float32 forward's calls at F = 64, to time
    for F in (16, FRAMES, CLI_DEFAULTS["max_video_length"]):
        for dtype, routes in STEP_ROUTES.items():
            cfg = NMNConfig(
                hidden_size=HIDDEN, video_size=VIDEO_D, text_size=TEXT_D,
                max_video_length=F, object_types=3, max_steps=16,
                num_vec=10, num_frames=6, num_attn=8,
                compute_dtype="float32" if dtype == torch.float32
                else "bfloat16")
            require(TE.step_route(dtype, F, HIDDEN) == routes[0],
                    f"step_route({dtype}, {F}, {HIDDEN})")
            model = W.build_model(cfg, seed=3, device=dev, executor="step")
            batch = W.to_device(W.opcode_batch(
                cfg, W.OPCODE_PROGRAMS * 8, seed=F), dev)
            tol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 3e-2)
            for route in routes:
                seen = {"err": 0.0, "e1": set(), "e2": set(), "same": 0}

                def both(*args):
                    if route == "fma32" and F == FRAMES:
                        calls32.append(tuple(a.clone() for a in args))
                    want = TE.fused_step_reference(*(a.clone() for a in args))
                    if route == "fma32":
                        # the general route on clones, its launch not counted
                        counted = dict(_build.LAUNCHES)
                        with step_route("general"):
                            general = real(*(a.clone() for a in args))
                        _build.LAUNCHES.update(counted)
                    got = real(*args)
                    torch.cuda.synchronize()
                    for g, w, what in zip(got, want, names):
                        torch.testing.assert_close(
                            g.float(), w.float(), rtol=tol[0], atol=tol[1],
                            msg=lambda m: f"executor_step {route} {what}: {m}")
                    if route == "fma32":
                        for g, k, what in zip(got, general, names):
                            require(torch.equal(g, k), f"executor_step fma32 "
                                    f"route != general route, {what}, F={F}")
                        seen["same"] += 1
                    seen["err"] = max(seen["err"], max_err(got, want))
                    seen["e1"] |= set(args[0][TE.S_E1].tolist())
                    seen["e2"] |= set(args[0][TE.S_E2].tolist())
                    return got

                TE.fused_step = both
                try:
                    with step_route(None if route == routes[0] else route):
                        _build.reset_launches()
                        out = model(batch)
                        launches = dict(_build.LAUNCHES)
                finally:
                    TE.fused_step = real
                T = batch["trace"]["opcode"].shape[1]
                key = TE.STEP_KEYS[route]
                require(launches[key] == T and all(
                    launches[k] == 0 for k in TE.STEP_KEYS.values()
                    if k != key),
                        f"{key} launches {launches}")
                if dtype == torch.float32 and F == FRAMES and \
                        route == "general":
                    general_launches = launches[key]
                require(seen["e2"] == set(range(5)) and {0, 4, 8, 9, 10}
                        <= seen["e1"], f"families not covered: {seen}")
                require(bool(torch.isfinite(out["logits"]).all()),
                        "non-finite logits on the step route")
                same = (f", equal bits to the general route at all "
                        f"{seen['same']} steps" if route == "fma32" else "")
                log(f"[executor_step] all {len(W.OPCODE_PROGRAMS)} opcode "
                    f"programs x8 H={HIDDEN} F={F} "
                    f"{'conv' if cfg.conv_temporal else 'linear'}-temporal "
                    f"{dtype} on the {route} route ({key}): {T} steps, every "
                    f"output and the whole frames file, max_abs_err "
                    f"{seen['err']:.3e} (rtol {tol[0]}, atol {tol[1]})"
                    f"{same}, stage-1 experts {sorted(seen['e1'])} ok")
    # #10 in float32 on both routes over the forward's T calls, timed in
    # place (a repeat rewrites the same frames slots)
    require(len(calls32) == general_launches, "float32 fused_step calls")
    B32 = calls32[0][1].shape[0]

    def run32():
        return [real(*a) for a in calls32]

    # back to back (the host's time between launches included: 11 of the
    # 16 launches have no live tile) and by graph replay (the device's)
    ms, graph = cuda_time_ms(run32, iters=5), graph_ms(run32, iters=2)
    with step_route("general"):
        general_ms = cuda_time_ms(run32, iters=5)
        general_graph = graph_ms(run32, iters=2)
    f32_record(
        "#10", f"opcode programs x8, B {B32} H {HIDDEN} F {FRAMES}, the "
        f"{len(calls32)} steps", "fma32", ms,
        cuda_time_ms(lambda: [TE.fused_step_reference(*a) for a in calls32],
                     iters=2, warmup=1),
        add_bounds(*[step_bound(a, torch.float32) for a in calls32]),
        launches=len(calls32), general_ms=general_ms, graph_ms=graph,
        general_graph_ms=general_graph,
        cluster=_build.build().stair_executor_step_fma32_cluster(
            B32, FRAMES, HIDDEN))
    return general_launches


def hold_files(what, trace, out, ref, keys):
    """Two bf16 routes' register files ``out[k]`` against ``ref[k]`` for
    ``k`` in ``keys``: the executor's bf16 tolerance (atol 3e-2 + rtol
    1e-2) on all but 1e-5 of a file's elements, and twice that on every
    element. Choose is the one module with a hard select: where its two
    cosines tie within CHOOSE_TIE the routes may keep different keywords,
    and such an example (at most one in 200) is held to that and left out.
    Returns ``(max abs errs, elements outside, flipped examples, widest
    flipped tie, each example's least Choose gap)``."""
    from stair_tpu_torch.testing.workload import choose_flips

    flipped, margin = choose_flips(trace, out["regs_vec"], ref["regs_vec"])
    n_flipped = int(flipped.sum())
    worst_tie = float(margin[flipped].max()) if n_flipped else 0.0
    require(n_flipped <= len(flipped) // 200 and worst_tie <= CHOOSE_TIE,
            f"{what}: {n_flipped} examples chose another keyword, "
            f"cosines apart by up to {worst_tie:.3e}")
    same = ~flipped
    errs, outside = {}, {}
    for k in keys:
        diff = (out[k][same] - ref[k][same]).abs()
        tol = 3e-2 + 1e-2 * ref[k][same].abs()
        outside[k] = int((diff > tol).sum())
        errs[k] = float(diff.max())
        require(outside[k] <= 1e-5 * diff.numel()
                and bool((diff <= 2 * tol).all()),
                f"{what} {k}: {outside[k]} of {diff.numel()} elements "
                f"outside the tolerance, worst {float((diff / tol).max()):.2f}"
                " of it")
    return errs, outside, n_flipped, worst_tie, margin


def phase_step_slice(dev, card, general_launches):
    """The serving path on the scan executor, beside the megakernel route
    of ``phase_slice`` (the same configuration, batches and weights)."""
    from stair_tpu_torch.models.nmn import VideoNMN
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import executor_step as TE
    from stair_tpu_torch.utils.device import cuda_time_ms

    serving, mega = SEEN["serving"], SEEN["mega_model"]
    cfg = serving.cfg
    model = VideoNMN(cfg, mega.param_tree(), device=dev, executor="step")
    host_batch, device_batch = serving.host_batch, serving.device_batch

    def forward(b):
        return model(b)["logits"]

    hb0 = host_batch(NUM_BATCHES)
    b0 = device_batch(hb0)
    T = b0["trace"]["opcode"].shape[1]
    forward(b0)                                   # warm-up
    torch.cuda.synchronize()

    # ---- the counted main-path run ------------------------------------
    _build.reset_launches()
    t0 = time.perf_counter()
    fetched = [forward(device_batch(host_batch(i))).float().cpu()
               for i in range(STEP_BATCHES)]
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    require(launches["executor_step_tc"] == T * STEP_BATCHES
            and launches["executor_step"] == 0
            and launches["bilstm_tc"] == 2 * STEP_BATCHES
            and launches["bilstm"] == 0 and launches["mega_exec"] == 0
            and launches["mega_exec_tc"] == 0,
            f"step route launches {launches} (T = {T})")
    for lg in fetched:
        require(lg.shape == (BATCH, cfg.answer_vocab_length)
                and bool(torch.isfinite(lg).all()), "step route logits")
    qps = STEP_BATCHES * BATCH / wall
    log(f"[step slice] {STEP_BATCHES} batches x {BATCH} questions on "
        f"executor='step': {qps:.1f} q/s end to end (megakernel route "
        f"{SEEN['mega_qps']:.1f}), launches per batch: executor_step_tc "
        f"{T}, executor_step 0, bilstm_tc 2, bilstm 0, mega_exec_tc 0, "
        f"mega_exec 0; card {card}")

    # ---- against the megakernel route on one batch ------------------------
    with kernel_route(("bilstm_tc", "executor_step_tc")):
        out = model(b0)
    with kernel_route(("bilstm_tc", "mega_exec_tc")):
        ref = mega(b0)
    agree = (out["logits"].argmax(-1) == ref["logits"].argmax(-1)
             ).float().mean().item()
    require(agree >= 0.98, f"step / mega argmax agreement {agree}")
    # Two routes that round to bf16 at the same sites but for one: the
    # Filter head pools the float32 feat tile in the step kernel and the
    # rounded one in the megakernel (as the two TPU kernels do), and the
    # sums run in other orders.
    errs, outside, n_flipped, worst_tie, margin = hold_files(
        "step vs mega", b0["trace"], out, ref,
        ("regs_vec", "regs_frames", "regs_attn"))
    require(float(out["regs_frames"][:, cfg.num_frames].abs().max()) == 0.0,
            "the scratch frames slot is not zero")
    dev_ms = cuda_time_ms(lambda: forward(b0), iters=5, warmup=1)
    with plain_route():
        plain = model(b0)["logits"]
        plain_ms = cuda_time_ms(lambda: forward(b0), iters=2, warmup=1)
    p_agree = (plain.argmax(-1) == out["logits"].argmax(-1)
               ).float().mean().item()
    require(p_agree >= 0.98, f"step kernel / plain route agreement {p_agree}")
    log(f"[step slice] vs the megakernel route on one batch: argmax "
        f"agreement {agree:.4f}, logits max_abs_err "
        f"{float((out['logits'] - ref['logits']).abs().max()):.3e}, register "
        f"files max_abs_err {({k: f'{v:.3e}' for k, v in errs.items()})}, "
        f"elements outside atol 3e-2 + rtol 1e-2: {outside} (at most 1e-5 "
        f"of a file, none beyond twice the tolerance; {n_flipped} of "
        f"{int(torch.isfinite(margin).sum())} examples with a Choose kept "
        f"the other keyword, cosines apart by {worst_tie:.3e} <= "
        f"{CHOOSE_TIE}, least gap in the batch {float(margin.min()):.3e}); "
        f"kernel vs plain "
        f"route argmax agreement {p_agree:.4f}")
    log(f"[step slice] device forward per batch of {BATCH} (CUDA events): "
        f"executor='step' {dev_ms:.3f} ms (plain route {plain_ms:.3f} ms), "
        f"megakernel route {SEEN['mega_dev_ms']:.3f} ms; card {card}")
    SEEN.update(step_qps=qps, step_dev_ms=dev_ms)

    # ---- the kernel on the main path's own inputs, step by step -----------
    calls = []
    real = TE.fused_step

    def record(*args):
        calls.append(tuple(a.clone() for a in args))
        return real(*args)

    TE.fused_step = record
    try:
        model(b0)
    finally:
        TE.fused_step = real
    require(len(calls) == T, "fused_step calls")
    errs, ms = {}, {}
    for route in STEP_ROUTES[torch.bfloat16]:
        err = 0.0
        with step_route(route):
            for args in calls:
                _build.reset_launches()
                got = real(*(a.clone() for a in args))
                require(_build.LAUNCHES[TE.STEP_KEYS[route]] == 1,
                        f"{route} route: {_build.LAUNCHES}")
                want = TE.fused_step_reference(*(a.clone() for a in args))
                for g, w in zip(got, want):
                    torch.testing.assert_close(g.float(), w.float(),
                                               rtol=1e-2, atol=3e-2)
                err = max(err, max_err(got, want))
            # timed in place: a repeat rewrites the same frames slots
            ms[route] = cuda_time_ms(lambda: [real(*a) for a in calls],
                                     iters=5)
        errs[route] = err
    plain_ms = cuda_time_ms(
        lambda: [TE.fused_step_reference(*a) for a in calls], iters=2)
    b = add_bounds(*[step_bound(a, model.compute_dtype) for a in calls])
    log(f"[main-path inputs] executor_step over the {T} steps of one batch: "
        f"tensor-core route max_abs_err {errs['tc']:.3e} and {ms['tc']:.3f} "
        f"ms, general route max_abs_err {errs['general']:.3e} and "
        f"{ms['general']:.3f} ms (rtol 1e-2, atol 3e-2); plain version "
        f"{plain_ms:.3f} ms, bound {b} (CUDA events, bf16); card {card}")
    del calls
    torch.cuda.empty_cache()
    source = "stair_tpu_torch/ops/csrc/executor_step.cu"
    return [
        {"name": "executor_step_tc", "route": "cuda", "source": source,
         "replaces": "stair_tpu/ops/executor_step.py:49",
         "launches": launches["executor_step_tc"], "max_abs_err": errs["tc"],
         "ms": ms["tc"], "general_ms": ms["general"], "plain_ms": plain_ms,
         **b, "library_ms": None},
        # the general route: timed on the same inputs; no main path takes
        # it, so its launches are those of phase 15's forced general run
        {"name": "executor_step", "route": "cuda", "source": source,
         "replaces": "stair_tpu/ops/executor_step.py:49",
         "launches": general_launches, "launches_path": "float32 forward "
         "on executor='step', F 64, the general route forced (phase 15)",
         "max_abs_err": errs["general"], "ms": ms["general"],
         "plain_ms": plain_ms, **b, "library_ms": None},
        step_slice_f32(dev, card),
    ]


def step_slice_f32(dev, card):
    """Float32 serving on ``executor="step"`` (phase 16's configuration,
    batches and weights, ``compute_dtype="float32"``): per batch ``T``
    launches of the "fma32" step kernel and none of the other two, the
    BiLSTM on its float32 cluster route and no megakernel; logits against
    the float32 megakernel route (``"fma32"`` #4) and the plain route on
    one batch; q/s and device ms a batch beside the bf16 step route's and
    the float32 megakernel's; the batch's 13 ``fused_step`` calls on the
    "fma32" route against the general route (equal bits) and the plain
    version (1e-4), each timed. Returns the ``executor_step_fma32``
    entry."""
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import executor_step as TE
    from stair_tpu_torch.utils.device import cuda_time_ms

    serving = SEEN["serving"]
    cfg = NMNConfig(**{**serving.cfg.to_dict(), "compute_dtype": "float32"})
    params = SEEN["mega_model"].param_tree()
    model = VideoNMN(cfg, params, device=dev, executor="step")
    mega = VideoNMN(cfg, params, device=dev)
    host_batch, device_batch = serving.host_batch, serving.device_batch
    b0 = device_batch(host_batch(NUM_BATCHES))
    T = b0["trace"]["opcode"].shape[1]
    require(TE.step_route(torch.float32, cfg.max_video_length,
                          cfg.hidden_size) == "fma32", "float32 step route")

    # ---- the counted main-path runs: the step route, then the megakernel
    qps, per_batch = {}, {
        "step": {"executor_step_fma32": T, "bilstm_f32c": 2},
        "mega": {"mega_exec_fma32": 1, "bilstm_f32c": 2}}
    for name, m in (("step", model), ("mega", mega)):
        m(b0)                                     # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        fetched = [m(device_batch(host_batch(i)))["logits"].cpu()
                   for i in range(STEP_BATCHES)]
        wall = time.perf_counter() - t0
        for lg in fetched:
            require(lg.shape == (BATCH, cfg.answer_vocab_length)
                    and lg.dtype == torch.float32
                    and bool(torch.isfinite(lg).all()),
                    f"float32 {name} route logits")
        require_launches(f"float32 serving on executor={name!r}",
                         dict(_build.LAUNCHES),
                         {k: v * STEP_BATCHES
                          for k, v in per_batch[name].items()})
        qps[name] = STEP_BATCHES * BATCH / wall
    launches = T * STEP_BATCHES
    log(f"[step slice f32] {STEP_BATCHES} batches x {BATCH} questions in "
        f"float32 on executor='step': {qps['step']:.1f} q/s end to end "
        f"(float32 megakernel route {qps['mega']:.1f}; bf16 step route "
        f"{SEEN['step_qps']:.1f}), launches per batch: executor_step_fma32 "
        f"{T}, executor_step 0, executor_step_tc 0, bilstm_f32c 2, bilstm 0, "
        f"no megakernel; card {card}")

    # ---- against the float32 megakernel and the plain route, one batch ---
    with kernel_route(("bilstm_f32c", "executor_step_fma32")):
        out = model(b0)
    with kernel_route(("bilstm_f32c", "mega_exec_fma32")):
        ref = mega(b0)
    agree = (out["logits"].argmax(-1) == ref["logits"].argmax(-1)
             ).float().mean().item()
    require(agree >= 0.98, f"float32 step / mega argmax agreement {agree}")
    file_errs = {k: f"{float((out[k] - ref[k]).abs().max()):.3e}"
                 for k in ("regs_vec", "regs_frames", "regs_attn")}
    with plain_route():
        plain = model(b0)["logits"]
        plain_dev_ms = cuda_time_ms(lambda: model(b0), iters=2, warmup=1)
    p_agree = (plain.argmax(-1) == out["logits"].argmax(-1)
               ).float().mean().item()
    require(p_agree >= 0.98,
            f"float32 step kernel / plain route agreement {p_agree}")
    dev_ms = cuda_time_ms(lambda: model(b0), iters=5, warmup=1)
    mega_ms = cuda_time_ms(lambda: mega(b0), iters=5, warmup=1)
    log(f"[step slice f32] vs the float32 megakernel route on one batch: "
        f"argmax agreement {agree:.4f}, logits max_abs_err "
        f"{float((out['logits'] - ref['logits']).abs().max()):.3e}, register "
        f"files max_abs_err {file_errs}; kernel vs plain route argmax "
        f"agreement {p_agree:.4f}")
    log(f"[step slice f32] device forward per batch of {BATCH} (CUDA "
        f"events): float32 executor='step' {dev_ms:.3f} ms (plain route "
        f"{plain_dev_ms:.3f} ms), float32 megakernel route {mega_ms:.3f} ms, "
        f"bf16 executor='step' {SEEN['step_dev_ms']:.3f} ms; card {card}")
    del out, ref, plain

    # ---- the kernel on the main path's own inputs, step by step -----------
    calls, real = [], TE.fused_step

    def record(*args):
        calls.append(tuple(a.clone() for a in args))
        return real(*args)

    TE.fused_step = record
    try:
        model(b0)
    finally:
        TE.fused_step = real
    require(len(calls) == T, "float32 fused_step calls")
    names = ("rf", "pooled", "hasitem", "existsframe", "loc_a", "loc_b")
    err = 0.0
    for args in calls:
        _build.reset_launches()
        got = real(*(a.clone() for a in args))
        require_launches("one float32 fused_step", dict(_build.LAUNCHES),
                         {"executor_step_fma32": 1})
        with step_route("general"):
            general = real(*(a.clone() for a in args))
        for g, k, what in zip(got, general, names):
            require(torch.equal(g, k), f"float32 serving step: the fma32 "
                    f"route != the general route in {what}")
        del general
        want = TE.fused_step_reference(*(a.clone() for a in args))
        for g, w, what in zip(got, want, names):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4,
                                       msg=lambda m: f"fma32 {what}: {m}")
        err = max(err, max_err(got, want))
        del got, want

    def run():
        return [real(*a) for a in calls]

    # timed in place (a repeat rewrites the same frames slots), back to
    # back and by graph replay
    ms, graph = cuda_time_ms(run, iters=5), graph_ms(run, iters=2)
    with step_route("general"):
        general_ms = cuda_time_ms(run, iters=5)
    plain_ms = cuda_time_ms(
        lambda: [TE.fused_step_reference(*a) for a in calls], iters=2)
    b = add_bounds(*[step_bound(a, torch.float32) for a in calls])
    f32_record("#10", f"float32 serving batch, B {BATCH} H "
               f"{cfg.hidden_size} F {cfg.max_video_length}, the {T} steps",
               "fma32", ms, plain_ms, b, launches=T, general_ms=general_ms,
               graph_ms=graph, cluster=_build.build()
               .stair_executor_step_fma32_cluster(
                   BATCH, cfg.max_video_length, cfg.hidden_size))
    log(f"[main-path inputs] float32 executor_step over the {T} steps of "
        f"one batch: fma32 route {ms:.3f} ms, equal bits to the general "
        f"route ({general_ms:.3f} ms) in every output and the whole frames "
        f"file, max_abs_err {err:.3e} against the plain version (rtol 1e-4, "
        f"atol 1e-4; {plain_ms:.3f} ms), bound {b} (CUDA events); card {card}")
    del calls
    torch.cuda.empty_cache()
    return {"name": "executor_step_fma32", "route": "cuda",
            "source": "stair_tpu_torch/ops/csrc/executor_step.cu",
            "replaces": "stair_tpu/ops/executor_step.py:49",
            "dtype": "float32", "launches": launches,
            "launches_path": f"float32 serving on executor='step', B "
            f"{BATCH}: {T} a batch, {STEP_BATCHES} batches",
            "max_abs_err": err, "ms": ms, "graph_ms": graph,
            "general_ms": general_ms, "plain_ms": plain_ms, **b,
            "library_ms": None}


def phase_rev_train(dev, card, slot_entries):
    """The train step on the reversible executor, beside ``phase_train``'s
    (the same configuration, batch and trainer arguments)."""
    from stair_tpu_torch.models.nmn import NMNConfig
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import regslots as TR
    from stair_tpu_torch.testing import workload as W
    from stair_tpu_torch.train.loop import make_train_step
    from stair_tpu_torch.train.losses import total_loss
    from stair_tpu_torch.utils.device import cuda_time_ms

    cfg, batch, args = (SEEN["train_cfg"], SEEN["train_batch"],
                        SEEN["train_args"])
    T = batch["trace"]["opcode"].shape[1]
    want = {**TRAIN_LAUNCHES, "mega_exec_train_tc": 0, "mega_exec_bwd_tc": 0,
            "mega_exec_wgrad_tc": 0, "executor_step": 0,
            "executor_step_tc": 0, "slot_set": 0, "slot_zero": 0,
            "slot_add": 0, "slot_set_many": T, "slot_zero_many": T,
            "slot_add_many": T}

    # ---- one float32 step: "rev" against "step" under the same seed ------
    cfg32 = NMNConfig(**{**cfg.to_dict(), "compute_dtype": "float32"})
    got = {}
    for executor in ("step", "rev"):
        m = W.build_model(cfg32, seed=0, device=dev, executor=executor)
        _build.reset_launches()
        loss, _ = total_loss(m, batch, torch.Generator().manual_seed(7), 1.0,
                             1.0, 1.0, 1.0,
                             contrastive_window=args.contrastive_window)
        loss.backward()
        torch.cuda.synchronize()
        # a leaf the loss does not reach has no gradient on the autograd
        # route and a zero one on the reversible route
        got[executor] = (float(loss.detach()), {
            k: torch.zeros_like(p) if p.grad is None else p.grad
            for k, p in m.weights.items()}, dict(_build.LAUNCHES))
        del m
    require(all(got["step"][2][k] == 0 for k in (
        "slot_set", "slot_zero", "slot_add", "slot_set_many",
        "slot_zero_many", "slot_add_many", "mega_exec_train",
        "mega_exec_train_tc")),
        f"step route launches {got['step'][2]}")
    ls, lr = got["step"][0], got["rev"][0]
    require(abs(ls - lr) <= 1e-5 * abs(ls), f"rev loss {lr} vs step {ls}")
    worst = max(((rel_err(got["rev"][1][k], g), k)
                 for k, g in got["step"][1].items()
                 if float(g.abs().max()) > 0))
    # the same step function and masks on both routes; the weight
    # cotangents are summed over steps in another order
    require(worst[0] <= 1e-4, f"rev vs step gradients: worst {worst}")
    log(f"[rev train] one float32 step, executor='rev' vs 'step' under one "
        f"seed: loss {lr:.6f} vs {ls:.6f}; {len(got['step'][1])} gradient "
        f"leaves, worst max|a-b|/max|b| {worst[0]:.3e} at {worst[1]} (bound "
        f"1e-4)")
    del got

    # ---- the counted main-path run: 10 steps ------------------------------
    model = W.build_model(cfg, seed=0, device=dev, executor="rev")
    step = make_train_step(model, args)
    # Warm-up, with every slot launch of the step made twice: the plan's
    # kernel on its files, its plain versions on copies of the files and
    # read-outs (a shallow copy of the plan that names the copies).
    real = TR.SlotPlan.__call__
    slot_err = {f"slot_{k}_many": 0.0 for k in ("set", "zero", "add")}
    checked_calls = dict.fromkeys(slot_err, 0)

    def checked(plan, t, vals=()):
        vals = list(vals)
        shadow = copy.copy(plan)
        copies = {id(f): f.clone() for f in plan.files}
        shadow.files = tuple(copies[id(f)] for f in plan.files)
        shadow.outs = tuple(None if o is None else o.clone()
                            for o in plan.outs)
        shadow.reference(t, vals)
        got = real(plan, t, vals)
        for a, b in zip((*plan.files, *plan.outs),
                        (*shadow.files, *shadow.outs)):
            if a is not None:
                slot_err[plan.key] = max(slot_err[plan.key], float(
                    (a.float() - b.float()).abs().max()))
        checked_calls[plan.key] += 1
        return got

    TR.SlotPlan.__call__ = checked
    try:
        step(batch, torch.Generator().manual_seed(100), 1.0, 1.0)
    finally:
        TR.SlotPlan.__call__ = real
    require(all(v == 0.0 for v in slot_err.values()),
            f"slot kernels differ from their plain versions: {slot_err}")
    require(all(n == T for n in checked_calls.values()),
            f"slot launches checked in one step: {checked_calls}, not {T} "
            "each")
    log(f"[main-path inputs] slot_set_many / slot_zero_many (read-outs "
        f"included) / slot_add_many over every launch of one train step "
        f"({T} each): max_abs_err {slot_err} (equal bits required) ok")
    torch.cuda.synchronize()
    _build.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        losses.append(step(batch, torch.Generator().manual_seed(i), 1.0,
                           1.0)["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    losses = [float(x) for x in losses]
    for k, n in want.items():
        require(launches[k] == n * TRAIN_STEPS,
                f"{k} launches {launches[k]} != {n * TRAIN_STEPS}")
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    require(np.mean(losses[-3:]) < np.mean(losses[:3]),
            f"loss did not fall: {losses}")
    k_ms = cuda_time_ms(lambda: step(batch, torch.Generator().manual_seed(
        200), 1.0, 1.0), iters=3, warmup=1)
    log(f"[rev train] {TRAIN_STEPS} steps B={TRAIN_BATCH} on executor='rev' "
        f"(T = {T}): losses {[round(x, 4) for x in losses]}; launches per "
        f"step: slot_set_many {T}, slot_zero_many {T}, slot_add_many {T} "
        f"(a step's four sets, eight reads-and-zeros and seven adds, one "
        f"launch each), slot_set / slot_zero / slot_add 0, "
        f"bilstm_train_tc 2, bilstm_bwd_tc 2, no megakernel; "
        f"{wall * 1e3 / TRAIN_STEPS:.3f} ms per step (host clock), "
        f"{k_ms:.3f} ms (CUDA events) beside the megakernel route's "
        f"{SEEN['mega_train_ms']:.3f} ms; card {card}")
    source = "stair_tpu_torch/ops/csrc/regslots.cu"
    # The single updates are the one-entry case of the same kernels and are
    # not on this path: their times are the one-entry launches of a step in
    # turn (phase 14), their errors those launches' against the plain
    # versions there (equal bits required).
    return [
        {"name": "slot_set", "route": "cuda", "source": source,
         "replaces": "stair_tpu/ops/regslots.py:76",
         "launches": launches["slot_set"],
         "max_abs_err": SEEN["slot_err"]["slot_set"],
         **slot_entries["slot_set"]},
        {"name": "slot_zero", "route": "cuda", "source": source,
         "replaces": "stair_tpu/ops/regslots.py:82",
         "launches": launches["slot_zero"],
         "max_abs_err": SEEN["slot_err"]["slot_zero"],
         **slot_entries["slot_zero"]},
        {"name": "slot_add", "route": "cuda", "source": source,
         "replaces": "stair_tpu/ops/regslots.py:87",
         "launches": launches["slot_add"],
         "max_abs_err": SEEN["slot_err"]["slot_add"],
         **slot_entries["slot_add"]},
        {"name": "slot_set_many", "route": "cuda", "source": source,
         "replaces": "stair_tpu/ops/regslots.py:76",
         "launches": launches["slot_set_many"],
         "max_abs_err": slot_err["slot_set_many"],
         **slot_entries["slot_set_many"]},
        {"name": "slot_zero_many", "route": "cuda", "source": source,
         "replaces": "stair_tpu/ops/regslots.py:82",
         "launches": launches["slot_zero_many"],
         "max_abs_err": slot_err["slot_zero_many"],
         **slot_entries["slot_zero_many"]},
        {"name": "slot_add_many", "route": "cuda", "source": source,
         "replaces": "stair_tpu/ops/regslots.py:87",
         "launches": launches["slot_add_many"],
         "max_abs_err": slot_err["slot_add_many"],
         **slot_entries["slot_add_many"]},
    ]


#: phase 18's world: 48 videos x 8 questions at the NMN train step's
#: widths (64 frames of 1024 features, 300-wide GloVe)
CLI_WORLD = dict(num_videos=48, questions_per_video=8, num_frames=FRAMES,
                 feature_dim=VIDEO_D, glove_dim=TEXT_D, seed=18)
CLI_EPOCHS = 3
#: per eval batch of the trainer and evaluate CLIs: the video, question and
#: class-table encodes on the BiLSTM eval kernel's cluster route (#1) and
#: one executor forward on the eval megakernel's tensor-core route (#4)
EVAL_LAUNCHES = {"bilstm_tc": 3, "mega_exec_tc": 1}


#: epochs of the trainer's own batches that time its inner loop
CLI_TIMED_EPOCHS = 5


def write_world(root, world=CLI_WORLD):
    """A world under ``root`` (``write_agqa_world(**world)``: phase 18's by
    default), written by a child process with a fixed string-hash seed:
    ``make_world`` picks relations and objects by position in lists built
    from sets (``testing/synthetic.py:139-145``, as the JAX original does),
    so its questions otherwise change from one process to the next. Returns
    ``write_agqa_world``'s paths."""
    code = ("import json, sys\n"
            "from stair_tpu_torch.testing.agqa_world import write_agqa_world\n"
            "w = write_agqa_world(sys.argv[1], **json.loads(sys.argv[2]))\n"
            "print(json.dumps(w))\n")
    res = subprocess.run(
        [sys.executable, "-c", code, root, json.dumps(world)],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, env={**os.environ, "PYTHONHASHSEED": "0"})
    require(res.returncode == 0, f"writing the world failed: {res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def time_inner_loop(step, batcher, dev, epochs, warm):
    """The trainer's inner loop: ``step`` over ``epochs`` shuffled epochs
    of ``batcher``'s batches through ``_device_batches``, after one step on
    ``warm``. Returns ms a step by the host clock (synchronized at the
    ends) and by CUDA events, and the steps."""
    from stair_tpu_torch.train import loop

    step(warm, torch.Generator().manual_seed(0), 1.0, 1.0)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    n = 0
    t0 = time.perf_counter()
    ev[0].record()
    for _ in range(epochs):
        for _, bdict in loop._device_batches(batcher, dev, shuffle=True):
            step(bdict, torch.Generator().manual_seed(n), 1.0, 1.0)
            n += 1
    ev[1].record()
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3 / n,
            ev[0].elapsed_time(ev[1]) / n, n)


def hold_cli_batches(dev, argv, out):
    """The main path's kernels on the trainer CLI's own batches, as its
    batcher packs them and its device tables fill them: the world's trace
    geometry and question lengths, real supervision, and padded rows. On
    ``best_model``'s weights, the eval step over the valid split's last
    batch (preds, regs_vec, loss_sums, cos_sum) and one train step on the
    last batch of a shuffled train epoch (loss in bf16 and float32,
    gradients in float32) run on the kernel route against the plain route,
    with the bounds of phases 3, 8 and 16. Then the trainer's inner loop
    (``make_train_step`` with the tables over ``_device_batches``) is timed
    over whole epochs. Returns what phase 18 prints."""
    from stair_tpu_torch.models.nmn import NMNConfig, VideoNMN, tree_map
    from stair_tpu_torch.train import evaluate, loop
    from stair_tpu_torch.utils.device import cuda_time_ms

    args = loop.parse_cli(argv + ["--model-ckpt", f"{out}/best_model"])
    train_ds, valid_ds = loop.load_datasets(args)
    model = evaluate.load_model(args, valid_ds, dev)

    def last_batch(ds, seed, shuffle):
        tables = loop.make_device_tables(ds, dev)
        batcher = loop.make_batcher(args, ds, model, seed=seed,
                                    device_tables=True)
        *_, (batch, bdict) = loop._device_batches(batcher, dev, shuffle)
        return tables, batcher, batch, bdict

    # ---- the eval step: bounds of phases 3 (preds) and 16 (regs_vec);
    # each family's loss sum moves by at most 1e-4 of the total (phase 8's
    # loss bound); the cosine sum by at most 1e-4 a cosine on average (the
    # cosines are of bf16 register values that the routes round at
    # different sites, a step moving one by up to ~1e-3 either way; one
    # Filter output gone wrong moves the sum by O(0.1)); the counts not at
    # all
    vtables, _, vbatch, vdict = last_batch(valid_ds, 0, False)
    eval_step = loop.make_eval_step(model, vtables, keep_regs=True)
    with kernel_route(("bilstm_tc", "mega_exec_tc")) as eval_launches:
        ek = eval_step(vdict)
    with plain_route():
        ep = eval_step(vdict)
    agree = float((ek["preds"] == ep["preds"]).float().mean())
    require(agree >= 0.98, f"CLI eval preds agreement {agree}")
    errs, outside, n_flipped, _, _ = hold_files(
        "CLI eval kernel vs plain", vdict["trace"], ek, ep, ("regs_vec",))
    for k in ("loss_counts", "cos_count"):
        require(torch.equal(ek[k], ep[k]), f"CLI eval {k} {ek[k]} {ep[k]}")
    sums_k, sums_p = ek["loss_sums"].double(), ep["loss_sums"].double()
    loss_err = float((sums_k - sums_p).abs().max() / sums_p.abs().sum())
    n_cos = float(ep["cos_count"])
    cos_err = abs(float(ek["cos_sum"]) - float(ep["cos_sum"])) / max(n_cos, 1)
    require(loss_err <= 1e-4 and cos_err <= 1e-4,
            f"CLI eval loss_sums {sums_k.tolist()} vs {sums_p.tolist()} "
            f"({loss_err:.2e} of the total), cos_sum {float(ek['cos_sum'])} "
            f"vs {float(ep['cos_sum'])} over {n_cos} cosines")

    # ---- one train step on the padded last batch of a shuffled epoch
    ttables, batcher, tbatch, tdict = last_batch(train_ds, args.rand_seed,
                                                 True)
    params = tree_map(lambda x: x.detach().clone(), model.param_tree())
    model32 = VideoNMN(NMNConfig(**{**model.config.to_dict(),
                                    "compute_dtype": "float32"}),
                       params, device=dev)
    step_launches = hold_step_routes(
        "[clis]", ((model32, "float32"), (model, "bfloat16")),
        loop.materialize_batch(tdict, ttables), args.contrastive_window)
    del model32

    # ---- the batcher's packing alone (host), then the trainer's inner
    # loop over whole epochs of its batches
    t0 = time.perf_counter()
    packed = sum(1 for _ in batcher.epoch(shuffle=True))
    pack_ms = (time.perf_counter() - t0) * 1e3 / packed
    step = loop.make_train_step(model, args, tables=ttables)
    host_ms, event_ms, n = time_inner_loop(step, batcher, dev,
                                           CLI_TIMED_EPOCHS, tdict)
    # the same step on one batch that stays on the card, as phase 8 times
    resident_ms = cuda_time_ms(lambda: step(
        tdict, torch.Generator().manual_seed(n), 1.0, 1.0), iters=10,
        warmup=1)
    return dict(eval_real=vbatch.meta["real"], train_real=tbatch.meta["real"],
                batch=len(vbatch.answer), agree=agree, errs=errs,
                outside=outside, n_flipped=n_flipped, loss_err=loss_err,
                cos_err=cos_err, n_cos=n_cos, eval_launches=eval_launches,
                step_launches=step_launches, timed_steps=n, host_ms=host_ms,
                pack_ms=pack_ms, resident_ms=resident_ms, event_ms=event_ms)


def run_clis(dev, root, hidden=HIDDEN, epochs=CLI_EPOCHS):
    """Phase 18's runs on ``dev``: the world under ``root``, the trainer
    (counted), its resume, and evaluate. Returns what the checks read."""
    from stair_tpu_torch.data.dataset import AGQADataset
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.testing.agqa_world import trainer_argv
    from stair_tpu_torch.train import checkpoint as ckpt
    from stair_tpu_torch.train import evaluate, loop

    t0 = time.perf_counter()
    w = write_world(f"{root}/world")
    out = f"{root}/run"
    common = trainer_argv(w, out, "--text-size", str(TEXT_D), "--dropout",
                          "0.25", "--contrastive-window", "32",
                          hidden=hidden, video=VIDEO_D, frames=FRAMES,
                          batch=TRAIN_BATCH)
    args = loop.parse_cli(common)
    paths = loop.data_paths(args)
    sets = [AGQADataset(paths, split, max_video_length=FRAMES)
            for split in ("train", "valid")]
    _, cfg = loop.build_model(args, sets, "cpu")
    cfg["compute_dtype"] = "bfloat16"
    with open(f"{root}/config.json", "w") as f:
        json.dump(cfg, f)
    n_train, n_valid = (sum(t is not None for t in ds.traces) for ds in sets)
    steps = -(-n_train // TRAIN_BATCH)
    eval_batches = -(-n_valid // TRAIN_BATCH)
    world_s = time.perf_counter() - t0
    train_argv = common + ["--config-filename", f"{root}/config.json",
                           "--evaluate-interval", str(steps),
                           "--report-interval", str(steps),
                           "--scheduler-total-iters", "20", "--lr", "1e-3"]

    if dev.type == "cuda":
        torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    quiet(loop.main, train_argv + ["--num-epochs", str(epochs)], device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    with open(f"{out}/metrics.jsonl") as f:
        recs = [json.loads(x) for x in f]
    files = {d: sorted(os.listdir(f"{out}/{d}"))
             for d in ("best_model", "latest")}
    first_state = ckpt.load_trainer_state(f"{out}/latest")

    t0 = time.perf_counter()
    _, resumed = quiet(loop.main, train_argv + [
        "--num-epochs", "1", "--model-ckpt", f"{out}/latest"], device=dev)
    resume_s = time.perf_counter() - t0
    with open(f"{out}/metrics.jsonl") as f:
        after = [json.loads(x) for x in f][len(recs):]
    state = ckpt.load_trainer_state(f"{out}/latest")
    best_state = ckpt.load_trainer_state(f"{out}/best_model")

    eval_argv = common + ["--model-ckpt", f"{out}/best_model",
                          "--test-filename", w["valid"]]
    t0 = time.perf_counter()
    acc, _ = quiet(evaluate.main, eval_argv + ["--evaluate-func", "acc"],
                   device=dev)
    audit, _ = quiet(evaluate.main, eval_argv + [
        "--evaluate-func", "filter_text_result",
        "--filter-answer-vocab-filename", w["filter"],
        "--result-filename", f"{out}/filter.pkl"], device=dev)
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    held = hold_cli_batches(dev, train_argv, out)
    held_s = time.perf_counter() - t0
    return dict(root=root, world=w, common=common,
                best_model=f"{out}/best_model",
                args=loop.parse_cli(train_argv), cfg=cfg, n_train=n_train,
                n_valid=n_valid, steps=steps, eval_batches=eval_batches,
                launches=launches, recs=recs, files=files,
                first_state=first_state, resumed=resumed, after=after,
                state=state, best_state=best_state, acc=acc, audit=audit,
                audit_file=os.path.exists(f"{out}/filter.pkl"),
                world_s=world_s, train_s=train_s, resume_s=resume_s,
                eval_s=eval_s, held=held, held_s=held_s)


def phase_clis(dev, card):
    """Phase 18. Returns ``run_clis``' readings, the world and the trained
    checkpoint under ``["root"]`` (phase 19 reads them; the caller removes
    the directory, which a failure removes here)."""
    import tempfile

    root = tempfile.mkdtemp(prefix="stair_clis_")
    try:
        return check_clis(card, run_clis(dev, root))
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise


def require_loss_falls(reports):
    """A trainer's report lines (``metrics.jsonl`` lines with
    ``loss/total``): every loss finite, and the answer loss and the mean
    module-family loss falling from the first report to the last. Returns
    the first and last reports and the families both hold."""
    losses = [x["loss/total"] for x in reports]
    require(all(np.isfinite(losses)), f"non-finite loss {losses}")
    # loss/total sums the module losses over each example's supervised
    # steps, so a window's value moves with its batches' supervision
    # density (the padded last batch of an epoch repeats its few examples);
    # the answer loss and the per-family means are per example and per
    # supervised step, and must fall from the first report to the last
    first, last = reports[0], reports[-1]
    shared = [n for n in first if n.startswith("loss/") and n in last
              and n not in ("loss/total", "loss/decoder")]
    fell = (last["loss/decoder"] < first["loss/decoder"],
            np.mean([last[n] for n in shared])
            < np.mean([first[n] for n in shared]))
    require(all(fell), "the answer loss / the mean module-family loss did "
            f"not fall: {[(x['step'], x['loss/decoder']) for x in reports]}, "
            f"{first} -> {last}")
    return first, last, shared


def check_clis(card, r):
    """Phase 18's checks and prints on ``run_clis``' readings ``r``."""
    from stair_tpu_torch.train.loop import lr_schedule

    steps, epochs = r["steps"], CLI_EPOCHS
    recs = r["recs"]
    evals = [x for x in recs if "valid/acc" in x]
    reports = [x for x in recs if "loss/total" in x]
    total_steps = steps * epochs
    require(r["first_state"]["step"] == total_steps,
            f"trainer state step {r['first_state']['step']} != {total_steps}")
    require(len(evals) == epochs + 1, f"{len(evals)} evaluations")
    n_eval = len(evals) * r["eval_batches"]
    want = {k: n * total_steps for k, n in TRAIN_LAUNCHES.items()}
    for k, n in EVAL_LAUNCHES.items():
        want[k] = want.get(k, 0) + n * n_eval
    require_launches("CLI", r["launches"], want)
    losses = [x["loss/total"] for x in reports]
    first, last, shared = require_loss_falls(reports)
    for d, names in r["files"].items():
        require({"params.msgpack", "config.json", "opt_state.msgpack",
                 "trainer_state.json"} <= set(names), f"{d}: {names}")
    names = set().union(*recs)
    fams = sorted(n for n in names if n.startswith("loss/")
                  and n != "loss/total")
    require({"loss/total", "lr/lr", "valid/acc"} <= names and fams,
            f"metric names {sorted(names)}")

    # the resume: state restored, steps adding up, the schedule continued
    require("optimizer state restored" in r["resumed"],
            "the resume did not restore the optimizer state")
    require(r["state"]["step"] == total_steps + steps,
            f"resumed step {r['state']['step']} != {total_steps + steps}")
    sched = lr_schedule(r["args"])
    after = [x for x in r["after"] if "lr/lr" in x]
    require(after and all(x["lr/lr"] == sched(x["step"]) for x in after),
            f"lr after the resume {[(x['step'], x['lr/lr']) for x in after]}")

    # evaluate on best_model over the valid split: the trainer's best
    best = r["best_state"]["best_acc"]
    require(r["acc"] == best, f"evaluate acc {r['acc']} != the trainer's "
            f"best valid acc {best}")
    require(r["audit_file"] and r["audit"], "no Filter audit")

    log(f"[clis] world: {r['n_train']} train / {r['n_valid']} valid "
        f"questions, {steps} steps an epoch at B={TRAIN_BATCH} "
        f"(world {r['world_s']:.1f} s); config "
        f"{json.dumps(r['cfg'])}")
    log(f"[clis] train.loop.main, {epochs} epochs = {total_steps} steps + "
        f"{len(evals)} evaluations x {r['eval_batches']} batch: loss by "
        f"report {[round(x, 4) for x in losses]} (families "
        f"{[f[5:] for f in fams]}); answer loss "
        f"{[round(x['loss/decoder'], 4) for x in reports]}, mean of "
        f"{len(shared)} module-family losses "
        f"{np.mean([first[n] for n in shared]):.4f} -> "
        f"{np.mean([last[n] for n in shared]):.4f}; valid acc "
        f"{[round(x['valid/acc'], 4) for x in evals]}; launches "
        f"{ {k: v for k, v in r['launches'].items() if v} } = "
        f"{total_steps} x TRAIN_LAUNCHES + {n_eval} x {EVAL_LAUNCHES}; "
        f"{r['train_s']:.1f} s")
    h = r["held"]
    log(f"[clis] the CLI's own batches, kernel vs plain route on best_model's"
        f" weights: eval step on the valid split's last batch ({h['eval_real']}"
        f" of {h['batch']} rows real) preds agreement {h['agree']:.4f} (bound"
        f" 0.98), regs_vec max_abs_err {h['errs']['regs_vec']:.3e} with "
        f"{h['outside']['regs_vec']} elements outside atol 3e-2 + rtol 1e-2 "
        f"({h['n_flipped']} Choose flips), loss_sums {h['loss_err']:.2e} of "
        f"their total (bound 1e-4), cos_sum {h['cos_err']:.2e} a cosine over "
        f"{h['n_cos']:.0f} (bound 1e-4), counts equal, launches "
        f"{h['eval_launches']}; one train step on the last "
        f"train batch of a shuffled epoch ({h['train_real']} rows real), "
        f"launches {h['step_launches']} ({r['held_s']:.1f} s)")
    log(f"[clis] the trainer's inner loop (make_train_step with its device "
        f"tables over _device_batches), {CLI_TIMED_EPOCHS} epochs = "
        f"{h['timed_steps']} steps: {h['host_ms']:.3f} ms a step by the host "
        f"clock (synchronized at the ends), {h['event_ms']:.3f} by CUDA "
        f"events, {1e3 / h['host_ms']:.3f} steps/s; the batcher packs a "
        f"batch in {h['pack_ms']:.3f} ms on the host; the step on one of "
        f"these batches left on the card {h['resident_ms']:.3f} ms (CUDA "
        f"events); phase 8's "
        f"make_train_step on one resident batch "
        f"{SEEN.get('mega_train_ms', float('nan')):.3f} ms (CUDA events); "
        f"card {card}")
    log(f"[clis] smoke readings of the trainer's last 3-step report window "
        f"(a padded batch, an evaluation and two saves in it; no per-step "
        f"cost): perf/step_ms_p50 "
        f"{last.get('perf/step_ms_p50', float('nan')):.3f}, "
        f"perf/step_event_ms "
        f"{last.get('perf/step_event_ms', float('nan')):.3f}, "
        f"perf/steps_per_sec {last['perf/steps_per_sec']:.3f}; card {card}")
    log(f"[clis] resume from latest/ for 1 epoch: optimizer state restored, "
        f"step {r['first_state']['step']} -> {r['state']['step']}, lr/lr "
        f"{[(x['step'], x['lr/lr']) for x in after]} = lr_schedule(step) "
        f"({r['resume_s']:.1f} s)")
    log(f"[clis] train.evaluate.main on best_model/ over the valid split: "
        f"acc {r['acc']:.4f} = the trainer's best {best:.4f}; "
        f"filter_text_result for {len(r['audit'])} questions "
        f"({r['eval_s']:.1f} s)")
    return r


#: phase 19: the LSTM program parser at the parser CLI's defaults (embed
#: 256, hidden 256: the BiLSTM at h 128 per direction, S 32, T 48, float32)
#: on phase 18's world, batches of 64, 2 epochs; decode in chunks of 256
#: questions x beam 5
PARSER_EPOCHS, PARSER_BATCH, DECODE_CHUNK, BEAM = 2, 64, 256, 5
#: parser train steps timed after the counted run
PARSER_TIMED_STEPS = 12


def hold_parser_kernels(dev, model, src, mask):
    """#2 + #3 on one training batch and #1 on one decode chunk, as the
    parser's encoder gives them the inputs (the CLI's own batch and chunk,
    the trained weights): each kernel twice (equal bits) against its plain
    version, the forward's float32 cluster route against its general route
    (equal bits on every output), the backward's float32 cluster route
    against its general route (1e-4, and equal bits at the rows' first
    valid walk steps) and equal on either forward's stacks, then timed
    beside the general route, the plain version and ``nn.LSTM``.
    ``src``/``mask``: {"train": ..., "decode": ...}. Returns per kernel
    (error, ms, general ms, plain ms, bound, library ms)."""
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import lstm as OL
    from stair_tpu_torch.utils.device import cuda_time_ms

    from stair_tpu_torch.weights import tree_map

    p = tree_map(lambda t: t.detach(), model.param_tree())
    out = {}
    gen = torch.Generator().manual_seed(19)
    with torch.no_grad():
        args = {k: OL._prep(p["encoder"], p["src_embed"][src[k]], mask[k])
                for k in src}
    for k, a in args.items():
        require(OL.fwd_route(a[0].dtype, a[0].shape[-1] // 4) == "cluster32"
                and OL.bwd_route(a[0].dtype, a[0].shape[-1] // 4)
                == "cluster32", f"parser {k}: not the float32 cluster "
                "forward and backward")
    B, L, G = args["train"][0].shape
    h = G // 4

    def on_both(call, key):
        """``call()`` twice on the float32 cluster route (equal bits, two
        launches of ``key`` + "_f32c" and no other) and once on the general
        route (equal bits). Returns the first output."""
        _build.reset_launches()
        k1, k2 = call(), call()
        torch.cuda.synchronize()
        require_launches(f"parser {key}", dict(_build.LAUNCHES),
                         {key + "_f32c": 2})
        with general_lstm_fwd():
            g = call()
        for other, what in ((k2, "two launches differ"),
                            (g, "the float32 cluster route differs from "
                                "the general route")):
            require(all(torch.equal(x, y) for x, y in zip(
                lstm_flat(k1), lstm_flat(other))), f"parser {key}: {what}")
        return k1, g

    # ---- #2 and #3 on the training batch: f32 1e-4 forward (max abs) and
    # backward (max |a - b| / max |b|), PERF.md section 2's BiLSTM bounds
    a = args["train"]
    k1, g1 = on_both(lambda: OL.bilstm_train_call(*a), "bilstm_train")
    fk = lstm_flat(k1)
    ref = OL.bilstm_reference(*a, return_stacks=True)
    e_fwd = max_err(fk, lstm_flat(ref))
    require(e_fwd <= 1e-4, f"parser #2 vs plain: {e_fwd:.3e}")
    cot = [torch.randn(B, L, h, generator=gen).to(dev) for _ in range(2)]
    cot.append(torch.randn(B, 2 * h, generator=gen).to(dev))
    _build.reset_launches()
    b1 = OL.bilstm_bwd_call(*a, k1[3], *cot)
    b2 = OL.bilstm_bwd_call(*a, k1[3], *cot)
    torch.cuda.synchronize()
    require_launches("parser #3", dict(_build.LAUNCHES), {
        "bilstm_bwd_f32c": 2, "bilstm_dwh_f32c": 2, "bilstm_dwh_sum": 2})
    bg = OL.bilstm_bwd_call(*a, g1[3], *cot)
    require(all(torch.equal(x, y) for x, y in zip(b1, b2)),
            "parser #3: two launches differ")
    require(all(torch.equal(x, y) for x, y in zip(b1, bg)),
            "parser #3: other bits on the general forward's stacks")
    bref = OL.bilstm_bwd_reference(*a, k1[3], *cot)
    e_bwd = max(rel_err(x, y) for x, y in zip(b1, bref))
    require(e_bwd <= 1e-4, f"parser #3 vs plain: {e_bwd:.3e}")
    with general_lstm_bwd():
        bgen = OL.bilstm_bwd_call(*a, k1[3], *cot)
    check_f32_bwd("parser #3", b1, bgen, a[2])

    # ---- #1 on the decode chunk
    d = args["decode"]
    o1, _ = on_both(lambda: OL.bilstm(*d), "bilstm")
    e_eval = max_err(o1, OL.bilstm_reference(*d))
    require(e_eval <= 1e-4, f"parser #1 vs plain: {e_eval:.3e}")

    # ---- times, bounds and the library call at these shapes
    D = p["src_embed"].shape[1]
    lib_fwd, lib_bwd = lstm_library_ms(B, L, D, h, dev, torch.float32,
                                       train=True)
    lib_eval, _ = lstm_library_ms(d[0].shape[0], L, D, h, dev,
                                  torch.float32)

    def general_ms(fn):
        with general_lstm_fwd():
            return cuda_time_ms(fn)

    out["bilstm_train_f32c"] = dict(
        err=e_fwd, ms=cuda_time_ms(lambda: OL.bilstm_train_call(*a)),
        general_ms=general_ms(lambda: OL.bilstm_train_call(*a)),
        plain_ms=cuda_time_ms(lambda: OL.bilstm_reference(
            *a, return_stacks=True), iters=3, warmup=1),
        bound=lstm_bound(a, k1[:3], extra=k1[3]), library_ms=lib_fwd,
        tile=lstm_tile(dev, "cluster32", B, h))
    def general_bwd_ms(fn):
        with general_lstm_bwd():
            return cuda_time_ms(fn)

    out["bilstm_bwd_f32c"] = dict(
        err=e_bwd, ms=cuda_time_ms(lambda: OL.bilstm_bwd_call(
            *a, k1[3], *cot)),
        general_ms=general_bwd_ms(lambda: OL.bilstm_bwd_call(
            *a, k1[3], *cot)),
        plain_ms=cuda_time_ms(lambda: OL.bilstm_bwd_reference(
            *a, k1[3], *cot), iters=3, warmup=1),
        bound=lstm_bound(a, b1, passes=3, extra=(k1[3], cot)),
        library_ms=lib_bwd, tile=OL.bwd_tile(B, OL._bwd_clusters_held(dev, h)))
    out["bilstm_f32c"] = dict(
        err=e_eval, ms=cuda_time_ms(lambda: OL.bilstm(*d)),
        general_ms=general_ms(lambda: OL.bilstm(*d)),
        plain_ms=cuda_time_ms(lambda: OL.bilstm_reference(*d), iters=3,
                              warmup=1),
        bound=lstm_bound(d, o1), library_ms=lib_eval,
        tile=lstm_tile(dev, "cluster32", d[0].shape[0], h))
    return out


def phase_parser(dev, card, clis):
    """Phase 19: the program parser's CLI on phase 18's world, its kernels
    held and timed at its shapes, and the parse -> NMN loop."""
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.programs import preprocess as PP
    from stair_tpu_torch.seq2seq import train as PC
    from stair_tpu_torch.seq2seq.vocab import BOS
    from stair_tpu_torch.train import evaluate

    t_phase = time.perf_counter()
    w, root = clis["world"], clis["root"]
    pdir, tsv = f"{root}/parser", f"{root}/parser/gen_valid.tsv"
    gen_pkl = f"{root}/valid_generated.pkl"
    train_pairs = PC.load_pairs(w["train"])
    valid_pairs = PC.load_pairs(w["valid"])
    n_train, n_valid = len(train_pairs), len(valid_pairs)
    require(n_train >= DECODE_CHUNK, f"{n_train} parser pairs")
    bs = min(PARSER_BATCH, n_train)
    steps = PARSER_EPOCHS * (n_train // bs)
    words = ["--arch", "lstm", "--train-filename", w["train"],
             "--valid-filename", w["valid"], "--output", pdir,
             "--num-epochs", str(PARSER_EPOCHS), "--batch-size",
             str(PARSER_BATCH), "--report-interval", "1000",
             "--device", str(dev)]

    # ---- the counted main-path runs: the train CLI (its steps, then the
    # valid split's exact match in chunks of the batch size), then the
    # predict CLI over the valid split in chunks of 256, beam 5
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    _, train_log = quiet(PC.main, ["--func", "train", *words])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = dict(_build.LAUNCHES)
    chunks = -(-n_valid // min(PARSER_BATCH, n_valid))
    require_launches("parser train CLI", train_launches, {
        "bilstm_train_f32c": steps, "bilstm_bwd_f32c": steps,
        "bilstm_dwh_f32c": steps, "bilstm_dwh_sum": steps,
        "bilstm_f32c": chunks})
    em = float(train_log.split("valid exact-match (top beam):")[1].split()[0])

    _build.reset_launches()
    t0 = time.perf_counter()
    quiet(PC.main, ["--func", "predict", *words, "--model-dir", pdir,
                    "--test-filename", w["valid"], "--result-filename", tsv,
                    "--batch-size", str(DECODE_CHUNK), "--beam-size",
                    str(BEAM)])
    predict_s = time.perf_counter() - t0
    predict_launches = dict(_build.LAUNCHES)
    predict_chunks = -(-n_valid // min(DECODE_CHUNK, n_valid))
    require_launches("parser predict CLI", predict_launches,
                     {"bilstm_f32c": predict_chunks})
    with open(tsv) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    require(len(rows) == BEAM * n_valid and all(len(r) == 3 for r in rows),
            f"the TSV has {len(rows)} rows for {n_valid} questions")
    (top1, any_beam), _ = quiet(PC.main, ["--func", "check_valid",
                                          "--result-filename", tsv,
                                          "--device", str(dev)])

    # ---- the loop: merge the programs, answer with phase 18's checkpoint
    quiet(PP.main, ["--func", "upgrade", "--generated-format",
                    "huggingface", "--src-data-filename", w["valid"],
                    "--dest-data-filename", gen_pkl,
                    "--generated-filename", tsv])
    eval_argv = clis["common"] + [
        "--model-ckpt", clis["best_model"], "--test-filename", gen_pkl,
        "--evaluate-func", "acc", "--result-filename",
        "valid_generated_preds.json"]
    _build.reset_launches()
    acc_gen, eval_log = quiet(evaluate.main, eval_argv, device=dev)
    eval_launches = dict(_build.LAUNCHES)
    with open(os.path.join(os.path.dirname(clis["best_model"]),
                           "valid_generated_preds.json")) as f:
        answered = len(json.load(f)["preds"])
    n_batches = -(-answered // TRAIN_BATCH)
    require(answered > 0, f"evaluate answered nothing: {eval_log[-300:]}")
    require_launches("evaluate on generated programs", eval_launches, {
        k: n * n_batches for k, n in EVAL_LAUNCHES.items()})

    # ---- the kernels on the CLI's own inputs: the first batch of its
    # first epoch (np.random.RandomState(seed 0)), a chunk of 256 questions
    model, sv, tv = PC.load_parser(pdir, dev)
    cfg = model.config
    args = types.SimpleNamespace(max_src_len=cfg.max_src_len,
                                 max_tgt_len=cfg.max_tgt_len)
    data = PC.train_arrays(train_pairs, sv, tv, args, BOS, dev)
    idx = torch.from_numpy(PC.epoch_batches(np.random.RandomState(0),
                                            n_train, bs)[0]).to(dev)
    t0 = time.perf_counter()
    held = hold_parser_kernels(
        dev, model, {"train": data[0][idx], "decode": data[0][:DECODE_CHUNK]},
        {"train": data[1][idx], "decode": data[1][:DECODE_CHUNK]})
    held_s = time.perf_counter() - t0

    # ---- ms a parser train step (the CLI's step function on its batches)
    # and decode q/s on one chunk of 256 (beam 5), after a warm pass
    step = PC.make_step(model, PC.make_optimizer(model, 1e-3))
    batches = PC.epoch_batches(np.random.RandomState(1), n_train, bs)
    step(*(x[idx] for x in data))
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(PARSER_TIMED_STEPS):
        b = torch.from_numpy(batches[i % len(batches)]).to(dev)
        step(*(x[b] for x in data))
    ev[1].record()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / PARSER_TIMED_STEPS
    step_event_ms = ev[0].elapsed_time(ev[1]) / PARSER_TIMED_STEPS
    dargs = types.SimpleNamespace(batch_size=DECODE_CHUNK, beam_size=BEAM,
                                  max_src_len=cfg.max_src_len,
                                  max_tgt_len=cfg.max_tgt_len)
    chunk = train_pairs[:DECODE_CHUNK]
    list(PC.decode_beams(model, sv, tv, chunk, dargs))
    t0 = time.perf_counter()
    list(PC.decode_beams(model, sv, tv, chunk, dargs))
    decode_qps = DECODE_CHUNK / (time.perf_counter() - t0)
    phase_s = time.perf_counter() - t_phase

    log(f"[parser] seq2seq.train --arch lstm at the CLI's widths (embed "
        f"{cfg.embed_dim}, hidden {cfg.hidden}: BiLSTM h "
        f"{cfg.hidden // 2}, S {cfg.max_src_len}, T {cfg.max_tgt_len}, "
        f"float32) on phase 18's world: {n_train} train / {n_valid} valid "
        f"pairs, src vocab {len(sv)}, tgt vocab {len(tv)}, "
        f"{sum(p.numel() for p in model.parameters())} parameters; "
        f"{PARSER_EPOCHS} epochs = {steps} steps of B {bs} in "
        f"{train_s:.1f} s, valid exact match {em:.4f}; launches "
        f"{ {k: v for k, v in train_launches.items() if v} } = {steps} x "
        "(bilstm_train_f32c + bilstm_bwd_f32c + bilstm_dwh_f32c + "
        "bilstm_dwh_sum) + "
        f"{chunks} x bilstm_f32c (the exact-match decode), nothing else")
    log(f"[parser] predict over the valid split, chunks of {DECODE_CHUNK}, "
        f"beam {BEAM}: {predict_s:.2f} s, launches "
        f"{ {k: v for k, v in predict_launches.items() if v} } = "
        f"{predict_chunks} x bilstm_f32c; check_valid top-beam {top1:.4f}, "
        f"any-beam {any_beam:.4f}; preprocess --func upgrade, then "
        f"train.evaluate on phase 18's best_model over the generated "
        f"programs: acc {acc_gen:.4f} on {answered} of {n_valid} questions "
        f"(gold programs: {clis['acc']:.4f}), launches "
        f"{ {k: v for k, v in eval_launches.items() if v} } = "
        f"{n_batches} x {EVAL_LAUNCHES}")
    for k, shape in (("bilstm_train_f32c", f"B {bs}"),
                     ("bilstm_bwd_f32c", f"B {bs}"),
                     ("bilstm_f32c", f"B {DECODE_CHUNK}")):
        x = held[k]
        bwd = k == "bilstm_bwd_f32c"
        route = (f"float32 cluster route (batch tile {x['tile']}; "
                 + ("within 1e-4 of the general route, its first valid "
                    "steps' dxp bit for bit" if bwd else
                    "bit for bit the general route's outputs")
                 + f"; general route {x['general_ms']:.4f} ms)")
        log(f"[parser] {k} {route} at {shape}, L {cfg.max_src_len}, h "
            f"{cfg.hidden // 2}, float32, the CLI's own inputs: "
            f"{'max |a-b| / max |b|' if bwd else 'max_abs_err'}"
            f" {x['err']:.3e} (bound 1e-4), two launches bit-identical; "
            f"{x['ms']:.4f} ms, plain {x['plain_ms']:.3f} ms, bound "
            f"{x['bound']['bound_ms']:.4f} ms ({x['bound']['bound_by']}), "
            f"nn.LSTM {x['library_ms']:.4f} ms; card {card}")
    log(f"[parser] a train step (the CLI's step function, B {bs}): "
        f"{step_ms:.3f} ms by the host clock (synchronized at the ends), "
        f"{step_event_ms:.3f} by CUDA events over {PARSER_TIMED_STEPS} "
        f"steps; decode {decode_qps:.1f} questions/s (one chunk of "
        f"{DECODE_CHUNK}, beam {BEAM}, host clock); kernels held in "
        f"{held_s:.1f} s; phase {phase_s:.1f} s; card {card}")
    src = "stair_tpu_torch/ops/csrc/bilstm.cu"
    launches = {"bilstm_f32c": train_launches["bilstm_f32c"]
                + predict_launches["bilstm_f32c"],
                "bilstm_train_f32c": train_launches["bilstm_train_f32c"],
                "bilstm_bwd_f32c": train_launches["bilstm_bwd_f32c"]}
    sites = {"bilstm_f32c": "stair_tpu/ops/lstm.py:136",
             "bilstm_train_f32c": "stair_tpu/ops/lstm.py:583",
             "bilstm_bwd_f32c": "stair_tpu/ops/lstm.py:390"}
    # the backward's entry times its three launches together (the walk,
    # the dwh slices, their sum), as the bf16 route's entry does
    extra = {"bilstm_bwd_f32c": {
        "dwh_launches": train_launches["bilstm_dwh_f32c"],
        "sum_launches": train_launches["bilstm_dwh_sum"]}}
    return [{"name": k, "route": "cuda", "path": "parser",
             "source": src, "replaces": sites[k], "launches": launches[k],
             **extra.get(k, {}),
             "max_abs_err": held[k]["err"], "ms": held[k]["ms"],
             "general_ms": held[k]["general_ms"],
             "plain_ms": held[k]["plain_ms"], **held[k]["bound"],
             "library_ms": held[k]["library_ms"]}
            for k in ("bilstm_f32c", "bilstm_train_f32c", "bilstm_bwd_f32c")]


def _http(port, path, payload=None):
    """``(status, JSON)`` of a GET (``payload`` None) or a POST to the
    demo server on ``127.0.0.1:port``."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def phase_demo(dev, card, model):
    """Phase 20: the demo server over phase 10's full-width model."""
    import threading
    from http.server import ThreadingHTTPServer

    from stair_tpu_torch.llm.videochat import KeywordsStoppingCriteria
    from stair_tpu_torch.llm.videochat_infer import build_prompt_batch
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.serve.demo import (
        ChatBackend, LatencyTracker, make_handler,
    )
    from stair_tpu_torch.serve.logutil import moderation_msg
    from stair_tpu_torch.testing import videochat as VW

    tokenizer = VW.tokenizer()
    backend = ChatBackend(model, tokenizer=tokenizer, num_frames=VW.FRAMES)
    n_layers = model.config.decoder.num_layers
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                make_handler(backend, LatencyTracker()))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    saved = os.environ.pop("MODERATION_BLOCKLIST", None)
    try:
        frames = VW.frame_sets(seed=20)[0]          # [100, 240, 320, 3]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sid = backend.open_frames(frames, "seeded-frames")
        torch.cuda.synchronize()
        encode_ms = (time.perf_counter() - t0) * 1e3
        vt = backend.sessions[sid]["video_tokens"]
        require(vt.shape == (model.config.video_token_len,
                             model.config.vision.d_model)
                and bool(torch.isfinite(vt.float()).all()),
                f"session video tokens {tuple(vt.shape)}")
        turn_ms, replies, served = [], [], []
        # keep the token ids each turn generates (the tokenizer reads most
        # of a random model's 32,000 ids as <unk>, so the strings alone
        # would hide a difference)
        generate = model.generate
        model.generate = lambda *a, **k: served.append(generate(*a, **k)) \
            or served[-1]
        for i, msg in enumerate(DEMO_TURNS):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            code, out = _http(port, "/api/chat",
                              {"session_id": sid, "message": msg})
            torch.cuda.synchronize()
            turn_ms.append((time.perf_counter() - t0) * 1e3)
            require(code == 200 and isinstance(out.get("reply"), str),
                    f"demo turn {i}: {code} {out}")
            require_launches(f"demo turn {i}", dict(_build.LAUNCHES),
                             {"flash_attn": n_layers})
            # the same prompt and generator seed straight through generate
            ids, start, plen, stop = build_prompt_batch(
                model, tokenizer, [msg])
            toks = generate(
                ids, vt[None], start, prompt_len=plen, max_new_tokens=64,
                temperature=0.2,
                generator=torch.Generator(device=dev).manual_seed(i),
                eos_id=tokenizer.eos_token_id)
            want = KeywordsStoppingCriteria([stop], tokenizer, 0).truncate(
                tokenizer.decode(toks[0].cpu().numpy()))
            require(len(served) == i + 1 and torch.equal(served[i], toks)
                    and out["reply"] == want,
                    f"demo turn {i}: reply {out['reply']!r} != direct "
                    f"generate {want!r}, or other token ids")
            replies.append(out["reply"])
        os.environ["MODERATION_BLOCKLIST"] = DEMO_BLOCKED
        _build.reset_launches()
        code, out = _http(port, "/api/chat", {
            "session_id": sid, "message": f"please say {DEMO_BLOCKED} now"})
        require(code == 200 and out == {"reply": moderation_msg,
                                        "flagged": True},
                f"moderation: {code} {out}")
        require(not any(_build.LAUNCHES.values()),
                f"a flagged message launched {_build.LAUNCHES}")
        code, sessions = _http(port, "/api/sessions")
        require(code == 200 and sessions == {sid: {
            "video": "seeded-frames", "turns": len(DEMO_TURNS)}},
            f"sessions {sessions}")
        code, stats = _http(port, "/api/stats")
        require(code == 200 and stats["chat"]["count"] == len(DEMO_TURNS),
                f"stats {stats}")
    finally:
        model.__dict__.pop("generate", None)
        if saved is None:
            os.environ.pop("MODERATION_BLOCKLIST", None)
        else:
            os.environ["MODERATION_BLOCKLIST"] = saved
        httpd.shutdown()
        httpd.server_close()
    log(f"[demo] Llama-7B + ViT-L/14 bf16 behind serve/demo.py on "
        f"127.0.0.1:{port}: session on {VW.FRAMES} seeded frames encoded in "
        f"{encode_ms:.1f} ms (host clock, synchronized: resize, CLIP tower, "
        f"pooling); {len(DEMO_TURNS)} turns through POST /api/chat at "
        f"temperature 0.2, 64 new tokens: "
        f"{[round(t, 1) for t in turn_ms]} ms a turn (host clock, request "
        f"to answer); {n_layers} flash_attn launches a turn, nothing else; "
        f"token ids and replies equal to direct generate's; moderation "
        f"reply with no "
        f"launch; /api/stats chat p50 {stats['chat']['p50_ms']:.1f} ms, "
        f"p99 {stats['chat']['p99_ms']:.1f} ms; replies "
        f"{[r[:24] for r in replies]}; card {card}")


def phase_data_parallel(dev, card, clis):
    """Phase 21: data parallel on one card, two ranks over gloo."""
    from stair_tpu_torch.models.nmn import NMNConfig
    from stair_tpu_torch.parallel.mesh import launch, use_data_parallel
    from stair_tpu_torch.testing import workload as W
    from stair_tpu_torch.testing.dp import train_cases, train_steps
    from stair_tpu_torch.train import evaluate, loop
    from stair_tpu_torch.weights import flatten_tree, params_to_numpy

    devices = [dev] * DP_RANKS
    log(f"[dp] {torch.cuda.device_count()} card(s) on this machine: "
        f"{DP_RANKS} ranks share {dev} over gloo (parallel.mesh.launch "
        f"with an explicit device list); NCCL across cards is not run here")
    base = W.workload_config(hidden_size=HIDDEN, video_size=VIDEO_D,
                             text_size=TEXT_D, max_video_length=FRAMES)
    cfg = NMNConfig(**{**base.to_dict(), "compute_dtype": "bfloat16",
                       "dropout": 0.0})
    cfg32 = NMNConfig(**{**cfg.to_dict(), "compute_dtype": "float32"})
    # the global batch and the weights are made here, before any rank runs
    batch = W.add_fake_supervision(
        W.make_batch(cfg, batch_size=TRAIN_BATCH, question_len=QUESTION_LEN),
        cfg)
    params = params_to_numpy(W.build_model(cfg, seed=0))
    args = loop.trainer_defaults(batch_size=TRAIN_BATCH)   # window 32
    require(use_data_parallel(args, DP_RANKS), "use_data_parallel")
    calls = [dict(cfg_dict=cfg.to_dict(), params=params, batch=batch,
                  args=args, steps=DP_STEPS),
             dict(cfg_dict=cfg32.to_dict(), params=params, batch=batch,
                  args=args, steps=1),
             dict(cfg_dict=cfg.to_dict(), params=params, batch=batch,
                  args=args, steps=0, eval_batch=batch)]
    t0 = time.perf_counter()
    ranks = launch(train_cases, DP_RANKS, devices, "gloo", args=(calls,))
    launch_s = time.perf_counter() - t0
    one = [train_steps(None, **c, device=dev) for c in calls]

    bf, f32, ev = (0, 1, 2)
    for r, res in enumerate(ranks):
        for s, got in enumerate(res[bf]["launches"]):
            require_launches(f"[dp] rank {r} step {s}", got, TRAIN_LAUNCHES)
        require_launches(f"[dp] rank {r} float32 step",
                         res[f32]["launches"][0], TRAIN_LAUNCHES_F32)
        require(all(np.isfinite(res[bf]["loss"])), f"loss {res[bf]['loss']}")
    for case in (bf, f32):
        require(ranks[0][case]["digest"] == ranks[1][case]["digest"],
                "the ranks' parameters differ after a step")
    l_dp, l_one = ranks[0][bf]["loss"][0], one[bf]["loss"][0]
    require(abs(l_dp - l_one) <= 1e-4 * abs(l_one),
            f"[dp] bf16 loss {l_dp} vs one process {l_one}")
    l32_dp, l32_one = ranks[0][f32]["loss"][0], one[f32]["loss"][0]
    require(abs(l32_dp - l32_one) <= 1e-4 * abs(l32_one),
            f"[dp] float32 loss {l32_dp} vs one process {l32_one}")
    # the per-family loss sums the ranks summed, against one process: each
    # within 1e-4 of their total (phase 8's loss bound), the counts equal
    sums_err = 0.0
    for case in (bf, f32):
        for r, res in enumerate(ranks):
            for k in ("loss_sums", "loss_counts"):
                require(np.array_equal(res[case][k][0], ranks[0][case][k][0]),
                        f"[dp] rank {r} {k} differs from rank 0's")
        require(np.array_equal(ranks[0][case]["loss_counts"][0],
                               one[case]["loss_counts"][0]),
                f"[dp] step loss_counts {ranks[0][case]['loss_counts'][0]} "
                f"vs one process {one[case]['loss_counts'][0]}")
        s_dp = ranks[0][case]["loss_sums"][0].astype(np.float64)
        s_one = one[case]["loss_sums"][0].astype(np.float64)
        err = float(np.abs(s_dp - s_one).max() / np.abs(s_one).sum())
        require(err <= 1e-4, f"[dp] step loss_sums {s_dp.tolist()} vs one "
                f"process {s_one.tolist()} ({err:.2e} of the total)")
        sums_err = max(sums_err, err)
    g_dp = flatten_tree(ranks[0][f32]["grads"])
    g_one = flatten_tree(one[f32]["grads"])
    rels = {k: float(np.linalg.norm(g_dp[k] - g_one[k]))
            / max(float(np.linalg.norm(g_one[k])), 1e-30)
            for k in g_one if np.abs(g_one[k]).max() > 0}
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    require(worst[0][1] <= 1e-2, f"[dp] float32 gradient leaves {worst}")
    # the eval step: the gathered predictions equal one process's in
    # example order on both ranks; the summed loss sums and cosine sum by
    # phase 18's bounds (1e-4 of the total, 1e-4 a cosine), the counts equal
    e_dp, e_one = ranks[0][ev]["eval"], one[ev]["eval"]
    answer = batch["answer"]
    acc_dp = float(np.mean(e_dp["preds"] == answer))
    acc_one = float(np.mean(e_one["preds"] == answer))
    for r, res in enumerate(ranks):
        require(np.array_equal(res[ev]["eval"]["preds"], e_one["preds"]),
                f"[dp] rank {r}'s gathered eval predictions differ from one "
                f"process's on "
                f"{int(np.sum(res[ev]['eval']['preds'] != e_one['preds']))} "
                f"of {len(e_one['preds'])} rows")
    for k in ("loss_counts", "cos_count"):
        require(np.array_equal(e_dp[k], e_one[k]),
                f"[dp] eval {k} {e_dp[k]} vs one process {e_one[k]}")
    es_dp = e_dp["loss_sums"].astype(np.float64)
    es_one = e_one["loss_sums"].astype(np.float64)
    eval_err = float(np.abs(es_dp - es_one).max() / np.abs(es_one).sum())
    cos_err = (abs(float(e_dp["cos_sum"]) - float(e_one["cos_sum"]))
               / max(float(e_one["cos_count"]), 1))
    require(eval_err <= 1e-4 and cos_err <= 1e-4,
            f"[dp] eval loss_sums {es_dp.tolist()} vs {es_one.tolist()} "
            f"({eval_err:.2e} of the total), cos_sum {float(e_dp['cos_sum'])} "
            f"vs {float(e_one['cos_sum'])} over {float(e_one['cos_count'])} "
            f"cosines")
    ms = [float(np.mean(res[bf]["ms"][1:])) for res in ranks]
    log(f"[dp] phase 8's configuration at dropout 0, B {TRAIN_BATCH} on "
        f"{DP_RANKS} ranks ({TRAIN_BATCH // DP_RANKS} a rank), window "
        f"{args.contrastive_window}: launches per rank per step "
        f"TRAIN_LAUNCHES exactly (float32: TRAIN_LAUNCHES_F32); parameters equal bit for bit on both ranks "
        f"after each of {DP_STEPS} steps; bf16 loss {l_dp:.6f} vs one "
        f"process {l_one:.6f} (bound 1e-4 relative); float32 loss "
        f"{l32_dp:.6f} vs {l32_one:.6f}, worst gradient leaves (norm rel) "
        f"{[(k, f'{v:.2e}') for k, v in worst]} (bound 1e-2); step loss "
        f"sums {sums_err:.2e} of the total (bound 1e-4), counts equal; eval "
        f"step predictions equal to one process's on all "
        f"{len(e_one['preds'])} rows on both ranks (accuracy {acc_dp:.4f} "
        f"vs {acc_one:.4f}), loss sums {eval_err:.2e} of the total, cos_sum "
        f"{cos_err:.2e} a cosine (bounds 1e-4), counts equal; ms a step per "
        f"rank (host "
        f"clock, steps 2-{DP_STEPS}) {[round(m, 3) for m in ms]}, one "
        f"process {float(np.mean(one[bf]['ms'][1:])):.3f}; launch "
        f"{launch_s:.1f} s; card {card}")

    # the evaluate CLI's ranks on phase 18's checkpoint over the valid split
    eval_argv = clis["common"] + [
        "--model-ckpt", clis["best_model"], "--test-filename",
        clis["world"]["valid"], "--evaluate-func", "acc",
        "--result-filename", "dp_result.json"]
    eargs = loop.parse_cli(eval_argv + ["--mesh-dp", str(DP_RANKS)])
    out_dp = os.path.join(clis["root"], "eval_dp")
    out_one = os.path.join(clis["root"], "eval_one")
    eargs.output = out_dp
    t0 = time.perf_counter()
    acc2 = launch(evaluate._evaluate_rank, DP_RANKS, devices, "gloo",
                  args=(eargs, "mega"))
    eval_dp_s = time.perf_counter() - t0
    acc1, _ = quiet(evaluate.main, eval_argv + ["--output", out_one],
                    device=dev)
    with open(os.path.join(out_dp, "dp_result.json")) as f2, \
            open(os.path.join(out_one, "dp_result.json")) as f1:
        same_file = json.load(f2) == json.load(f1)
    require(acc2[0] == acc2[1] == acc1 == clis["acc"] and same_file,
            f"[dp] evaluate accuracy {acc2} vs one device {acc1} (phase 18 "
            f"{clis['acc']}), result files equal: {same_file}")
    log(f"[dp] train/evaluate.py's rank body on {DP_RANKS} ranks over "
        f"phase 18's best_model and valid split ({clis['n_valid']} "
        f"questions): accuracy {acc2[0]:.4f} on both ranks, equal to one "
        f"device's and phase 18's; result files equal; {eval_dp_s:.1f} s "
        f"with the ranks' start; card {card}")


#: phase 22: the NMN trainer and evaluate CLIs at their own defaults
#: (``train/args.py``: hidden 512, video 2048, text 300, F 150, B 32,
#: dropout 0.25, window 32, lr 2e-4, float32), on a world cut to 24 videos
#: x 8 questions of 300 saved frames (150 after the loader's stride of 2)
DEFAULT_WORLD = dict(num_videos=24, questions_per_video=8, num_frames=150,
                     feature_dim=2048, glove_dim=300, seed=22)
DEFAULT_EPOCHS = 3
#: per eval batch of the float32 CLIs: the video, question and class-table
#: encodes on the BiLSTM's float32 cluster route (#1) and one executor
#: forward on its "fma32" route (#4)
CLI_EVAL_LAUNCHES_F32 = {"bilstm_f32c": 3, "mega_exec_fma32": 1}
#: epochs of the CLI's own batches that time its inner loop, a route each
DEFAULT_TIMED_EPOCHS = 2
#: the batches at which #4-#6 and the train step are timed: the CLI's
#: (clusters of 4 CTAs an example on an H100), 64 (clusters of 2) and
#: phase 8's (one CTA an example)
DEFAULT_TIMED_BATCHES = (32, 64, TRAIN_BATCH)
#: what phase 22 requires of the trained model's config and the batch: the
#: defaults of ``train/args.py`` and ``models/nmn.py``
CLI_DEFAULTS = dict(hidden_size=512, max_video_length=150, batch_size=32,
                    compute_dtype="float32", dropout=0.25, video_size=2048,
                    text_size=300)


def run_default_clis(dev, root, world=None, extra=(), run="run"):
    """Phase 22's runs: the world under ``root`` (or ``world``, one written
    before), ``train.loop.main`` with only the data paths, the output (under
    ``root/run``), ``extra`` and what keeps the run short, then
    ``train.evaluate.main`` on its ``best_model``, each counted. Returns
    what the checks read."""
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.testing.agqa_world import data_argv
    from stair_tpu_torch.train import checkpoint as ckpt
    from stair_tpu_torch.train import evaluate, loop

    t0 = time.perf_counter()
    w = world or write_world(f"{root}/world", DEFAULT_WORLD)
    out = f"{root}/{run}"
    args = loop.parse_cli(data_argv(w, out, *extra))
    train_ds, valid_ds = loop.load_datasets(args)
    n_train, n_valid = (sum(t is not None for t in ds.traces)
                        for ds in (train_ds, valid_ds))
    steps = -(-n_train // args.batch_size)
    eval_batches = -(-n_valid // args.batch_size)
    world_s = time.perf_counter() - t0
    argv = data_argv(w, out, *extra, "--num-epochs", str(DEFAULT_EPOCHS),
                     "--report-interval", str(steps),
                     "--evaluate-interval", str(steps))

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    best, _ = quiet(loop.main, argv, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = dict(_build.LAUNCHES)
    train_clusters = {k: dict(v) for k, v in _build.CLUSTERS.items()}
    with open(f"{out}/metrics.jsonl") as f:
        recs = [json.loads(x) for x in f]
    cfg = ckpt.load_config(f"{out}/best_model")
    best_state = ckpt.load_trainer_state(f"{out}/best_model")

    _build.reset_launches()
    t0 = time.perf_counter()
    acc, _ = quiet(evaluate.main, argv + [
        "--model-ckpt", f"{out}/best_model", "--test-filename", w["valid"],
        "--evaluate-func", "acc"], device=dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = dict(_build.LAUNCHES)
    eval_clusters = {k: dict(v) for k, v in _build.CLUSTERS.items()}
    return dict(world=w, out=out, argv=argv, args=loop.parse_cli(argv),
                n_train=n_train, n_valid=n_valid, steps=steps,
                eval_batches=eval_batches, best=best, acc=acc, cfg=cfg,
                best_state=best_state, recs=recs,
                train_launches=train_launches, eval_launches=eval_launches,
                train_clusters=train_clusters, eval_clusters=eval_clusters,
                world_s=world_s, train_s=train_s, eval_s=eval_s)


#: phase 22's timed routes of #4-#6: key prefix of the record (ms,
#: walk_ms, wgrad_ms), context, cluster argument of the walk's launch
DEFAULT_ROUTES = (("", contextlib.nullcontext, None),
                  ("one_cta_", one_cta, 1),
                  ("general_", general_mega, None))


def time_default_kernels(held, label):
    """#4, #5 and #6 on ``hold_f32_executor``' inputs by CUDA-graph
    replay on the "fma32" route (each on the cluster its launch picks,
    ``held["clusters"]``), on the same kernels one CTA an example and on
    the general route forced (#6 also its walk and weight-gradient launches
    apart), beside the plain versions (CUDA events) and their bounds (the
    flop counter's operations on the plain version at these inputs, 67
    TFLOP/s; each argument read and each output written once). Returns
    ``{kernel: record}``."""
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.utils.device import cuda_time_ms

    f32 = torch.float32
    meta4, a4 = held["ins"]["eval"]
    meta5, a5 = held["ins"]["train"]
    rate, seed, gouts = held["rate"], held["seed"], held["gouts"]
    out = held["outs"]

    def plain4():
        return TX.mega_exec_reference(meta4, a4)

    def plain5():
        return TX.mega_exec_reference(meta5, a5, rate=rate, seed=seed)

    def plain6():
        return TG.mega_exec_bwd_reference(meta5, a5, out["#5"], gouts, rate,
                                          seed, at_files=True)

    rec = {
        "#4": {"plain_ms": cuda_time_ms(plain4, iters=2, warmup=1),
               **bound(counted_flops(plain4), tensor_bytes(a4, out["#4"]),
                       f32)},
        "#5": {"plain_ms": cuda_time_ms(plain5, iters=2, warmup=1),
               **bound(counted_flops(plain5), tensor_bytes(a5, out["#5"]),
                       f32)},
        "#6": {"plain_ms": cuda_time_ms(plain6, iters=1, warmup=1),
               **bound(counted_flops(plain6),
                       tensor_bytes(a5, out["#5"], gouts, out["#6"]), f32)}}
    for pre, ctx, cluster in DEFAULT_ROUTES:
        with ctx():
            o = TX.mega_exec_train_call(meta5, a5, rate, seed)
            walk, wgrad, _ = TG.bwd_launches(
                meta5, a5, o, gouts, TX.dropout_params(rate, seed), cluster)
            times = {
                "#4": graph_ms(lambda: TX.mega_exec_call(meta4, a4), 5),
                "#5": graph_ms(lambda: TX.mega_exec_train_call(
                    meta5, a5, rate, seed), 5),
                "#6": graph_ms(lambda: (walk(), wgrad()), 5),
                "walk": graph_ms(walk, 5), "wgrad": graph_ms(wgrad, 5)}
        for k in ("#4", "#5", "#6"):
            rec[k][f"{pre}ms"] = times[k]
        rec["#6"][f"{pre}walk_ms"] = times["walk"]
        rec["#6"][f"{pre}wgrad_ms"] = times["wgrad"]
    for k, r in rec.items():
        f32_record(k, label, "fma32", r["ms"], r["plain_ms"],
                   {"bound_ms": r["bound_ms"], "bound_by": r["bound_by"]},
                   cluster=held["clusters"][k], one_cta_ms=r["one_cta_ms"],
                   general_ms=r["general_ms"], timing="graph replay")
    return rec


def default_batch(dev, args, ds, model, tables, B, seed, shuffle):
    """A CLI batch of ``B`` rows from ``ds`` as the trainer packs it (its
    batcher over ``tables``, ``ds``'s device tables, and
    ``_device_batches``): the first batch of an epoch, or with ``shuffle``
    the padded last one of a shuffled epoch. Returns ``(batch dict,
    materialized batch, real rows)``."""
    from stair_tpu_torch.train import loop

    bargs = copy.copy(args)
    bargs.batch_size = B
    batcher = loop.make_batcher(bargs, ds, model, seed=seed,
                                device_tables=True)
    batches = list(loop._device_batches(batcher, dev, shuffle))
    batch, bdict = batches[-1] if shuffle else batches[0]
    return bdict, loop.materialize_batch(bdict, tables), batch.meta["real"]


def phase_default_clis(dev, card, root=None):
    """Phase 22: the NMN trainer and evaluate CLIs at their own defaults
    (H 512, F 150, float32, B 32): every executor launch on the "fma32"
    routes, which take F 150 on ``gemm32``'s row tiles. With ``root`` (a
    directory the caller removes) its world stays there for phase 23
    (``SEEN["defaults"]["world"]``). Returns the F 150 kernel entries."""
    import tempfile

    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.train import evaluate, loop
    from stair_tpu_torch.utils.device import cuda_time_ms

    t_phase = time.perf_counter()
    own = root is None
    root = root or tempfile.mkdtemp(prefix="stair_defaults_")
    try:
        r = run_default_clis(dev, root)
        args, cfg = r["args"], r["cfg"]
        H, F, B = cfg["hidden_size"], cfg["max_video_length"], args.batch_size
        # the CLIs' own defaults, no flag or config file setting them
        got = {**{k: cfg[k] for k in CLI_DEFAULTS if k in cfg},
               "batch_size": B}
        require(got == CLI_DEFAULTS,
                f"[defaults] not the CLI's defaults {CLI_DEFAULTS}: {got}")
        require(TX.fwd_route(torch.float32, H, F, False)
                == TG.bwd_route(torch.float32, H, F) == "fma32",
                f"[defaults] H {H} F {F} float32 not on the fma32 routes")
        steps, epochs = r["steps"], DEFAULT_EPOCHS
        total = steps * epochs
        n_eval = (epochs + 1) * r["eval_batches"]
        want = {k: n * total for k, n in TRAIN_LAUNCHES_F32.items()}
        for k, n in CLI_EVAL_LAUNCHES_F32.items():
            want[k] = want.get(k, 0) + n * n_eval
        require_launches("[defaults] train.loop.main", r["train_launches"],
                         want)
        require_launches("[defaults] train.evaluate.main",
                         r["eval_launches"],
                         {k: n * r["eval_batches"]
                          for k, n in CLI_EVAL_LAUNCHES_F32.items()})
        # every CLI batch is padded to B rows: each "fma32" launch on the
        # cluster its launch picks at B (clusters of 4 at the CLIs' B 32 on
        # an H100), none one CTA an example
        pick, pick6 = (TX.fma32_launch_cluster(B, H),
                       TX.fma32_launch_cluster(B, H, F))
        want_c = {"mega_exec_fma32": {pick: want["mega_exec_fma32"]},
                  "mega_exec_train_fma32": {
                      pick: want["mega_exec_train_fma32"]},
                  "mega_exec_bwd_fma32": {pick6: want["mega_exec_bwd_fma32"]}}
        require(r["train_clusters"] == {**want_c, **{
                    k: {} for k in r["train_clusters"] if k not in want_c}},
                f"[defaults] train.loop.main cluster launches "
                f"{r['train_clusters']}, want {want_c}")
        want_e = {k: {pick: n * r["eval_batches"]} if k == "mega_exec_fma32"
                  else {} for k in r["eval_clusters"]}
        require(r["eval_clusters"] == want_e,
                f"[defaults] train.evaluate.main cluster launches "
                f"{r['eval_clusters']}, want {want_e}")
        reports = [x for x in r["recs"] if "loss/total" in x]
        evals = [x for x in r["recs"] if "valid/acc" in x]
        require(len(evals) == epochs + 1, f"{len(evals)} evaluations")
        first, last, shared = require_loss_falls(reports)
        require(r["acc"] == r["best_state"]["best_acc"] == r["best"],
                f"[defaults] evaluate acc {r['acc']} != the trainer's best "
                f"{r['best_state']['best_acc']} ({r['best']})")
        log(f"[defaults] world: {r['n_train']} train / {r['n_valid']} valid "
            f"questions of {F} frames x {cfg['video_size']} features "
            f"(world {r['world_s']:.1f} s); train.loop.main with only the "
            f"data paths, the output, --num-epochs {epochs}, the report and "
            f"evaluate intervals: H {H}, F {F}, B {B}, "
            f"{cfg['compute_dtype']}, dropout {cfg['dropout']}, lr "
            f"{args.lr}, window {args.contrastive_window}; {epochs} epochs "
            f"= {total} steps + {len(evals)} evaluations x "
            f"{r['eval_batches']} batch ({r['train_s']:.1f} s): launches "
            f"{ {k: v for k, v in r['train_launches'].items() if v} } = "
            f"{total} x TRAIN_LAUNCHES_F32 + {n_eval} x "
            f"{CLI_EVAL_LAUNCHES_F32}, no general executor launch, by "
            f"cluster size {r['train_clusters']} (#4, #5 on clusters of "
            f"{pick}, #6's walk {pick6}); answer "
            f"loss {[round(x['loss/decoder'], 4) for x in reports]}, mean "
            f"of {len(shared)} module-family losses "
            f"{np.mean([first[n] for n in shared]):.4f} -> "
            f"{np.mean([last[n] for n in shared]):.4f}; valid acc "
            f"{[round(x['valid/acc'], 4) for x in evals]}; "
            f"train.evaluate.main on best_model: acc {r['acc']:.4f} = the "
            f"trainer's best, launches "
            f"{ {k: v for k, v in r['eval_launches'].items() if v} } "
            f"(clusters {r['eval_clusters']['mega_exec_fma32']}; "
            f"{r['eval_s']:.1f} s); card {card}")

        # ---- one CLI batch on best_model's weights: the kernels against
        # the general route (equal bits) and their plain versions, then
        # one step's every gradient leaf on both routes (equal bits) and
        # against the plain route (phase 8's bounds)
        targs = loop.parse_cli(r["argv"] + ["--model-ckpt",
                                            f"{r['out']}/best_model"])
        train_ds, valid_ds = loop.load_datasets(targs)
        model = evaluate.load_model(targs, valid_ds, dev)
        window = targs.contrastive_window
        tables = loop.make_device_tables(train_ds, dev)
        tdict, tbatch, real = default_batch(
            dev, targs, train_ds, model, tables, B, targs.rand_seed, True)
        h = hold_f32_executor(dev, model, tbatch, cfg["dropout"])
        # the evaluate CLI's batch: the valid split's last (and only), its
        # rows past the split's end cycled in
        vdict, vbatch, vreal = default_batch(
            dev, targs, valid_ds, model, loop.make_device_tables(
                valid_ds, dev), B, targs.rand_seed, False)
        hv = hold_f32_executor(dev, model, vbatch, cfg["dropout"])
        hold_step_routes("[defaults]", ((model, "float32"),), tbatch, window)
        prior = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            l1, g1 = step_grads(model, tbatch, window)
            l2, g2 = step_grads(model, tbatch, window)
            with general_mega():
                lg, gg = step_grads(model, tbatch, window)
        finally:
            torch.use_deterministic_algorithms(prior)
        require(l1 == l2 and all(torch.equal(g1[k], g2[k]) for k in g1),
                "[defaults] the step is not deterministic on the card")
        differ = [k for k in g1 if not torch.equal(g1[k], gg[k])]
        require(lg == l1 and not differ,
                f"[defaults] the step's loss {l1} / {lg} or leaves {differ} "
                "differ between the fma32 and general routes")
        log(f"[defaults] the CLI's padded last train batch ({real} of {B} "
            f"rows real), best_model's weights: #4, #5 files and #6's "
            f"{len(h['outs']['#6'])} gradients on the fma32 route (clusters "
            f"{h['clusters']}) equal one CTA an example's and the general "
            f"route's bit for bit; against the plain versions #4 "
            f"max_abs_err {h['e4']:.3e}, #5 {h['e5']:.3e} (1e-4), #6 max rel "
            f"err {h['rel6']:.3e} (5e-2; max_abs_err {h['e6']:.3e}); the "
            f"evaluate CLI's batch ({vreal} of {B} rows real) likewise "
            f"(clusters {hv['clusters']}; #4 {hv['e4']:.3e}, #5 "
            f"{hv['e5']:.3e}, #6 {hv['rel6']:.3e}); one "
            f"train step's loss and all {len(g1)} gradient leaves equal bit "
            f"for bit on both routes (deterministic algorithms, twice on "
            f"the fma32 route); card {card}")

        # ---- times: the CLI's inner loop, a train step at B 32 and 128,
        # and #4-#6 at both, each beside the general route
        step = loop.make_train_step(model, targs, tables=tables)
        batcher = loop.make_batcher(targs, train_ds, model,
                                    seed=targs.rand_seed, device_tables=True)
        loop_ms = {}
        for name, ctx in (("fma32", contextlib.nullcontext),
                          ("one CTA", one_cta), ("general", general_mega)):
            with ctx():
                loop_ms[name] = time_inner_loop(step, batcher, dev,
                                                DEFAULT_TIMED_EPOCHS, tdict)
        # the first batch of an epoch in order: every row real at B 32
        step_ms, real_rows, held = {}, {}, {}
        turns = {"fma32": contextlib.nullcontext, "one CTA": one_cta,
                 "general": general_mega}
        for b in DEFAULT_TIMED_BATCHES:
            bdict, mat, real_rows[b] = default_batch(
                dev, targs, train_ds, model, tables, b, 0, False)
            held[b] = hold_f32_executor(dev, model, mat, cfg["dropout"])
            ms = {k: [] for k in turns}
            for name in (*turns, *reversed(turns)):
                with turns[name]():
                    ms[name].append(cuda_time_ms(lambda: step(
                        bdict, torch.Generator().manual_seed(1), 1.0, 1.0),
                        iters=5, warmup=1))
            step_ms[b] = ms
        timed = {b: time_default_kernels(
            held[b], f"NMN CLIs' defaults, B {b} H {H} F {F} float32")
            for b in DEFAULT_TIMED_BATCHES}
        log(f"[defaults] the trainer's inner loop (make_train_step with its "
            f"device tables over _device_batches), {DEFAULT_TIMED_EPOCHS} "
            f"epochs = {loop_ms['fma32'][2]} steps a route: "
            + "; ".join(f"{k} {v[0]:.3f} ms a step by the host clock, "
                        f"{v[1]:.3f} by CUDA events" for k, v in
                        loop_ms.items())
            + f"; card {card}")
        for b, ms in step_ms.items():
            log(f"[defaults] one train step at B {b} ({real_rows[b]} rows "
                f"real; CUDA events, 5 steps "
                f"after one, in turns): "
                + "; ".join(f"{k} {[round(x, 4) for x in v]}"
                            for k, v in ms.items()) + f"; card {card}")
        for b, rec in timed.items():
            log(f"[defaults] #4, #5, #6 at B {b} H {H} F {F} float32 (#4 and"
                f" #5 files, #6 gradients equal to one CTA an example's and "
                f"the general route's, #6 within {held[b]['rel6']:.2e} of "
                f"the plain version) by graph replay, on clusters "
                f"{held[b]['clusters']}: "
                + "; ".join(f"{k} fma32 {v['ms']:.4f} ms, one CTA "
                            f"{v['one_cta_ms']:.4f}, general "
                            f"{v['general_ms']:.4f}, plain {v['plain_ms']:.3f}"
                            f", bound {v['bound_ms']:.4f} ({v['bound_by']})"
                            for k, v in rec.items())
                + f"; #6's walk {rec['#6']['walk_ms']:.4f} + weight "
                f"gradients {rec['#6']['wgrad_ms']:.4f} (one CTA "
                f"{rec['#6']['one_cta_walk_ms']:.4f} + "
                f"{rec['#6']['one_cta_wgrad_ms']:.4f}; general "
                f"{rec['#6']['general_walk_ms']:.4f} + "
                f"{rec['#6']['general_wgrad_ms']:.4f}); card {card}")
        SEEN["defaults"] = dict(loop_ms=loop_ms, step_ms=step_ms,
                                timed=timed, world=r["world"],
                                argv=r["argv"], out=r["out"], acc=r["acc"])
        log(f"[defaults] phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        if own:
            shutil.rmtree(root, ignore_errors=True)

    launches = {k: r["train_launches"].get(k, 0) + r["eval_launches"].get(
        k, 0) for k in ("mega_exec_fma32", "mega_exec_train_fma32",
                        "mega_exec_bwd_fma32", "mega_exec_wgrad_fma32")}
    base = {"route": "cuda", "path": f"NMN trainer and evaluate CLIs at "
            f"their defaults, H {H} F {F} float32 B {B} (phase 22)",
            "executor_route": "fma32", "library_ms": None}

    def entry(name, kernel, source, replaces, launches_n, err, **more):
        t = timed[B][kernel]
        other = {}
        for b in DEFAULT_TIMED_BATCHES:
            if b != B:
                tb = timed[b][kernel]
                other.update({f"b{b}_ms": tb["ms"],
                              f"b{b}_cluster": held[b]["clusters"][kernel],
                              f"b{b}_one_cta_ms": tb["one_cta_ms"],
                              f"b{b}_general_ms": tb["general_ms"],
                              f"b{b}_plain_ms": tb["plain_ms"],
                              f"b{b}_bound_ms": tb["bound_ms"]})
        return {"name": name, **base, "source": source,
                "replaces": replaces, "launches": launches_n,
                "max_abs_err": err, "ms": t["ms"],
                "cluster": held[B]["clusters"][kernel],
                "one_cta_ms": t["one_cta_ms"],
                "general_ms": t["general_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                **other, **more}

    h = held[B]   # the errors on the timed B 32 batch
    return [
        entry("mega_exec_fma32", "#4", "stair_tpu_torch/ops/csrc/mega_exec.cu",
              "stair_tpu/ops/mega_exec.py:123", launches["mega_exec_fma32"],
              h["e4"]),
        entry("mega_exec_train_fma32", "#5",
              "stair_tpu_torch/ops/csrc/mega_exec.cu",
              "stair_tpu/ops/mega_grad.py:1016",
              launches["mega_exec_train_fma32"], h["e5"]),
        entry("mega_exec_bwd_fma32", "#6",
              "stair_tpu_torch/ops/csrc/mega_grad.cu",
              "stair_tpu/ops/mega_grad.py:111",
              launches["mega_exec_bwd_fma32"], h["e6"],
              wgrad_launches=launches["mega_exec_wgrad_fma32"],
              walk_ms=timed[B]["#6"]["walk_ms"],
              wgrad_ms=timed[B]["#6"]["wgrad_ms"],
              one_cta_walk_ms=timed[B]["#6"]["one_cta_walk_ms"]),
    ]


#: phase 23: the NMN trainer and evaluate CLIs at their defaults in bf16:
#: phase 22's world and driver, ``--config-filename`` naming the config the
#: port's ``train/loop.py build_model`` makes for that world with only
#: ``compute_dtype`` set to "bfloat16" (the JAX trainer's one way to bf16,
#: ``stair_tpu/train/loop.py:612-615``)
BF16_CLI_DEFAULTS = dict(CLI_DEFAULTS, compute_dtype="bfloat16")
#: phase 23's timed routes of #4-#6: key prefix of the record, context,
#: cluster argument of the walk's launch (the row-slice mode on the
#: launch's cluster, on one CTA an example, and the general route forced)
BF16_DEFAULT_ROUTES = (("", contextlib.nullcontext, None),
                       ("one_cta_", one_cta, 1),
                       ("general_", general_mega, None))


def bf16_cli_config(dev, world, path):
    """The model config the port's trainer makes for ``world`` at the CLIs'
    defaults (``train/loop.py build_model`` on the data paths alone), with
    ``compute_dtype`` "bfloat16", written to ``path`` as the file
    ``--config-filename`` reads. Returns it."""
    from stair_tpu_torch.testing.agqa_world import data_argv
    from stair_tpu_torch.train import loop

    args = loop.parse_cli(data_argv(world, os.path.dirname(path)))
    model, cfg = loop.build_model(args, list(loop.load_datasets(args)), dev)
    del model
    cfg["compute_dtype"] = "bfloat16"
    with open(path, "w") as f:
        json.dump(cfg, f)
    return cfg


def executor_files(out):
    """The executor's three register files by the names the file checks
    (``hold_files``) read, in float32."""
    return dict(zip(("regs_vec", "regs_frames", "regs_attn"),
                    (o.float() for o in out)))


def hold_tc_executor(dev, model, batch, rate, seed=(11, 22)):
    """#4 on ``batch``'s eval inputs, #5 and #6 on its training inputs
    (``executor_inputs``), bf16, on the tensor-core route in its row-slice
    mode: one launch of each of its keys, each counted under the cluster
    its launch picks (``mega_exec.tc_launch_cluster``: ``F`` / 64 CTAs an
    example while the batch fits one wave of the card's CTA slots, else 2,
    else one CTA); against one CTA an example (the same mode, every slice on
    one CTA; equal bits) and a second run (equal bits); against the plain
    versions (#4 and #5 files by ``hold_files``: atol 3e-2 + rtol 1e-2, the
    executor's bf16 bound; #6 within 1e-1 of each gradient's largest value
    at its own files, ``at_files``); and the walk's recompute products at
    this F against the forward's (``mega_grad.recompute_check``, equal
    bits). Returns the errors, the cluster and what the timings reuse."""
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG

    ins = {"eval": executor_inputs(model, batch, train=False),
           "train": executor_inputs(model, batch, train=True)}
    meta4, a4 = ins["eval"]
    meta5, a5 = ins["train"]
    B, F, H = meta4[0], meta4[5], meta4[6]
    require(meta4[9] == meta5[9] == torch.bfloat16,
            f"bf16 executor inputs in {meta4[9]} / {meta5[9]}")
    C = TX.tc_launch_cluster(B, F, H, meta4[8])
    C6 = TX.tc_launch_cluster(B, F, H, walk=True)
    slots = TX.tc_slots(F, H, meta4[8])
    require(C == C6 == TX.tc_cluster(B, F, slots),
            f"bf16 B {B} F {F}: the launches pick {C} / {C6}, tc_cluster "
            f"over {slots} slots {TX.tc_cluster(B, F, slots)}")
    require(TX.fwd_route(torch.bfloat16, H, F, True) == "tc"
            and TX.tc_sliced(F), f"bf16 H {H} F {F}: not the row-slice mode")
    with kernel_route(("mega_exec_tc",)) as l4:
        k4 = TX.mega_exec_call(meta4, a4)
    require_launches("bf16 #4", l4, {"mega_exec_tc": 1})
    seen = {"#4": dict(_build.CLUSTERS["mega_exec_tc"])}
    keys = ("mega_exec_train_tc", "mega_exec_bwd_tc", "mega_exec_wgrad_tc")
    gen = torch.Generator().manual_seed(6)
    with kernel_route(keys) as l56:
        k5 = TX.mega_exec_train_call(meta5, a5, rate, seed)
        gouts = [torch.randn(o.shape, generator=gen).to(dev) for o in k5]
        k6 = TG.mega_exec_bwd_call(meta5, a5, k5, gouts, rate, seed)
    require_launches("bf16 #5 + #6", l56, dict.fromkeys(keys, 1))
    seen["#5"] = dict(_build.CLUSTERS["mega_exec_train_tc"])
    seen["#6"] = dict(_build.CLUSTERS["mega_exec_bwd_tc"])
    require(seen == {k: {C: 1} for k in ("#4", "#5", "#6")},
            f"bf16 #4-#6 B {B} H {H} F {F}: cluster launches {seen}, the "
            f"launch's pick {C}")
    with one_cta():
        o4 = TX.mega_exec_call(meta4, a4)
        o5 = TX.mega_exec_train_call(meta5, a5, rate, seed)
        o6 = TG.mega_exec_bwd_call(meta5, a5, o5, gouts, rate, seed)
    t5 = TX.mega_exec_train_call(meta5, a5, rate, seed)
    t6 = TG.mega_exec_bwd_call(meta5, a5, k5, gouts, rate, seed)
    torch.cuda.synchronize()
    for what, k, o, t in (("#4 files", k4, o4, k4), ("#5 files", k5, o5, t5),
                          ("#6 gradients", k6, o6, t6)):
        require(all(torch.equal(a, b) for a, b in zip(k, o)),
                f"bf16 {what}: the row-slice mode on clusters of {C} "
                "differs from one CTA an example")
        require(all(torch.equal(a, b) for a, b in zip(k, t)),
                f"bf16 {what}: two runs differ")
    r4 = TX.mega_exec_reference(meta4, a4)
    r5 = TX.mega_exec_reference(meta5, a5, rate=rate, seed=seed)
    trace = batch["trace"]
    e4 = hold_files("bf16 #4 vs plain", trace, executor_files(k4),
                    executor_files(r4), ("regs_vec", "regs_frames",
                                         "regs_attn"))
    e5 = hold_files("bf16 #5 vs plain", trace, executor_files(k5),
                    executor_files(r5), ("regs_vec", "regs_frames",
                                         "regs_attn"))
    r6 = TG.mega_exec_bwd_reference(meta5, a5, k5, gouts, rate, seed,
                                    at_files=True)
    rel6 = max(rel_err(x, y) for x, y in zip(k6, r6))
    require(rel6 <= 1e-1, f"bf16 #6 vs plain at its files: rel err {rel6}")
    # the walk's recompute at this F: each product (the [F, H] @ [H, H]
    # one over row slices, alone and as stage 1's chained pair, and the
    # vec-level one) gives the forward's bits
    rg = torch.Generator().manual_seed(F)
    for vec in (False, True):
        for chain in (False, True):
            A = torch.randn(3 if vec else F, H, generator=rg).to(
                dev, torch.bfloat16)
            A = A.float() if vec else A
            Bm = (torch.randn((3 if vec else 1) * H, H, generator=rg)
                  / H ** 0.5).to(dev, torch.bfloat16)
            fw, wk = TG.recompute_check(A, Bm, vec, chain)
            torch.cuda.synchronize()
            require(torch.equal(fw, wk), f"bf16 recompute check at F {F} "
                    f"(vec {vec}, chain {chain}): walk differs from forward")
    return dict(e4=max_err(k4, r4), e5=max_err(k5, r5), e6=max_err(k6, r6),
                rel6=rel6, outside=(e4[1], e5[1]), flipped=(e4[2], e5[2]),
                ins=ins, gouts=gouts, seed=seed, rate=rate, cluster=C,
                outs={"#4": k4, "#5": k5, "#6": k6})


def time_tc_kernels(held, label):
    """#4, #5 and #6 on ``hold_tc_executor``'s inputs by CUDA-graph replay
    on the tensor-core route's row-slice mode (on the cluster its launch
    picks), on one CTA an example and on the general route forced (#6 also
    its walk and weight-gradient launches apart), beside the plain versions
    (CUDA events) and their bounds (the flop counter's operations on the
    plain version at these inputs, 989 TFLOP/s bf16; each argument read and
    each output written once). Returns ``{kernel: record}``."""
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.utils.device import cuda_time_ms

    bf = torch.bfloat16
    meta4, a4 = held["ins"]["eval"]
    meta5, a5 = held["ins"]["train"]
    rate, seed, gouts = held["rate"], held["seed"], held["gouts"]
    out = held["outs"]

    def plain4():
        return TX.mega_exec_reference(meta4, a4)

    def plain5():
        return TX.mega_exec_reference(meta5, a5, rate=rate, seed=seed)

    def plain6():
        return TG.mega_exec_bwd_reference(meta5, a5, out["#5"], gouts, rate,
                                          seed, at_files=True)

    rec = {
        "#4": {"plain_ms": cuda_time_ms(plain4, iters=2, warmup=1),
               **bound(counted_flops(plain4), tensor_bytes(a4, out["#4"]),
                       bf)},
        "#5": {"plain_ms": cuda_time_ms(plain5, iters=2, warmup=1),
               **bound(counted_flops(plain5), tensor_bytes(a5, out["#5"]),
                       bf)},
        "#6": {"plain_ms": cuda_time_ms(plain6, iters=1, warmup=1),
               **bound(counted_flops(plain6),
                       tensor_bytes(a5, out["#5"], gouts, out["#6"]), bf)}}
    for pre, ctx, cluster in BF16_DEFAULT_ROUTES:
        with ctx():
            o = TX.mega_exec_train_call(meta5, a5, rate, seed)
            walk, wgrad, _ = TG.bwd_launches(
                meta5, a5, o, gouts, TX.dropout_params(rate, seed), cluster)
            times = {
                "#4": graph_ms(lambda: TX.mega_exec_call(meta4, a4), 5),
                "#5": graph_ms(lambda: TX.mega_exec_train_call(
                    meta5, a5, rate, seed), 5),
                "#6": graph_ms(lambda: (walk(), wgrad()), 5),
                "walk": graph_ms(walk, 5), "wgrad": graph_ms(wgrad, 5)}
        for k in ("#4", "#5", "#6"):
            rec[k][f"{pre}ms"] = times[k]
        rec["#6"][f"{pre}walk_ms"] = times["walk"]
        rec["#6"][f"{pre}wgrad_ms"] = times["wgrad"]
    for k, r in rec.items():
        entry = {"kernel": k, "shape": label, **r}
        log(f"[bf16 defaults] {json.dumps(entry)}")
    return rec


def phase_bf16_clis(dev, card, root):
    """Phase 23: the NMN trainer and evaluate CLIs at their defaults (H
    512, F 150, B 32, dropout 0.25) in bf16, through ``--config-filename``
    on phase 22's world (under ``root``): every executor launch on the
    tensor-core route's row-slice mode (#4, #5 and #6's walk on clusters of
    F / 64 CTAs an example at the CLIs' B 32), none general; every BiLSTM
    launch on its bf16 cluster route. Returns the F 150 bf16 kernel
    entries."""
    from stair_tpu_torch.ops import mega_exec as TX
    from stair_tpu_torch.ops import mega_grad as TG
    from stair_tpu_torch.train import evaluate, loop
    from stair_tpu_torch.utils.device import cuda_time_ms

    t_phase = time.perf_counter()
    world = SEEN["defaults"]["world"]
    cfg_path = f"{root}/bf16_config.json"
    made = bf16_cli_config(dev, world, cfg_path)
    r = run_default_clis(dev, root, world, ("--config-filename", cfg_path),
                         "run_bf16")
    args, cfg = r["args"], r["cfg"]
    H, F, B = cfg["hidden_size"], cfg["max_video_length"], args.batch_size
    got = {**{k: cfg[k] for k in BF16_CLI_DEFAULTS if k in cfg},
           "batch_size": B}
    require(got == BF16_CLI_DEFAULTS and cfg == made,
            f"[bf16 defaults] not the CLI's defaults in bf16 "
            f"{BF16_CLI_DEFAULTS}: {got}")
    require(TX.fwd_route(torch.bfloat16, H, F, False)
            == TG.bwd_route(torch.bfloat16, H, F) == "tc" and TX.tc_sliced(F),
            f"[bf16 defaults] H {H} F {F} bf16 not on the tc row-slice mode")
    C = TX.tc_launch_cluster(B, F, H)
    steps, epochs = r["steps"], DEFAULT_EPOCHS
    total = steps * epochs
    n_eval = (epochs + 1) * r["eval_batches"]
    want = {k: n * total for k, n in TRAIN_LAUNCHES.items() if n}
    for k, n in EVAL_LAUNCHES.items():
        want[k] = want.get(k, 0) + n * n_eval
    require_launches("[bf16 defaults] train.loop.main", r["train_launches"],
                     want)
    require_launches("[bf16 defaults] train.evaluate.main",
                     r["eval_launches"],
                     {k: n * r["eval_batches"]
                      for k, n in EVAL_LAUNCHES.items()})
    want_c = {k: {} for k in r["train_clusters"]}
    want_c.update({"mega_exec_tc": {C: want["mega_exec_tc"]},
                   "mega_exec_train_tc": {C: want["mega_exec_train_tc"]},
                   "mega_exec_bwd_tc": {C: want["mega_exec_bwd_tc"]}})
    require(r["train_clusters"] == want_c,
            f"[bf16 defaults] train.loop.main cluster launches "
            f"{r['train_clusters']}, want {want_c}")
    want_e = {k: {} for k in r["eval_clusters"]}
    want_e["mega_exec_tc"] = {C: r["eval_batches"]}
    require(r["eval_clusters"] == want_e,
            f"[bf16 defaults] train.evaluate.main cluster launches "
            f"{r['eval_clusters']}, want {want_e}")
    reports = [x for x in r["recs"] if "loss/total" in x]
    evals = [x for x in r["recs"] if "valid/acc" in x]
    require(len(evals) == epochs + 1, f"{len(evals)} evaluations")
    first, last, shared = require_loss_falls(reports)
    require(r["acc"] == r["best_state"]["best_acc"] == r["best"],
            f"[bf16 defaults] evaluate acc {r['acc']} != the trainer's best "
            f"{r['best_state']['best_acc']} ({r['best']})")
    log(f"[bf16 defaults] phase 22's world ({r['n_train']} train / "
        f"{r['n_valid']} valid questions of {F} frames); train.loop.main "
        f"with the data paths, --config-filename (build_model's config for "
        f"it, compute_dtype bfloat16), the output, --num-epochs {epochs} and"
        f" the report and evaluate intervals: H {H}, F {F}, B {B}, "
        f"{cfg['compute_dtype']}, dropout {cfg['dropout']}, lr {args.lr}; "
        f"{epochs} epochs = {total} steps + {len(evals)} evaluations x "
        f"{r['eval_batches']} batch ({r['train_s']:.1f} s): launches "
        f"{ {k: v for k, v in r['train_launches'].items() if v} } = "
        f"{total} x TRAIN_LAUNCHES + {n_eval} x {EVAL_LAUNCHES}, no general "
        f"executor or BiLSTM launch, by cluster size "
        f"{ {k: v for k, v in r['train_clusters'].items() if v} } (#4, #5 "
        f"and #6's walk on clusters of {C}); answer loss "
        f"{[round(x['loss/decoder'], 4) for x in reports]}, mean of "
        f"{len(shared)} module-family losses "
        f"{np.mean([first[n] for n in shared]):.4f} -> "
        f"{np.mean([last[n] for n in shared]):.4f}; valid acc "
        f"{[round(x['valid/acc'], 4) for x in evals]}; train.evaluate.main "
        f"on best_model: acc {r['acc']:.4f} = the trainer's best, launches "
        f"{ {k: v for k, v in r['eval_launches'].items() if v} } (clusters "
        f"{r['eval_clusters']['mega_exec_tc']}; {r['eval_s']:.1f} s); card "
        f"{card}")

    # ---- one CLI batch and the evaluate batch on best_model's weights:
    # #4-#6 against one CTA, a second run and the plain versions; the eval
    # step's predictions on both routes; one step against the plain route
    # and twice on the kernel route (equal bits)
    targs = loop.parse_cli(r["argv"] + ["--model-ckpt",
                                        f"{r['out']}/best_model"])
    train_ds, valid_ds = loop.load_datasets(targs)
    model = evaluate.load_model(targs, valid_ds, dev)
    require(model.config.compute_dtype == "bfloat16", "best_model not bf16")
    window = targs.contrastive_window
    tables = loop.make_device_tables(train_ds, dev)
    tdict, tbatch, real = default_batch(
        dev, targs, train_ds, model, tables, B, targs.rand_seed, True)
    h = hold_tc_executor(dev, model, tbatch, cfg["dropout"])
    vtables = loop.make_device_tables(valid_ds, dev)
    vdict, vbatch, vreal = default_batch(
        dev, targs, valid_ds, model, vtables, B, targs.rand_seed, False)
    hv = hold_tc_executor(dev, model, vbatch, cfg["dropout"])
    eval_step = loop.make_eval_step(model, vtables)
    with kernel_route(("bilstm_tc", "mega_exec_tc")):
        ek = eval_step(vdict)
    with plain_route():
        ep = eval_step(vdict)
    agree = float((ek["preds"] == ep["preds"]).float().mean())
    require(agree >= 0.98, f"[bf16 defaults] eval preds agreement {agree}")
    hold_step_routes("[bf16 defaults]", ((model, "bfloat16"),), tbatch,
                     window)
    prior = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        l1, g1 = step_grads(model, tbatch, window)
        l2, g2 = step_grads(model, tbatch, window)
    finally:
        torch.use_deterministic_algorithms(prior)
    require(l1 == l2 and all(torch.equal(g1[k], g2[k]) for k in g1),
            "[bf16 defaults] the step is not deterministic on the card")
    log(f"[bf16 defaults] the CLI's padded last train batch ({real} of {B} "
        f"rows real), best_model's weights: #4, #5 files and #6's "
        f"{len(h['outs']['#6'])} gradients on the tc route's row-slice mode "
        f"(clusters of {h['cluster']}) equal one CTA an example's and a "
        f"second run's bit for bit; against the plain versions #4 "
        f"max_abs_err {h['e4']:.3e}, #5 {h['e5']:.3e} (atol 3e-2 + rtol "
        f"1e-2; elements outside {h['outside']}, Choose flips "
        f"{h['flipped']}), #6 max rel err {h['rel6']:.3e} (1e-1; max_abs_err"
        f" {h['e6']:.3e}); the walk's recompute products at F {F} equal the "
        f"forward's; the evaluate CLI's batch ({vreal} of {B} rows real) "
        f"likewise (#4 {hv['e4']:.3e}, #5 {hv['e5']:.3e}, #6 "
        f"{hv['rel6']:.3e}), its eval step's predictions agree {agree:.4f} "
        f"with the plain route; one train step's loss and all {len(g1)} "
        f"gradient leaves equal bit for bit twice (deterministic "
        f"algorithms); card {card}")

    # ---- times: the CLI's inner loop, a train step at B 32, 64 and 128,
    # and #4-#6 at each, beside one CTA an example and the general route
    step = loop.make_train_step(model, targs, tables=tables)
    batcher = loop.make_batcher(targs, train_ds, model,
                                seed=targs.rand_seed, device_tables=True)
    loop_ms = {}
    for name, ctx in (("tc", contextlib.nullcontext),
                      ("general", general_mega)):
        with ctx():
            loop_ms[name] = time_inner_loop(step, batcher, dev,
                                            DEFAULT_TIMED_EPOCHS, tdict)
    step_ms, real_rows, held = {}, {}, {}
    turns = {"tc": contextlib.nullcontext, "one CTA": one_cta,
             "general": general_mega}
    for b in DEFAULT_TIMED_BATCHES:
        bdict, mat, real_rows[b] = default_batch(
            dev, targs, train_ds, model, tables, b, 0, False)
        held[b] = h if b == B else hold_tc_executor(dev, model, mat,
                                                    cfg["dropout"])
        ms = {k: [] for k in turns}
        for name in (*turns, *reversed(turns)):
            with turns[name]():
                ms[name].append(cuda_time_ms(lambda: step(
                    bdict, torch.Generator().manual_seed(1), 1.0, 1.0),
                    iters=5, warmup=1))
        step_ms[b] = ms
    timed = {b: time_tc_kernels(
        held[b], f"NMN CLIs' defaults in bf16, B {b} H {H} F {F}")
        for b in DEFAULT_TIMED_BATCHES}
    log(f"[bf16 defaults] the trainer's inner loop, "
        f"{DEFAULT_TIMED_EPOCHS} epochs = {loop_ms['tc'][2]} steps a route: "
        + "; ".join(f"{k} {v[0]:.3f} ms a step by the host clock, "
                    f"{v[1]:.3f} by CUDA events" for k, v in loop_ms.items())
        + f"; card {card}")
    for b, ms in step_ms.items():
        log(f"[bf16 defaults] one train step at B {b} ({real_rows[b]} rows "
            f"real; CUDA events, 5 steps after one, in turns): "
            + "; ".join(f"{k} {[round(x, 4) for x in v]}"
                        for k, v in ms.items()) + f"; card {card}")
    for b, rec in timed.items():
        log(f"[bf16 defaults] #4, #5, #6 at B {b} H {H} F {F} bf16 by graph "
            f"replay, tc on clusters of {held[b]['cluster']}: "
            + "; ".join(f"{k} tc {v['ms']:.4f} ms, one CTA "
                        f"{v['one_cta_ms']:.4f}, general "
                        f"{v['general_ms']:.4f}, plain {v['plain_ms']:.3f}"
                        f", bound {v['bound_ms']:.4f} ({v['bound_by']})"
                        for k, v in rec.items())
            + f"; #6's walk {rec['#6']['walk_ms']:.4f} + weight gradients "
            f"{rec['#6']['wgrad_ms']:.4f} (one CTA "
            f"{rec['#6']['one_cta_walk_ms']:.4f} + "
            f"{rec['#6']['one_cta_wgrad_ms']:.4f}; general "
            f"{rec['#6']['general_walk_ms']:.4f} + "
            f"{rec['#6']['general_wgrad_ms']:.4f}); card {card}")
    SEEN["bf16_defaults"] = dict(loop_ms=loop_ms, step_ms=step_ms,
                                 timed=timed, world=world, argv=r["argv"],
                                 out=r["out"], acc=r["acc"])
    log(f"[bf16 defaults] phase {time.perf_counter() - t_phase:.1f} s")

    launches = {k: r["train_launches"].get(k, 0) + r["eval_launches"].get(
        k, 0) for k in ("mega_exec_tc", "mega_exec_train_tc",
                        "mega_exec_bwd_tc", "mega_exec_wgrad_tc")}
    base = {"route": "cuda", "path": f"NMN trainer and evaluate CLIs at "
            f"their defaults in bf16, H {H} F {F} B {B} (phase 23)",
            "executor_route": "tc", "library_ms": None}

    def entry(name, kernel, source, replaces, launches_n, err, **more):
        t = timed[B][kernel]
        other = {}
        for b in DEFAULT_TIMED_BATCHES:
            if b != B:
                tb = timed[b][kernel]
                other.update({f"b{b}_ms": tb["ms"],
                              f"b{b}_one_cta_ms": tb["one_cta_ms"],
                              f"b{b}_general_ms": tb["general_ms"],
                              f"b{b}_plain_ms": tb["plain_ms"],
                              f"b{b}_bound_ms": tb["bound_ms"]})
        return {"name": name, **base, "source": source,
                "replaces": replaces, "launches": launches_n,
                "max_abs_err": err, "ms": t["ms"], "cluster": h["cluster"],
                "one_cta_ms": t["one_cta_ms"],
                "general_ms": t["general_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                **other, **more}

    return [
        entry("mega_exec_tc", "#4", "stair_tpu_torch/ops/csrc/mega_exec.cu",
              "stair_tpu/ops/mega_exec.py:123", launches["mega_exec_tc"],
              h["e4"]),
        entry("mega_exec_train_tc", "#5",
              "stair_tpu_torch/ops/csrc/mega_exec.cu",
              "stair_tpu/ops/mega_grad.py:1016",
              launches["mega_exec_train_tc"], h["e5"]),
        entry("mega_exec_bwd_tc", "#6",
              "stair_tpu_torch/ops/csrc/mega_grad_tc.cu",
              "stair_tpu/ops/mega_grad.py:111",
              launches["mega_exec_bwd_tc"], h["e6"],
              wgrad_launches=launches["mega_exec_wgrad_tc"],
              walk_ms=timed[B]["#6"]["walk_ms"],
              wgrad_ms=timed[B]["#6"]["wgrad_ms"],
              one_cta_walk_ms=timed[B]["#6"]["one_cta_walk_ms"],
              general_walk_ms=timed[B]["#6"]["general_walk_ms"]),
    ]


#: phase 24: per eval batch of the evaluate CLI on ``--executor step``, the
#: encodes of ``CLI_EVAL_LAUNCHES_F32`` / ``EVAL_LAUNCHES`` (video,
#: question, class table) without the megakernel; the step kernel adds T
STEP_CLI_ENCODES = {torch.float32: {"bilstm_f32c": 3},
                    torch.bfloat16: {"bilstm_tc": 3}}
#: the batches at which an eval batch's ``fused_step`` calls are timed: the
#: CLIs' B 32 (the evaluate CLI's own batch), 128 and phase 16's 1024
STEP_TIMED_BATCHES = (32, 128, 1024)


def record_step_calls(fn, clone=True):
    """``fn()`` with the arguments of each ``fused_step`` call recorded:
    cloned, or with ``clone`` false the tensors themselves (the register
    files then hold their last state, which a timing rewrites in place).
    Returns the list of argument tuples."""
    from stair_tpu_torch.ops import executor_step as TE

    calls, real = [], TE.fused_step

    def record(*args):
        calls.append(tuple(a.clone() for a in args) if clone else args)
        return real(*args)

    TE.fused_step = record
    try:
        fn()
    finally:
        TE.fused_step = real
    return calls


def time_step_calls(calls, dtype):
    """A batch's ``fused_step`` calls by CUDA-graph replay on the route
    ``step_route`` picks and on the general route forced, the plain
    version by CUDA events, and the bound of footnote 6 (each launch's
    live tiles' products or bytes, summed)."""
    from stair_tpu_torch.ops import executor_step as TE
    from stair_tpu_torch.utils.device import cuda_time_ms

    def run():
        return [TE.fused_step(*a) for a in calls]

    rec = {"ms": graph_ms(run, 2)}
    with step_route("general"):
        rec["general_ms"] = graph_ms(run, 2)
    rec["plain_ms"] = cuda_time_ms(
        lambda: [TE.fused_step_reference(*a) for a in calls], iters=2,
        warmup=1)
    return {**rec, **add_bounds(*[step_bound(a, dtype) for a in calls])}


def hold_step_calls(calls, dtype):
    """An eval batch's ``fused_step`` calls on clones, each one launch of
    the route ``step_route`` picks: float32 "fma32" equal to the general
    route forced bit for bit and within 1e-4 of the plain version; bf16
    "tc" equal to one CTA a tile (``cluster=1``) and to a second run bit
    for bit and within atol 3e-2 + rtol 1e-2 of the plain version; every
    output and the whole frames file. Returns the largest error against
    the plain version."""
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import executor_step as TE

    names = ("rf", "pooled", "hasitem", "existsframe", "loc_a", "loc_b")
    B, _, F, H = calls[0][2].shape
    key = TE.STEP_KEYS[TE.step_route(dtype, F, H)]
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 3e-2)
    err = 0.0
    for args in calls:
        _build.reset_launches()
        got = TE.fused_step(*(a.clone() for a in args))
        require_launches(f"one {dtype} fused_step", dict(_build.LAUNCHES),
                         {key: 1})
        if dtype == torch.float32:
            with step_route("general"):
                others = {"the general route": TE.fused_step(
                    *(a.clone() for a in args))}
        else:
            others = {"one CTA a tile": TE.fused_step(
                *(a.clone() for a in args), cluster=1),
                "a second run": TE.fused_step(*(a.clone() for a in args))}
        for what, other in others.items():
            for g, o, name in zip(got, other, names):
                require(torch.equal(g, o), f"[step defaults] {key} B {B} F "
                        f"{F}: {name} differs from {what}")
        del others
        want = TE.fused_step_reference(*(a.clone() for a in args))
        for g, w, name in zip(got, want, names):
            torch.testing.assert_close(
                g.float(), w.float(), rtol=tol[0], atol=tol[1],
                msg=lambda m: f"[step defaults] {key} {name}: {m}")
        err = max(err, max_err(got, want))
        del got, want
    return err


def step_cli_run(dev, card, dtype, seen):
    """Phase 24 in one dtype, on the world, the flags and the best_model of
    phase 22 (float32) or 23 (bf16), ``seen``. Returns the kernel
    entry's fields."""
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.ops import executor_step as TE
    from stair_tpu_torch.train import evaluate, loop

    w, argv, out = seen["world"], seen["argv"], seen["out"]
    ckpt = f"{out}/best_model"
    targs = loop.parse_cli(argv + ["--model-ckpt", ckpt])
    train_ds, valid_ds = loop.load_datasets(targs)
    model = evaluate.load_model(targs, valid_ds, dev, "step")
    cfg = model.config
    H, F, B = cfg.hidden_size, cfg.max_video_length, targs.batch_size
    require(model.compute_dtype == dtype and (H, F, B) == (
        CLI_DEFAULTS["hidden_size"], CLI_DEFAULTS["max_video_length"],
        CLI_DEFAULTS["batch_size"]),
        f"[step defaults] not the CLIs' defaults in {dtype}: H {H} F {F} "
        f"B {B}, {model.compute_dtype}")
    route = TE.step_route(dtype, F, H)
    require(route == ("fma32" if dtype == torch.float32 else "tc"),
            f"[step defaults] {dtype} F {F} H {H} on {route!r}")
    key = TE.STEP_KEYS[route]
    C = TE.step_launch_cluster(route, B, F, H)
    vtables = loop.make_device_tables(valid_ds, dev)
    vdict, vbatch, vreal = default_batch(dev, targs, valid_ds, model,
                                         vtables, B, targs.rand_seed, False)
    T = vbatch["trace"]["opcode"].shape[1]
    n_valid = sum(t is not None for t in valid_ds.traces)
    batches = -(-n_valid // B)

    # ---- the evaluate CLI on --executor step (counted), then on mega ------
    runs = {}
    for executor in ("step", "mega"):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        acc, _ = quiet(evaluate.main, argv + [
            "--model-ckpt", ckpt, "--test-filename", w["valid"],
            "--evaluate-func", "acc", "--executor", executor,
            "--result-filename", f"preds_{executor}.json"], device=dev)
        torch.cuda.synchronize()
        with open(os.path.join(out, f"preds_{executor}.json")) as f:
            preds = json.load(f)["preds"]
        runs[executor] = dict(
            acc=acc, preds=preds, s=time.perf_counter() - t0,
            launches=dict(_build.LAUNCHES),
            clusters={k: dict(v) for k, v in _build.CLUSTERS.items() if v})
    step = runs["step"]
    want = {key: T * batches, **{k: n * batches for k, n in
                                 STEP_CLI_ENCODES[dtype].items()}}
    require_launches(f"[step defaults] {dtype} train.evaluate.main "
                     "--executor step", step["launches"], want)
    require(step["clusters"] == {key: {C: T * batches}},
            f"[step defaults] {dtype} cluster launches {step['clusters']}, "
            f"want {key}: {C} x {T * batches}")
    # argmax agreement with --executor mega on the same checkpoint: the
    # evaluate CLI's split, and the train split through both eval steps
    same = sum(a == b for a, b in zip(step["preds"], runs["mega"]["preds"]))
    n = len(step["preds"])
    require(n == len(runs["mega"]["preds"]) == n_valid,
            f"[step defaults] {n} predictions")
    tables = loop.make_device_tables(train_ds, dev)
    train_preds = {}
    for executor in ("step", "mega"):
        m = evaluate.load_model(targs, train_ds, dev, executor)
        _, _, pg = loop.evaluate_accuracy(
            loop.make_batcher(targs, train_ds, m, device_tables=True),
            loop.make_eval_step(m, tables), dev)
        train_preds[executor] = pg["preds"]
        del m
    same_t = sum(a == b for a, b in zip(*train_preds.values()))
    n_t = len(train_preds["step"])
    agree = (same + same_t) / (n + n_t)
    require(agree >= 0.98, f"[step defaults] {dtype} step / mega argmax "
            f"agreement {agree} ({same} of {n} valid, {same_t} of {n_t} "
            "train)")
    log(f"[step defaults] train.evaluate.main --executor step on phase "
        f"{22 if dtype == torch.float32 else 23}'s best_model ({dtype}, H "
        f"{H}, F {F}, B {B}; {n_valid} valid questions, {batches} batch of "
        f"T {T}): acc {step['acc']:.4f} (--executor mega "
        f"{runs['mega']['acc']:.4f}; phase's own evaluate "
        f"{seen['acc']:.4f}), {step['s']:.1f} s (mega "
        f"{runs['mega']['s']:.1f}); launches "
        f"{ {k: v for k, v in step['launches'].items() if v} }, no "
        f"executor_step and no megakernel launch, by cluster size "
        f"{step['clusters']}; argmax agreement with --executor mega "
        f"{same} of {n} on the valid split and {same_t} of {n_t} on the "
        f"train split (eval steps): {agree:.4f}; card {card}")

    # ---- the CLI's eval batch: its T calls against the other routes and
    # the plain version, then the calls timed at B 32, 128 and 1024
    eval_step = loop.make_eval_step(model, vtables)
    calls = record_step_calls(lambda: eval_step(vdict))
    require(len(calls) == T, f"[step defaults] {len(calls)} fused_step "
            f"calls, T {T}")
    err = hold_step_calls(calls, dtype)
    timed = {B: time_step_calls(calls, dtype)}
    clusters = {B: C}
    del calls
    for b in STEP_TIMED_BATCHES:
        if b == B:
            continue
        bdict, _, _ = default_batch(dev, targs, train_ds, model, tables, b,
                                    0, False)
        tstep = loop.make_eval_step(model, tables)
        calls = record_step_calls(lambda: tstep(bdict), clone=False)
        timed[b] = time_step_calls(calls, dtype)
        clusters[b] = TE.step_launch_cluster(route, b, F, H)
        del calls, bdict
        torch.cuda.empty_cache()
    what = ("equal bits to the general route" if dtype == torch.float32
            else "equal bits to one CTA a tile and to a second run")
    log(f"[step defaults] the evaluate CLI's batch ({vreal} of {B} rows "
        f"real): its {T} fused_step calls on {route!r} (clusters of {C}) "
        f"{what} in every output and the whole frames file, max_abs_err "
        f"{err:.3e} against the plain version; by graph replay: "
        + "; ".join(f"B {b} {route} {r['ms']:.4f} ms (clusters of "
                    f"{clusters[b]}), general {r['general_ms']:.4f}, plain "
                    f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.4f} "
                    f"({r['bound_by']})" for b, r in timed.items())
        + f"; card {card}")
    other = {}
    for b, r in timed.items():
        if b != B:
            other.update({f"b{b}_ms": r["ms"], f"b{b}_cluster": clusters[b],
                          f"b{b}_general_ms": r["general_ms"],
                          f"b{b}_plain_ms": r["plain_ms"],
                          f"b{b}_bound_ms": r["bound_ms"]})
    t = timed[B]
    return {"source": "stair_tpu_torch/ops/csrc/executor_step.cu",
            "replaces": "stair_tpu/ops/executor_step.py:49",
            "dtype": str(dtype).replace("torch.", ""),
            "path": f"train.evaluate --executor step at the NMN CLIs' "
            f"defaults, H {H} F {F} B {B} (phase 24)",
            "executor_route": route, "launches": step["launches"][key],
            "launches_path": f"{T} a batch, {batches} eval batch",
            "max_abs_err": err, "ms": t["ms"], "cluster": C,
            "general_ms": t["general_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "timing": "graph replay", **other}


def phase_step_clis(dev, card):
    """Phase 24: the evaluate CLI on ``--executor step`` at the NMN CLIs'
    defaults (H 512, F 150, B 32), in float32 on phase 22's best_model and
    in bf16 on phase 23's (``--config-filename``), over phase 22's world:
    #10 on its redesigned routes at F 150 ("fma32" over ``gemm32``'s row
    tiles, "tc" in its row-slice mode), no general step launch and no
    megakernel. Returns the two #10 entries at F 150."""
    t_phase = time.perf_counter()
    f32 = step_cli_run(dev, card, torch.float32, SEEN["defaults"])
    bf16 = step_cli_run(dev, card, torch.bfloat16, SEEN["bf16_defaults"])
    log(f"[step defaults] phase {time.perf_counter() - t_phase:.1f} s")
    return [{"name": name, "route": "cuda", **rec} for name, rec in (
        ("executor_step_fma32", f32), ("executor_step_tc", bf16))]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it runs only on an "
                         "NVIDIA GPU")
    from stair_tpu_torch.ops import _build
    from stair_tpu_torch.utils.device import card_identity, exact_f32
    from stair_tpu_torch.utils.mfu import chip_peak_flops, chip_peak_hbm_bw

    # The run mixes CUDA graphs with torch.profiler sessions. Kineto tears
    # CUPTI down after each session and sets it up again for the next, and
    # after graph replays such a session can record no device event at all
    # (phase 11 lost three in a row that way). Keep CUPTI set up between
    # sessions, as torch.profiler itself does for programs with CUDA graphs.
    os.environ["TEARDOWN_CUPTI"] = "0"
    os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"
    dev = torch.device("cuda", 0)
    card = card_identity().splitlines()[0]
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible")
    exact_f32()
    name = torch.cuda.get_device_name(0)
    peak, hbm = chip_peak_flops(dev), chip_peak_hbm_bw(dev)
    log(f"[mfu] utils/mfu.py peaks for {name}: {peak} FLOP/s dense bf16, "
        f"{hbm} bytes/s; card {card}")
    if "H100" in name:
        require(peak is not None and hbm is not None,
                f"utils/mfu.py has no peaks for {name}")
    if name == "NVIDIA H100 80GB HBM3":
        require(peak == PEAK_FLOPS[torch.bfloat16] and hbm == PEAK_BYTES,
                "utils/mfu.py's H100 SXM peaks differ from the bounds'")

    t0 = time.perf_counter()
    _build.build()
    log(f"[build] nvcc sm_90a: {time.perf_counter() - t0:.1f} s "
        f"({'cached' if _build.BUILD_INFO['cached'] else 'compiled'}); "
        f"each source done at {_build.BUILD_INFO['source_seconds']} s")
    report = _build.ptxas_report(_build.BUILD_INFO["log"])
    # the attention backward's and the executor's tensor-core kernels, the
    # BiLSTM's float32 cluster forward, walk and dwh, the executor's
    # float32 "fma32" kernels and the attention's float32 tensor-core
    # kernels are designed to keep their accumulators and state in
    # registers
    no_spill = ("flash_bwd_dq_mma", "flash_bwd_dkv_mma",
                "mega_exec_tc_kernel<false", "mega_exec_tc_kernel<true",
                "mega_bwd_tc_kernel", "mega_wgrad_tc_kernel",
                "executor_step_tc_kernel", "executor_step_fma32_kernel",
                "bilstm_fwd_f32_kernel",
                "bilstm_bwd_f32_kernel", "bilstm_dwh_f32_kernel",
                "mega_exec_kernel<float, true>",
                "mega_bwd_kernel<float, true>", "mega_wgrad_fma32_kernel",
                "mega_wgrad_index_kernel", "flash_fwd_mma32",
                "flash_bwd_dq_mma32", "flash_bwd_dkv_mma32")
    require(_build.BUILD_INFO["cached"] or all(
        any(r["kernel"].startswith(k) for r in report) for k in no_spill),
        f"the build log names not all of {no_spill}")
    for r in report:
        log(f"[build] ptxas {r['kernel']}: {r.get('registers')} registers, "
            f"{r.get('spill_stores')} bytes spill stores, "
            f"{r.get('spill_loads')} bytes spill loads")
        if r["kernel"].startswith(no_spill):
            require(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
                    f"ptxas spills in {r['kernel']}: {r}")
        # two CTAs an SM (__launch_bounds__(THREADS, 2)): 65,536 registers
        # over 2 x 256 threads
        if r["kernel"].startswith("executor_step_fma32_kernel"):
            require((r.get("registers") or 999) <= 128,
                    f"executor_step_fma32_kernel above 128 registers: {r}")

    phase_lstm(dev)
    phase_mega(dev)
    kernels = phase_slice(dev, card)
    phase_lstm_train(dev)
    phase_mega_train(dev)
    kernels += phase_train(dev, card)
    phase_attention(dev, card)
    entries, model = phase_videochat(dev, card)
    kernels += entries
    phase_demo(dev, card, model)
    phase_attention_bwd(dev, card)
    kernels += phase_sft(dev, card, model)
    del model
    torch.cuda.empty_cache()
    phase_sft_routes(dev)
    kernels += phase_trainers(dev)
    slot_entries = phase_slots(dev, card)
    general_launches = phase_step_kernel(dev)
    kernels += phase_step_slice(dev, card, general_launches)
    kernels += phase_rev_train(dev, card, slot_entries)
    clis = phase_clis(dev, card)
    try:
        kernels += phase_parser(dev, card, clis)
        phase_data_parallel(dev, card, clis)
    finally:
        shutil.rmtree(clis["root"], ignore_errors=True)
    root = tempfile.mkdtemp(prefix="stair_defaults_")
    try:
        kernels += phase_default_clis(dev, card, root)
        kernels += phase_bf16_clis(dev, card, root)
        kernels += phase_step_clis(dev, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[f32 routes] {json.dumps(SEEN.get('f32', []))}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
