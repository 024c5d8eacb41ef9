"""The NMN train step (port of ``stair_tpu/train/loop.py``
``lr_schedule``, ``make_train_step`` on one device, ``metrics_of``).

One step: the training forward (encoders and executor through their
forward/backward kernel pairs, dropout), ``total_loss``, ``backward``, and
an Adam update with the trainer's linear learning-rate schedule. Adam
follows ``optax.adam(lr_schedule)``: ``m_hat / (sqrt(v_hat) + 1e-8)`` with
the schedule read at the step count before the update, which is what
``torch.optim.Adam`` under a ``LambdaLR`` stepped after each update gives.
``args`` is the trainer's argument namespace (the port's own
``train/args.py``): lr, scheduler_start_factor /
scheduler_end_factor / scheduler_total_iters, module_loss_weight,
decoder_loss_weight, modules_no_intermediate_train, contrastive_window.
The data-parallel route waits for a later slice.
"""

from __future__ import annotations

import argparse

import torch

from stair_tpu_torch.train.args import build_parser
from stair_tpu_torch.train.losses import total_loss


def trainer_defaults(**overrides) -> argparse.Namespace:
    """The trainer CLI's argument defaults (``train/args.py``) as a namespace, with ``overrides`` applied."""
    parser = build_parser()
    ns = {a.dest: a.default for a in parser._actions if a.dest != "help"}
    ns.update(overrides)
    return argparse.Namespace(**ns)


def lr_schedule(args):
    """Linear start -> end factor of ``args.lr`` over total iters, then
    flat: step -> learning rate."""
    start, end = args.scheduler_start_factor, args.scheduler_end_factor
    total = max(1.0, float(args.scheduler_total_iters))

    def schedule(step):
        frac = min(float(step), total) / total
        return args.lr * (start + (end - start) * frac)

    return schedule


def make_optimizer(model, args):
    """``(Adam, LambdaLR)`` over the model's parameters with the trainer's
    schedule (optax.adam's betas and eps)."""
    opt = torch.optim.Adam(model.parameters(), lr=args.lr,
                           betas=(0.9, 0.999), eps=1e-8)
    sched = lr_schedule(args)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: sched(step) / args.lr)
    return opt, scheduler


def metrics_of(loss, aux):
    return {
        "loss": loss,
        "decoder_loss": aux["scalars"]["decoder_loss"].detach(),
        "module_loss": aux["scalars"]["module_loss"].detach(),
        "loss_sums": aux["telemetry"]["loss_sums"].detach(),
        "loss_counts": aux["telemetry"]["loss_counts"].detach(),
    }


def make_train_step(model, args, optimizer=None):
    """-> ``train_step(batch, generator, module_gate, decoder_gate)``,
    which updates ``model`` in place and returns the step's metrics (on
    the device; nothing is fetched). ``optimizer`` is an ``(Adam,
    LambdaLR)`` pair, ``make_optimizer``'s by default."""
    opt, scheduler = optimizer or make_optimizer(model, args)
    train_filterframe = "FilterFrame" not in (
        args.modules_no_intermediate_train or [])
    window = getattr(args, "contrastive_window", 0) or 0

    def train_step(batch, generator, module_gate, decoder_gate):
        opt.zero_grad(set_to_none=True)
        loss, aux = total_loss(
            model, batch, generator,
            module_loss_weight=args.module_loss_weight,
            decoder_loss_weight=args.decoder_loss_weight,
            module_gate=module_gate, decoder_gate=decoder_gate,
            deterministic=False, train_filterframe=train_filterframe,
            contrastive_window=window)
        loss.backward()
        opt.step()
        scheduler.step()
        return metrics_of(loss.detach(), aux)

    train_step.optimizer = opt
    train_step.scheduler = scheduler
    return train_step
