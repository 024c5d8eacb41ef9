"""AdamW and the learning-rate schedules of the two LLM trainers, written
to match optax step for step.

``optax.adamw(schedule, weight_decay)`` reads the schedule at the step
count before the update (step 0 uses ``schedule(0)``) and applies ``p -= lr
* (m_hat / (sqrt(v_hat) + 1e-8) + weight_decay * p)``. That is
``torch.optim.AdamW`` (betas 0.9 / 0.999, eps 1e-8, decoupled decay) under
a ``LambdaLR`` stepped after each update; the optimizer's base rate is 1 so
the lambda is the rate itself.
"""

from __future__ import annotations

import math

import torch


def linear_schedule(init_value, end_value, transition_steps):
    """``optax.linear_schedule``: from ``init_value`` to ``end_value`` over
    ``transition_steps``, constant after."""
    if transition_steps <= 0:
        return lambda step: end_value

    def schedule(step):
        frac = 1.0 - min(max(step, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps,
                                 decay_steps, end_value=0.0):
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine to ``end_value``
    that ends at ``decay_steps`` (counted from step 0)."""
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={cos_steps}.")
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    alpha = 0.0 if peak_value == 0 else end_value / peak_value

    def schedule(step):
        if step < warmup_steps:
            return warm(step)
        count = min(step - warmup_steps, cos_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / cos_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def make_adamw(params, schedule, weight_decay):
    """``(AdamW, LambdaLR)`` over ``params`` under ``schedule`` (a function
    of the step count that returns the rate)."""
    opt = torch.optim.AdamW(list(params), lr=1.0, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda=schedule)
    return opt, scheduler


def make_step(loss_fn, optimizer):
    """``step(batch) -> loss`` (a 0-d tensor, not fetched): zero the
    gradients, ``loss_fn(batch)``, backward, one AdamW update, advance the
    schedule. ``optimizer`` is ``make_adamw``'s pair. A parameter the loss
    did not reach gets a zero gradient, as ``jax.grad`` gives, so that it
    still decays."""
    opt, scheduler = optimizer
    held = [p for group in opt.param_groups for p in group["params"]]

    def step(batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(batch)
        loss.backward()
        for p in held:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        scheduler.step()
        return loss.detach()

    step.optimizer, step.scheduler = opt, scheduler
    return step
