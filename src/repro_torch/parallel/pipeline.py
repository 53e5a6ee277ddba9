"""Pipeline parallelism: the paper's junction pipelining at mesh scale.

The FPGA runs all L junctions at once on different inputs with FF, BP and
UP overlapped (Fig. 1), updating weights with bounded staleness.  Here
the junctions are "stages": ``stage_fn(stage_params, x) -> y`` with x
and y of one shape, the stages' params stacked on a leading axis whose
length is the number of stages S.  One process runs every stage: each
tick computes every stage's body on what that stage read at the start of
the tick, then the buffers move as the reference's ``ppermute`` moves
them (activations right, stage 0 reading zeros from the left;
gradients left, the last stage reading zeros from the right).

* ``gpipe_forward`` / ``gpipe_loss`` / ``gpipe_step`` — the synchronous
  microbatch pipeline (the baseline the paper implicitly beats): the
  forward streams M + S - 1 ticks and autograd reverses it through the
  buffer moves; bubble fraction (S - 1) / (M + S - 1) each way.
* ``async_pipeline_epoch`` — the paper's schedule: every tick each stage
  does FF on one microbatch, BP on another and UP with the gradient that
  just arrived; weights update with staleness 2 (S - s) - 1 ticks and
  there is no bubble once warm (PipeDream-style semantics).

A stage whose microbatch index is out of range at a tick does nothing:
the reference computes it and masks it to zeros (its activation, its
update and, as its cotangent is zero, its gradient), so the results are
equal for finite values and a tick of an epoch runs S * M stage
forwards and S * M stage vjps in all.  A stage's vjp recomputes its
forward with the current params on the input stashed at its FF (the
reference's ``jax.vjp``), then ``torch.autograd.grad`` with respect to
its float params and that input; a junction stage thus launches the
junction's dx and dw.  Updates are ``p - lr * g`` in fp32, stored in
p's dtype.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.tree import tree_leaves, tree_map


def _n_stages(params_stacked) -> int:
    return next(t.shape[0] for t in tree_leaves(params_stacked)
                if torch.is_tensor(t))


def _stage(params_stacked, s: int):
    return tree_map(lambda t: t[s], params_stacked)


def _stack(stages):
    return tree_map(lambda *ts: torch.stack(ts), stages[0], *stages[1:])


def _trainable(t) -> bool:
    return torch.is_tensor(t) and t.is_floating_point()


def _sgd(params, grads, lr: float):
    return tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype)
                    if _trainable(p) else p, params, grads)


def _with_grad(tree, live: list):
    """``tree`` with each float leaf replaced by a grad-requiring alias
    (appended to ``live``)."""
    def one(t):
        if not _trainable(t):
            return t
        a = t.detach().requires_grad_(True)
        live.append(a)
        return a
    return tree_map(one, tree)


def _grads(tree, got):
    """A tree like ``tree`` with the gradients ``got`` (in ``_with_grad``'s
    order) at its float leaves, None elsewhere."""
    it = iter(got)
    return tree_map(lambda t: next(it) if _trainable(t) else None, tree)


# ===================================================================== GPipe
def gpipe_forward(stage_fn: Callable, params_stacked, x_microbatches):
    """The forward pipeline: x_microbatches [M, mb, ...] through the S
    stages of params_stacked.  Returns the last stage's outputs [M, mb,
    ...]."""
    S = _n_stages(params_stacked)
    M = x_microbatches.shape[0]
    stages = [_stage(params_stacked, s) for s in range(S)]
    zeros = torch.zeros_like(x_microbatches[0])
    bufs = [zeros] * S
    outs = [None] * M
    for t in range(M + S - 1):
        sent = []
        for s in range(S):
            m = t - s                      # the microbatch at stage s
            y = zeros
            if 0 <= m < M:
                y = stage_fn(stages[s], x_microbatches[m] if s == 0
                             else bufs[s])
                if s == S - 1:
                    outs[m] = y
            sent.append(y)
        bufs = [zeros] + sent[:-1]         # shift right
    return torch.stack(outs)


def gpipe_loss(stage_fn, loss_fn, params_stacked, xs, ys):
    return loss_fn(gpipe_forward(stage_fn, params_stacked, xs), ys)


def gpipe_step(stage_fn, loss_fn, params_stacked, xs, ys, lr: float):
    """One synchronous training step (autograd through the pipeline):
    (new params_stacked, loss)."""
    live: list = []
    aliased = _with_grad(params_stacked, live)
    with torch.enable_grad():
        loss = gpipe_loss(stage_fn, loss_fn, aliased, xs, ys)
        got = torch.autograd.grad(loss, live)
    return _sgd(params_stacked, _grads(params_stacked, got), lr), \
        loss.detach()


# ============================================================== async (paper)
def _vjp(stage_fn, params, x, g):
    """(d params, d x) of ``stage_fn`` at (params, x) for cotangent g."""
    live: list = []
    aliased = _with_grad(params, live)
    xa = x.detach().requires_grad_(True)
    with torch.enable_grad():
        y = stage_fn(aliased, xa)
        got = torch.autograd.grad(y, live + [xa], grad_outputs=g,
                                  allow_unused=True)
    got = [torch.zeros_like(a) if d is None else d
           for a, d in zip(live + [xa], got)]
    return _grads(params, got[:-1]), got[-1]


def async_pipeline_epoch(stage_fn: Callable, loss_grad_fn: Callable,
                         params_stacked, xs, ys, lr: float):
    """The paper's asynchronous pipeline over one epoch of M microbatches
    (FF / BP / UP overlapped, stale updates, no bubble).  Per tick, per
    stage s (every read at the tick's start, every write at its end):

      FF : x from stage s-1 (stage 0: microbatch t), stash it, send the
           activation right; the last stage's ``loss_grad_fn(y, target)
           -> (dy, loss)`` starts the gradient back
      BP : the gradient from stage s+1, the stash of microbatch
           t - (2S - s - 2), vjp -> (d params, d x); send d x left
      UP : params -= lr * d params

    Returns (new params_stacked, losses [S * T], T = M + 2S): stage s's
    row of T ticks at [s * T, (s + 1) * T), the losses in the last
    stage's row at the ticks its FF ran, zeros elsewhere."""
    S = _n_stages(params_stacked)
    M = xs.shape[0]
    T = M + 2 * S
    stages = [_stage(params_stacked, s) for s in range(S)]
    zeros = torch.zeros_like(xs[0])
    act, grad = [zeros] * S, [zeros] * S
    stash = [{} for _ in range(S)]
    losses = torch.zeros(S * T, dtype=torch.float32, device=xs.device)
    for t in range(T):
        right, left = [zeros] * S, [zeros] * S
        for s in range(S):
            p = stages[s]
            m_f, dy = t - s, None
            if 0 <= m_f < M:
                x_in = xs[m_f] if s == 0 else act[s]
                with torch.no_grad():
                    right[s] = stage_fn(p, x_in)
                stash[s][m_f] = x_in
                if s == S - 1:
                    dy, loss = loss_grad_fn(right[s], ys[m_f])
                    losses[(S - 1) * T + t] = loss
            m_b = t - (2 * S - s - 2)
            if 0 <= m_b < M:
                g_in = dy if s == S - 1 else grad[s]
                dp, left[s] = _vjp(stage_fn, p, stash[s].pop(m_b), g_in)
                stages[s] = _sgd(p, dp, lr)
        act = [zeros] + right[:-1]
        grad = left[1:] + [zeros]
    return _stack(stages), losses


def bubble_fraction(n_stages: int, n_microbatches: int,
                    schedule: str = "gpipe") -> float:
    """Idle fraction per stage: the paper's zero-bubble claim quantified."""
    if schedule == "gpipe":
        return 2.0 * (n_stages - 1) / (n_microbatches + 2.0 * (n_stages - 1))
    return 0.0  # async: every tick does useful FF+BP+UP once warm
