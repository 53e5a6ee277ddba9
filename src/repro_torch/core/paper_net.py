"""The paper's network (Table I), bit- and schedule-faithful.

1024 -> 64 -> 32 with pre-defined sparsity (d1_out = 4 / 6.25 %, d2_out =
16 / 50 %), trained with explicit FF / BP / UP passes per eqs. (1)-(3),
not autodiff, in (b_w, b_n, b_f) fixed point with clipping tree adders
and a LUT sigmoid.  ``fmt=None`` gives the ideal floating-point network
the paper compares against.

Two training schedules:
  * ``train_epoch``: sequential online SGD, one input at a time.
  * ``train_epoch_pipelined``: the paper's junction pipelining (Fig. 1).
    At clock t, J1 does FF(t) and UP(t-3), J2 does FF(t-1), BP(t-2) and
    UP(t-2), all reading the state as it was at the start of the clock,
    so weight updates land with the FPGA's exact staleness.

Plain functions on tensors.  Parameters are ``{"junctions": [{w, b, idx,
rev_j, rev_f}, ...]}``; the patterns are int32.  The epoch loops keep
their losses and corrects on the device and read nothing back to the
host on the way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core.sparsity import NeuronPattern, make_neuron_pattern
from repro_torch.device import resolve_device

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PaperNetConfig:
    layers: tuple = (1024, 64, 32)          # N_0, N_1, N_2
    d_out: tuple = (4, 16)                  # fan-out per junction (Table I)
    z: tuple = (128, 32)                    # degree of parallelism (Table I)
    fmt: Optional[fxp.FxpFormat] = fxp.PAPER_FMT
    activation: str = "sigmoid"             # sigmoid | relu8 | relu1
    init_mode: str = "random"               # random | shared (Sec. III-C-1)
    seed: int = 0

    @property
    def n_junctions(self) -> int:
        return len(self.layers) - 1

    def d_in(self, i: int) -> int:
        return self.layers[i] * self.d_out[i] // self.layers[i + 1]

    def weights(self, i: int) -> int:
        return self.layers[i] * self.d_out[i]

    def block_cycles(self, i: int) -> int:
        """W_i / z_i (+2 for memory-access stages, Sec. III-D-6)."""
        return self.weights(i) // self.z[i] + 2

    def density(self, i: int) -> float:
        return self.d_out[i] / self.layers[i + 1]

    def overall_density(self) -> float:
        w = sum(self.weights(i) for i in range(self.n_junctions))
        full = sum(self.layers[i] * self.layers[i + 1]
                   for i in range(self.n_junctions))
        return w / full

    def n_params(self) -> int:
        return (sum(self.weights(i) for i in range(self.n_junctions))
                + sum(self.layers[1:]))


def patterns(cfg: PaperNetConfig) -> list[NeuronPattern]:
    return [make_neuron_pattern(cfg.layers[i], cfg.layers[i + 1],
                                cfg.d_in(i), z=cfg.z[i], seed=cfg.seed + i)
            for i in range(cfg.n_junctions)]


def reverse_pattern(pat: NeuronPattern) -> tuple[np.ndarray, np.ndarray]:
    """For BP: per left neuron, the (right neuron, slot) pairs reading it."""
    n_in, d_out = pat.n_in, pat.d_out
    rev_j = np.full((n_in, d_out), -1, np.int32)
    rev_f = np.full((n_in, d_out), -1, np.int32)
    fill = np.zeros(n_in, np.int64)
    for j in range(pat.n_out):
        for f in range(pat.idx.shape[1]):
            k = int(pat.idx[j, f])
            rev_j[k, fill[k]] = j
            rev_f[k, fill[k]] = f
            fill[k] += 1
    assert np.all(fill == d_out), "pattern not fan-out balanced"
    return rev_j, rev_f


def init(cfg: PaperNetConfig, generator: torch.Generator | None = None,
         device=None) -> Params:
    """Glorot-normal over the actual degrees (Sec. III-C-1); biases drawn
    like weights (the FPGA keeps them in the same memories).  Draws from
    ``generator`` (default: a CPU generator seeded with ``cfg.seed``) on
    its own device, then moves to ``device`` (default: the card)."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator()
        gen.manual_seed(cfg.seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    params: Params = {"junctions": []}
    for i, pat in enumerate(patterns(cfg)):
        std = float(np.sqrt(2.0 / (cfg.d_out[i] + cfg.d_in(i))))
        if cfg.init_mode == "shared":
            # W_i / z_i unique values replicated across the z_i memories
            uw = normal(cfg.weights(i) // cfg.z[i]) * std
            w = uw.repeat(cfg.z[i]).reshape(pat.n_out, pat.idx.shape[1])
            b = uw[:1].repeat(pat.n_out)
        else:
            w = normal(*pat.idx.shape) * std
            b = normal(pat.n_out) * std
        rev_j, rev_f = reverse_pattern(pat)
        w, b = w.to(dev), b.to(dev)
        if cfg.fmt is not None:
            w = fxp.quantize(w, cfg.fmt)
            b = fxp.quantize(b, cfg.fmt)
        params["junctions"].append({
            "w": w, "b": b,
            "idx": torch.as_tensor(pat.idx, device=dev),
            "rev_j": torch.as_tensor(rev_j, device=dev),
            "rev_f": torch.as_tensor(rev_f, device=dev),
        })
    return params


def tables_on(cfg: PaperNetConfig, device) -> tuple | None:
    """The sigmoid tables of ``cfg.fmt`` as tensors on ``device`` (None
    without a format): made once, so a step copies nothing to the card."""
    if cfg.fmt is None:
        return None
    return tuple(torch.as_tensor(t, device=device)
                 for t in fxp.sigmoid_tables(cfg.fmt))


# ------------------------------------------------------------------ ops
def _q(x, fmt):
    return x if fmt is None else fxp.quantize(x, fmt)


def _gather(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[..., idx]: [..., N] by int32 idx [R, C] -> [..., R, C]."""
    return torch.index_select(a, -1, idx.reshape(-1)).reshape(
        *a.shape[:-1], *idx.shape)


def _act(s, cfg: PaperNetConfig, tables):
    if cfg.activation == "sigmoid":
        if cfg.fmt is None:
            a = torch.sigmoid(s)
            return a, a * (1 - a)
        return fxp.lut_sigmoid(s, cfg.fmt, tables)
    clip_at = 8.0 if cfg.activation == "relu8" else 1.0
    if cfg.fmt is None:
        return (torch.clamp(s, 0, clip_at),
                ((s > 0) & (s < clip_at)).to(s.dtype))
    return fxp.relu_clipped(s, cfg.fmt, clip_at)


def ff_junction(jp: Params, a_prev, cfg: PaperNetConfig, i: int, tables):
    """eq. (1): s_j = sum_f w[j,f] * a_prev[idx[j,f]] + b_j (clipping
    tree); returns (a, a_dot, s)."""
    fmt = cfg.fmt
    prod = _q(jp["w"] * _gather(a_prev, jp["idx"]), fmt)
    if fmt is None:
        s = torch.sum(prod, dim=-1) + jp["b"]
    else:
        s = fxp.q_add(fxp.tree_sum_clipped(prod, fmt), jp["b"], fmt)
    a, adot = _act(s, cfg, tables)
    return a, adot, s


def forward(params: Params, x, cfg: PaperNetConfig, tables=None):
    """Full FF pass.  x [..., N_0] -> (activations [a_0 .. a_L], their
    derivatives [None, a'_1 .. a'_L])."""
    tables = tables or tables_on(cfg, x.device)
    acts, adots = [x], [None]
    a = x
    for i, jp in enumerate(params["junctions"]):
        a, adot, _ = ff_junction(jp, a, cfg, i, tables)
        acts.append(a)
        adots.append(adot)
    return acts, adots


def bp_junction(jp: Params, delta_next, adot, cfg: PaperNetConfig):
    """eq. (2b): delta_i[k] = adot[k] * sum over the d_out edges of w*delta.
    The weights are gathered afresh on every call: w changes every input."""
    fmt = cfg.fmt
    w_rev = jp["w"][jp["rev_j"], jp["rev_f"]]                # [N_in, d_out]
    prod = _q(w_rev * _gather(delta_next, jp["rev_j"]), fmt)
    if fmt is None:
        s = torch.sum(prod, dim=-1)
    else:
        s = fxp.tree_sum_clipped(prod, fmt)
    return _q(adot * s, fmt)


def up_junction(jp: Params, a_prev, delta, eta, cfg: PaperNetConfig) -> Params:
    """eq. (3): w -= eta * a_prev[idx] * delta ; b -= eta * delta.  eta is
    a power of two, so eta * x is exact on the grid (a bit shift).  Leading
    batch axes are averaged over (a mini-batch)."""
    fmt = cfg.fmt
    gw = _q(_gather(a_prev, jp["idx"]) * delta[..., None], fmt)
    if gw.dim() > jp["w"].dim():
        gw = gw.mean(dim=tuple(range(gw.dim() - jp["w"].dim())))
        gd = delta.mean(dim=tuple(range(delta.dim() - jp["b"].dim())))
    else:
        gd = delta
    new_w = _q(jp["w"] - eta * gw, fmt)
    new_b = _q(jp["b"] - eta * gd, fmt)
    return dict(jp, w=new_w, b=new_b)


def output_delta(a_out, y, cfg: PaperNetConfig):
    """eq. (2a): cross-entropy with a sigmoid output -> delta_L = a_L - y."""
    return _q(a_out - y, cfg.fmt)


# ------------------------------------------------------------------ training
def _loss(a_out, y):
    return -torch.mean(y * torch.log(torch.clamp(a_out, 1e-7, 1.0))
                       + (1 - y) * torch.log(torch.clamp(1 - a_out, 1e-7,
                                                         1.0)))


def _correct(out, y):
    return (torch.argmax(out, -1) == torch.argmax(y, -1)).float()


def sgd_step(params: Params, x, y, eta, cfg: PaperNetConfig, tables=None):
    """One sequential FF -> BP -> UP pass: (new params, loss, output)."""
    acts, adots = forward(params, x, cfg, tables)
    L = cfg.n_junctions
    deltas = [None] * (L + 1)
    deltas[L] = output_delta(acts[L], y, cfg)
    for i in range(L - 1, 0, -1):
        deltas[i] = bp_junction(params["junctions"][i], deltas[i + 1],
                                adots[i], cfg)
    new_j = [up_junction(params["junctions"][i], acts[i], deltas[i + 1], eta,
                         cfg) for i in range(L)]
    return {"junctions": new_j}, _loss(acts[L], y), acts[L]


def train_epoch(params: Params, xs, ys, eta, cfg: PaperNetConfig):
    """Online SGD over the inputs xs [n, N_0] with one-hot targets ys:
    (params, losses [n], corrects [n]), all on xs's device."""
    tables = tables_on(cfg, xs.device)
    n = xs.shape[0]
    losses = torch.empty(n, device=xs.device)
    corrects = torch.empty(n, device=xs.device)
    for t in range(n):
        params, loss, out = sgd_step(params, xs[t], ys[t], eta, cfg, tables)
        losses[t] = loss
        corrects[t] = _correct(out, ys[t])
    return params, losses, corrects


def train_epoch_pipelined(params: Params, xs, ys, eta, cfg: PaperNetConfig):
    """Junction-pipelined training of the L = 2 network (Fig. 1):
    (params, corrects [n]); corrects[t] scores input t - 1.

    Clock t (every op reads start-of-clock state; updates land at its end):
      J1.FF(t)    J2.FF(t-1) + cost    J2.BP(t-2)    J2.UP(t-2)    J1.UP(t-3)
    The FIFOs of inputs in flight start as zeros, as the FPGA's do."""
    assert cfg.n_junctions == 2, "clocked schedule is specialized to L=2"
    tables = tables_on(cfg, xs.device)
    N0, N1, N2 = cfg.layers
    n = xs.shape[0]

    def zeros(m):
        return torch.zeros(m, dtype=xs.dtype, device=xs.device)

    a0 = [zeros(N0)] * 4        # inputs t, t-1, t-2, t-3
    yq = [zeros(N2)] * 4
    a1 = [zeros(N1)] * 3        # J1.FF outputs of inputs t-1, t-2, t-3
    adot1 = [zeros(N1)] * 3
    delta2 = zeros(N2)          # J2's cost of input t-2 (last clock's)
    delta1 = zeros(N1)          # J2.BP of input t-3 (last clock's)
    corrects = torch.empty(n, device=xs.device)
    for t in range(n):
        j1, j2 = params["junctions"]
        a0 = [xs[t]] + a0[:3]
        yq = [ys[t]] + yq[:3]
        a1_t, adot1_t, _ = ff_junction(j1, xs[t], cfg, 0, tables)
        a2_tm1, _, _ = ff_junction(j2, a1[0], cfg, 1, tables)
        delta2_tm1 = output_delta(a2_tm1, yq[1], cfg)
        delta1_tm2 = bp_junction(j2, delta2, adot1[1], cfg)
        j2_new = up_junction(j2, a1[1], delta2, eta, cfg)
        j1_new = up_junction(j1, a0[3], delta1, eta, cfg)
        a1 = [a1_t] + a1[:2]
        adot1 = [adot1_t] + adot1[:2]
        delta2, delta1 = delta2_tm1, delta1_tm2
        corrects[t] = _correct(a2_tm1, yq[1])
        params = {"junctions": [j1_new, j2_new]}
    return params, corrects
