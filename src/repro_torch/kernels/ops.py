"""Public entry of the junction kernels, and the kernels' launch counts.

``junction_matmul`` is the pre-defined-sparse junction
y = act(x @ W_sparse + bias) as a ``torch.autograd.Function``: forward
through ``bsm.fwd`` (saving the pre-activation for silu/gelu), backward
through ``bsm.dx`` and ``bsm.dw``.  A 4-D weight ``[nob, kb, bs, bs]`` is
a single junction (the kernels' E=1 case): x may carry any leading dims
and the result is squeezed back.  A 5-D weight ``[E, nob, kb, bs, bs]``
is E units sharing one pattern.  The weight is cast to x's dtype on every
call, outside the Function, so its gradient is the fp32 kernel sum
rounded to x's dtype and widened back to the master's dtype, as the
reference's does; a junction without bias gets a zero bias that takes no
gradient.  ``wi=`` (shaped like w) makes it the gated junction
silu(x @ w) * (x @ wi) (the MoE expert FFN's gate), one forward through
``bsm.gated_fwd`` saving (g, u) and a backward through ``bsm.gated_dx``
and ``bsm.gated_dw``; it takes no bias and no activation.

``junction_train_update`` is the fused BP+UP twin: the same forward, but
its backward runs ``dx`` against the old weights and then ``update_dw``,
which applies the optimizer step to w, b and the fp32 slots in place
(under ``no_grad``), so the weight gradient never reaches device memory;
with ``wi=`` its backward runs ``gated_dx`` and then ``update_gated_dw``
on both weight streams.
It returns no gradient for those tensors; with a ``health`` tensor it
writes the per-unit count of non-finite (e, o) update tiles into it.
The wrappers pick the CUDA kernel for a CUDA tensor and the plain
version for a CPU or meta tensor.

``fxp_qmatmul`` and ``sigmoid_lut`` are the reference's entry points of
the fixed-point matmul and the table lookup; ``selective_scan`` and
``flash_attention.mha`` are called from their own modules.

Quantized junctions (core/quantize.py's integer codes) go through
``junction_matmul`` too: ``w_scale`` (with ``wi_scale`` for the gate)
selects the int8 kernels, ``qfmt`` with ``qlut`` the fixed-point one.
They are forward only (no autograd Function, nothing to differentiate),
the codes are read as they are and the bias goes in as fp32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fxp_qmatmul as fxpk
from repro_torch.kernels import selective_scan as ssk
from repro_torch.kernels import sigmoid_lut as slut

_COUNTED = {"junction_fwd": bsm.fwd, "junction_dx": bsm.dx,
            "junction_dw": bsm.dw, "junction_update_dw": bsm.update_dw,
            "junction_gated_fwd": bsm.gated_fwd,
            "junction_gated_dx": bsm.gated_dx,
            "junction_gated_dw": bsm.gated_dw,
            "junction_update_gated_dw": bsm.update_gated_dw,
            "junction_fwd_int8": bsm.fwd_int8,
            "junction_gated_fwd_int8": bsm.gated_fwd_int8,
            "junction_fwd_fxp": bsm.fwd_fxp,
            "flash_decode": fa.flash_decode,
            "flash_attention": fa.flash_attention,
            "selective_scan": ssk.selective_scan,
            "qmatmul": fxpk.qmatmul,
            "lut_lookup": slut.lut_lookup}


# the kernels with a tensor-core entry point beside their SIMT one
_TC_COUNTED = ("junction_fwd", "junction_dx", "junction_dw",
               "junction_update_dw", "junction_gated_fwd",
               "junction_gated_dx", "junction_gated_dw",
               "junction_update_gated_dw")


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def tc_launch_counts() -> dict[str, int]:
    """Of those, the launches of the tensor-core entry points."""
    return {name: _COUNTED[name].tc_launches for name in _TC_COUNTED}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0
    for name in _TC_COUNTED:
        _COUNTED[name].tc_launches = 0


def resolve_engine(engine: str) -> str:
    """'auto' and 'pallas' -> 'pallas': the kernels on a CUDA tensor and
    their plain versions on a CPU tensor, both eligible for the fused
    update; 'jnp' keeps the two-pass path."""
    if engine in ("auto", "pallas"):
        return "pallas"
    if engine == "jnp":
        return "jnp"
    raise ValueError(f"unknown engine {engine!r} (pallas | jnp | auto)")


def _forward(x3, w5, b2, idx, act):
    """(y, residual) through the forward kernel: the residual is the
    pre-activation for silu / gelu, y for relu / sigmoid, None for none."""
    if act in bsm.ACT_NEEDS_PRE:
        return bsm.fwd(x3, w5, idx, b2, act, save_pre=True)
    y = bsm.fwd(x3, w5, idx, b2, act)
    return y, (None if act == "none" else y)


class _Junction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, w5, b2, idx, rev_ob, rev_t, rev_cnt, act,
                has_bias):
        y, res = _forward(x3, w5, b2, idx, act)
        ctx.act, ctx.has_bias = act, has_bias
        ctx.save_for_backward(x3, w5, res, idx, rev_ob, rev_t, rev_cnt)
        return y

    @staticmethod
    def backward(ctx, dy):
        x3, w5, res, idx, rev_ob, rev_t, rev_cnt = ctx.saved_tensors
        dy = dy.contiguous()
        dxv = (bsm.dx(dy, w5, rev_ob, rev_t, rev_cnt, res, ctx.act)
               if ctx.needs_input_grad[0] else None)
        dwv = dbv = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dwv, dbv = bsm.dw(x3, dy, idx, res, ctx.act,
                              with_bias=ctx.has_bias)
            dwv = dwv.to(w5.dtype)
            if ctx.needs_input_grad[2]:
                dbv = (torch.zeros((dy.shape[0], dy.shape[2]),
                                   dtype=torch.float32, device=dy.device)
                       if dbv is None else dbv).to(x3.dtype)
        return dxv, dwv, dbv, None, None, None, None, None, None


class WholeJunction:
    """The weights (w and the bias, or the gate's wg and wi) and fp32
    slots (mom, mom_b, vel, vel_b, or the gate's mom_wg, mom_wi, vel_wg,
    vel_wi; None where absent) of a fused junction as one rank holds them
    whole: the kernels read them and update them in place.  The
    partitioned mesh steps hand ``junction_train_update`` a holder of the
    same interface instead (``parallel/partition.HeldJunction``), which
    gathers the rank's shards where the kernels read them, gathers the
    update's operands over the rows of every rank and places the update
    back."""

    def __init__(self, weights: tuple, slots: tuple):
        self.weight_vals, self.slot_vals = weights, slots

    def weights(self):
        return self.weight_vals

    def slots(self):
        return self.slot_vals

    def update_operands(self, *ops):
        """The row-major operands over the rows the update sums over:
        (x, dy, the residual) of a plain junction, (x, dh, g, u) of the
        gate."""
        return ops

    def commit(self, weights, slots):
        """Keep the updated tensors (here they are the held ones)."""


class _JunctionUpdate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, held, idx, rev_ob, rev_t, rev_cnt, act, has_bias,
                single, hyp, health):
        lift = _lifter(single)
        w, b = held.weights()
        w5 = lift(w)
        b2 = (torch.zeros((x3.shape[0], w5.shape[1] * w5.shape[4]),
                          dtype=x3.dtype, device=x3.device) if b is None
              else lift(b))
        y, res = _forward(x3, w5, b2, idx, act)
        ctx.act, ctx.has_bias, ctx.lift = act, has_bias, lift
        # the parameters and slots are updated in place by the backward:
        # their holder rides as an attribute, not as saved tensors
        ctx.held, ctx.hyp, ctx.health = held, hyp, health
        ctx.save_for_backward(x3, res, idx, rev_ob, rev_t, rev_cnt)
        return y

    @staticmethod
    def backward(ctx, dy):
        x3, res, idx, rev_ob, rev_t, rev_cnt = ctx.saved_tensors
        held, lift = ctx.held, ctx.lift
        dy = dy.contiguous()
        w, b = held.weights()
        w5 = lift(w)
        # BP reads the old weights: dx is queued before the update
        dxv = bsm.dx(dy, w5, rev_ob, rev_t, rev_cnt, res, ctx.act)
        slots = held.slots()
        mom, mom_b, vel, vel_b = (lift(s) for s in slots)
        x3, dy, res = held.update_operands(x3, dy, res)
        with torch.no_grad():
            flags = bsm.update_dw(
                x3, dy, idx, res, w5, lift(b) if ctx.has_bias else None, mom,
                mom_b, ctx.hyp, vel=vel, vel_b=vel_b, act=ctx.act,
                with_bias=ctx.has_bias, with_health=ctx.health is not None)
            held.commit((w, b), slots)
            if ctx.health is not None:
                ctx.health.copy_(flags.to(ctx.health.dtype))
        return (dxv,) + (None,) * 10


def _lifter(single: bool):
    """t -> t[None] for a 4-D weight's tensors (the E=1 squeeze), else
    the identity; None stays None."""
    if not single:
        return lambda t: t
    return lambda t: None if t is None else t[None]


class _GatedJunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, wg5, wi5, idx, rev_ob, rev_t, rev_cnt):
        h, g, u = bsm.gated_fwd(x3, wg5, wi5, idx, save_res=True)
        ctx.save_for_backward(x3, wg5, wi5, g, u, idx, rev_ob, rev_t,
                              rev_cnt)
        return h

    @staticmethod
    def backward(ctx, dh):
        x3, wg5, wi5, g, u, idx, rev_ob, rev_t, rev_cnt = ctx.saved_tensors
        dh = dh.contiguous()
        dxv = (bsm.gated_dx(dh, wg5, wi5, rev_ob, rev_t, rev_cnt, g, u)
               if ctx.needs_input_grad[0] else None)
        dwg = dwi = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dwg, dwi = bsm.gated_dw(x3, dh, idx, g, u)
            dwg, dwi = dwg.to(wg5.dtype), dwi.to(wi5.dtype)
        return dxv, dwg, dwi, None, None, None, None


class _GatedJunctionUpdate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x3, held, idx, rev_ob, rev_t, rev_cnt, single, hyp,
                health):
        lift = _lifter(single)
        wg, wi = held.weights()
        h, g, u = bsm.gated_fwd(x3, lift(wg), lift(wi), idx, save_res=True)
        ctx.lift = lift
        # updated in place by the backward: their holder rides as an
        # attribute, not as saved tensors
        ctx.held, ctx.hyp, ctx.health = held, hyp, health
        ctx.save_for_backward(x3, g, u, idx, rev_ob, rev_t, rev_cnt)
        return h

    @staticmethod
    def backward(ctx, dh):
        x3, g, u, idx, rev_ob, rev_t, rev_cnt = ctx.saved_tensors
        held, lift = ctx.held, ctx.lift
        dh = dh.contiguous()
        wg, wi = held.weights()
        wg5, wi5 = lift(wg), lift(wi)
        # BP reads the old weights: dx is queued before the update
        dxv = bsm.gated_dx(dh, wg5, wi5, rev_ob, rev_t, rev_cnt, g, u)
        slots = held.slots()
        mg, mi, vg, vi = (lift(s) for s in slots)
        x3, dh, g, u = held.update_operands(x3, dh, g, u)
        with torch.no_grad():
            flags = bsm.update_gated_dw(
                x3, dh, idx, g, u, wg5, wi5, mg, mi, ctx.hyp, vg=vg, vi=vi,
                with_health=ctx.health is not None)
            held.commit((wg, wi), slots)
            if ctx.health is not None:
                ctx.health.copy_(flags.to(ctx.health.dtype))
        return (dxv,) + (None,) * 8


def _lift(x, w, bias):
    """(single, lead, x3, w5, b2): the E=1 squeeze of a 4-D weight."""
    if w.dim() == 4:
        return (True, x.shape[:-1], x.reshape(1, -1, x.shape[-1]), w[None],
                None if bias is None else bias[None])
    return False, None, x, w, bias


def junction_matmul(x, w, idx, rev_ob, rev_t, rev_cnt, *, wi=None,
                    bias=None, act: str = "none", w_scale=None,
                    wi_scale=None, x_scale=None, qfmt=None, qlut=None):
    """y = act(x @ W_sparse + bias) through the pattern, or with ``wi``
    the gate silu(x @ W) * (x @ Wi); differentiable in x and the weights
    (and bias) through the dx and dw kernels.

    Quantized (forward only): int8 codes with ``w_scale`` ([nob, kb], or
    [E, nob, kb] for 5-D codes; ``wi_scale`` for the gate's second
    stream) and an optional calibrated ``x_scale`` (one per unit: [E],
    or a scalar for 4-D codes);
    int32 triplet codes with ``qfmt`` and ``qlut`` (plain junctions only:
    the table replaces ``act``)."""
    if wi is not None and (bias is not None or act != "none"):
        raise ValueError("gated junction fixes act=silu-gate and takes no "
                         "bias")
    if qfmt is not None or w_scale is not None:
        return _junction_quant(x, w, idx, wi=wi, bias=bias, act=act,
                               w_scale=w_scale, wi_scale=wi_scale,
                               x_scale=x_scale, qfmt=qfmt, qlut=qlut)
    if not w.is_floating_point() or (wi is not None
                                     and not wi.is_floating_point()):
        raise ValueError(
            "integer-code weights need their quantization leaves (w_scale "
            "for int8, qfmt and qlut for fixed point): refusing to cast "
            "codes to floats")
    single, lead, x3, w5, b2 = _lift(x, w, bias)
    E = x3.shape[0]
    _, nob, _, bs, _ = w5.shape
    x3 = x3.contiguous()
    w5 = w5.to(x.dtype).contiguous()
    if wi is not None:
        wi5 = (wi[None] if single else wi).to(x.dtype).contiguous()
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x3, w5, wi5)):
            y = _GatedJunction.apply(x3, w5, wi5, idx, rev_ob, rev_t,
                                     rev_cnt)
        else:   # inference: no residuals to save
            y = bsm.gated_fwd(x3, w5, wi5, idx)
        return y.reshape(*lead, nob * bs) if single else y
    b = (torch.zeros((E, nob * bs), dtype=x.dtype, device=x.device)
         if b2 is None else b2.to(x.dtype)).contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x3, w5, b)):
        y = _Junction.apply(x3, w5, b, idx, rev_ob, rev_t, rev_cnt, act,
                            bias is not None)
    else:       # inference: no residual to save
        y = bsm.fwd(x3, w5, idx, b, act)
    return y.reshape(*lead, nob * bs) if single else y


def _junction_quant(x, w, idx, *, wi, bias, act, w_scale, wi_scale, x_scale,
                    qfmt, qlut):
    """The forward of a quantized junction: the E=1 lift of 4-D codes,
    scales lifted alongside, bias in fp32, then one quantized kernel."""
    gated = wi is not None
    fxp_mode = qfmt is not None
    if fxp_mode and gated:
        raise ValueError("fxp quantization covers plain junctions only: the "
                         "gate epilogue has no single-table fixed-point "
                         "form; use the int8 path for gated junctions")
    if fxp_mode and qlut is None:
        raise ValueError("fxp mode needs the baked activation table (qlut)")
    if not fxp_mode and gated and wi_scale is None:
        raise ValueError("gated int8 junction needs wi_scale for the second "
                         "branch")
    single, lead, x3, w5, b2 = _lift(x, w, bias)
    E = x3.shape[0]
    _, nob, _, bs, _ = w5.shape
    x3 = x3.contiguous()

    def lift(s):
        return None if s is None else (s[None] if single else s)

    b = (torch.zeros((E, nob * bs), dtype=torch.float32, device=x.device)
         if b2 is None else b2.float().contiguous())
    xs = bsm.unit_x_scale(x_scale, E)
    if fxp_mode:
        y = bsm.fwd_fxp(x3, w5, idx, qfmt, qlut, b)
    elif gated:
        y = bsm.gated_fwd_int8(x3, w5, lift(wi), idx, lift(w_scale),
                               lift(wi_scale), xs)
    else:
        y = bsm.fwd_int8(x3, w5, idx, lift(w_scale), b, act, xs)
    return y.reshape(*lead, nob * bs) if single else y


def junction_train_update(x, w, idx, rev_ob, rev_t, rev_cnt, *, hyp,
                          wi=None, bias=None, act: str = "none", mom=None,
                          mom_wi=None, mom_b=None, vel=None, vel_wi=None,
                          vel_b=None, health=None, held=None):
    """The fused BP+UP junction: forward as ``junction_matmul``; its
    backward updates w (and wi, for the gate), bias and the fp32 slots in
    place (mom alone: SGD+momentum, mom and vel: Adam, none: SGD; the
    gate takes mom_wi / vel_wi with them) from ``hyp`` (the shared
    (HYP_K,) row, a legacy (2,) pair, or a per-unit [E, 2] / [E, HYP_K]
    table) and writes the [E] non-finite tile counts into ``health``
    (float32 zeros of shape (E,), (1,) for a 4-D weight) when given.

    w must already be in x's dtype (a cast would update a copy), so must
    wi and the bias; the slots are fp32.  x must take part in autograd, or
    the backward, and with it the update, would never run.

    ``held``: the holder of the weights (w and the bias, or wg and wi)
    and the slots when they are a rank's shards on the partitioned mesh
    route (``parallel/partition.HeldJunction``; w and the rest are then
    those shards); by default a ``WholeJunction`` of the tensors given."""
    gated = wi is not None
    if gated and (bias is not None or act != "none"):
        raise ValueError("gated junction fixes act=silu-gate and takes no "
                         "bias")
    if not w.is_floating_point() or (gated and not wi.is_floating_point()):
        raise ValueError(
            "junction_train_update refuses quantized (integer-code) "
            "weights — the int8/fxp datapath is inference-only; reload "
            "full-precision weights to train")
    if w.dtype != x.dtype or (gated and wi.dtype != x.dtype) or (
            bias is not None and bias.dtype != x.dtype):
        raise ValueError(
            "junction_train_update requires param dtype == activation dtype "
            f"(got w={w.dtype}, x={x.dtype}) — run the two-pass path for "
            "mixed-precision casts")
    if gated and (mom is None) != (mom_wi is None):
        raise ValueError("gated junction needs momentum for both branches")
    if gated and (vel is None) != (vel_wi is None):
        raise ValueError("gated junction needs the Adam v slot for both "
                         "branches")
    if vel is not None and mom is None:
        raise ValueError("the Adam vel slot requires the mom slot too "
                         "(slot layout: w, mom, vel)")
    for name, m in (("mom", mom), ("mom_wi", mom_wi), ("mom_b", mom_b),
                    ("vel", vel), ("vel_wi", vel_wi), ("vel_b", vel_b)):
        if m is not None and m.dtype != torch.float32:
            raise ValueError(f"{name} must be an fp32 accumulator "
                             f"(got {m.dtype}) — the optimizer state stays "
                             "full-precision even for bf16 params")
    if not (torch.is_grad_enabled() and x.requires_grad):
        raise ValueError("junction_train_update needs x to take part in "
                         "autograd: the update runs in the backward")
    single, lead, x3, w5, b2 = _lift(x, w, bias)
    E = x3.shape[0]
    _, nob, _, _, bs = w5.shape     # a shard may cut the in rows
    lift = _lifter(single)
    wi5 = lift(wi)
    if not w5.is_contiguous() or (gated and not wi5.is_contiguous()):
        raise ValueError("w must be contiguous: it is updated in place")
    if health is not None and tuple(health.shape) != (E,):
        raise ValueError(f"health must be ({E},) f32 zeros (one slot per "
                         f"junction unit), got shape {tuple(health.shape)}")
    hyp = bsm.normalize_hyp(hyp, E).to(x.device)
    if gated:
        if held is None:
            held = WholeJunction((w, wi), (mom, mom_wi, vel, vel_wi))
        y = _GatedJunctionUpdate.apply(x3.contiguous(), held, idx, rev_ob,
                                       rev_t, rev_cnt, single, hyp, health)
        return y.reshape(*lead, nob * bs) if single else y
    if held is None:
        held = WholeJunction((w, bias), (
            mom, mom_b if bias is not None else None, vel,
            vel_b if bias is not None else None))
    y = _JunctionUpdate.apply(x3.contiguous(), held, idx, rev_ob, rev_t,
                              rev_cnt, act, bias is not None, single, hyp,
                              health)
    return y.reshape(*lead, nob * bs) if single else y


# ------------------------------------------------------------ fixed point
def fxp_qmatmul(a_code, w_code, *, bf: int, bn: int):
    """a [M, K] int32 codes @ w [K, N] int32 codes -> [M, N] int32 codes:
    the int32 sum, the round-half-up shift by bf, saturation to the
    triplet's range (``kernels/fxp_qmatmul.qmatmul``)."""
    return fxpk.qmatmul(a_code, w_code, bf=bf, bn=bn)


# ------------------------------------------------------------ LUT sigmoid
def sigmoid_lut(codes, table):
    """table[codes] for int32 codes of any leading dims [..., N]
    (``kernels/sigmoid_lut.lut_lookup`` over the rows flattened)."""
    lead = codes.shape[:-1]
    y = slut.lut_lookup(codes.reshape(-1, codes.shape[-1]), table)
    return y.reshape(*lead, codes.shape[-1])
