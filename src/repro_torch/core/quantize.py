"""Post-training quantization of junction weights: the int8 and
fixed-point inference datapath.

``quantize_junction`` replaces a junction's fp weight leaf ``"w"`` with
integer codes under ``"wq"`` (a MoE expert dict: ``wg`` / ``wi`` / ``wo``
-> ``wgq`` / ``wiq`` / ``woq``), so a quantized tree cannot reach a
floating-point kernel: there is no fp weight left.  Detection is
structural: ``"wq"`` (``"wgq"``) in the dict.

* ``mode="int8"``: symmetric absmax codes per [nob, kb] weight block
  (``granularity="block"``) or one scale per junction unit
  (``"unit"``, broadcast into the same [..., nob, kb] layout).  Codes
  sit in int8 for any ``bits <= 8`` (narrower widths clip to
  +-(2^(bits-1) - 1)).  Activations are quantized per row per gathered
  fan-in slot (absmax / 127) unless a calibrated static per-unit
  ``x_scale`` rides along (``calibrate_layer_scales``).  The dequant
  rescales the integer dot to fp32 and the ordinary activation follows.
* ``mode="fxp"``: the paper's fixed point.  Weights become triplet codes
  (value * 2^bf, saturated, int32), products sum exactly in int32, one
  round-half-up shift by bf and a saturation replace the fp epilogue,
  and the activation is a table over all 2^bw codes (``qlut``) baked at
  quantize time; ``qfmt = [bf, bn]`` rides as an int32 leaf.

Both are inference only: ``ops.junction_train_update`` and the fused
context (``sparse_linear.inject_update_ctx``) refuse integer codes.
``quantize_tree`` works one leaf at a time, on the leaf's own device.

``apply_quant`` and ``expert_apply_int8`` are the plain (engine "jnp")
forms of the quantized junction and of the quantized experts, with the
kernels' arithmetic op for op.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import fixed_point as fp
from repro_torch.core import sparse_linear as sl
from repro_torch.core.fixed_point import PAPER_FMT, FxpFormat
from repro_torch.core.sparse_linear import is_quantized  # noqa: F401
from repro_torch.kernels import block_sparse_matmul as bsm

Params = dict[str, Any]

# activations the fxp table can bake (act_lut)
FXP_LUT_ACTS = ("sigmoid", "none", "relu")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """One quantization configuration (a member of the PTQ sweep).

    mode: "int8" (scaled integer codes, fp32 dequant, fp activation) or
        "fxp" (the paper's fixed point with a table activation).
    bits: int8 code width, 2..8 (codes stay in int8).
    granularity: "block" (a scale per [nob, kb] block) or "unit" (one per
        junction unit).
    fmt: the fxp bit triplet (Table II).
    act: the fxp table's activation, baked at quantize time.
    """
    mode: str = "int8"
    bits: int = 8
    granularity: str = "block"
    fmt: FxpFormat = PAPER_FMT
    act: str = "sigmoid"

    def __post_init__(self):
        if self.mode not in ("int8", "fxp"):
            raise ValueError(f"unknown quant mode {self.mode!r} (int8 | fxp)")
        if self.mode == "int8" and not 2 <= self.bits <= 8:
            raise ValueError(f"int8 mode bits must be 2..8, got {self.bits}")
        if self.granularity not in ("block", "unit"):
            raise ValueError(f"granularity {self.granularity!r} "
                             "(block | unit)")
        if self.mode == "fxp" and self.act not in FXP_LUT_ACTS:
            raise ValueError(f"fxp LUT activation {self.act!r} "
                             f"(one of {FXP_LUT_ACTS})")

    def to_dict(self) -> dict:
        d = {"mode": self.mode, "bits": self.bits,
             "granularity": self.granularity}
        if self.mode == "fxp":
            d.update(fmt=[self.fmt.bw, self.fmt.bn, self.fmt.bf],
                     act=self.act)
        return d


def structure_key(q: QuantConfig) -> tuple:
    """What changes the stacked layout of a quantized population: int8
    widths and granularities share the int8 codes and the [nob, kb]
    scales, so they share a cohort; each fxp triplet and table is its
    own."""
    if q.mode == "int8":
        return ("int8",)
    return ("fxp", q.fmt.bw, q.fmt.bn, q.fmt.bf, q.act)


def quant_mode(p: Params) -> str:
    return "fxp" if "qfmt" in p else "int8"


# ------------------------------------------------------------ weight codes
def quantize_weights(w: torch.Tensor, *, bits: int = 8,
                     granularity: str = "block"):
    """w [..., nob, kb, bs, bs] -> (int8 codes of the same shape, fp32
    scales [..., nob, kb]): symmetric absmax per block, or per unit
    broadcast into the block layout."""
    w = w.float()
    qmax = float(2 ** (bits - 1) - 1)
    if granularity == "block":
        absmax = w.abs().amax(dim=(-2, -1))
    else:
        absmax = w.abs().amax(dim=(-4, -3, -2, -1))
        absmax = absmax[..., None, None].expand(w.shape[:-2])
    scale = torch.where(absmax == 0.0, 1.0,
                        bsm.true_div(absmax, qmax)).contiguous()
    codes = torch.clamp(torch.round(w / scale[..., None, None]), -qmax, qmax)
    return codes.to(torch.int8), scale


def fxp_encode_weights(w: torch.Tensor, fmt: FxpFormat) -> torch.Tensor:
    """fp weights -> int32 triplet codes (value * 2^bf, saturated)."""
    lim = fmt.n_codes // 2
    codes = torch.round(w.float() * fmt.scale)
    return torch.clamp(codes, -lim, lim - 1).to(torch.int32)


def act_lut(fmt: FxpFormat, act: str = "sigmoid", device="cpu"
            ) -> torch.Tensor:
    """The activation table: one fp32 entry per two's-complement code
    (index = code & (2^bw - 1)), the activation applied and put back on
    the grid, as the FPGA's tables hold it."""
    if act == "sigmoid":
        table = fp.sigmoid_tables(fmt)[0]
    elif act == "none":
        table = fp.code_values(fmt)
    elif act == "relu":
        table = np.clip(fp.code_values(fmt), 0.0, fmt.max_val)
    else:
        raise ValueError(f"fxp LUT activation {act!r} "
                         f"(one of {FXP_LUT_ACTS})")
    return torch.tensor(np.asarray(table, np.float32), device=device)


# -------------------------------------------------------- tree conversion
def _f32(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _quantize_single(p: Params, q: QuantConfig, x_scale=None) -> Params:
    w = p["w"]
    out = {k: v for k, v in p.items() if k != "w"}
    if q.mode == "int8":
        out["wq"], out["w_scale"] = quantize_weights(
            w, bits=q.bits, granularity=q.granularity)
        if x_scale is not None:
            out["x_scale"] = _f32(x_scale, w.device)
    else:
        out["wq"] = fxp_encode_weights(w, q.fmt)
        out["qfmt"] = torch.tensor([q.fmt.bf, q.fmt.bn], dtype=torch.int32,
                                   device=w.device)
        out["qlut"] = act_lut(q.fmt, q.act, w.device)
        if "b" in p:   # the bias snapped to the grid (the q_add operand)
            out["b"] = fp.quantize(p["b"], q.fmt)
    return out


def _quantize_moe(p: Params, q: QuantConfig, x_scale_in=None,
                  x_scale_out=None) -> Params:
    if q.mode != "int8":
        raise ValueError(
            "fxp quantization covers plain junctions only: the MoE expert "
            "gate (silu(g) * u) has no single-table fixed-point epilogue; "
            "quantize expert FFNs with mode='int8'")
    dev = p["wg"].device
    out = {k: v for k, v in p.items() if k not in ("wg", "wi", "wo")}
    for name in ("wg", "wi", "wo"):
        out[name + "q"], out[name + "_scale"] = quantize_weights(
            p[name], bits=q.bits, granularity=q.granularity)
    if x_scale_in is not None:
        out["x_scale_in"] = _f32(x_scale_in, dev)
    if x_scale_out is not None:
        out["x_scale_out"] = _f32(x_scale_out, dev)
    return out


def quantize_junction(p: Params, q: QuantConfig, **x_scales) -> Params:
    """Quantize one junction dict (a single "w" / "idx" junction or a MoE
    expert pair "wg" / "idx_in").  Pattern leaves, bias and the other
    leaves ride through; the fp weight leaves are removed.  Optional
    calibrated activation scales: ``x_scale=`` (single), ``x_scale_in=``
    / ``x_scale_out=`` (MoE)."""
    if "idx_in" in p:
        return _quantize_moe(p, q, x_scales.get("x_scale_in"),
                             x_scales.get("x_scale_out"))
    return _quantize_single(p, q, x_scales.get("x_scale"))


def quantize_tree(params, q: QuantConfig):
    """A copy of a params tree with every sparse junction dict quantized,
    one junction at a time on its own device; dense layers (attention,
    embeddings, junctions whose dims did not tile) stay as they are.  A
    tree already quantized comes back unchanged."""
    def rec(p):
        if isinstance(p, dict):
            if sl.is_junction(p) and ("w" in p or "wg" in p):
                return quantize_junction(p, q)
            return {k: rec(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(rec(v) for v in p)
        return p
    return rec(params)


def calibrate_layer_scales(layers: Sequence[Params], x: torch.Tensor, *,
                           act: str) -> list[float]:
    """Static activation scales from a calibration batch: run ``x``
    through the fp layers and record each junction's input absmax / 127
    (1 for an all-zero input).  For layer lists (the MLP path); served
    models quantize with dynamic per-row scales."""
    scales = []
    with torch.no_grad():
        for p in layers:
            ax = float(x.abs().max())
            scales.append(ax / 127.0 if ax > 0.0 else 1.0)
            x = sl.apply(p, x, act=act)
    return scales


# ------------------------------------------------------------ plain forms
def _lift(t, single):
    return None if t is None else (t[None] if single else t)


def apply_quant(params: Params, x: torch.Tensor, *, act: str = "none"
                ) -> torch.Tensor:
    """The plain forward of a quantized junction dict, 4-D (single, x
    [..., n_in]) or 5-D (E-stacked, x [E, M, n_in], patterns shared),
    through the kernels' plain versions: int8 applies ``act`` to the
    dequantized fp32 sum, fxp ignores it (the table holds it)."""
    wq = params["wq"]
    single = wq.dim() == 4
    lead = x.shape[:-1]
    x3 = x.reshape(1, -1, x.shape[-1]) if single else x
    E = x3.shape[0]
    nob, bs = wq.shape[-4], wq.shape[-1]
    b = params.get("b")
    b = (torch.zeros((E, nob * bs), dtype=torch.float32, device=x.device)
         if b is None else _lift(b, single).float())
    w5 = _lift(wq, single)
    if quant_mode(params) == "fxp":
        y = bsm.fwd_fxp_ref(x3, w5, params["idx"], params["qfmt"],
                            params["qlut"], b)
    else:
        y = bsm.fwd_int8_ref(x3, w5, params["idx"],
                             _lift(params["w_scale"], single), b, act,
                             bsm.unit_x_scale(params.get("x_scale"), E))
    return y.reshape(*lead, nob * bs) if single else y


def expert_apply_int8(wq, w_scale, idx, x, x_scale=None) -> torch.Tensor:
    """Plain quantized twin of models/moe._expert_apply: x [G, E, C, din]
    -> the fp32 dequantized sum [G, E, C, dout] (no activation), per
    expert scales on E."""
    G, E, C, din = x.shape
    xe = x.movedim(1, 0).reshape(E, G * C, din)
    (y,) = bsm.int8_sums(xe, (wq,), idx, (w_scale,),
                         bsm.unit_x_scale(x_scale, E))
    return y.reshape(E, G, C, -1).movedim(0, 1)
