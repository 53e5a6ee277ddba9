"""The arithmetic of the port's two attention kernels, emulated in plain
torch on the CPU and held against the plain versions (``attention_ref``,
``paged_decode_ref``) and the reference's Pallas kernels in interpret
mode.  The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds them to their plain versions; these tests pin
the design those kernels follow.

``flash_attention`` in bf16 (``csrc/flash_attention.cu``): 128-row query
tiles, key tiles of 64 visited as the kernel visits them, QK^T in fp32
(products of bf16 are exact in fp32), scores pre-scaled by
scale * log2(e), masked with NEG_INF (keys past Sk left out), an online
softmax by exp2 whose running max moves only when a tile passes it by
more than 2^8, and P fed to PV as hi = bf16(p) plus lo = bf16(p - hi)
into an fp32 accumulator.

``flash_decode`` (``csrc/flash_decode.cu``): a slot's pages split into
``decode_splits`` ranges chosen from shapes alone; within a split four
warps take chunks of 2 S tokens in turn (S = 2 for 8 query heads
a block, else 4), each chunk rescaling its warp's (m, l, acc) once; the
warps merge in order, then the splits that hold tokens merge in split
order; a slot of length 0 gives exact zeros.

Tolerances are ``chip_smoke.py``'s ``TOL``, the bound the kernels are
held to on the card: fp32 atol = rtol = 1e-4 (the same sums in another
order); bf16 atol 1e-5, rtol 2^-7 (both sides round fp32 values that
differ only in summation order, so an output may move by one bf16 ulp).
"""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.obs.telemetry import percentile as ref_percentile

from repro_torch.kernels import flash_attention as tfa
from repro_torch.obs import percentile

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-5, rtol=2.0 ** -7)}
LOG2E = 1.4426950408889634
BQ, BK = 128, 64                  # the bf16 kernel's query and key tiles
LAZY = 8.0                        # its running max moves by more than 2^8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, dtype) -> bool:
    return bool(torch.allclose(got.float(), want.float(), **TOL[dtype]))


# ------------------------------------------------------------ flash_attention
def _key_range(q0, q_last, Sk, causal, window):
    """The keys a query tile's rows reach; every key when one of them has
    no valid key (as csrc/flash_attention.cu's key_range)."""
    if window and q_last >= Sk + window - 1:
        return 0, Sk
    lo = max(0, q0 - window + 1) if window else 0
    hi = min(Sk, q_last + 1) if causal else Sk
    return lo, hi


def emulate_attention_bf16(q, k, v, *, causal, window, split=True):
    """The bf16 kernel's arithmetic: q [BH, Sq, D], k / v [BHkv, Sk, D]
    bf16 -> bf16.  ``split=False`` feeds PV a single bf16 P instead."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    rep = BH // k.shape[0]
    qf = q.float()
    kf = k.float().repeat_interleave(rep, 0)
    vf = v.float().repeat_interleave(rep, 0)
    sl2 = torch.tensor((1.0 / math.sqrt(D)) * LOG2E, dtype=torch.float32)
    out = torch.empty(BH, Sq, D)
    for q0 in range(0, Sq, BQ):
        rows = torch.arange(q0, min(q0 + BQ, Sq))
        lo, hi = _key_range(q0, int(rows[-1]), Sk, causal, window)
        m = torch.full((BH, len(rows)), -1e30)
        l = torch.zeros(BH, len(rows))
        o = torch.zeros(BH, len(rows), D)
        for k0 in range(lo // BK * BK, hi, BK):
            keys = torch.arange(k0, min(k0 + BK, Sk))
            s = torch.einsum("hqd,hkd->hqk", qf[:, rows], kf[:, keys]) * sl2
            valid = torch.ones(len(rows), len(keys), dtype=torch.bool)
            if causal:
                valid &= rows[:, None] >= keys[None, :]
            if window:
                valid &= rows[:, None] - keys[None, :] < window
            s = torch.where(valid, s, torch.tensor(-1e30))
            mx = s.amax(-1)
            bump = mx > m + LAZY               # the running max moves
            mn = torch.where(bump, mx, m)
            c = torch.where(bump, torch.exp2(m - mn), torch.tensor(1.0))
            p = torch.exp2(s - mn[..., None])
            m = mn
            l = l * c + p.sum(-1)
            o = o * c[..., None]
            p_hi = p.bfloat16().float()
            o = o + torch.einsum("hqk,hkd->hqd", p_hi, vf[:, keys])
            if split:
                p_lo = (p - p_hi).bfloat16().float()
                o = o + torch.einsum("hqk,hkd->hqd", p_lo, vf[:, keys])
        out[:, rows] = o / l.clamp_min(1e-30)[..., None]
    return out.bfloat16()


def _attn_inputs(BH, BHkv, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .bfloat16() for s in ((BH, Sq, D), (BHkv, Sk, D),
                                       (BHkv, Sk, D)))


# (BH, BHkv, Sq, Sk, D, causal, window): causal at D 80 over several key
# tiles, GQA, a window, ragged non-causal, rows with no valid key
ATTN_CASES = [
    (4, 4, 200, 200, 80, True, 0),
    (8, 2, 130, 130, 64, True, 0),
    (4, 2, 150, 150, 32, True, 48),
    (2, 2, 37, 93, 48, False, 0),
    (2, 1, 100, 70, 80, True, 5),
]


@pytest.mark.parametrize("BH,BHkv,Sq,Sk,D,causal,window", ATTN_CASES)
def test_attention_hi_lo_split_holds_tol_against_plain_version(
        BH, BHkv, Sq, Sk, D, causal, window):
    q, k, v = _attn_inputs(BH, BHkv, Sq, Sk, D, seed=Sq * D + window)
    got = emulate_attention_bf16(q, k, v, causal=causal, window=window)
    want = tfa.attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 == want.dtype
    assert _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("BH,BHkv,Sq,Sk,D,causal,window",
                         [c for c in ATTN_CASES if c[2] <= c[3]])
def test_attention_hi_lo_split_holds_tol_against_reference_kernel(
        BH, BHkv, Sq, Sk, D, causal, window):
    """The reference's Pallas kernel (interpret mode; no rows without a
    valid key, which it averages over padded keys, ROADMAP queue 3)."""
    q, k, v = _attn_inputs(BH, BHkv, Sq, Sk, D, seed=Sq * D + window)
    got = emulate_attention_bf16(q, k, v, causal=causal, window=window)
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                               bq=64, bk=64, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert _close(got, want, torch.bfloat16)


def test_attention_rows_without_valid_key_average_v():
    """Sq 100 over Sk 70, window 5: rows 74.. see no key; the emulation,
    like the kernel, visits every key tile for their query tile and
    averages V over exactly the Sk keys."""
    q, k, v = _attn_inputs(2, 1, 100, 70, 80, seed=3)
    got = emulate_attention_bf16(q, k, v, causal=True, window=5)
    mean = v.float().mean(1).bfloat16()
    assert _close(got[0, 90], mean[0], torch.bfloat16)
    assert _close(got, tfa.attention_ref(q, k, v, causal=True, window=5),
                  torch.bfloat16)


def test_attention_running_max_moves_past_the_lazy_bound():
    """Keys of the second and third key tiles scaled up, so a row's max
    passes its running max by more than 2^8 mid-row and O is rescaled."""
    q, k, v = _attn_inputs(2, 2, 256, 256, 32, seed=9)
    k = k.float()
    k[:, 64:192] *= 6.0
    k = k.bfloat16()
    sl2 = LOG2E / math.sqrt(32)
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * sl2
    first = s[:, 100:, :64].amax(-1)
    later = s[:, 100:, 64:192].amax(-1)
    assert bool((later > first + LAZY).any())
    got = emulate_attention_bf16(q, k, v, causal=True, window=0)
    assert _close(got, tfa.attention_ref(q, k, v, causal=True),
                  torch.bfloat16)


def test_attention_single_bf16_p_breaks_tol():
    """Why P is split: rounding P to one bf16 before PV moves outputs that
    are small next to their row's scale by more than a bf16 ulp."""
    q, k, v = _attn_inputs(4, 4, 256, 256, 80, seed=11)
    want = tfa.attention_ref(q, k, v, causal=True)
    single = emulate_attention_bf16(q, k, v, causal=True, window=0,
                                    split=False)
    split = emulate_attention_bf16(q, k, v, causal=True, window=0)
    tol = TOL[torch.bfloat16]
    bad = ((single.float() - want.float()).abs()
           > tol["atol"] + tol["rtol"] * want.float().abs())
    assert int(bad.sum()) > 0
    assert _close(split, want, torch.bfloat16)


# ------------------------------------------------------------ flash_decode
def emulate_decode(q, k_pool, v_pool, page_table, seq_lens, n_sms=132):
    """The decode kernel's arithmetic in fp32, in its order: splits from
    ``decode_splits``, four warps a split taking chunks in turn, warps
    merged in order, then the splits holding tokens in split order."""
    B, Hkv, rep, D = q.shape
    ps, maxp = k_pool.shape[1], page_table.shape[1]
    nsplit, pps = tfa.decode_splits(B, Hkv, rep, ps, maxp, n_sms)
    assert nsplit == -(-maxp // pps)
    R = min(8, 1 << (rep - 1).bit_length())
    chunk = 2 * (2 if R >= 8 else 4)
    span = pps * ps
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    out = torch.zeros(B, Hkv, rep, D)
    for b in range(B):
        n = min(max(int(seq_lens[b]), 0), maxp * ps)
        pages = page_table[b].long()
        for h in range(Hkv):
            qh = q[b, h].float()                                  # [rep, D]
            parts = []
            for sp in range(nsplit):
                t0, t1 = sp * span, min(n, sp * span + span)
                if t0 >= t1:
                    continue                  # an empty split: no partial
                warps = []
                for w in range(4):
                    m = torch.full((rep,), -1e30)
                    l = torch.zeros(rep)
                    acc = torch.zeros(rep, D)
                    for c0 in range(t0 + w * chunk, t1, 4 * chunk):
                        tok = torch.arange(c0, min(c0 + chunk, t1))
                        rows = pages[tok // ps] * ps + tok % ps
                        kt = k_pool.reshape(-1, Hkv, D)[rows, h].float()
                        vt = v_pool.reshape(-1, Hkv, D)[rows, h].float()
                        s = (qh @ kt.T) * scale
                        mn = torch.maximum(m, s.amax(-1))
                        c = torch.exp(m - mn)
                        p = torch.exp(s - mn[:, None])
                        m, l = mn, l * c + p.sum(-1)
                        acc = acc * c[:, None] + p @ vt
                    warps.append((m, l, acc))
                M = torch.stack([w[0] for w in warps]).amax(0)
                f = [torch.exp(w[0] - M) for w in warps]
                parts.append((M, sum(fi * w[1] for fi, w in zip(f, warps)),
                              sum(fi[:, None] * w[2]
                                  for fi, w in zip(f, warps))))
            if not parts:                     # seq_len 0: exact zeros
                continue
            M = torch.stack([p[0] for p in parts]).amax(0)
            f = [torch.exp(p[0] - M) for p in parts]
            L = sum(fi * p[1] for fi, p in zip(f, parts))
            A = sum(fi[:, None] * p[2] for fi, p in zip(f, parts))
            out[b, h] = A / L[:, None]
    return out.to(q.dtype)


def _decode_inputs(lens, Hkv, rep, D, ps, maxp, seed, dtype):
    rng = np.random.default_rng(seed)
    B = len(lens)
    n_pages = 1 + B * maxp
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dtype) for s in ((B, Hkv, rep, D),
                                    (n_pages, ps, Hkv, D),
                                    (n_pages, ps, Hkv, D)))
    perm = rng.permutation(n_pages - 1) + 1
    pt = np.zeros((B, maxp), np.int32)
    for b, n in enumerate(lens):
        used = -(-n // ps)
        pt[b, :used] = perm[b * maxp:b * maxp + used]
    return q, k, v, torch.from_numpy(pt), torch.tensor(lens, dtype=torch.int32)


# (lens, Hkv, rep, D, ps, maxp): empty splits beside full ones, a slot of
# length 0, a long slot over many splits, GQA up to rep 8 at D 128
DECODE_CASES = [
    ([0, 1, 17, 128], 8, 1, 80, 16, 8),
    ([0, 5, 40, 64], 2, 8, 128, 8, 8),
    ([3, 0, 300, 512], 2, 4, 80, 16, 32),
    ([1000, 0, 7], 1, 3, 48, 16, 64),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens,Hkv,rep,D,ps,maxp", DECODE_CASES)
def test_decode_split_combine_holds_tol_against_plain_version(
        lens, Hkv, rep, D, ps, maxp, dtype):
    q, k, v, pt, sl = _decode_inputs(lens, Hkv, rep, D, ps, maxp,
                                     seed=sum(lens) + D, dtype=dtype)
    got = emulate_decode(q, k, v, pt, sl)
    want = tfa.paged_decode_ref(q, k, v, pt, sl)
    assert got.dtype == dtype
    assert _close(got, want, dtype)
    assert not got[sl == 0].any()                          # exact zeros


@pytest.mark.parametrize("lens,Hkv,rep,D,ps,maxp", DECODE_CASES[:2])
def test_decode_split_combine_against_reference_kernel(lens, Hkv, rep, D,
                                                       ps, maxp):
    q, k, v, pt, sl = _decode_inputs(lens, Hkv, rep, D, ps, maxp, seed=5,
                                     dtype=torch.float32)
    got = emulate_decode(q, k, v, pt, sl)
    want = jfa.flash_decode(*(jnp.asarray(t.numpy())
                              for t in (q, k, v, pt, sl)), interpret=True)
    assert _close(got, torch.from_numpy(np.array(want)), torch.float32)


def test_decode_splits_fill_the_card_from_shapes_alone():
    """The serving shapes (4 slots, page 16, 8 pages a slot) and a
    4k-token cache, on 132 SMs; every split count covers maxp."""
    assert tfa.decode_splits(4, 32, 1, 16, 8, 132) == (3, 3)     # stablelm
    assert tfa.decode_splits(4, 4, 8, 16, 8, 132) == (8, 1)      # qwen3-moe
    assert tfa.decode_splits(4, 32, 1, 16, 256, 132) == (32, 8)
    assert tfa.decode_splits(4, 4, 8, 16, 256, 132) == (32, 8)
    for B, Hkv, rep, ps, maxp in [(1, 1, 1, 1, 1), (64, 32, 1, 16, 8),
                                  (3, 5, 12, 7, 100), (2, 8, 4, 32, 1)]:
        nsplit, pps = tfa.decode_splits(B, Hkv, rep, ps, maxp, 132)
        assert 1 <= nsplit <= maxp and (nsplit - 1) * pps < maxp <= \
            nsplit * pps


# ------------------------------------------------------------ percentile
@pytest.mark.parametrize("values,q", [
    ([], 50), ([3.0, 1.0], 0), ([3.0, 1.0], -1), ([3.0, 1.0], 101),
    ([3.0, 1.0, 2.0], 100), ([3.0, 1.0, 2.0], 50), ([5.5], 50),
    (list(range(1, 101)), 99), ([0.25, 4.0, 1.5, 2.0], 50),
    ([0.25, 4.0, 1.5, 2.0], 100), ([7.0, 7.0, 1.0], 1),
])
def test_launcher_percentile_matches_reference(values, q):
    """The port's nearest-rank percentile (repro_torch.obs, which the
    launcher uses) raises ValueError where repro.obs.telemetry.percentile
    does and otherwise gives its value."""
    try:
        want = ref_percentile(values, q)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            percentile(values, q)
        return
    assert percentile(values, q) == want
