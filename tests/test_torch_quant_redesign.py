"""The int8 kernels of ``csrc/junction_quant.cu`` (``fwd_int8`` and
``gated_fwd_int8``) on the CPU: the CUDA kernels run only on the card
(``chip_smoke.quant_kernel_phase`` holds them against their plain
versions there), so these tests emulate the kernels' arithmetic and index
maps in numpy / torch and hold the emulation against the plain versions
and the reference's kernels (interpret mode).

- ``int8_plan`` (the path, the rows and slots a block, the split) covers
  every slot of an output block once and in order, at every shape of the
  serving and sweep paths and at small ones, from the shapes alone.
- The lane maps: the dp4a path's word reads and byte transposes, and the
  mma path's B fragments built from the swizzled staging with its
  permuted output columns, give the plain integer dot exactly; the reads
  meet no shared-memory bank conflict where the design says so.
- The arithmetic: int32 dots (any order of K, lanes and warps), per-slot
  fp32 parts in lane order in scratch, the last block's sum in slot order
  from 0: equal bit for bit to ``fwd_int8_ref`` / ``gated_fwd_int8_ref``
  (act none) for every split, E 1 and 3, M 1 / 4 / 5 / 32 / 33, blocks
  32 / 64 / 128, dynamic and static scales; and, as
  ``test_torch_quant_kernels.py`` holds it, within 1e-5 of the
  reference's kernels in interpret mode (fp32: in bf16 the reference's
  kernel and its jnp sim may round a half-way x / sx to different codes).
- The wrappers pass the plan, the scratch and the tickets to the C entry
  points (a recorder in place of the library), and read no tensor on the
  host.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jqz
from repro.core.sparsity import make_block_pattern
from repro.kernels import block_sparse_matmul as jbsm
from repro_torch.kernels import block_sparse_matmul as tbsm
from torch_tc_helpers import _c_prototype, _launch_recorder

INT8 = dict(atol=1e-5, rtol=1e-5)
# (E, M, nob, kb, bs): stablelm-3b's FFN junctions at decode and prefill,
# qwen3-moe's expert gate and down junctions at decode, prefill and an
# expert's training rows, the sweep's two int8 junctions; then small ones
PATH_SHAPES = [(1, M, nob, kb, 128) for M in (1, 4, 32)
               for nob, kb in ((54, 5), (20, 14))] \
    + [(128, M, nob, kb, 128) for M in (4, 32, 160)
       for nob, kb in ((6, 4), (16, 2))] \
    + [(6, 512, 4, 2, 128), (6, 512, 1, 1, 128)]
SMALL_SHAPES = [(E, M, nob, kb, bs) for E in (1, 3) for M in (1, 4, 5, 33)
                for nob, kb in ((2, 1), (3, 4), (6, 14)) for bs in (32, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("shape", PATH_SHAPES + SMALL_SHAPES, ids=str)
def test_plan_covers_every_slot_once_in_order(shape):
    E, M, nob, kb, bs = shape
    variant, rows, run, nsplit = tbsm.int8_plan(E, M, nob, kb, bs)
    assert all(type(v) is int for v in (rows, run, nsplit))
    assert variant == ("mma" if bs == 128 and M >= tbsm.INT8_MMA_MIN_M
                       else "dp4a")
    assert 1 <= rows <= (16 if variant == "mma" else 8) and rows <= M
    slots = [k for s in range(nsplit)
             for k in range(s * run, min(kb, (s + 1) * run))]
    assert slots == list(range(kb))                 # once each, in order
    assert all(s * run < kb for s in range(nsplit))  # no block without one
    rows_pad = tbsm.int8_rows_pad(variant, rows)
    assert rows <= rows_pad in ((16,) if variant == "mma" else (4, 8))
    assert run * rows_pad * (bs + 16) <= tbsm._INT8_XQ_BYTES or run == 1
    # the same shapes give the same plan (no tensor, no card is read)
    assert tbsm.int8_plan(E, M, nob, kb, bs) == (variant, rows, run, nsplit)


def test_plan_splits_the_stablelm_junctions_and_not_the_experts():
    """Stablelm-3b's 6912 -> 2560 junction has 20 output blocks: one slot
    a block (280 blocks); qwen3-moe's 128 experts fill the card unsplit."""
    assert tbsm.int8_plan(1, 4, 20, 14, 128) == ("dp4a", 4, 1, 14)
    assert tbsm.int8_plan(1, 4, 54, 5, 128) == ("dp4a", 4, 1, 5)
    for M in (4, 32):                      # decode and prefill
        for nob, kb in ((54, 5), (20, 14)):
            _, rows, _, nsplit = tbsm.int8_plan(1, M, nob, kb, 128)
            assert nob * -(-M // rows) * nsplit >= tbsm._INT8_BLOCKS
    assert tbsm.int8_plan(128, 4, 6, 4, 128) == ("dp4a", 4, 4, 1)
    assert tbsm.int8_plan(128, 4, 16, 2, 128) == ("dp4a", 4, 2, 1)


# ------------------------------------------------------------- lane maps
def _swz(bs, i, c):
    return c ^ (((i >> 2) & 3) << 1) if bs == 128 else c


def _stage(tile):
    """A code tile [bs, bs] int8 as the kernel stages it: 16-byte chunk c
    of row i at chunk ``_swz(i, c)`` of the row (flat uint8)."""
    bs = tile.shape[0]
    kc = bs // 16
    src = tile.view(np.uint8).reshape(bs, kc, 16)
    dst = np.empty_like(src)
    i = np.arange(bs)[:, None]
    c = np.arange(kc)[None, :]
    dst[i, _swz(bs, i, c)] = src
    return dst.reshape(-1)


def _word(buf, off):
    """Little-endian 32-bit words of uint8 ``buf`` at byte offsets."""
    b = buf.astype(np.uint32)
    return b[off] | b[off + 1] << 8 | b[off + 2] << 16 | b[off + 3] << 24


def _byte_perm(x, y, s):
    """CUDA's __byte_perm(x, y, s) (selector bytes 0-7, no sign mode)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
        [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(s >> (4 * n)) & 7] << (8 * n)
    return out


def _transpose4x4(a):
    t0 = _byte_perm(a[0], a[1], 0x5140)
    t1 = _byte_perm(a[0], a[1], 0x7362)
    t2 = _byte_perm(a[2], a[3], 0x5140)
    t3 = _byte_perm(a[2], a[3], 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _s8(word, k):
    return ((word >> (8 * k)) & 0xFF).astype(np.int64) - \
        256 * (((word >> (8 * k)) & 0x80) != 0)


def _dp4a(a, b, c):
    return c + sum(_s8(a, k) * _s8(b, k) for k in range(4))


def layout(variant, bs, rt):
    """``Int8Layout``: (warps, warps sharing a tile's K, int32 sums a lane
    of a warp's tile, sums a thread owns after the warps add theirs)."""
    warps = 4 if variant == "mma" or bs != 32 else 2
    v = 64 if variant == "mma" else 4 * rt
    return warps, warps, v, v // warps


def _dp4a_lanes(staged, xq, bs, ks, n_ks):
    """``dot_dp4a`` of K share ks of n_ks: d[lane, 4r + j] for code rows
    xq [RT, bs] int8 against the staged tile, and the byte offsets the
    lanes read, one array per load instruction."""
    RT = xq.shape[0]
    wr = bs // 4
    G, lane = 32 // wr, np.arange(32)
    kr = bs // (G * n_ks)
    w, h = lane % wr, lane // wr
    d = np.zeros((32, RT * 4), np.int64)
    xb = np.ascontiguousarray(xq).view(np.uint8)
    reads = []
    for step in range(kr // 4):
        i = (ks * G + h) * kr + 4 * step
        a = []
        for rr in range(4):
            off = (i + rr) * bs + _swz(bs, i + rr, w >> 2) * 16 + (w & 3) * 4
            reads.append(off)
            a.append(_word(staged, off))
        b = _transpose4x4(a)
        for r in range(RT):
            xw = _word(xb[r], i)
            for j in range(4):
                d[:, 4 * r + j] = _dp4a(xw, b[j], d[:, 4 * r + j])
    off = wr
    while off < 32:                                   # shuffles over h
        d = d + d[lane ^ off]
        off *= 2
    return d, reads


def _mma_lanes(staged, xq, ks, n_ks):
    """``dot_mma`` of K share ks of n_ks: the int32 sums lane (g, t)
    holds, v = 4 nt + c, for code rows xq [16, 128] against the staged
    tile (m16n8k16 fragments: A rows g, g + 8 at k 4t .. 4t+3; B column
    g at the same k; D rows g, g + 8 at columns 2t, 2t + 1), and the
    lds.128 offsets."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    D = np.zeros((16, 16, 8), np.int64)               # [nt, row, L]
    xb = np.ascontiguousarray(xq).view(np.uint8).reshape(-1)
    reads = []
    steps = 8 // n_ks
    for s in range(ks * steps, (ks + 1) * steps):
        raw = np.zeros((4, 4, 32), np.uint32)         # [q][r][lane]
        for r in range(4):
            i = 16 * s + 4 * t + r
            off = i * 128 + _swz(128, i, g) * 16
            reads.append(off)
            for q in range(4):
                raw[q][r] = _word(staged, off + 4 * q)
        A = np.zeros((16, 16), np.int64)
        a0 = _word(xb, g * 128 + 16 * s + 4 * t)
        a1 = _word(xb, (g + 8) * 128 + 16 * s + 4 * t)
        for kk in range(4):
            A[g, 4 * t + kk] = _s8(a0, kk)
            A[g + 8, 4 * t + kk] = _s8(a1, kk)
        for q in range(4):
            b = _transpose4x4(list(raw[q]))
            for j in range(4):
                B = np.zeros((16, 8), np.int64)
                for kk in range(4):
                    B[4 * t + kk, g] = _s8(b[j], kk)
                D[4 * q + j] += A @ B
    vals = np.zeros((32, 64), np.int64)
    for v in range(64):
        nt, c = v >> 2, v & 3
        vals[:, v] = D[nt, g + 8 * (c >> 1), 2 * t + (c & 1)]
    return vals, reads


def _value_map(variant, bs, v, lane):
    """(row of the block's tile, output column) of sum v of a lane."""
    if variant == "mma":
        g, t = lane >> 2, lane & 3
        return g + 8 * ((v & 3) >> 1), \
            32 * t + 16 * (v & 1) + (v >> 2)
    return v >> 2, 4 * (lane % (bs // 4)) + (v & 3)


def lane_map(variant, bs, rt):
    """For sum u of thread (warp, lane) after the warps of a tile add
    theirs, [warps, kVO, 32] arrays: the output (row, column) and whether
    this thread stores it (the dp4a path's k-groups hold copies)."""
    warps, n_ks, _, kvo = layout(variant, bs, rt)
    w = np.arange(warps)[:, None, None]
    u = np.arange(kvo)[None, :, None]
    lane = np.arange(32)[None, None, :]
    v = (w % n_ks) * kvo + u
    row, col = _value_map(variant, bs, v, lane)
    owner = np.ones_like(row, bool) if variant == "mma" \
        else lane < bs // 4
    shape = (warps, kvo, 32)
    return tuple(np.broadcast_to(a, shape).copy() for a in (row, col, owner))


@pytest.mark.parametrize("bs,rt", [(32, 4), (32, 8), (64, 4), (64, 8),
                                   (128, 4), (128, 8)])
def test_dp4a_lane_map_equals_the_plain_dot(bs, rt):
    rng = np.random.default_rng(bs + rt)
    tile = rng.integers(-127, 128, (bs, bs), dtype=np.int8)
    xq = rng.integers(-127, 128, (rt, bs), dtype=np.int8)
    _, n_ks, _, _ = layout("dp4a", bs, rt)
    d = 0
    for ks in range(n_ks):                          # the warps' K shares
        dk, reads = _dp4a_lanes(_stage(tile), xq, bs, ks, n_ks)
        d = d + dk
        if bs == 128:   # a warp reads one row's 32 words: 32 banks
            for off in reads:
                assert len(set((off // 4) % 32)) == 32
    want = xq.astype(np.int64) @ tile.astype(np.int64)
    lane = np.arange(32)[:, None]
    row, col = _value_map("dp4a", bs, np.arange(rt * 4)[None, :], lane)
    np.testing.assert_array_equal(d, want[row, col])
    row, col, owner = lane_map("dp4a", bs, rt)
    counts = np.zeros((rt, bs), int)
    np.add.at(counts, (row[owner], col[owner]), 1)
    assert (counts == 1).all()                      # each output once


def test_mma_lane_map_equals_the_plain_dot():
    rt = 16
    rng = np.random.default_rng(rt)
    tile = rng.integers(-127, 128, (128, 128), dtype=np.int8)
    xq = rng.integers(-127, 128, (16, 128), dtype=np.int8)
    _, n_ks, _, _ = layout("mma", 128, rt)
    vals = 0
    for ks in range(n_ks):
        vk, reads = _mma_lanes(_stage(tile), xq, ks, n_ks)
        vals = vals + vk
        # lds.128: each quarter warp meets 8 distinct 16-byte bank groups
        for off in reads:
            for p in range(4):
                assert len(set((off[8 * p:8 * p + 8] // 16) % 8)) == 8
    want = xq.astype(np.int64) @ tile.astype(np.int64)
    lane = np.arange(32)[:, None]
    row, col = _value_map("mma", 128, np.arange(64)[None, :], lane)
    np.testing.assert_array_equal(vals, want[row, col])
    # lane (g, t) holds rows g, g + 8 of columns 32t .. 32t+31
    assert all(set(col[l]) == set(range(32 * (l & 3), 32 * (l & 3) + 32))
               for l in range(32))
    row, col, owner = lane_map("mma", 128, rt)
    counts = np.zeros((rt, 128), int)
    np.add.at(counts, (row[owner], col[owner]), 1)
    assert (counts == 1).all()
    # A fragments from rows of bs + 16 bytes: 32 distinct banks
    lane = np.arange(32)
    for s in range(8):
        a = (lane >> 2) * 144 + 16 * s + 4 * (lane & 3)
        assert len(set((a // 4) % 32)) == 32


# ----------------------------------------------------------- arithmetic
def emulate_int8(x, ws, idx, scales, x_scale, nsplit=None, seed=0):
    """The int8 kernels' fp32 sums [E, M, nob*bs] a branch, as the card
    forms them: the plan's row chunks, slot runs and lane order; per slot
    the activation codes, the int32 dot (K in a shuffled order of 4-row
    chunks), the part float(dot) * (sx * scale) written to scratch in
    lane order by blocks that finish in a shuffled order, and the sums
    of all kb parts in slot order from 0 (``nsplit`` forces a split)."""
    E, M, n_in = x.shape
    nob, kb = idx.shape
    bs = ws[0].shape[-1]
    variant, rows, run, ns = tbsm.int8_plan(E, M, nob, kb, bs)
    if nsplit is not None:
        run = -(-kb // nsplit)
        ns = -(-kb // run)
    rng = np.random.default_rng(seed)
    rows_pad = tbsm.int8_rows_pad(variant, rows)
    lrow, lcol, lown = lane_map(variant, bs, rows_pad)
    xb = x.float().reshape(E, M, n_in // bs, bs)
    out = [torch.zeros((E, M, nob * bs)) for _ in ws]
    for m0 in range(0, M, rows):
        nr = min(rows, M - m0)
        xc = torch.zeros((E, rows_pad, n_in // bs, bs))
        xc[:, :nr] = xb[:, m0:m0 + nr]
        scratch = {}
        for sp in rng.permutation(ns):               # blocks in any order
            for k in range(sp * run, min(kb, (sp + 1) * run)):
                xk = xc[:, :, idx[:, k].long(), :]   # [E, rows_pad, nob, bs]
                if x_scale is None:
                    ax = xk.abs().amax(dim=-1, keepdim=True)
                    sx = torch.where(ax == 0.0, 1.0, ax / torch.full_like(
                        ax, 127.0))
                else:
                    sx = x_scale.reshape(E, 1, 1, 1).expand(E, rows_pad,
                                                            nob, 1)
                xq = torch.clamp(torch.round(xk / sx), -127, 127)
                xq[:, nr:] = 0.0                     # padding rows
                for br, (w, sc) in enumerate(zip(ws, scales)):
                    wk = w[:, :, k].long()           # [E, nob, bs, bs]
                    dot = torch.zeros((E, rows_pad, nob, bs),
                                      dtype=torch.int64)
                    for c in rng.permutation(bs // 4):
                        ks = slice(4 * c, 4 * c + 4)
                        dot += torch.einsum("erok,eokc->eroc",
                                            xq[..., ks].long(), wk[:, :, ks])
                    part = dot.float() * (sx * sc[:, None, :, k, None])
                    # thread order [e, o, warp, u, lane]
                    scratch[br, k] = part.permute(0, 2, 1, 3)[
                        :, :, lrow, lcol]
        for br in range(len(ws)):
            acc = torch.zeros_like(scratch[br, 0])
            for k in range(kb):                      # slot order, from 0
                acc = acc + scratch[br, k]
            full = torch.zeros((E, nob, rows_pad, bs))
            full[:, :, lrow[lown], lcol[lown]] = acc[:, :, lown]
            full = full[:, :, :nr]
            out[br][:, m0:m0 + nr] = full.permute(0, 2, 1, 3).reshape(
                E, nr, nob * bs)
    return out


def _case(rng, E, M, bs, kb_nob=(3, 2), dtype=torch.float32, n=1,
          static=False):
    nob, kb = kb_nob
    n_in = bs * (kb + 2)
    pat = make_block_pattern(n_in, nob * bs, kb / (kb + 2), bs, seed=1)
    assert pat.idx.shape == (nob, kb)
    x = rng.standard_normal((E, M, n_in)).astype(np.float32)
    if M > 1:
        x[:, 1, :bs] = 0.0                 # a slot whose dynamic scale is 1
    ws = []
    for _ in range(n):
        w = rng.standard_normal((E, nob, kb, bs, bs)).astype(np.float32)
        w[0, 0, 0, :, :3] = 0.0
        q, s = jqz.quantize_weights(jnp.asarray(w * 0.2), bits=8)
        ws.append((torch.from_numpy(np.array(q)),
                   torch.from_numpy(np.array(s))))
    xs = (np.abs(x).max(axis=(1, 2)) / 127.0).astype(np.float32) \
        if static else None
    xt = torch.from_numpy(x).to(dtype)
    b = torch.from_numpy(rng.standard_normal((E, nob * bs))
                         .astype(np.float32))
    return (pat, torch.from_numpy(pat.idx), xt, ws, b,
            None if xs is None else torch.from_numpy(xs))


@pytest.mark.parametrize("bs", [32, 64, 128])
@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("M", [1, 4, 5, 32, 33])
def test_emulation_equals_plain_versions_bit_for_bit(M, E, bs):
    """Every split 1 .. kb, dynamic and static scales, fp32 and bf16 x,
    both kernels, act none: the kernel's order of roundings is the plain
    versions' (int32 dots exact, the same two fp32 products, the same
    sums in slot order)."""
    rng = np.random.default_rng(M * 10 + E + bs)
    kb = 3
    for static in (False, True):
        dtype = torch.bfloat16 if static else torch.float32
        _, idx, x, ((wq, sc), (wi, si)), b, xs = _case(
            rng, E, M, bs, (2, kb), dtype, n=2, static=static)
        want_y = tbsm.fwd_int8_ref(x, wq, idx, sc, b, "none", xs)
        want_h = tbsm.gated_fwd_int8_ref(x, wq, wi, idx, sc, si, xs)
        for nsplit in range(1, kb + 1):
            (s,) = emulate_int8(x, [wq], idx, [sc], xs, nsplit, seed=nsplit)
            y = (s + b[:, None, :]).to(x.dtype)
            assert torch.equal(y, want_y), (static, nsplit)
            g, u = emulate_int8(x, [wq, wi], idx, [sc, si], xs, nsplit)
            h = (tbsm.act_fwd(g, "silu") * u).to(x.dtype)
            assert torch.equal(h, want_h), (static, nsplit)


def test_emulation_at_the_plan_of_a_path_shape():
    """The plan's own split at a block-128 copy of a split serving shape
    (nob 2, kb 6, E 1: six blocks an output block) and at the mma rows."""
    rng = np.random.default_rng(21)
    for M in (4, 32):
        _, idx, x, ((wq, sc),), b, _ = _case(rng, 1, M, 128, (2, 6))
        assert tbsm.int8_plan(1, M, 2, 6, 128)[3] == 6
        (s,) = emulate_int8(x, [wq], idx, [sc], None)
        want = tbsm.fwd_int8_ref(x, wq, idx, sc, b, "none")
        assert torch.equal(s + b[:, None, :], want)


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_emulation_matches_reference_kernels_in_interpret_mode(static):
    """fp32, E 3, M 16, block 32, a split of two: within 1e-5 of the
    reference's ``fwd_int8`` and ``gated_fwd_int8`` Pallas kernels."""
    rng = np.random.default_rng(31 + static)
    _, idx, x, ((wq, sc), (wi, si)), b, xs = _case(
        rng, 3, 16, 32, (3, 4), n=2, static=static)
    jxs = None if xs is None else jnp.asarray(xs.numpy())
    j = lambda t: jnp.asarray(t.numpy())
    (s,) = emulate_int8(x, [wq], idx, [sc], xs, nsplit=2)
    want = jbsm.fwd_int8(j(x), j(wq), idx.numpy(), j(sc), j(b), act="none",
                         x_scale=jxs, interpret=True)
    np.testing.assert_allclose((s + b[:, None, :]).numpy(),
                               np.asarray(want), **INT8)
    g, u = emulate_int8(x, [wq, wi], idx, [sc, si], xs, nsplit=2)
    want = jbsm.gated_fwd_int8(j(x), j(wq), j(wi), idx.numpy(), j(sc),
                               j(si), x_scale=jxs, bm=16, interpret=True)
    np.testing.assert_allclose((tbsm.act_fwd(g, "silu") * u).numpy(),
                               np.asarray(want), **INT8)


# -------------------------------------------------------------- wrappers
def _no_host_read(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the int8 wrapper read a tensor on the host")
    for name in ("item", "tolist", "numpy", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("gated", [False, True], ids=["fwd", "gated"])
@pytest.mark.parametrize("shape", [(1, 4, 20, 14), (1, 32, 54, 5),
                                   (128, 4, 6, 4), (3, 33, 2, 3)], ids=str)
def test_wrappers_pass_plan_scratch_and_tickets(monkeypatch, shape, gated):
    E, M, nob, kb = shape
    bs = 128 if E != 3 else 32
    nib = kb + 2
    x = torch.zeros((E, M, nib * bs))
    codes = [torch.zeros((E, nob, kb, bs, bs), dtype=torch.int8)
             for _ in range(2)]
    sc = torch.ones((E, nob, kb))
    idx = torch.from_numpy(np.stack([np.arange(kb)] * nob)
                           .astype(np.int32))
    variant, rows, run, nsplit = tbsm.int8_plan(E, M, nob, kb, bs)
    name = "junction_gated_fwd_int8" if gated else "junction_fwd_int8"
    with _launch_recorder(monkeypatch) as calls:
        _no_host_read(monkeypatch)
        if gated:
            tbsm.gated_fwd_int8(x, codes[0], codes[1], idx, sc, sc)
        else:
            tbsm.fwd_int8(x, codes[0], idx, sc, torch.zeros((E, nob * bs)))
    (lib, got_name, n_ptr, n_int, n_args), = calls
    assert (lib, got_name) == ("junction_quant", name)
    assert (n_ptr, n_int) == _c_prototype(name)
    assert n_args == n_ptr + n_int + 1
    args = calls.args[0]
    part, tickets = args[n_ptr - 2], args[n_ptr - 1]
    ints = args[n_ptr:n_ptr + n_int]
    assert ints[-4:] == (int(variant == "mma"), rows, run, nsplit)
    assert ints[:5] == (E, M, nib, nob, kb)
    if nsplit > 1:
        assert isinstance(part, int) and isinstance(tickets, int)
    else:
        assert part is None and tickets is None
    tbsm.fwd_int8.launches = tbsm.gated_fwd_int8.launches = 0


def test_split_scratch_holds_every_part_in_lane_order(monkeypatch):
    """The scratch of a split launch: kBr * E * chunks * nob * kb tiles of
    rows_pad * 128 fp32 parts; the tickets: E * chunks * nob."""
    sizes = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes.append(t.numel())
        return t
    E, M, nob, kb, bs = 3, 33, 2, 3, 32
    variant, rows, run, nsplit = tbsm.int8_plan(E, M, nob, kb, bs)
    assert nsplit > 1
    chunks = math.ceil(M / rows)
    x = torch.zeros((E, M, (kb + 2) * bs))
    codes = torch.zeros((E, nob, kb, bs, bs), dtype=torch.int8)
    idx = torch.zeros((nob, kb), dtype=torch.int32)
    with _launch_recorder(monkeypatch):
        monkeypatch.setattr(torch, "empty", empty)
        tbsm.gated_fwd_int8(x, codes, codes, idx, torch.ones((E, nob, kb)),
                            torch.ones((E, nob, kb)))
    want = 2 * E * chunks * nob * kb * tbsm.int8_rows_pad(variant, rows) \
        * 128
    assert want in sizes
    tbsm.gated_fwd_int8.launches = 0
