"""The byte-plane product of ``csrc/fxp_tc.cuh`` on the CPU: the two
fixed-point kernels, ``fxp_qmatmul`` and ``junction_fwd_fxp``, run on the
int8 tensor cores only on the card (``chip_smoke.py`` holds them against
their plain versions there), so these tests emulate their arithmetic and
index maps in numpy and hold the emulation against the plain versions
and the reference's kernels (interpret mode).

- Planes: a code that fits P bytes is the sum of its byte planes (u8
  below the top one, s8 the top); ``transpose4x4``'s byte permutes give
  the planes of four codes; the vote finds the planes a tile needs.
- Staging and fragments: every staged word is written once; the
  ``mma.sync m16n8k32`` fragments read from the padded rows meet no bank
  conflict and, laid out as the PTX ISA defines them, give the plain
  product of every plane pair and signedness; the sums' (warp, lane, u)
  map covers the tile once.
- The int32 accumulators: one k adds at most 195330 to any of them, so
  8192 of K (CHUNK_TILES K tiles, the most a block takes) stay inside
  int32; the plain version is exact past that chunk too.
- The whole arithmetic (planes a tile by vote, shifted int32 sums, the
  uint32 combine, the K split of ``split_plan`` and the epilogue): equal
  bit for bit to ``qmatmul_ref`` / ``fwd_fxp_ref`` and to the reference's
  kernels, at every paper triplet, on sums that wrap int32, on codes
  beyond 16 bits, ragged shapes, blocks 32 / 64 / 128, fp32 and bf16 x.
- The wrappers pass the plan, the scratch and the tickets to the C entry
  points (a recorder in place of the library) and read no tensor on the
  host.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixed_point as jfp
from repro.core import quantize as jqz
from repro.core.sparsity import make_block_pattern
from repro.kernels import fxp_qmatmul as jfxpk
from repro.kernels import ops as jops

from repro_torch.kernels import block_sparse_matmul as tbsm
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import fxp_qmatmul as tfxpk
from torch_tc_helpers import _c_prototype, _launch_recorder

BM, BK, ROW_WORDS, PLANES = 64, 32, 12, 4
QK, QROW = 128, 36      # fxp_qmatmul's packed K tiles and staged rows
TRIPLETS = [(f.bw, f.bn, f.bf) for f in jfp.PAPER_TRIPLETS]
LANES = np.arange(32)
G, T4 = LANES >> 2, LANES & 3
MASK32 = (1 << 32) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------- byte planes
def _byte_perm(x, y, s):
    """__byte_perm on uint32 arrays (selector nibbles 0..7)."""
    src = [(np.asarray(v, np.int64) >> (8 * b)) & 0xFF
           for v in (x, y) for b in range(4)]
    return sum(src[(s >> (4 * k)) & 7] << (8 * k) for k in range(4))


def _transpose4x4(a):
    """fxp_tc::transpose4x4 on four arrays of words."""
    t0 = _byte_perm(a[0], a[1], 0x5140)
    t1 = _byte_perm(a[0], a[1], 0x7362)
    t2 = _byte_perm(a[2], a[3], 0x5140)
    t3 = _byte_perm(a[2], a[3], 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _u32(c):
    return np.asarray(c, np.int64) & MASK32


def _bytes(words):
    """uint32 words [...] -> their bytes [..., 4], low byte first."""
    return (np.asarray(words, np.int64)[..., None] >> (8 * np.arange(4))) \
        & 0xFF


def _val(b, signed):
    return b - 256 * (b >= 128) if signed else b


def _wide_bits(c):
    """fxp_tc::wide_bits of the OR of fxp_tc::magnitude over an array of
    int32 codes (c ^ (c >> 31): c, or -c - 1 below 0)."""
    c = np.asarray(c, np.int64)
    mag = np.bitwise_or.reduce(np.ravel(c ^ (c >> 63)))
    return (1 if mag >> 7 else 0) | (2 if mag >> 15 else 0)


def _planes_of(bits):
    return 4 if bits & 2 else (2 if bits & 1 else 1)


def test_transpose4x4_gives_the_planes_of_four_codes():
    rng = np.random.default_rng(0)
    c = rng.integers(-2 ** 31, 2 ** 31, (4, 500))
    got = _transpose4x4([_u32(v) for v in c])
    for p in range(4):
        want = sum((((c[r] >> (8 * p)) & 0xFF) << (8 * r)) for r in range(4))
        np.testing.assert_array_equal(got[p], want)


@pytest.mark.parametrize("P,lo,hi", [(1, -2 ** 7, 2 ** 7),
                                     (2, -2 ** 15, 2 ** 15),
                                     (4, -2 ** 31, 2 ** 31)])
def test_planes_sum_to_the_code_and_the_vote_finds_them(P, lo, hi):
    rng = np.random.default_rng(P)
    c = np.concatenate([rng.integers(lo, hi, 4000), [lo, hi - 1, 0, -1]])
    b = _bytes(_u32(c))
    got = sum(_val(b[:, i], i == P - 1) << (8 * i) for i in range(P))
    np.testing.assert_array_equal(got, c)
    assert _planes_of(_wide_bits(c)) == P
    # mod 2^32 every int32 code is its four planes
    np.testing.assert_array_equal(
        sum(_val(b[:, i], i == 3) << (8 * i) for i in range(4)), c)


@pytest.mark.parametrize("code,planes", [(127, 1), (-128, 1), (128, 2),
                                         (-129, 2), (2 ** 15 - 1, 2),
                                         (-2 ** 15, 2), (2 ** 15, 4),
                                         (-2 ** 15 - 1, 4), (2 ** 31 - 1, 4),
                                         (-2 ** 31, 4)])
def test_vote_boundaries(code, planes):
    assert _planes_of(_wide_bits([0, code, 1])) == planes


# ------------------------------------------------------- staging and mma
def _shape(bn):
    warps = 2 * bn // 32
    threads = 32 * warps
    return dict(wn=bn // 32, warps=warps, threads=threads,
                a_words=PLANES * BM * ROW_WORDS,
                b_words=PLANES * bn * ROW_WORDS,
                a_quads=BM * BK // 4 // threads)


def stage(a, b, bn, written=None):
    """fxp_tc::stage over all threads: a [64, 32] and b [32, bn] int32
    codes -> the stage's words and the block's vote.  ``written`` counts
    the stores of each word."""
    S = _shape(bn)
    st = np.zeros(S["a_words"] + S["b_words"], np.int64)
    written = np.zeros(st.shape, np.int64) if written is None else written
    tid = np.arange(S["threads"])
    for u in range(S["a_quads"]):
        q = tid + u * S["threads"]
        r, w = q >> 3, q & 7
        quads = [a[r, 4 * w + i] for i in range(4)]
        for i, p in enumerate(_transpose4x4([_u32(v) for v in quads])):
            at = (i * BM + r) * ROW_WORDS + w
            st[at] = p
            np.add.at(written, at, 1)
    lane, warp = tid & 31, tid >> 5
    kq, nq = lane & 7, warp * 4 + (lane >> 3)
    for j in range(4):
        col = [b[4 * kq + r, 4 * nq + j] for r in range(4)]
        for i, p in enumerate(_transpose4x4([_u32(v) for v in col])):
            at = S["a_words"] + (i * bn + 4 * nq + j) * ROW_WORDS + kq
            st[at] = p
            np.add.at(written, at, 1)
    return st, _wide_bits(a) | (_wide_bits(b) << 2)


def mma(d, a, b, a_signed, b_signed):
    """mma.sync.m16n8k32.row.col.s32 with 8-bit operands for one warp:
    a [32 lanes, 4 regs], b [32, 2], d [32, 4] int64, laid out as the
    PTX ISA defines the fragments (each element placed exactly once)."""
    A = np.full((16, 32), 1 << 40, np.int64)
    B = np.full((32, 8), 1 << 40, np.int64)
    ab = _val(_bytes(a), a_signed)
    for r in range(4):
        A[(G + 8 * (r & 1))[:, None],
          4 * T4[:, None] + np.arange(4) + 16 * (r >> 1)] = ab[:, r]
    bb = _val(_bytes(b), b_signed)
    for r in range(2):
        B[4 * T4[:, None] + np.arange(4) + 16 * r, G[:, None]] = bb[:, r]
    assert (A != 1 << 40).all() and (B != 1 << 40).all()
    D = A @ B
    for c in range(4):
        d[:, c] += D[G + 8 * (c >> 1), 2 * T4 + (c & 1)]


def _pairs(pa, pb):
    return [(i, j) for i in range(pa) for j in range(pb) if i + j <= 3]


def k_step_lanes(st, pa, pb, bn, acc):
    """fxp_tc::k_step as each lane runs it: acc [warps, 2 mt, 4 nt, 4
    shifts, 32 lanes, 4] int64."""
    S = _shape(bn)
    for warp in range(S["warps"]):
        wm, wn = warp // S["wn"], warp % S["wn"]
        for mt in range(2):
            r = wm * 32 + mt * 16 + G
            af = [np.stack([st[(i * BM + r) * ROW_WORDS + T4],
                            st[(i * BM + r + 8) * ROW_WORDS + T4],
                            st[(i * BM + r) * ROW_WORDS + T4 + 4],
                            st[(i * BM + r + 8) * ROW_WORDS + T4 + 4]], 1)
                  for i in range(pa)]
            for nt in range(4):
                n = wn * 32 + nt * 8 + G
                bf = [np.stack([st[S["a_words"] + (j * bn + n) * ROW_WORDS
                                   + T4 + o] for o in (0, 4)], 1)
                      for j in range(pb)]
                for i, j in _pairs(pa, pb):
                    mma(acc[warp, mt, nt, i + j], af[i], bf[j],
                        i == pa - 1, j == pb - 1)


def k_step_tile(st, pa, pb, bn, acc):
    """The same k step on whole planes: acc [4 shifts, 64, bn] int64 +=
    sum over pairs of A_i @ B_j^T."""
    S = _shape(bn)
    bytes_a = _bytes(st[:S["a_words"]].reshape(PLANES, BM, ROW_WORDS)
                     [:, :, :8]).reshape(PLANES, BM, BK)
    bytes_b = _bytes(st[S["a_words"]:].reshape(PLANES, bn, ROW_WORDS)
                     [:, :, :8]).reshape(PLANES, bn, BK)
    for i, j in _pairs(pa, pb):
        acc[i + j] += _val(bytes_a[i], i == pa - 1) \
            @ _val(bytes_b[j], j == pb - 1).T


def sum_map(bn):
    """(row, col) in the block tile of each thread's sum u, [warps, 32
    lanes, 32 u] (fxp_tc::row_of / col_of)."""
    S = _shape(bn)
    warp = np.arange(S["warps"])[:, None, None]
    u = np.arange(32)[None, None, :]
    lane = LANES[None, :, None]
    row = (warp // S["wn"]) * 32 + 16 * (u >> 4) + (lane >> 2) \
        + 8 * ((u >> 1) & 1)
    col = (warp % S["wn"]) * 32 + 8 * ((u >> 2) & 3) + 2 * (lane & 3) \
        + (u & 1)
    return np.broadcast_to(row, (S["warps"], 32, 32)), \
        np.broadcast_to(col, (S["warps"], 32, 32))


def _codes(rng, shape, width):
    lo = {8: -2 ** 7, 16: -2 ** 15, 32: -2 ** 31}[width]
    return rng.integers(lo, -lo, shape)


@pytest.mark.parametrize("bn", [32, 64, 128])
def test_stage_writes_every_word_once_and_reads_meet_no_bank_conflict(bn):
    S = _shape(bn)
    rng = np.random.default_rng(bn)
    written = np.zeros(S["a_words"] + S["b_words"], np.int64)
    stage(_codes(rng, (BM, BK), 32), _codes(rng, (BK, bn), 32), bn, written)
    data = np.zeros_like(written, dtype=bool).reshape(-1, ROW_WORDS)
    data[:, :8] = True
    data = data.reshape(-1)
    assert (written[data] == 1).all() and (written[~data] == 0).all()
    # a fragment load: lane (g, t) reads word t (+4) of row g (+8) at a
    # 12-word stride: 32 distinct banks
    assert len({(12 * g + t) % 32 for g in range(8) for t in range(4)}) == 32


@pytest.mark.parametrize("bn", [32, 64, 128])
def test_sum_map_covers_the_tile_once_as_the_fragments_place_it(bn):
    rows, cols = sum_map(bn)
    cover = np.zeros((BM, bn), np.int64)
    np.add.at(cover, (rows.reshape(-1), cols.reshape(-1)), 1)
    assert (cover == 1).all()
    # the D fragment of (warp, mt, nt) lane, c is sum u = 16 mt + 4 nt + c
    S = _shape(bn)
    for warp in range(S["warps"]):
        wm, wn = warp // S["wn"], warp % S["wn"]
        for mt in range(2):
            for nt in range(4):
                for c in range(4):
                    u = 16 * mt + 4 * nt + c
                    np.testing.assert_array_equal(
                        rows[warp, :, u], wm * 32 + mt * 16 + G + 8 * (c >> 1))
                    np.testing.assert_array_equal(
                        cols[warp, :, u], wn * 32 + nt * 8 + 2 * T4 + (c & 1))


@pytest.mark.parametrize("widths", [(8, 8), (16, 16), (8, 16), (16, 32),
                                    (32, 8), (32, 32)], ids=str)
@pytest.mark.parametrize("bn", [32, 64, 128])
def test_lane_fragments_give_the_plain_product(bn, widths):
    """k_step as the lanes run it equals the product of the staged tiles
    mod 2^32, and equals the whole-plane form the other tests use."""
    rng = np.random.default_rng(bn + widths[0] * 7 + widths[1])
    a = _codes(rng, (BM, BK), widths[0])
    b = _codes(rng, (BK, bn), widths[1])
    st, bits = stage(a, b, bn)
    pa, pb = _planes_of(bits & 3), _planes_of(bits >> 2)
    assert (pa, pb) == tuple({8: 1, 16: 2, 32: 4}[w] for w in widths)
    S = _shape(bn)
    lanes = np.zeros((S["warps"], 2, 4, 4, 32, 4), np.int64)
    k_step_lanes(st, pa, pb, bn, lanes)
    tile = np.zeros((4, BM, bn), np.int64)
    k_step_tile(st, pa, pb, bn, tile)
    rows, cols = sum_map(bn)
    for s in range(4):
        per_u = lanes[:, :, :, s].transpose(0, 3, 1, 2, 4).reshape(
            S["warps"], 32, 32)
        np.testing.assert_array_equal(tile[s][rows, cols], per_u)
    got = sum(tile[s] << (8 * s) for s in range(4)) & MASK32
    want = (a @ b) & MASK32          # int64 products wrap mod 2^64
    np.testing.assert_array_equal(got, want)


def test_one_k_adds_at_most_195330_to_an_accumulator():
    """The K chunk of fxp_tc.cuh: the worst byte values of every plane
    pair of every plane count, summed over a shift, then 8192 of K."""
    worst = 0
    for pa in (1, 2, 4):
        for pb in (1, 2, 4):
            for s in range(4):
                worst = max(worst, sum(
                    (128 if i == pa - 1 else 255) * (128 if j == pb - 1
                                                     else 255)
                    for i, j in _pairs(pa, pb) if i + j == s))
    assert worst == 195330
    assert tfxpk.CHUNK_TILES * tfxpk.TILE_K * worst < 2 ** 31
    assert (2 ** 31 - 1) // worst == 10994    # the most K an int32 holds
    # the extreme plane values (255, 255, 255, -128: 0x80ffffff) tile
    # after tile stay within the bound
    a = np.full((BM, BK), 0x80FFFFFF - 2 ** 32, np.int64)
    st, bits = stage(a, np.full((BK, 64), 0x80FFFFFF - 2 ** 32, np.int64),
                     64)
    assert bits == 0b1111
    tile = np.zeros((4, BM, 64), np.int64)
    for n in range(1, 4):
        k_step_tile(st, 4, 4, 64, tile)
        assert 0 < np.abs(tile).max() <= n * BK * worst


# ------------------------------------------------- the whole arithmetic
def plane_sums(a_tile, b_tile, t0, nt, bn):
    """fxp_tc::plane_sums: K tiles t0 .. t0 + nt - 1 (a_tile(t) [64, 32],
    b_tile(t) [32, bn] int32 codes), planes a tile by the block's vote,
    int32 sums checked against overflow, combined mod 2^32 [64, bn]."""
    acc = np.zeros((4, BM, bn), np.int64)
    for t in range(t0, t0 + nt):
        st, bits = stage(a_tile(t), b_tile(t), bn)
        k_step_tile(st, _planes_of(bits & 3), _planes_of(bits >> 2), bn, acc)
        assert np.abs(acc).max() < 2 ** 31
    return sum(acc[s] << (8 * s) for s in range(4)) & MASK32


def _pad(m, rows, cols):
    out = np.zeros((rows, cols), np.int64)
    out[:m.shape[0], :m.shape[1]] = m
    return out


def pack(a, w):
    """fxp_pack_kernel over its grid: a [M, K] and w [K, N] int32 codes ->
    ap [4, M, Kp] and bp [4, N, Kp] plane bytes (w transposed, zero codes
    past K; Kp = K rounded up to 128) and each operand's vote, by the
    kernel's thread maps, every word written exactly once."""
    M, K = a.shape
    N = w.shape[1]
    Kp = QK * max(1, -(-K // QK))
    words = Kp // 4
    a_pad, w_pad = _pad(a, M, Kp), _pad(w, Kp, N)
    ap = np.full((4, M, words), -1, np.int64)
    bp = np.full((4, N, words), -1, np.int64)
    q = np.arange(M * words)                   # A: one quad a thread
    m, kw = q // words, q % words
    for p, v in enumerate(_transpose4x4(
            [_u32(a_pad[m, 4 * kw + j]) for j in range(4)])):
        assert (ap[p, m, kw] == -1).all()
        ap[p, m, kw] = v
    tiles_n = -(-N // tfxpk.TILE_N)            # B: a 32 x 128 tile a block
    tid = np.arange(256)
    lane, warp = tid & 31, tid >> 5
    for blk in range(Kp // BK * tiles_n):
        kq = (blk // tiles_n) * 8 + (lane & 7)
        gn = (blk % tiles_n) * tfxpk.TILE_N + 4 * (warp * 4 + (lane >> 3))
        for j in range(4):
            ok = gn + j < N
            col = [_u32(w_pad[4 * kq[ok] + r, gn[ok] + j]) for r in range(4)]
            for p, v in enumerate(_transpose4x4(col)):
                assert (bp[p, gn[ok] + j, kq[ok]] == -1).all()
                bp[p, gn[ok] + j, kq[ok]] = v
    assert (ap >= 0).all() and (bp >= 0).all()
    return (_bytes(ap).reshape(4, M, Kp), _bytes(bp).reshape(4, N, Kp),
            _wide_bits(a), _wide_bits(w))


def copy_map(pa, pb, bn=128):
    """The packed kernel's copies of one K tile of 128, chunk c of an
    operand (plane c / (8 rows), row c / 8 % rows, sixteenth c % 8) ->
    (operand, plane, row, sixteenth) and its destination in the stage
    (rows of QROW words, A's pa planes then B's), in words."""
    a_words = pa * BM * QROW
    out = []
    for op, planes, rows, base in (("a", pa, BM, 0), ("b", pb, bn, a_words)):
        for c in range(planes * rows * 8):
            pr, h = c >> 3, c & 7
            out.append((op, pr // rows, pr % rows, h,
                        base + pr * QROW + 4 * h))
    return out


def emulate_qmatmul(a, w, bf, bn):
    """fxp_qmatmul: the pack, then fxp_qmatmul_kernel over its grid at
    qmatmul_plan, the planes of the operands' votes."""
    M, K = a.shape
    N = w.shape[1]
    tiles, run, nsplit = tfxpk.qmatmul_plan(M, K, N)
    ap, bp, va, vb = pack(a, w)
    pa, pb = _planes_of(va), _planes_of(vb)
    kt = ap.shape[2] // QK
    TN = tfxpk.TILE_N
    tiles_n = -(-N // TN)
    out = np.zeros((M, N), np.int64)
    for tile in range(tiles):
        m0, n0 = (tile // tiles_n) * BM, (tile % tiles_n) * TN
        v = np.zeros((BM, TN), np.int64)
        for s in range(nsplit):
            t0 = s * run
            nt = min(run, kt - t0)
            assert 1 <= nt <= tfxpk.QMM_CHUNK_TILES
            acc = np.zeros((4, BM, TN), np.int64)
            for t in range(t0, t0 + nt):
                ks = slice(t * QK, (t + 1) * QK)
                A = np.zeros((4, BM, QK), np.int64)
                B = np.zeros((4, TN, QK), np.int64)
                A[:, :min(BM, M - m0)] = ap[:, m0:m0 + BM, ks]
                B[:, :min(TN, N - n0)] = bp[:, n0:n0 + TN, ks]
                for i, j in _pairs(pa, pb):
                    acc[i + j] += _val(A[i], i == pa - 1) \
                        @ _val(B[j], j == pb - 1).T
                assert np.abs(acc).max() < 2 ** 31
            part = sum(acc[s] << (8 * s) for s in range(4)) & MASK32
            v = (v + part) & MASK32
        rows = min(BM, M - m0)
        cols = min(TN, N - n0)
        acc = v[:rows, :cols]
        s32 = ((acc + (1 << (bf - 1))) & MASK32)
        s32 = np.where(s32 >= 2 ** 31, s32 - 2 ** 32, s32) >> bf
        lim = 1 << (bn + bf)
        out[m0:m0 + rows, n0:n0 + cols] = np.clip(s32, -lim, lim - 1)
    return out.astype(np.int32)


@pytest.mark.parametrize("pa,pb", [(pa, pb) for pa in (1, 2, 4)
                                   for pb in (1, 2, 4)], ids=str)
def test_packed_copies_fill_the_planes_k_step_reads_once(pa, pb):
    rows = pa * BM + pb * 128
    hits = np.zeros(rows * QROW, np.int64)
    for _, _, _, _, dst in copy_map(pa, pb):
        assert dst % 4 == 0                    # 16-byte destinations
        hits[dst:dst + 4] += 1
    need = np.zeros((rows, QROW), bool)
    need[:, :QK // 4] = True
    assert (hits[need.reshape(-1)] == 1).all()
    assert (hits[~need.reshape(-1)] == 0).all()
    # the k steps read words 8 k + t (and + 4) of rows g (and g + 8): 36
    # words apart, a warp's 32 reads meet 32 banks
    assert len({(QROW * g + t) % 32 for g in range(8) for t in range(4)}) \
        == 32
    # at most kMaxStages stages of the voted planes in 224 KiB, two at least
    stages = min(4, 224 * 1024 // (4 * rows * QROW))
    assert 2 <= stages <= 4 and (stages == 4 or max(pa, pb) == 4)


@pytest.mark.parametrize("MKN", [(70, 90, 130), (3, 33, 5), (64, 32, 128),
                                 (1, 0, 1)], ids=str)
def test_pack_writes_every_plane_word_once(MKN):
    M, K, N = MKN
    rng = np.random.default_rng(K)
    a = _codes(rng, (M, K), 32)
    w = _codes(rng, (K, N), 16)
    ap, bp, va, vb = pack(a, w)
    Kp = QK * max(1, -(-K // QK))
    assert ap.shape == (4, M, Kp) and bp.shape == (4, N, Kp)
    assert 4 * ap[0].size == 4 * tfxpk.packed_words(M, K)
    for p in range(4):      # plane p of code (m, k): its byte p; 0 past K
        np.testing.assert_array_equal(ap[p, :, :K], (a >> (8 * p)) & 0xFF)
        np.testing.assert_array_equal(bp[p, :, :K], ((w >> (8 * p)) & 0xFF).T)
    assert not ap[:, :, K:].any() and not bp[:, :, K:].any()
    if K:
        assert (_planes_of(va), _planes_of(vb)) == (4, 2)


def _qmm_inputs(rng, M, K, N, case, fmt):
    bw, bn, bf = fmt
    lim = 1 << (bn + bf)
    if case == "spread":
        return (rng.integers(-lim, lim, (M, K)),
                rng.integers(-lim, lim, (K, N)))
    if case == "wraps":
        a = np.full((M, K), 2 ** 15 - 1, np.int64)
        w = np.full((K, N), 2 ** 15 - 1, np.int64)
        w[:, 1::2] = -(2 ** 15)
        return a, w
    if case == "wide":                 # codes beyond 16 bits, of one sign
        return (rng.integers(2 ** 30, 2 ** 31, (M, K)),
                rng.integers(2 ** 30, 2 ** 31, (K, N)))
    # "mixed": each K tile another width, so the block's vote changes
    a = np.concatenate([_codes(rng, (M, BK), wd) for wd in (8, 32, 16)], 1)
    w = np.concatenate([_codes(rng, (BK, N), wd) for wd in (16, 8, 32)], 0)
    return a[:, :K], w[:K]


QMM_CASES = [(f"spread-{f}", 9, 70, 33, "spread", f) for f in TRIPLETS] + [
    ("wraps", 4, 1024, 3, "wraps", TRIPLETS[-1]),
    ("wide", 5, 96, 20, "wide", TRIPLETS[-1]),
    ("mixed-ragged", 75, 90, 130, "mixed", TRIPLETS[2]),
    ("ragged", 75, 33, 50, "spread", TRIPLETS[1])]


@pytest.mark.parametrize("case", QMM_CASES, ids=[c[0] for c in QMM_CASES])
def test_qmatmul_emulation_bit_exact(case):
    _, M, K, N, kind, fmt = case
    rng = np.random.default_rng(M * K + N)
    a, w = _qmm_inputs(rng, M, K, N, kind, fmt)
    a32, w32 = a.astype(np.int32), w.astype(np.int32)
    _, bn, bf = fmt
    got = emulate_qmatmul(a, w, bf, bn)
    plain = tfxpk.qmatmul_ref(torch.from_numpy(a32), torch.from_numpy(w32),
                              bf=bf, bn=bn).numpy()
    np.testing.assert_array_equal(got, plain)
    if kind == "wraps":
        assert int((a[0] @ w[:, 0])) > 2 ** 31
    if kind in ("wide", "mixed"):
        assert np.abs(a).max() >= 2 ** 15
    want = np.asarray(jfxpk.qmatmul(jnp.asarray(a32), jnp.asarray(w32),
                                    bf=bf, bn=bn, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_qmatmul_plain_past_the_k_chunk():
    """16 x 65536 x 16 with every low byte 0xFF: more K than one block
    takes (8192), the plain version against an int64 dot mod 2^32 (numpy
    wraps int64 products and sums mod 2^64)."""
    rng = np.random.default_rng(65536)
    a = (rng.integers(0, 2 ** 23, (16, 65536)) << 8) | 0xFF
    w = (rng.integers(-2 ** 23, 2 ** 23, (65536, 16)) << 8) | 0xFF
    a32, w32 = a.astype(np.int32), w.astype(np.int32)
    bf, bn = 11, 4
    acc = (a32.astype(np.int64) @ w32.astype(np.int64)) & MASK32
    acc = np.where(acc >= 2 ** 31, acc - 2 ** 32, acc)
    r = ((acc + (1 << (bf - 1)) + 2 ** 31) % 2 ** 32 - 2 ** 31) >> bf
    want = np.clip(r, -(1 << (bn + bf)), (1 << (bn + bf)) - 1)
    got = tfxpk.qmatmul_ref(torch.from_numpy(a32), torch.from_numpy(w32),
                            bf=bf, bn=bn).numpy()
    np.testing.assert_array_equal(got, want)
    tiles, run, nsplit = tfxpk.qmatmul_plan(16, 65536, 16)
    assert run * QK <= 8192 and nsplit * run * QK >= 65536


# -------------------------------------------------------------- fwd_fxp
def _encode(x, bf, n_lut):
    lim = np.float32(n_lut // 2)
    v = np.rint(np.float32(x) * np.float32(2.0 ** bf))
    return np.clip(v, -lim, lim - np.float32(1)).astype(np.int64)


def emulate_fwd_fxp(x, wq, idx, bf, lut, bias):
    """junction_fxp_kernel over its grid at fxp_plan: x [E, M, n_in] fp32
    values (of x's dtype), wq [E, nob, kb, bs, bs] int64 codes, idx [nob,
    kb]; returns the fp32 LUT values."""
    E, M, _ = x.shape
    _, nob, kb, bs, _ = wq.shape
    n_lut = lut.shape[0]
    lim = n_lut // 2
    tiles, run, nsplit = tbsm.fxp_plan(E, M, nob, kb, bs)
    mtiles = -(-M // BM)
    assert tiles == E * nob * mtiles
    kts = bs // BK
    kt = kb * kts
    y = np.zeros((E, M, nob * bs), np.float32)
    for e in range(E):
        for o in range(nob):
            for mt in range(mtiles):
                m0 = mt * BM

                def a_tile(t):
                    c0 = int(idx[o, t // kts]) * bs + (t % kts) * BK
                    return _pad(_encode(x[e, m0:m0 + BM, c0:c0 + BK], bf,
                                        n_lut), BM, BK)

                def b_tile(t):
                    k, r0 = t // kts, (t % kts) * BK
                    return wq[e, o, k, r0:r0 + BK, :]
                v = np.zeros((BM, bs), np.int64)
                for s in range(nsplit):
                    t0 = s * run
                    nt = min(run, kt - t0)
                    assert 1 <= nt <= tfxpk.CHUNK_TILES
                    v = (v + plane_sums(a_tile, b_tile, t0, nt, bs)) & MASK32
                rows = min(BM, M - m0)
                s32 = (v[:rows] + (1 << (bf - 1))) & MASK32
                s32 = np.where(s32 >= 2 ** 31, s32 - 2 ** 32, s32) >> bf
                s32 = np.clip(s32, -lim, lim - 1)
                bcode = _encode(bias[e, o * bs:(o + 1) * bs], bf, n_lut)
                s32 = np.clip(s32 + bcode, -lim, lim - 1)
                y[e, m0:m0 + rows, o * bs:(o + 1) * bs] = \
                    lut[s32 & (n_lut - 1)]
    return y


def _fxp_case(fmt, E, M, bs, kind, dtype, seed, n_in=None, n_out=None):
    jf = jfp.FxpFormat(*fmt)
    rng = np.random.default_rng(seed)
    n_in, n_out = n_in or 4 * bs, n_out or 3 * bs
    pat = make_block_pattern(n_in, n_out, 0.5, bs, seed=0)
    shape = (E, pat.n_out_blocks, pat.fan_in_blocks, bs, bs)
    if kind == "wraps":
        w = np.full(shape, jf.max_val, np.float32)
        x = np.full((E, M, n_in), jf.max_val, np.float32)
        x[:, 1::2] = jf.min_val
    else:
        w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
        x = (rng.standard_normal((E, M, n_in)) * 2.0).astype(np.float32)
    q = np.asarray(jqz.fxp_encode_weights(w, jf)).astype(np.int64)
    if kind == "wide":               # weight codes beyond 16 bits
        q = rng.integers(2 ** 30, 2 ** 31, shape)
        x = np.full((E, M, n_in), jf.max_val, np.float32)
    x = torch.from_numpy(x).to(dtype).float().numpy()
    b = np.asarray(jfp.quantize(jnp.asarray(
        rng.standard_normal((E, n_out)).astype(np.float32)), jf))
    lut = np.asarray(jqz.act_lut(jf, "sigmoid"))
    qfmt = np.asarray([jf.bf, jf.bn], np.int32)
    return pat, q, x, b, lut, qfmt


FXP_CASES = [(f"l-{f}", f, 1, 64, 128, "spread", torch.float32)
             for f in TRIPLETS] + [
    ("wraps", TRIPLETS[-1], 1, 64, 128, "wraps", torch.float32),
    ("wide", TRIPLETS[-1], 1, 64, 128, "wide", torch.float32),
    ("ragged-bf16-bs32", TRIPLETS[2], 2, 33, 32, "spread", torch.bfloat16),
    ("ragged-bs64", TRIPLETS[0], 1, 33, 64, "spread", torch.float32),
    ("bf16-bs128-e2", TRIPLETS[3], 2, 70, 128, "spread", torch.bfloat16),
    ("wide-bs32", TRIPLETS[-1], 1, 5, 32, "wide", torch.float32)]


@pytest.mark.parametrize("case", FXP_CASES, ids=[c[0] for c in FXP_CASES])
def test_fwd_fxp_emulation_bit_exact(case):
    _, fmt, E, M, bs, kind, dtype = case
    pat, q, x, b, lut, qfmt = _fxp_case(fmt, E, M, bs, kind, dtype,
                                        seed=M + bs)
    bf = fmt[2]
    got = emulate_fwd_fxp(x, q, pat.idx, bf, lut, b)
    t = torch.from_numpy
    plain = tbsm.fwd_fxp_ref(t(x).to(dtype), t(q.astype(np.int32)),
                             t(pat.idx), t(qfmt), t(lut), t(b))
    np.testing.assert_array_equal(t(got).to(dtype).float().numpy(),
                                  plain.float().numpy())
    if kind == "wraps":
        s = np.einsum("mi,ic->mc", _encode(x[0, :, :bs], bf, lut.shape[0]),
                      q[0, 0, 0])
        assert np.abs(s).max() > 2 ** 31
    # the reference's kernel in interpret mode (ragged rows padded by its
    # ops.junction_matmul)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    want = jops.junction_matmul(
        jx, jnp.asarray(q.astype(np.int32)), pat.idx, pat.rev_ob, pat.rev_t,
        pat.rev_cnt, bias=jnp.asarray(b), qfmt=jnp.asarray(qfmt),
        qlut=jnp.asarray(lut), interpret=True)
    np.testing.assert_array_equal(plain.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------- plans
@pytest.mark.parametrize("tiles,k_tiles", [(1, 1), (32, 32), (2048, 128),
                                           (1, 2048), (8, 4), (32, 8),
                                           (200, 600), (3, 1)])
def test_split_plan_covers_every_k_tile_once_within_the_chunk(tiles,
                                                              k_tiles):
    run, nsplit = tfxpk.split_plan(tiles, k_tiles)
    assert all(type(v) is int for v in (run, nsplit))
    assert 1 <= run <= tfxpk.CHUNK_TILES
    ranges = [range(s * run, min(k_tiles, (s + 1) * run))
              for s in range(nsplit)]
    assert [t for r in ranges for t in r] == list(range(k_tiles))
    assert all(len(r) >= 1 for r in ranges)
    if tiles < tfxpk.TC_BLOCKS and k_tiles > 1:
        assert nsplit > 1
    assert tfxpk.split_plan(tiles, k_tiles) == (run, nsplit)
    # fxp_qmatmul's K tiles of 128: 8192 of K a block at most
    qrun, qsplit = tfxpk.split_plan(tiles, k_tiles, tfxpk.QMM_CHUNK_TILES)
    assert qrun <= tfxpk.QMM_CHUNK_TILES and qrun * qsplit >= k_tiles


def test_plans_at_the_chip_shapes():
    # qmatmul at 512 x 1024 x 512: 32 tiles, split 4 -> 128 blocks;
    # 4096^3: 2048 tiles, unsplit; 16 x 65536 x 16: K split for occupancy
    # (4 K tiles a block); 1024 x 16384 x 1024: 128 tiles, K split by the
    # chunk (64 K tiles of 128, 8192 of K, a block)
    assert tfxpk.qmatmul_plan(512, 1024, 512) == (32, 2, 4)
    assert tfxpk.qmatmul_plan(4096, 4096, 4096) == (2048, 32, 1)
    assert tfxpk.qmatmul_plan(16, 65536, 16) == (1, 4, 128)
    assert tfxpk.qmatmul_plan(1024, 16384, 1024) == (
        128, tfxpk.QMM_CHUNK_TILES, 2)
    assert tfxpk.qmatmul_plan(16, 2 ** 20, 16) == (1, 63, 131)
    # the sweep's junctions, M 512: 1024 -> 512 (kb 2), 512 -> 128 (kb 1)
    assert tbsm.fxp_plan(1, 512, 4, 2, 128) == (32, 2, 4)
    assert tbsm.fxp_plan(1, 512, 1, 1, 128) == (8, 1, 4)


# ------------------------------------------------------------- wrappers
def _no_host_read(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the fxp wrapper read a tensor on the host")
    for name in ("item", "tolist", "numpy", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("shape", [(1, 512, 4, 2, 128), (1, 512, 1, 1, 128),
                                   (2, 33, 3, 2, 32), (1, 4096, 6, 1, 64)],
                         ids=str)
def test_fwd_fxp_wrapper_passes_plan_scratch_and_tickets(monkeypatch, shape):
    E, M, nob, kb, bs = shape
    nib = kb + 1
    x = torch.zeros((E, M, nib * bs))
    wq = torch.zeros((E, nob, kb, bs, bs), dtype=torch.int32)
    idx = torch.from_numpy(np.stack([np.arange(kb)] * nob).astype(np.int32))
    qfmt = torch.tensor([8, 3], dtype=torch.int32)
    lut, b = torch.zeros(4096), torch.zeros((E, nob * bs))
    tiles, run, nsplit = tbsm.fxp_plan(E, M, nob, kb, bs)
    sizes = []
    real_empty = torch.empty

    def empty(*a, **kw):
        t = real_empty(*a, **kw)
        sizes.append(t.numel())
        return t
    with _launch_recorder(monkeypatch) as calls:
        monkeypatch.setattr(torch, "empty", empty)
        _no_host_read(monkeypatch)
        tbsm.fwd_fxp(x, wq, idx, qfmt, lut, b)
    (lib, name, n_ptr, n_int, n_args), = calls
    assert (lib, name) == ("junction_quant", "junction_fwd_fxp")
    assert (n_ptr, n_int) == _c_prototype(name) == (9, 10)
    assert n_args == n_ptr + n_int + 1
    args = calls.args[0]
    part, tickets = args[7], args[8]
    assert args[n_ptr:n_ptr + n_int] == (E, M, nib, nob, kb, bs, 4096, 0,
                                         run, nsplit)
    if nsplit > 1:
        assert isinstance(part, int) and isinstance(tickets, int)
        assert nsplit * tiles * BM * bs in sizes
    else:
        assert part is None and tickets is None
    tbsm.fwd_fxp.launches = 0


@contextlib.contextmanager
def _qmatmul_recorder(monkeypatch):
    calls = []

    def kernel():
        def fn(*args):
            calls.append(args)
            return 0
        return fn
    monkeypatch.setattr(tfxpk, "_route", lambda *_: False)
    monkeypatch.setattr(tfxpk, "_kernel", kernel)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda *_: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *_: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(tbuild, "tickets",
                        lambda dev, n: torch.zeros(max(n, 1024),
                                                   dtype=torch.int32))
    yield calls


@pytest.mark.parametrize("MKN", [(512, 1024, 512), (4096, 64, 4096),
                                 (16, 65536, 16), (1024, 16384, 1024),
                                 (75, 33, 50)], ids=str)
def test_qmatmul_wrapper_passes_plan_scratch_and_tickets(monkeypatch, MKN):
    M, K, N = MKN
    a = torch.zeros((M, K), dtype=torch.int32)
    w = torch.zeros((K, N), dtype=torch.int32)
    tiles, run, nsplit = tfxpk.qmatmul_plan(M, K, N)
    before = tfxpk.qmatmul.launches
    sizes = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes.append(t.numel())
        return t
    with _qmatmul_recorder(monkeypatch) as calls:
        monkeypatch.setattr(torch, "empty", empty)
        _no_host_read(monkeypatch)
        out = tfxpk.qmatmul(a, w, bf=8, bn=3)
    Kp = QK * max(1, -(-K // QK))
    assert sizes[1:3] == [M * Kp, N * Kp]      # words: 4 planes of bytes
    assert out.shape == (M, N) and out.dtype == torch.int32
    (args,), = [calls]
    assert _c_prototype("fxp_qmatmul") == (8, 7) and len(args) == 16
    assert args[8:15] == (M, K, N, 8, 3, run, nsplit)
    assert all(isinstance(args[i], int) for i in (3, 4, 5))  # ap, bp, votes
    assert (args[6] is None) == (args[7] is None) == (nsplit == 1)
    if nsplit > 1:             # the votes follow the split's tickets
        assert args[5] == args[7] + 4 * tiles
    assert tfxpk.qmatmul.launches == before + 1
    tfxpk.qmatmul.launches = before
