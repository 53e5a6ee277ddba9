"""The redesigned selective scan on the CPU: ``csrc/selective_scan.cu``
runs only on the card (``chip_smoke.py`` holds it against its plain
version there), so these tests check its plan and emulate its arithmetic
in torch, and hold the emulation against ``selective_scan_ref`` and the
reference's kernel (interpret mode).

- The plan (``scan_plan``): at every shape ``chip_smoke.py`` runs, and
  over N 1 / 5 / 8 / 16 / 32, S 1 / 37 / 4096, di 96 to 8192, B 1 to 4:
  each state is held by exactly one lane, the grid and shared memory fit
  the card, the chunks cover the sequence, and the sequence is split only
  where the unsplit grid has fewer blocks than the card has SMs.
- The arithmetic: a channel's states on nt lanes (zeros past N), y summed
  over a lane's states in state order and then over the lanes by the
  shuffle butterfly (offsets nt / 2, ..., 1), and the chunk split: each
  chunk but the last from a zero state with the product of its exps, the
  carry in chunk order, each chunk rerun from its true start.  Held
  within 1e-5 of max |y| and of max |h| (the bound of
  ``test_torch_standalone_kernels.py``) against the plain version and the
  reference's kernel; with bf16 inputs y is rounded once, at the end.
- The wrapper passes the plan and a scratch of the size the plan gives to
  the C entry point of ``csrc/selective_scan.cu`` (a recorder in place of
  the library), and a CUDA tensor never reaches the plain version.
"""
import contextlib
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import selective_scan as jss

from repro_torch.configs import registry
from repro_torch.kernels import selective_scan as tss
from torch_tc_helpers import _c_prototype, chip_smoke

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5
BF16_ULP = 2.0 ** -7
SMEM_BLOCK = 227 * 1024         # shared memory a block may use
SMEM_SM = 228 * 1024            # an SM's, 1 KB of it reserved a block


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, di, N, seed):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))) * 0.1
    x = rng.standard_normal((B, S, di))
    bc = rng.standard_normal((B, S, N))
    cc = rng.standard_normal((B, S, N))
    a = -np.exp(rng.standard_normal((di, N)) * 0.3)
    h0 = rng.standard_normal((B, di, N)) * 0.1
    return [v.astype(np.float32) for v in (dt, x, bc, cc, a, h0)]


def _rel_err(got, want):
    got, want = (np.asarray(v, np.float32) for v in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _smem(nt, ns, N, elt, with_c):
    """Dynamic shared memory of one ``scan_kernel`` block, as the kernel's
    ``Layout`` sizes it: SCAN_STAGES ring stages of dt, x [SCAN_STEPS,
    ch] and the raw B (C) run from its 16-byte-aligned start, then two
    buffers of B (C) widened to fp32 [SCAN_STEPS, nt * ns]."""
    ch = tss.SCAN_THREADS // nt
    run = -(-(tss.SCAN_STEPS * N + 16 // elt) * elt // 16) * 16
    stage = 2 * tss.SCAN_STEPS * ch * elt + (2 if with_c else 1) * run
    return tss.SCAN_STAGES * stage \
        + 2 * (2 if with_c else 1) * tss.SCAN_STEPS * nt * ns * 4


def _plan(S, N, nt, L):
    """The plan with nt lanes a channel and (at most) L chunks."""
    return (nt, tss.scan_ns(N, nt), tss.SCAN_THREADS // nt,
            *tss.scan_chunks(S, L))


# ------------------------------------------------------------------ plan
def _check_plan(B, S, di, N):
    nt, ns, ch, L, chunk = plan = tss.scan_plan(B, S, di, N)
    # each state on exactly one lane; the fewest lanes a channel whose
    # states fit SCAN_MAX_NS, ns the next power of two of N / nt
    assert nt in (1, 2, 4) and ns <= tss.SCAN_MAX_NS and ns & (ns - 1) == 0
    assert nt == 1 or tss.scan_ns(N, nt // 2) > tss.SCAN_MAX_NS
    assert ns == 1 or (ns // 2) * nt < N
    owned = [j * ns + s for j in range(nt) for s in range(ns)
             if j * ns + s < N]
    assert sorted(owned) == list(range(N))
    # grid and shared memory
    assert ch * nt == tss.SCAN_THREADS and ch % 16 == 0
    blocks = B * -(-di // ch)
    assert blocks * L < 2 ** 31 and B <= 65535 and L <= 65535
    for elt in (2, 4):
        for with_c in (False, True):
            smem = _smem(nt, ns, N, elt, with_c)
            assert smem % 16 == 0 and smem <= SMEM_BLOCK
            assert tss.SCAN_BLOCKS_PER_SM * (smem + 1024) <= SMEM_SM
    # the chunks cover S, each a whole number of ring stages
    assert chunk % tss.SCAN_STEPS == 0 and chunk >= tss.SCAN_STEPS
    if S == 0:
        assert L == 1
    else:
        assert (L - 1) * chunk < S <= L * chunk
    # split only where the unsplit grid leaves SMs without a block, into at
    # most one wave of resident blocks, no chunk below SCAN_MIN_CHUNK
    if L > 1:
        assert blocks < tss.SCAN_SMS
        assert blocks * L <= tss.SCAN_SMS * tss.SCAN_BLOCKS_PER_SM
        assert chunk >= tss.SCAN_MIN_CHUNK
    else:
        assert (blocks >= tss.SCAN_SMS or S < 2 * tss.SCAN_MIN_CHUNK
                or tss.SCAN_SMS * tss.SCAN_BLOCKS_PER_SM < 2 * blocks)
    return plan


@pytest.mark.parametrize("S", [1, 37, 4096])
@pytest.mark.parametrize("N", [1, 5, 8, 16, 32])
def test_plan_owns_each_state_once_within_the_card(N, S):
    for di in (96, 100, 1000, 4096, 8192):
        for B in (1, 2, 3, 4):
            _check_plan(B, S, di, N)


def test_plans_at_the_chip_shapes():
    seen = set()
    for B, S, di, N, _, dtypes in chip_smoke.scan_cases(registry):
        _check_plan(B, S, di, N)
        for dtype in dtypes:
            elt = torch.tensor([], dtype=dtype).element_size()
            seen |= chip_smoke.scan_plan_kinds(tss, B, S, di, N, elt)
    assert seen >= chip_smoke.SCAN_KINDS
    # falcon-mamba-7b (d_inner 8192, N 16): one lane a channel, 64 blocks
    # a batch row: batch 1 in 6 chunks (384 blocks, one wave at 3 an SM),
    # batch 4 unsplit (256 blocks)
    assert tss.scan_plan(1, 4096, 8192, 16) == (1, 16, 128, 6, 688)
    assert tss.scan_plan(4, 1024, 8192, 16) == (1, 16, 128, 1, 1024)
    assert tss.scan_plan(1, 4001, 8192, 16) == (1, 16, 128, 6, 672)
    assert tss.scan_plan(2, 1000, 96, 25) == (2, 16, 64, 3, 336)
    assert tss.scan_plan(1, 129, 512, 32) == (2, 16, 64, 1, 144)


def test_plan_constants_are_the_kernels():
    src = (ROOT / "src" / "repro_torch" / "csrc"
           / "selective_scan.cu").read_text()
    got = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert got == {"kThreads": tss.SCAN_THREADS, "kSteps": tss.SCAN_STEPS,
                   "kStages": tss.SCAN_STAGES, "kMaxNS": tss.SCAN_MAX_NS}


def test_scan_chunks_cover_the_sequence():
    for S in (0, 1, 15, 16, 17, 300, 4001, 4096):
        for L in (0, 1, 2, 3, 6, 12, 100):
            n, chunk = tss.scan_chunks(S, L)
            assert chunk % tss.SCAN_STEPS == 0 and 1 <= n <= max(1, L)
            assert n == 1 if S == 0 else (n - 1) * chunk < S <= n * chunk


# ------------------------------------------------------------ arithmetic
def _lane_sum(p):
    """y over a channel's lanes [..., nt] as the shuffle butterfly adds
    them: p_j += p_(j ^ o) for o = nt / 2, ..., 1; lane 0's value."""
    nt = p.shape[-1]
    o = nt // 2
    while o:
        p = p + p[..., torch.arange(nt) ^ o]
        o //= 2
    return p[..., 0]


def _run(dt, x, Bp, Cp, A, h, t0, t1, y=None):
    """Steps [t0, t1) from state h [B, di, nt, ns]: y (when given) gets
    each step's output; returns the end state and the product of the
    exps."""
    prod = torch.ones_like(h)
    for t in range(t0, t1):
        d = dt[:, t, :, None, None]
        e = torch.exp(d * A)
        h = e * h + (d * x[:, t, :, None, None]) * Bp[:, t, None]
        if y is None:
            prod = prod * e
            continue
        p = torch.zeros(h.shape[:-1])
        for s in range(h.shape[-1]):          # a lane's states in order
            p = p + h[..., s] * Cp[:, t, None, :, s]
        y[:, t] = _lane_sum(p)
    return h, prod


def emulate(dt, x, bc, cc, a, h0, plan):
    """The kernel's arithmetic at ``plan`` = (nt, ns, ch, L, chunk), in
    fp32 torch: states on nt lanes of ns (zeros past N); unsplit, or each
    chunk but the last from zeros (end state, exp product), the carry in
    chunk order, every chunk again from its start; y rounded once."""
    nt, ns, _, L, chunk = plan
    B, S, di = dt.shape
    N = bc.shape[-1]

    def lanes(t):
        out = torch.zeros(*t.shape[:-1], nt * ns)
        out[..., :N] = t.float()
        return out.view(*t.shape[:-1], nt, ns)
    dtf, xf = dt.float(), x.float()
    Bp, Cp, A, H0 = lanes(bc), lanes(cc), lanes(a), lanes(h0)
    y = torch.zeros(B, S, di)
    starts = [H0]
    if L > 1:
        local = [_run(dtf, xf, Bp, Cp, A, torch.zeros_like(H0), k * chunk,
                      (k + 1) * chunk) for k in range(L - 1)]
        for hl, pd in local:                  # the carry, in chunk order
            starts.append(pd * starts[-1] + hl)
    for k in range(L):
        h, _ = _run(dtf, xf, Bp, Cp, A, starts[k], k * chunk,
                    min(S, (k + 1) * chunk), y)
    h_last = starts[0] if S == 0 else h
    return y.to(dt.dtype), h_last.reshape(B, di, nt * ns)[..., :N]


def _t(a):
    return torch.from_numpy(np.array(a))


PLANS = [(1, 1), (2, 1), (4, 1), (1, 3), (2, 4), (4, 2)]


@pytest.mark.parametrize("nt,L", PLANS, ids=str)
def test_emulation_vs_reference_kernel(nt, L):
    B, S, di, N = 2, 128, 256, 16
    ins = _inputs(B, S, di, N, 40 + nt + L)
    plan = _plan(S, N, nt, L)
    assert plan[3] == L
    y, h = emulate(*map(_t, ins), plan)
    y1, h1 = jss.selective_scan(*map(jnp.asarray, ins), chunk=32, bd=128,
                                interpret=True)
    ry, rh = tss.selective_scan_ref(*map(_t, ins))
    for got, want in ((y, y1), (h, h1), (y, ry), (h, rh)):
        assert _rel_err(got, want) <= REL


@pytest.mark.parametrize("nt,L", [(1, 1), (2, 3), (4, 2), (2, 1), (4, 5)],
                         ids=str)
@pytest.mark.parametrize("B,S,di,N", [(1, 37, 100, 5), (3, 80, 96, 25),
                                      (2, 45, 40, 1)], ids=str)
def test_emulation_any_shape_vs_plain_and_oracle(B, S, di, N, nt, L):
    """N not a multiple of nt (lanes past N hold zeros), ragged chunks."""
    if tss.scan_ns(N, nt) > tss.SCAN_MAX_NS:
        nt = 2
    ins = _inputs(B, S, di, N, B * S + N)
    plan = _plan(S, N, nt, L)
    y, h = emulate(*map(_t, ins), plan)
    ry, rh = tss.selective_scan_ref(*map(_t, ins))
    y2, h2 = jref.selective_scan(*map(jnp.asarray, ins))
    for got, want in ((y, ry), (h, rh), (y, y2), (h, h2)):
        assert _rel_err(got, want) <= REL


@pytest.mark.parametrize("nt,L", [(1, 1), (1, 4), (2, 2)], ids=str)
def test_emulation_bf16_rounds_y_once(nt, L):
    """bf16 dt, x, B, C (fp32 A and h0): fp32 throughout, y rounded to
    bf16 once; against the reference's kernel in bf16."""
    B, S, di, N = 2, 64, 256, 16
    ins = _inputs(B, S, di, N, 11)
    bf = [jnp.asarray(v).astype(jnp.bfloat16) for v in ins[:4]] \
        + [jnp.asarray(v) for v in ins[4:]]
    y1, h1 = jss.selective_scan(*bf, chunk=32, bd=128, interpret=True)
    tin = [_t(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
           for v in bf[:4]] + [_t(v) for v in ins[4:]]
    y, h = emulate(*tin, _plan(S, N, nt, L))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    ry, _ = tss.selective_scan_ref(*tin)
    yf = emulate(*[t.float() for t in tin[:4]], *tin[4:],
                 _plan(S, N, nt, L))[0]
    assert torch.equal(y, yf.to(torch.bfloat16))        # one rounding
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y1.astype(jnp.float32)),
                               rtol=BF16_ULP, atol=1e-5)
    np.testing.assert_allclose(y.float().numpy(), ry.float().numpy(),
                               rtol=BF16_ULP, atol=1e-5)
    assert _rel_err(h, h1) <= REL


def test_lane_butterfly_order():
    """Four lanes: lane 0 ends with (p0 + p2) + (p1 + p3); two: p0 + p1."""
    p = torch.tensor([[1.0, 2.0 ** -24, 1.0, 3 * 2.0 ** -24]])
    assert _lane_sum(p).item() == (p[0, 0] + p[0, 2]) + (p[0, 1] + p[0, 3])
    assert _lane_sum(p[:, :2]).item() == p[0, 0] + p[0, 1]


def test_chunk_split_composes_to_the_unsplit_scan():
    """The local end states and exp products of the chunks, carried in
    order, give each chunk's start state of the unsplit scan; the
    product of a chunk's exps is exp(A * sum dt) to rounding."""
    B, S, di, N = 2, 96, 64, 8
    dt, x, bc, cc, a, h0 = map(_t, _inputs(B, S, di, N, 5))
    nt, ns, _, L, chunk = _plan(S, N, 1, 3)

    def lanes(t):
        return t.float().reshape(*t.shape[:-1], nt, ns)
    Bp, Cp, A, H0 = lanes(bc), lanes(cc), lanes(a), lanes(h0)
    h = H0
    for k in range(L):
        hl, pd = _run(dt, x, Bp, Cp, A, torch.zeros_like(H0), k * chunk,
                      (k + 1) * chunk)
        h_true, _ = _run(dt, x, Bp, Cp, A, h, k * chunk, (k + 1) * chunk)
        h = pd * h + hl
        assert _rel_err(h, h_true) <= REL
        sdt = dt[:, k * chunk:(k + 1) * chunk].sum(1)[..., None, None]
        np.testing.assert_allclose(pd.numpy(),
                                   torch.exp(sdt * A).numpy(), rtol=1e-5)


def test_emulation_at_zero_and_one_step():
    for S in (0, 1):
        ins = [_t(v) for v in _inputs(2, S, 40, 5, 3)]
        y, h = emulate(*ins, _plan(S, 5, 2, 1))
        ry, rh = tss.selective_scan_ref(*ins)
        assert y.shape == ry.shape and _rel_err(h, rh) <= REL
        if S:
            assert _rel_err(y, ry) <= REL


# --------------------------------------------------------------- wrapper
@contextlib.contextmanager
def _recorder(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors: each launch's arguments
    are recorded and it returns success; the plain version refuses."""
    calls = []

    def kernel():
        def fn(*args):
            calls.append(args)
            return 0
        return fn

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA call reached selective_scan_ref")
    monkeypatch.setattr(tss, "_route", lambda *_: False)
    monkeypatch.setattr(tss, "_kernel", kernel)
    monkeypatch.setattr(tss, "selective_scan_ref", refuse)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda *_: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *_: type("S", (), {"cuda_stream": 0})())
    yield calls


@pytest.mark.parametrize("shape", [(1, 4096, 1024, 16), (4, 64, 8192, 16),
                                   (2, 1000, 96, 25), (3, 70, 200, 20),
                                   (1, 0, 64, 4)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_passes_plan_and_scratch(monkeypatch, shape, dtype):
    B, S, di, N = shape
    ins = [torch.empty(s, dtype=dtype) for s in
           ((B, S, di), (B, S, di), (B, S, N), (B, S, N))] \
        + [torch.empty((di, N)), torch.empty((B, di, N))]
    nt, _, _, L, chunk = tss.scan_plan(B, S, di, N)
    sizes = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes.append(t.numel())
        return t
    before = tss.selective_scan.launches
    with _recorder(monkeypatch) as calls:
        monkeypatch.setattr(torch, "empty", empty)
        y, h = tss.selective_scan(*ins)
    assert y.shape == (B, S, di) and y.dtype == dtype
    assert h.shape == (B, di, N) and h.dtype == torch.float32
    (args,) = calls
    assert _c_prototype("selective_scan") == (9, 8) and len(args) == 18
    assert args[9:17] == (B, S, di, N, nt, L, chunk,
                          0 if dtype == torch.float32 else 1)
    # y, h_last, then the scratch of a split: 2 (L - 1) B di N fp32
    if L > 1:
        assert sizes[2:] == [tss.scratch_floats(B, di, N, L)]
        assert sizes[2] == 2 * (L - 1) * B * di * N
        assert isinstance(args[8], int)
    else:
        assert sizes[2:] == [] and args[8] is None
    assert tss.selective_scan.launches == before + 1


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    B, S, di, N = 1, 8, 32, 4
    ins = [torch.zeros(s) for s in ((B, S, di), (B, S, di), (B, S, N),
                                    (B, S, N), (di, N), (B, di, N))]
    y, h = tss.selective_scan(*[t.to("meta") for t in ins])  # plain
    assert y.device.type == h.device.type == "meta"
    assert y.shape == (B, S, di) and h.shape == (B, di, N)
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        tss.selective_scan(types.SimpleNamespace(
            device=torch.device("xpu")), *ins[1:])
    with _recorder(monkeypatch) as calls:
        mixed = list(ins)
        mixed[1] = mixed[1].to(torch.bfloat16)
        with pytest.raises(ValueError, match="one dtype"):
            tss.selective_scan(*mixed)
        strided = list(ins)
        strided[0] = torch.zeros(B, di, S).transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            tss.selective_scan(*strided)
    assert calls == []
