"""Fixed-point matmul of integer codes: the plain PyTorch version
``qmatmul_ref`` and the wrapper ``qmatmul`` of the CUDA kernel
``csrc/fxp_qmatmul.cu``.

a [M, K] int32 codes, w [K, N] int32 codes -> [M, N] int32 codes:

    acc = sum_k a[m, k] * w[k, n]        (int32, wrapping as an int32 dot)
    out = clip((acc + 2^(bf-1)) >> bf,   (wrapping add, arithmetic shift)
               -2^(bn+bf), 2^(bn+bf) - 1)

the paper's one bit triplet (b_w, b_n, b_f) kept end to end: products
summed exactly, one round-half-up shift by b_f, saturation to the
triplet's range.  Any M, K, N (ragged shapes need no padding), any int32
codes.

The kernel (and ``junction_fwd_fxp``, which shares its product,
``csrc/fxp_tc.cuh``) splits the codes into byte planes on the int8 tensor
cores, 64-row output tiles over K tiles of 32; ``split_plan`` splits K
over blocks, from the shapes alone.  ``fxp_qmatmul`` first writes both
operands as planes into scratch (``packed_words``) and reads back only
the planes its codes need.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.device import plain_route as _route

# the plain version's float64 sums are exact while K * 2^32 < 2^53
MAX_K = 1 << 20

# The byte-plane kernels' tiles (csrc/fxp_tc.cuh): 64 output rows, K tiles
# of 32, at most CHUNK_TILES K tiles a block (so that no int32 partial sum
# of plane products can overflow: K <= 8192 a block), and a K split that
# fills the card's 132 streaming multiprocessors (one block each) when an
# output has few tiles.  A split is exact: the blocks' uint32 sums add
# mod 2^32 in any order.
TILE_M, TILE_N, TILE_K = 64, 128, 32
CHUNK_TILES = 256
TC_BLOCKS = 132
# fxp_qmatmul reads its packed planes in K tiles of 128 (QMM_TILE_K), at
# most QMM_CHUNK_TILES of them a block (the same 8192 of K)
QMM_TILE_K = 128
QMM_CHUNK_TILES = CHUNK_TILES * TILE_K // QMM_TILE_K


def split_plan(tiles: int, k_tiles: int, chunk: int = CHUNK_TILES
               ) -> tuple[int, int]:
    """(run, nsplit) for ``tiles`` output tiles of ``k_tiles`` K tiles
    each, at most ``chunk`` K tiles a block: block s of a tile takes K
    tiles s * run .. min(k_tiles, (s + 1) * run) - 1.  From the shapes
    alone; K = 0 is one K tile (of zeros)."""
    k_tiles = max(1, k_tiles)
    nsplit = max(1, min(k_tiles, TC_BLOCKS // max(1, tiles)))
    run = min(chunk, -(-k_tiles // nsplit))
    return run, -(-k_tiles // run)


def qmatmul_plan(M: int, K: int, N: int) -> tuple[int, int, int]:
    """(output tiles, run, nsplit) of one ``fxp_qmatmul`` launch, in K
    tiles of QMM_TILE_K."""
    tiles = -(-M // TILE_M) * -(-N // TILE_N)
    return (tiles, *split_plan(tiles, -(-K // QMM_TILE_K), QMM_CHUNK_TILES))


def packed_words(rows: int, K: int) -> int:
    """int32 words of one operand's four byte planes in ``fxp_qmatmul``'s
    scratch: [4][rows][Kp] bytes, Kp = K rounded up to QMM_TILE_K (at
    least one tile)."""
    return rows * QMM_TILE_K * max(1, -(-K // QMM_TILE_K))


def _check(a_code, w_code, bf: int, bn: int):
    if a_code.dim() != 2 or w_code.dim() != 2:
        raise ValueError("expected a [M, K] and w [K, N]")
    if a_code.shape[1] != w_code.shape[0]:
        raise ValueError(f"shape mismatch: a {tuple(a_code.shape)}, w "
                         f"{tuple(w_code.shape)}")
    if a_code.dtype != torch.int32 or w_code.dtype != torch.int32:
        raise ValueError(f"codes must be int32, not {a_code.dtype} / "
                         f"{w_code.dtype}")
    if not (bf >= 1 and bn >= 0 and bn + bf <= 31):
        raise ValueError(f"need 1 <= bf and 0 <= bn with bn + bf <= 31, "
                         f"got bf={bf} bn={bn}")
    if a_code.shape[1] > MAX_K:
        raise ValueError(f"K = {a_code.shape[1]} > {MAX_K}")


def wrap_i32(v):
    """int64 values wrapped into int32's range, as an int32 sum wraps."""
    return torch.remainder(v + 2 ** 31, 2 ** 32) - 2 ** 31


def wrapped_dot(eq: str, a, w):
    """``torch.einsum(eq, a, w)`` of int32-range integer codes (int64
    tensors) as an int32 dot gives it: the sum taken mod 2^32, as int64
    values in int32's range.  Exact from 16-bit halves (a = ah * 2^16 +
    al, al in [0, 2^16)): al.wl and ah.wl + al.wh summed in float64 (the
    ah.wh term is a multiple of 2^32), exact while the summed dimension
    is at most MAX_K."""
    al, ah = (a & 0xFFFF).double(), (a >> 16).double()
    wl, wh = (w & 0xFFFF).double(), (w >> 16).double()
    lo_sum = torch.einsum(eq, al, wl).long()
    mid_sum = (torch.einsum(eq, ah, wl) + torch.einsum(eq, al, wh)).long()
    return wrap_i32(lo_sum + (torch.remainder(mid_sum, 1 << 16) << 16))


def qmatmul_ref(a_code, w_code, *, bf: int, bn: int):
    """Plain version, bit for bit the reference: the int32 dot taken
    modulo 2^32 (``wrapped_dot``), then the wrapped round-half-up shift
    and the clip."""
    _check(a_code, w_code, bf, bn)
    acc = wrapped_dot("mk,kn->mn", a_code.long(), w_code.long())
    rounded = wrap_i32(acc + (1 << (bf - 1))) >> bf
    lim = 1 << (bn + bf)
    return torch.clamp(rounded, -lim, lim - 1).to(torch.int32)


def _kernel():
    from repro_torch.kernels import build
    fn = build.load("fxp_qmatmul").fxp_qmatmul
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def qmatmul(a_code, w_code, *, bf: int, bn: int):
    """A CPU or meta tensor runs ``qmatmul_ref``.  A CUDA tensor launches the
    ``fxp_qmatmul`` kernel on the current stream at ``qmatmul_plan``
    (``qmatmul.launches`` counts those launches) or raises; any other
    device raises.  Reads no tensor on the host."""
    if _route(a_code, "qmatmul"):
        return qmatmul_ref(a_code, w_code, bf=bf, bn=bn)
    _check(a_code, w_code, bf, bn)
    if w_code.device != a_code.device:
        raise ValueError(f"w_code is on {w_code.device}, a_code on "
                         f"{a_code.device}")
    if not (a_code.is_contiguous() and w_code.is_contiguous()):
        raise ValueError("qmatmul takes contiguous codes")
    M, K = a_code.shape
    N = w_code.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=a_code.device)
    if M == 0 or N == 0:
        return out
    tiles, run, nsplit = qmatmul_plan(M, K, N)
    with torch.cuda.device(a_code.device):
        from repro_torch.kernels import build
        packed = [torch.empty(packed_words(n, K), dtype=torch.int32,
                              device=a_code.device) for n in (M, N)]
        # the split's tickets, then the three ints of the planes' votes
        state = build.tickets(a_code.device, tiles + 3)
        part = None
        if nsplit > 1:
            part = torch.empty(nsplit * tiles * TILE_M * TILE_N,
                               dtype=torch.int32, device=a_code.device)
        err = _kernel()(a_code.data_ptr(), w_code.data_ptr(), out.data_ptr(),
                        packed[0].data_ptr(), packed[1].data_ptr(),
                        state.data_ptr() + 4 * tiles,
                        None if part is None else part.data_ptr(),
                        None if part is None else state.data_ptr(),
                        M, K, N, bf, bn, run, nsplit,
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fxp_qmatmul launch failed: cudaError {err}")
    qmatmul.launches += 1
    return out


qmatmul.launches = 0
