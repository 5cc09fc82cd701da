"""K1: the tokenize + hash kernel, hand-written in CUDA for Hopper.

Counterpart of :mod:`mapreduce_tpu.ops.pallas.tokenize` in its compact
lane-major mode (:func:`tokenize_split_compact`) and its pair mode
(:func:`tokenize_split`, the exact spill fallback).  The kernel itself is
``mapreduce_tpu_torch/csrc/tokenize.cu``; its note says what bounds it.

What is kept from the TPU kernel is the stream contract, not the layout:
the same multiset of ``(key_hi, key_lo, packed = start << 6 | len)`` rows,
poison rows ``(sent, sent-1, last_byte << 6)`` at the ends of runs longer
than W included, the same ``overlong`` and token totals, and a flattened
stream in global byte order.  The TPU kernel's 128-lane column view, its
sequential-grid carry and its XLA seam pass do not exist here: one CUDA
block owns each :data:`WINDOW` contiguous bytes and reads its lookback halo
directly, so the port emits ONE stream and no seam stream.

Geometry: :data:`COMPACT_SLOTS` rows per window in compact mode — the JAX
package's density of 128 slots per 384 bytes, over a window 8x longer, so
a spill needs a whole 3 KB run of text averaging under 3 bytes per token
plus separator.  Pair mode gives each window ``WINDOW // 2`` rows, which
cannot spill.  Limits from the packed row word stay: chunks of at most
2**26 bytes and ``1 <= W <= 63``.  The TPU layout's limits (``n % 128``,
``block_rows``, even rows) are gone.

Dispatch: a CPU tensor goes to :func:`tokenize_windows_plain`, the plain
PyTorch version of the same function; a CUDA tensor launches the kernel or
raises.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple

import torch

from mapreduce_tpu_torch import constants
from mapreduce_tpu_torch.ops import tokenize as tok_ops
from mapreduce_tpu_torch.ops.cuda import _build

WINDOW = 3072  # bytes per CUDA block; csrc/tokenize.cu kWindow
COMPACT_SLOTS = 1024  # compact mode rows per window
PAIR_SLOTS = WINDOW // 2  # pair mode rows per window: never spills
DEFAULT_MAX_TOKEN = 32  # W
MAX_CHUNK = 1 << 26  # positions are packed into 26 bits

_SENT = tok_ops.SENT
_ALL_ONES = 0xFFFFFFFF

#: Kernel launches on the card, by wrapper ("tokenize_compact",
#: "tokenize_pair").  CPU calls run the plain version and count nothing.
LAUNCHES: Counter = Counter()


class PackedTokenStream(NamedTuple):
    """The kernel's rows as one stream (int64 tensors holding uint32).

    ``packed`` is ``start << 6 | len`` for a token, ``last_byte << 6`` for
    a poison row and all-ones for dead filler; ``total`` is the exact token
    count.  The TokenStream view (``count``, ``pos``, ``length``) derives
    from ``packed`` on demand, so the aggregation path, which sorts
    ``packed`` directly, never materializes it.
    """

    key_hi: torch.Tensor
    key_lo: torch.Tensor
    packed: torch.Tensor
    total: torch.Tensor

    def _has_tok(self) -> torch.Tensor:
        return (self.packed != _ALL_ONES) & ((self.packed & 63) != 0)

    @property
    def count(self) -> torch.Tensor:
        return self._has_tok().to(torch.int64)

    @property
    def pos(self) -> torch.Tensor:
        return torch.where(self._has_tok(), self.packed >> 6, tok_ops.POS_INF)

    @property
    def length(self) -> torch.Tensor:
        return torch.where(self._has_tok(), self.packed & 63, 0)


def _resolve_args(data: torch.Tensor, max_token_bytes: int) -> int:
    """Check what the kernel takes; returns W."""
    if data.dtype != torch.uint8:
        raise TypeError(f"tokenize kernel expects uint8, got {data.dtype}")
    if data.dim() != 1 or not data.is_contiguous():
        raise ValueError("tokenize kernel expects a flat contiguous buffer, "
                         f"got shape {tuple(data.shape)}")
    n = data.shape[0]
    if not 1 <= n <= MAX_CHUNK:
        raise ValueError(
            f"input of {n} bytes is outside the kernel's [1, 2**26] chunk "
            "envelope (positions are packed into 26 bits of the sort "
            "payload); lower chunk_bytes or use the xla backend")
    w = max_token_bytes
    if not 1 <= w <= 63:
        raise ValueError(f"max_token_bytes must be in [1, 63] (length is "
                         f"packed into 6 bits), got {w}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    return w


def tokenize_windows_plain(data: torch.Tensor, w: int, slots: int):
    """Plain PyTorch version of the kernel: same outputs, same geometry.

    A vectorised k = 0..W lookback at every live position, then a
    per-window ``cumsum`` rank compacts the live rows into their window's
    ``slots`` rows.  Returns ``(key_hi, key_lo, packed, overlong, ntok,
    spill)``: three int64 planes of ``ceil(n / WINDOW) * slots`` rows and
    three int64 scalars.
    """
    n = data.shape[0]
    dev = data.device
    grid = -(-n // WINDOW)
    # W+1 separator bytes before the chunk and one after: the lookback and
    # the next-byte test never leave the buffer.
    buf = torch.zeros(w + 2 + n, dtype=torch.uint8, device=dev)
    buf[w + 1: w + 1 + n] = data
    sep = tok_ops.separator_mask(buf)
    live = ~sep[w + 1: w + 1 + n] & sep[w + 2: w + 2 + n]
    p = torch.nonzero(live).squeeze(1)  # ascending positions
    q = p + (w + 1)
    c = buf.to(torch.int64) + 1
    intok = torch.ones_like(p, dtype=torch.bool)
    h1 = torch.zeros_like(p)
    h2 = torch.zeros_like(p)
    ln = torch.zeros_like(p)
    b1, b2 = int(constants.HASH_BASE_1), int(constants.HASH_BASE_2)
    for k in range(w):
        if k:
            intok &= ~sep[q - k]
        ck = c[q - k]
        h1 = h1 + torch.where(intok, tok_ops.mul32(ck, pow(b1, k, 1 << 32)), 0)
        h2 = h2 + torch.where(intok, tok_ops.mul32(ck, pow(b2, k, 1 << 32)), 0)
        ln += intok
    over = intok & ~sep[q - w]
    key_hi, key_lo = tok_ops.finalize_keys(h1 & tok_ops.MASK32,
                                           h2 & tok_ops.MASK32, ln)
    key_hi = torch.where(over, _SENT, key_hi)
    key_lo = torch.where(over, _SENT - 1, key_lo)
    packed = torch.where(over, p << 6, ((p + 1 - ln) << 6) | ln)

    win = p // WINDOW
    per_win = torch.bincount(win, minlength=grid)
    first = torch.cumsum(per_win, 0) - per_win
    rank = torch.arange(p.shape[0], device=dev) - first[win]
    keep = rank < slots
    slot = (win * slots + rank)[keep]
    out = []
    for vals, fill in ((key_hi, _SENT), (key_lo, _SENT), (packed, _ALL_ONES)):
        plane = torch.full((grid * slots,), fill, dtype=torch.int64, device=dev)
        plane[slot] = vals[keep]
        out.append(plane)
    n_over = over.sum()
    spill = (per_win - slots).clamp(min=0).sum()
    return (*out, n_over, p.shape[0] - n_over, spill)


def _kernel_fn():
    """The kernel's C entry point, built and bound on first use."""
    lib = _build.load("tokenize")
    fn = lib.mr_tokenize_windows
    if fn.argtypes is None:
        if lib.mr_tokenize_window_bytes() != WINDOW:
            raise RuntimeError("csrc/tokenize.cu and ops/cuda/tokenize.py "
                               "disagree on WINDOW")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def tokenize_windows_kernel(data: torch.Tensor, w: int, slots: int):
    """Launch the CUDA kernel on ``data``'s device and current stream.

    Returns what :func:`tokenize_windows_plain` returns: the ``key_hi``,
    ``key_lo`` and ``packed`` planes and the ``overlong``, token and
    ``spill`` scalars, as int64 tensors holding uint32 values (the kernel
    stores them so).  Does not synchronise."""
    if data.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got "
                         f"{data.device}")
    fn = _kernel_fn()
    n = data.shape[0]
    rows = -(-n // WINDOW) * slots
    dev = data.device
    khi = torch.empty(rows, dtype=torch.int64, device=dev)
    klo = torch.empty(rows, dtype=torch.int64, device=dev)
    packed = torch.empty(rows, dtype=torch.int64, device=dev)
    counters = torch.zeros(3, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(data.data_ptr(), n, w, slots, khi.data_ptr(), klo.data_ptr(),
             packed.data_ptr(), counters.data_ptr(), stream)
    if err:
        raise RuntimeError(f"tokenize kernel launch failed: CUDA error {err}")
    return khi, klo, packed, counters[0], counters[1], counters[2]


def _tokenize_windows(data: torch.Tensor, w: int, slots: int, mode: str):
    if data.device.type == "cpu":
        return tokenize_windows_plain(data, w, slots)
    out = tokenize_windows_kernel(data, w, slots)
    LAUNCHES[mode] += 1
    return out


def tokenize_split_compact(data: torch.Tensor,
                           max_token_bytes: int = DEFAULT_MAX_TOKEN):
    """Compact mode: ``(stream, overlong, spill)``.

    ``stream`` holds :data:`COMPACT_SLOTS` rows per :data:`WINDOW` bytes in
    global byte order.  A nonzero ``spill`` (live rows beyond a window's
    budget) means the stream is INCOMPLETE: the caller must discard it and
    run :func:`tokenize_split` instead.
    """
    w = _resolve_args(data, max_token_bytes)
    khi, klo, packed, over, ntok, spill = _tokenize_windows(
        data, w, COMPACT_SLOTS, "tokenize_compact")
    return PackedTokenStream(khi, klo, packed, ntok), over, spill


def tokenize_split(data: torch.Tensor,
                   max_token_bytes: int = DEFAULT_MAX_TOKEN):
    """Pair mode, the exact full-resolution path: ``(stream, overlong)``.

    Every token of at most ``max_token_bytes`` bytes is emitted once; longer
    runs are tallied in ``overlong`` and leave a poison row at their end.
    """
    w = _resolve_args(data, max_token_bytes)
    khi, klo, packed, over, ntok, _ = _tokenize_windows(
        data, w, PAIR_SLOTS, "tokenize_pair")
    return PackedTokenStream(khi, klo, packed, ntok), over
