"""Tokenize + hash a flat byte buffer: the port's ``backend='xla'`` path.

Counterpart of :mod:`mapreduce_tpu.ops.tokenize`.  Every position that ends a
whitespace-delimited token gets two 32-bit polynomial hashes of the token
(odd bases ``HASH_BASE_1``/``HASH_BASE_2``), a length-mixed murmur3 ``fmix32``
finalization and a clamp off the two reserved sentinel keys — bit-identical
to the JAX package, so tables from either package compare field by field.

Formulation.  The JAX package runs a segmented affine ``associative_scan``.
Eager PyTorch has no such scan, but the bases are odd and therefore
invertible mod 2**32, so the segment hash is a difference of prefix sums::

    h(p) = sum_{j=start..p} c_j * B**(p-j)
         = B**p * (S_p - S_{start-1}),   S_i = sum_{j<=i} c_j * B**(-j)

with ``c_j = byte + 1`` (0 at separators).  Token length is unbounded.

uint32 in torch: every uint32 plane is an int64 tensor holding a value in
``[0, 2**32)``.  Products go through :func:`mul32`, which splits one factor
into 16-bit halves so no partial product leaves int64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mapreduce_tpu_torch import constants

MASK32 = 0xFFFFFFFF
SENT = int(constants.SENTINEL_KEY)
POS_INF = int(constants.POS_INF)
_MIX = 0x9E3779B9


class TokenStream(NamedTuple):
    """Per-position token emissions (int64 tensors holding uint32 values).

    Positions that do not end a token carry the sentinel key, count 0,
    ``POS_INF`` and length 0.
    """

    key_hi: torch.Tensor
    key_lo: torch.Tensor
    count: torch.Tensor  # 1 at token ends, else 0
    pos: torch.Tensor  # byte offset of the token's first byte
    length: torch.Tensor  # token length in bytes


def mul32(a, b):
    """``a * b mod 2**32`` for int64 tensors (or ints) holding uint32 values.

    ``b`` is split into 16-bit halves: each partial product stays below
    2**48, so nothing relies on int64 overflow wrapping.
    """
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & MASK32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: bijective avalanche on a uint32 lane."""
    x = x ^ (x >> 16)
    x = mul32(x, int(constants.FMIX_C1))
    x = x ^ (x >> 13)
    x = mul32(x, int(constants.FMIX_C2))
    return x ^ (x >> 16)


def finalize_keys(h1: torch.Tensor, h2: torch.Tensor, length: torch.Tensor):
    """Token hashes + length -> the clamped 64-bit key as (key_hi, key_lo).

    Shared by every tokenizer of the port (this module, the kernel's plain
    version and the overlong rescue), the rule of the JAX package: real keys
    never equal the reserved (sent, sent) dead filler or (sent, sent-1)
    poison marker; both remap to (sent, sent-2).
    """
    key_hi = _fmix32(h1 ^ length)
    key_lo = _fmix32((h2 + mul32(length, _MIX)) & MASK32)
    at_sent = (key_hi == SENT) & (key_lo >= SENT - 1)
    return key_hi, torch.where(at_sent, SENT - 2, key_lo)


def separator_mask(data: torch.Tensor) -> torch.Tensor:
    """True where the byte is a separator (whitespace / NUL pad)."""
    sep = torch.zeros(data.shape, dtype=torch.bool, device=data.device)
    for b in constants.SEPARATOR_BYTES:
        sep |= data == b
    return sep


def _pow32(base: int, exps: torch.Tensor, bits: int) -> torch.Tensor:
    """``base ** exps mod 2**32`` elementwise (exps in ``[0, 2**bits)``)."""
    out = torch.ones_like(exps)
    sq = base
    for b in range(bits):
        out = torch.where(((exps >> b) & 1) == 1, mul32(out, sq), out)
        sq = sq * sq & MASK32
    return out


def segment_hashes(data: torch.Tensor):
    """Per-position segment hashes along the last axis of a uint8 tensor.

    Returns ``(h1, h2, length, sep)``: at a non-separator position p, the two
    polynomial hashes and the length of the run of non-separators ending at
    p (the run may start at index 0: nothing before the buffer is read).
    """
    sep = separator_mask(data)
    n = data.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=data.device)
    c = torch.where(sep, 0, data.to(torch.int64) + 1)
    last_sep = torch.cummax(torch.where(sep, idx, -1), dim=-1).values
    length = idx - last_sep
    bits = max(1, (n - 1).bit_length())
    hashes = []
    for base in (int(constants.HASH_BASE_1), int(constants.HASH_BASE_2)):
        fwd = _pow32(base, idx, bits)
        bwd = _pow32(pow(base, -1, 1 << 32), idx, bits)
        # Terms are < 2**32 and there are < 2**31 of them: no int64 overflow.
        s = torch.cumsum(mul32(c, bwd), dim=-1) & MASK32
        s_prev = torch.where(last_sep >= 0,
                             s.gather(-1, last_sep.clamp(min=0)), 0)
        hashes.append(mul32(fwd, (s - s_prev) & MASK32))
    return hashes[0], hashes[1], length, sep


def tokenize(data: torch.Tensor, base_offset: int = 0) -> TokenStream:
    """Hash every whitespace-delimited token in a flat uint8 buffer.

    The buffer is treated as if followed by a separator, so a token touching
    the end is complete.  Returns a :class:`TokenStream` of length N.
    """
    if data.dtype != torch.uint8:
        raise TypeError(f"tokenize expects uint8 bytes, got {data.dtype}")
    if data.dim() != 1:
        raise ValueError(f"tokenize expects a flat buffer, got shape "
                         f"{tuple(data.shape)}")
    h1, h2, length, sep = segment_hashes(data)
    next_sep = torch.cat([sep[1:], sep.new_ones(1)])
    is_end = ~sep & next_sep
    key_hi, key_lo = finalize_keys(h1, h2, length)
    idx = torch.arange(data.shape[0], dtype=torch.int64, device=data.device)
    start = (idx + 1 - length + base_offset) & MASK32
    return TokenStream(
        key_hi=torch.where(is_end, key_hi, SENT),
        key_lo=torch.where(is_end, key_lo, SENT),
        count=is_end.to(torch.int64),
        pos=torch.where(is_end, start, POS_INF),
        length=torch.where(is_end, length, 0),
    )


def mix_gram(prev_hi, prev_lo, key_hi, key_lo):
    """One order-sensitive gram extension: ``fmix32(prev * B ^ key)`` per
    lane, then the sentinel clamp.  The composition every n-gram path of
    both packages shares (the XLA scan, the position-sorted pairing, the
    seam windows), so their tables merge interchangeably."""
    g_hi = _fmix32(mul32(prev_hi, int(constants.HASH_BASE_1)) ^ key_hi)
    g_lo = _fmix32(mul32(prev_lo, int(constants.HASH_BASE_2)) ^ key_lo)
    at_sent = (g_hi == SENT) & (g_lo >= SENT - 1)
    return g_hi, torch.where(at_sent, SENT - 2, g_lo)


def _extend_grams(gram: TokenStream, tokens: TokenStream) -> TokenStream:
    """One pairing step: the (k)-gram stream from the (k-1)-gram stream and
    the token stream.  At every token end, the (k-1)-gram ending at the
    previous token is the last gram end strictly before this position (the
    current token's bytes hold no gram end): a running maximum of the
    valid indices, shifted by one, takes the JAX package's carry-forward
    scan's place.  The span runs from the gram's first byte to the
    token's last, separators included."""
    n = gram.count.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=gram.count.device)
    last = torch.cummax(torch.where(gram.count > 0, idx, -1), dim=0).values
    prev = torch.cat([last.new_full((1,), -1), last[:-1]])
    c_valid = prev >= 0
    at = prev.clamp(min=0)
    c_hi = torch.where(c_valid, gram.key_hi[at], 0)
    c_lo = torch.where(c_valid, gram.key_lo[at], 0)
    c_pos = torch.where(c_valid, gram.pos[at], POS_INF)
    is_end = (tokens.count > 0) & c_valid
    key_hi, key_lo = mix_gram(c_hi, c_lo, tokens.key_hi, tokens.key_lo)
    length = (tokens.pos + tokens.length - c_pos) & MASK32
    return TokenStream(
        key_hi=torch.where(is_end, key_hi, SENT),
        key_lo=torch.where(is_end, key_lo, SENT),
        count=is_end.to(torch.int64),
        pos=torch.where(is_end, c_pos, POS_INF),
        length=torch.where(is_end, length, 0))


def ngrams(stream: TokenStream, n: int) -> TokenStream:
    """The n-token-gram stream of a per-byte token stream (n >= 1).

    Each emission is keyed by an order-sensitive 64-bit hash of its n
    consecutive tokens and carries the byte span from the first token's
    first byte to the last token's last byte, so the host recovers the
    gram's source text as it recovers a word.  Only in-buffer grams form
    here (the first n-1 tokens start none); a streamed run forms the
    cross-chunk ones from its seam carry
    (:class:`...models.wordcount.NGramCountJob`).
    """
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    gram = stream
    for _ in range(n - 1):
        gram = _extend_grams(gram, stream)
    return gram


def token_count(data: torch.Tensor) -> torch.Tensor:
    """Total number of tokens in a flat uint8 buffer (int64 scalar)."""
    sep = separator_mask(data)
    next_sep = torch.cat([sep[1:], sep.new_ones(1)])
    return (~sep & next_sep).sum()


def pad_to(data: np.ndarray | bytes, size: int) -> np.ndarray:
    """Host-side: right-pad raw bytes with PAD_BYTE to a static size."""
    buf = np.frombuffer(data, dtype=np.uint8) \
        if isinstance(data, (bytes, bytearray)) else data
    if buf.shape[0] > size:
        raise ValueError(f"buffer of {buf.shape[0]} bytes exceeds static "
                         f"size {size}")
    out = np.full((size,), constants.PAD_BYTE, dtype=np.uint8)
    out[: buf.shape[0]] = buf
    return out
