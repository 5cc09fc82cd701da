"""HyperLogLog and Count-Min sketches of a word count.

Counterpart of :mod:`mapreduce_tpu.ops.sketch`.  The count table is exact
up to its capacity and accounts what it drops, but past capacity its
distinct count is an estimate and a spilled word's frequency is lost.  The
sketches keep both: a 2**p-register HyperLogLog tracks the number of
distinct keys (~1.04/sqrt(2**p) relative error), and a depth x width
Count-Min sketch upper-bounds any key's count.

Both update from the deduplicated per-chunk batch table the map already
builds, never from the token stream, and merge with an associative,
commutative monoid (elementwise max, elementwise add).  The keys are the
tokenizer's 64-bit hashes, already avalanche-finalized.  In the JAX
package the updates are XLA scatters; here they are one
``scatter_reduce(amax)`` on the registers and one flattened
``index_add`` over depth x rows on the sketch.  The JAX sketch cells are
uint32 and wrap; the port's int64 cells are masked to 32 bits after every
add, so they wrap the same way.

The host mirrors (:func:`hash_word`, :func:`cms_query`) key any word or
n-gram span the way the device does, so any word can be queried after the
run without a device trip.
"""

from __future__ import annotations

import numpy as np
import torch

from mapreduce_tpu_torch import constants
from mapreduce_tpu_torch.ops.tokenize import MASK32, _fmix32, mul32

DEFAULT_PRECISION = 14  # 2**14 registers; ~0.8% error


def empty(precision: int = DEFAULT_PRECISION, device=None) -> torch.Tensor:
    """Zeroed registers, ``2**precision`` int64 cells."""
    if not 4 <= precision <= 18:
        raise ValueError(f"precision must be in [4, 18], got {precision}")
    return torch.zeros((1 << precision,), dtype=torch.int64, device=device)


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Per-lane bit length of a uint32 (0 for 0)."""
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        n = torch.where(big, n + shift, n)
        x = torch.where(big, x >> shift, x)
    return n + (x > 0).to(x.dtype)


def update_from_keys(registers: torch.Tensor, key_hi, key_lo,
                     valid) -> torch.Tensor:
    """Fold a batch of 64-bit keys into the registers (a new tensor).

    ``valid`` masks real rows.  Bucket = the low p bits of ``key_hi``; rho
    = the leading-zero count of ``key_lo`` + 1 (33 for ``key_lo == 0``)."""
    bucket = key_hi & (registers.shape[0] - 1)
    rho = torch.where(valid, 33 - _bit_length(key_lo), 0)
    return registers.scatter_reduce(0, bucket, rho, reduce="amax")


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Associative, commutative, idempotent register merge."""
    return torch.maximum(a, b)


def estimate(registers) -> float:
    """Bias-corrected HLL cardinality estimate (host, float64), with the
    small-range linear-counting correction."""
    if isinstance(registers, torch.Tensor):
        registers = registers.cpu().numpy()
    regs = np.asarray(registers, dtype=np.float64)
    m = regs.shape[0]
    alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1 + 1.079 / m))
    raw = alpha * m * m / np.sum(np.exp2(-regs))
    zeros = int(np.sum(regs == 0))
    if raw <= 2.5 * m and zeros:
        return float(m * np.log(m / zeros))  # linear counting, small range
    return float(raw)


# --- Count-Min Sketch --------------------------------------------------------

CMS_DEPTH = 4
CMS_WIDTH_LOG2 = 16  # 4 x 64K cells

# Odd row salts (xxhash/murmur-family primes) making the per-row bucket
# hashes effectively independent.
_CMS_SALTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
              0x165667B1, 0xFD7046C5, 0xB55A4F09, 0x2127599B)


def cms_empty(depth: int = CMS_DEPTH, width_log2: int = CMS_WIDTH_LOG2,
              device=None) -> torch.Tensor:
    """Zeroed sketch, int64 ``[depth, 2**width_log2]`` holding uint32."""
    if not 1 <= depth <= len(_CMS_SALTS):
        raise ValueError(f"depth must be in [1, {len(_CMS_SALTS)}], got "
                         f"{depth}")
    if not 8 <= width_log2 <= 24:
        raise ValueError(f"width_log2 must be in [8, 24], got {width_log2}")
    return torch.zeros((depth, 1 << width_log2), dtype=torch.int64,
                       device=device)


def _cms_bucket(key_hi, key_lo, row: int, width_mask: int) -> torch.Tensor:
    h = _fmix32((mul32(key_hi ^ _CMS_SALTS[row], int(constants.FMIX_C1))
                 + mul32(key_lo, int(constants.FMIX_C2)) + row) & MASK32)
    return h & width_mask


def cms_update(cms: torch.Tensor, key_hi, key_lo, counts) -> torch.Tensor:
    """Add a batch of ``(key, count)`` rows into the sketch (a new
    tensor).  Empty table slots carry count 0, so no mask is needed.  All
    depth rows go through one flattened ``index_add``; cells wrap at
    2**32 as the JAX package's uint32 cells do."""
    depth, width = cms.shape
    flat_idx = torch.cat([_cms_bucket(key_hi, key_lo, r, width - 1) + r * width
                          for r in range(depth)])
    updates = counts.to(torch.int64).repeat(depth)
    flat = cms.reshape(-1).index_add(0, flat_idx, updates) & MASK32
    return flat.reshape(depth, width)


def cms_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Associative, commutative sketch merge (wrapping at 2**32)."""
    return (a + b) & MASK32


# Host-side mirrors (python-int arithmetic, masked to 32 bits) so any word,
# retained or spilled, can be queried after the run without a device trip.

_M32 = 0xFFFFFFFF


def _fmix32_host(x: int) -> int:
    x ^= x >> 16
    x = (x * int(constants.FMIX_C1)) & _M32
    x ^= x >> 13
    x = (x * int(constants.FMIX_C2)) & _M32
    x ^= x >> 16
    return x


def _clamp_sentinel(key_hi: int, key_lo: int) -> tuple[int, int]:
    if key_hi == int(constants.SENTINEL_KEY) \
            and key_lo == int(constants.SENTINEL_KEY):
        key_lo = (key_lo - 1) & _M32
    return key_hi, key_lo


def _hash_token(token: bytes) -> tuple[int, int]:
    v1 = v2 = 0
    for c in token:
        v1 = (v1 * int(constants.HASH_BASE_1) + c + 1) & _M32
        v2 = (v2 * int(constants.HASH_BASE_2) + c + 1) & _M32
    n = len(token)
    return _clamp_sentinel(_fmix32_host(v1 ^ (n & _M32)),
                           _fmix32_host((v2 + 0x9E3779B9 * n) & _M32))


def hash_word(word: bytes) -> tuple[int, int]:
    """The device's 64-bit key of ``word``: a token, or an n-gram span.

    A ``word`` with separator bytes is keyed as the device keys grams:
    each token's rolling hash and fmix (:func:`...ops.tokenize.tokenize`),
    folded left to right with the gram mix
    (:func:`...ops.tokenize.mix_gram`).  The device never emits a token
    holding a separator, so the two readings cannot collide."""
    seps = bytes(constants.SEPARATOR_BYTES)
    tokens, cur = [], bytearray()
    for c in word:
        if c in seps:
            if cur:
                tokens.append(bytes(cur))
                cur = bytearray()
        else:
            cur.append(c)
    if cur:
        tokens.append(bytes(cur))
    if not tokens:
        return _hash_token(b"")
    key_hi, key_lo = _hash_token(tokens[0])
    for tok in tokens[1:]:
        t_hi, t_lo = _hash_token(tok)
        key_hi, key_lo = _clamp_sentinel(
            _fmix32_host(((key_hi * int(constants.HASH_BASE_1)) & _M32)
                         ^ t_hi),
            _fmix32_host(((key_lo * int(constants.HASH_BASE_2)) & _M32)
                         ^ t_lo))
    return key_hi, key_lo


def cms_query(cms, word: bytes) -> int:
    """Estimated occurrence count of ``word``: the min over rows (host).
    Never under-estimates a word the sketch saw; over-estimates by at most
    ~total/width per row with probability 1 - 2**-depth."""
    sk = cms.cpu().numpy() if isinstance(cms, torch.Tensor) \
        else np.asarray(cms)
    depth, width = sk.shape
    key_hi, key_lo = hash_word(word)
    est = None
    for r in range(depth):
        h = _fmix32_host(((key_hi ^ _CMS_SALTS[r]) * int(constants.FMIX_C1)
                          + key_lo * int(constants.FMIX_C2) + r) & _M32)
        v = int(sk[r, h & (width - 1)])
        est = v if est is None else min(est, v)
    return est
