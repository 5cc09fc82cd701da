"""Framework-wide constants.

The reference pins its scalability envelope with compile-time ``#define``s
(``main.cu:9-15``: GRID_SIZE/BLOCK_SIZE/MAX_INPUT_COUNT/...).  This port
(a copy of the JAX package's constants: both packages must hash and pad
identically) replaces those with *semantic* constants (separator classes,
hash parameters, sentinels) plus runtime-configurable capacities (see
:mod:`mapreduce_tpu_torch.config`).
Nothing here limits input size; shapes are chosen per run.
"""

from __future__ import annotations

import numpy as np

# --- Separator byte classes -------------------------------------------------
# The reference tokenizes on space / CR / LF only (main.cu:188) and implicitly
# on NUL via memset padding (main.cu:178).  We add TAB (0x09) — a deliberate
# fix of the reference's "no tabs" quirk (SURVEY §2 defect 5) — and VT/FF for
# full C `isspace` semantics.  Keys remain case-sensitive and punctuation is
# preserved, matching the reference's intended semantics.
SEPARATOR_BYTES: tuple[int, ...] = (0x00, 0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20)

# Byte used to pad chunk tensors to static shapes.  Must be a separator so
# padding can never extend or create a token.
PAD_BYTE: int = 0x00

# --- Rolling-hash parameters ------------------------------------------------
# Two independent 32-bit polynomial rolling hashes (odd bases, natural mod
# 2**32) form an effective 64-bit key.  Polynomial hashing is used because it
# has an *associative* segmented formulation (affine-function composition),
# which lets the whole tokenize+hash pass run as prefix sums instead of the
# per-thread char loops of the reference mapper (main.cu:37-54).
HASH_BASE_1 = np.uint32(16777619)  # FNV-1a 32-bit prime
HASH_BASE_2 = np.uint32(2654435761)  # Knuth multiplicative constant (odd)

# murmur3 fmix32 constants, used to finalize each 32-bit lane.
FMIX_C1 = np.uint32(0x85EBCA6B)
FMIX_C2 = np.uint32(0xC2B2AE35)

# --- Sentinels ---------------------------------------------------------------
# Empty slots in count tables and non-token positions in the per-byte stream
# carry the all-ones key; real keys are clamped one below it (a 2**-64 bias).
SENTINEL_KEY = np.uint32(0xFFFFFFFF)

# uint32 "infinity" used for first-occurrence position tracking (min-reduced).
POS_INF = np.uint32(0xFFFFFFFF)

# Length sentinel for cross-chunk n-gram table entries: the gram's true byte
# span ends in a LATER chunk whose row base the device cannot know, so the
# host recovers the span by scanning n tokens forward from the entry's
# absolute start offset (reader.scan_gram_length).  Real span lengths are
# bounded by the corpus size; the all-ones value cannot collide.
SEAM_GRAM_LENGTH = np.uint32(0xFFFFFFFF)
