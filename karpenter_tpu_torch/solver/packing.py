"""Bit-packed [C, K] class/type masks (32 type columns per uint32 word).

Copy of karpenter_tpu/solver/packing.py for the host (NumPy) side, plus
the device-side unpack in torch.

Bit layout: bit j of word w covers column ``32*w + j`` -- little-endian
within the word, words in ascending column order (the same layout as the
fused decision's gmask_bits and encode's per-dim ``allowed`` words).

On the device, packed words live in **int32 lanes** holding the uint32
bits: torch has no shifts on ``torch.uint32`` on the CPU, and ``>>`` on
int32 is arithmetic, which leaves bit j of the word at bit 0 after
``>> j`` all the same. Words are reinterpreted as uint32 only where the
fused buffer reaches the host.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32


def packed_words(k: int) -> int:
    """Words per row for k columns."""
    return (k + WORD_BITS - 1) // WORD_BITS


def is_packed(arr) -> bool:
    """True when `arr` is a packed mask: uint32 words on the host, or
    their int32 lanes on the device. A full-width mask is bool."""
    if arr is None:
        return False
    if isinstance(arr, torch.Tensor):
        return arr.dtype == torch.int32
    return np.dtype(arr.dtype) == np.uint32


def pack_mask(mask: np.ndarray) -> np.ndarray:
    """[..., K] bool -> [..., KW] uint32 (host numpy). K may be any
    size; tail bits of the last word are zero."""
    mask = np.ascontiguousarray(np.asarray(mask, dtype=bool))
    k = mask.shape[-1]
    kw = packed_words(k)
    packed8 = np.packbits(mask, axis=-1, bitorder="little")       # [..., ceil(K/8)] u8
    want8 = kw * 4
    if packed8.shape[-1] != want8:
        pad = np.zeros(mask.shape[:-1] + (want8 - packed8.shape[-1],), dtype=np.uint8)
        packed8 = np.concatenate([packed8, pad], axis=-1)
    return np.ascontiguousarray(packed8).view(np.uint32)


def unpack_mask(words: np.ndarray, k: int) -> np.ndarray:
    """[..., KW] uint32 -> [..., k] bool (host numpy inverse)."""
    words = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    bits = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    return bits[..., :k].astype(bool)


def _bit_shifts(device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=torch.int32, device=device)


def pack_rows(mask: torch.Tensor) -> torch.Tensor:
    """[..., K] bool -> [..., K/32] int32 lanes of the uint32 words
    (K a multiple of 32). The sum runs in int64 and narrows by
    truncation, which keeps bit 31."""
    k = mask.shape[-1]
    kw = k // WORD_BITS
    lanes = mask.reshape(mask.shape[:-1] + (kw, WORD_BITS)).to(torch.int64)
    shifts = _bit_shifts(mask.device).to(torch.int64)
    return (lanes << shifts).sum(dim=-1).to(torch.int32)


def unpack_rows(words: torch.Tensor, k: int) -> torch.Tensor:
    """[..., KW] int32 lanes -> [..., k] bool (inverse of pack_rows)."""
    kw = words.shape[-1]
    bits = (words[..., :, None] >> _bit_shifts(words.device)) & 1
    return bits.reshape(words.shape[:-1] + (kw * WORD_BITS,))[..., :k].to(torch.bool)


def as_bool_mask(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Packed int32 lanes unpack to [..., k] bool; a full-width bool
    mask passes through unchanged."""
    if is_packed(mask):
        return unpack_rows(mask, k)
    return mask
