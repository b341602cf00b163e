"""Correlated multi-jittered (CMJ) sampler, batched and stateless.

Counterpart of aten_tpu/core/sampler.py, bit for bit.  The reference is
uint32 arithmetic with wraparound; this torch build has no shifts, adds
or divisions for torch.uint32 on the CPU, so every value here is an
int64 tensor holding a uint32, reduced with `& 0xFFFFFFFF` after each
multiply, add and shift.  Products are split into 16-bit halves
(`_mul32`) so no intermediate leaves the int64 range.

The public entry points `wang_hash`, `make_state`, `next_1d` and
`next_2d` each record a "sampler" span (utils/spans.py); they call the
unspanned `_wang_hash` inside, so one draw is one span.
"""
from __future__ import annotations

import numpy as np
import torch

from aten_tpu_torch.utils import spans

CMJ_DIM = 16  # 16x16 grid, as the reference (cmj.h:9)
CMJ_N = CMJ_DIM * CMJ_DIM

_M32 = 0xFFFFFFFF
_ROUND_MULS = (0x9E3779B9, 0x85157AF5, 0xC2B2AE35, 0x27D4EB2F)  # all odd
# f32(1/4294967808): the reference multiplies by the float32 constant
_INV_U32 = float(np.float32(1.0 / 4294967808.0))


def _mul32(a, m):
    """(a * m) mod 2**32 for uint32 values a, m (int or int64 tensor)."""
    return (a * (m & 0xFFFF) + (((a * (m >> 16)) & 0xFFFF) << 16)) & _M32


def wang_hash(seed):
    """Wang integer hash (reference fallback sampler, sampler/wanghash.h:8)."""
    with spans.span("sampler"):
        return _wang_hash(seed)


def _wang_hash(seed):
    seed = (seed ^ 61) ^ (seed >> 16)
    seed = _mul32(seed, 9)
    seed = seed ^ (seed >> 4)
    seed = _mul32(seed, 0x27D4EB2D)
    seed = seed ^ (seed >> 15)
    return seed


def _permute_pow2(i, l, p):
    """Randomized permutation of [0, l) for power-of-two l (static int)."""
    w = l - 1
    bits = int(l).bit_length() - 1
    s = max(1, bits // 2)
    i = i & w
    k = _wang_hash(p ^ 0x55555555)
    for r, mul in enumerate(_ROUND_MULS):
        i = _mul32(i, mul) & w
        i = i ^ (i >> s)
        i = ((i + (k >> (r * 7))) & _M32) & w
        i = i ^ (i >> 1)
    return i & w


def _randfloat(i, p):
    """Kensler's hash-to-float in [0, 1)."""
    i = i ^ p
    i = i ^ (i >> 17)
    i = i ^ (i >> 10)
    i = _mul32(i, 0xB36534E5)
    i = i ^ (i >> 12)
    i = i ^ (i >> 21)
    i = _mul32(i, 0x93FC4795)
    i = i ^ 0xDF6E307F
    i = i ^ (i >> 17)
    i = _mul32(i, 1 | (p >> 18))
    # int64 -> float32 rounds to nearest even, as the reference's u32 -> f32
    return i.to(torch.float32) * _INV_U32


def _permute_256(s, p):
    lo = _permute_pow2(s & 15, CMJ_DIM, _mul32(p, 0x51633E2D))
    hi = _permute_pow2(
        s >> 4, CMJ_DIM, _mul32(p ^ _mul32(lo, 0x68BC21EB), 0x02E5BE93))
    return hi * CMJ_DIM + lo


def cmj_2d(s, p):
    """The s-th sample of 16x16 CMJ pattern p. Returns (x, y) in [0,1)."""
    s = s & (CMJ_N - 1)
    s = _permute_256(s, _mul32(p, 0xA399D265))
    m = CMJ_DIM
    sx = _permute_pow2(s & (m - 1), m, _mul32(p, 0xA511E9B3))
    sy = _permute_pow2(s >> 4, m, _mul32(p, 0x63D83595))
    jx = _randfloat(s, _mul32(p, 0xA399D265))
    jy = _randfloat(s, _mul32(p, 0x711AD6A5))
    col = (s & (m - 1)).to(torch.float32)
    row = (s >> 4).to(torch.float32)
    inv_m = 1.0 / m
    x = (col + (sy.to(torch.float32) + jx) * inv_m) * inv_m
    y = (row + (sx.to(torch.float32) + jy) * inv_m) * inv_m
    return x, y


def cmj_1d(s, p):
    """Stratified-permutation 1D sample over the 256 strata."""
    s = s & (CMJ_N - 1)
    sx = _permute_256(s, _mul32(p, 0x85157AF5))
    j = _randfloat(s, _mul32(p, 0x967A889B))
    return (sx.to(torch.float32) + j) * (1.0 / CMJ_N)


# --- batched sampler state --------------------------------------------------
#
# {idx, dim, scramble} as int64 tensors holding uint32 values, mirroring
# the reference's 12-byte CMJ state (sampler/cmj.h:121-123).


def make_state(pixel_seed, frame, sample, spp, bounce=0):
    """Batched sampler state.  pixel_seed: int64 tensor of uint32 values;
    frame, spp, bounce: ints; sample: int or int64 tensor."""
    with spans.span("sampler"):
        idx = (_mul32(frame & _M32, spp & _M32) + sample) & _M32
        if not torch.is_tensor(idx):
            idx = torch.full_like(pixel_seed, idx)
        epoch = idx >> 8  # pattern exhausted every 256 samples -> new pattern
        scramble = _wang_hash(pixel_seed ^ _wang_hash(_mul32(epoch, 0x9E3779B9)))
        dim = (_mul32(bounce & _M32, 300) + 4) & _M32
        shape = scramble.shape
        return {
            "idx": torch.broadcast_to(idx & (CMJ_N - 1), shape),
            "dim": torch.full(shape, dim, dtype=torch.int64, device=scramble.device),
            "scramble": scramble,
        }


def next_1d(state):
    with spans.span("sampler"):
        p = state["scramble"] ^ _wang_hash(state["dim"])
        u = cmj_1d(state["idx"], p)
        state = dict(state, dim=(state["dim"] + 1) & _M32)
        return u, state


def next_2d(state):
    with spans.span("sampler"):
        p = state["scramble"] ^ _wang_hash(state["dim"])
        x, y = cmj_2d(state["idx"], p)
        state = dict(state, dim=(state["dim"] + 2) & _M32)
        return x, y, state
