"""Correlated multi-jittered (CMJ) sampler, batched and stateless.

A frozen copy of the sampler the path tracer draws from (Kensler's CMJ
over a 16x16 pattern, re-seeded per bounce with a Wang hash).  Values are
uint32 held in int64 tensors and masked back to 32 bits after each
multiply, add and shift, so every draw is exact; only the final
conversion to a float takes the run's floating type.  The frame may be a
tensor, one per lane, so lanes of several images trace in one batch.
"""
from __future__ import annotations

import numpy as np

from benchmark.reference.vecmath import ftype

CMJ_DIM = 16
CMJ_N = CMJ_DIM * CMJ_DIM

_M32 = 0xFFFFFFFF
_ROUND_MULS = (0x9E3779B9, 0x85157AF5, 0xC2B2AE35, 0x27D4EB2F)
_INV_U32 = float(np.float32(1.0 / 4294967808.0))


def _mul32(a, m):
    """(a * m) mod 2**32 for uint32 values a and m (ints or int64 tensors)."""
    return (a * (m & 0xFFFF) + (((a * (m >> 16)) & 0xFFFF) << 16)) & _M32


def wang_hash(seed):
    seed = (seed ^ 61) ^ (seed >> 16)
    seed = _mul32(seed, 9)
    seed = seed ^ (seed >> 4)
    seed = _mul32(seed, 0x27D4EB2D)
    seed = seed ^ (seed >> 15)
    return seed


def _permute_pow2(i, l, p):
    w = l - 1
    bits = int(l).bit_length() - 1
    s = max(1, bits // 2)
    i = i & w
    k = wang_hash(p ^ 0x55555555)
    for r, mul in enumerate(_ROUND_MULS):
        i = _mul32(i, mul) & w
        i = i ^ (i >> s)
        i = ((i + (k >> (r * 7))) & _M32) & w
        i = i ^ (i >> 1)
    return i & w


def _randfloat(i, p):
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
    return i.to(ftype()) * _INV_U32


def _permute_256(s, p):
    lo = _permute_pow2(s & 15, CMJ_DIM, _mul32(p, 0x51633E2D))
    hi = _permute_pow2(s >> 4, CMJ_DIM, _mul32(p ^ _mul32(lo, 0x68BC21EB), 0x02E5BE93))
    return hi * CMJ_DIM + lo


def cmj_2d(s, p):
    s = s & (CMJ_N - 1)
    s = _permute_256(s, _mul32(p, 0xA399D265))
    m = CMJ_DIM
    sx = _permute_pow2(s & (m - 1), m, _mul32(p, 0xA511E9B3))
    sy = _permute_pow2(s >> 4, m, _mul32(p, 0x63D83595))
    jx = _randfloat(s, _mul32(p, 0xA399D265))
    jy = _randfloat(s, _mul32(p, 0x711AD6A5))
    f = ftype()
    col = (s & (m - 1)).to(f)
    row = (s >> 4).to(f)
    inv_m = 1.0 / m
    x = (col + (sy.to(f) + jx) * inv_m) * inv_m
    y = (row + (sx.to(f) + jy) * inv_m) * inv_m
    return x, y


def cmj_1d(s, p):
    s = s & (CMJ_N - 1)
    sx = _permute_256(s, _mul32(p, 0x85157AF5))
    j = _randfloat(s, _mul32(p, 0x967A889B))
    return (sx.to(ftype()) + j) * (1.0 / CMJ_N)


def make_state(pixel_seed, frame, sample, spp, bounce=0):
    """Sampler state of each lane: pixel_seed, frame and sample int64
    tensors (frame may be an int), spp and bounce ints."""
    idx = (_mul32(frame & _M32, spp & _M32) + sample) & _M32
    epoch = idx >> 8
    scramble = wang_hash(pixel_seed ^ wang_hash(_mul32(epoch, 0x9E3779B9)))
    dim = (_mul32(bounce & _M32, 300) + 4) & _M32
    return {"idx": idx & (CMJ_N - 1), "dim": scramble * 0 + dim, "scramble": scramble}


def next_1d(state):
    p = state["scramble"] ^ wang_hash(state["dim"])
    u = cmj_1d(state["idx"], p)
    return u, dict(state, dim=(state["dim"] + 1) & _M32)


def next_2d(state):
    p = state["scramble"] ^ wang_hash(state["dim"])
    x, y = cmj_2d(state["idx"], p)
    return x, y, dict(state, dim=(state["dim"] + 2) & _M32)
