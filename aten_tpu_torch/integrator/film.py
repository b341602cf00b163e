"""Film accumulation.

Counterpart of aten_tpu/integrator/film.py (the reference's
FilmProgressive): a running average `(n*cur + v)/(n+1)` with an explicit
sample counter, on the device of the images it accumulates; `state` and
`load_state` checkpoint it (utils/checkpoint.py).
"""
from __future__ import annotations

import numpy as np
import torch


class Film:
    def __init__(self, height, width, device):
        self.height = height
        self.width = width
        self.device = device
        self.clear()

    def clear(self):
        self.buf = torch.zeros((self.height, self.width, 3), dtype=torch.float32,
                               device=self.device)
        self.count = 0

    def accumulate(self, img):
        n = self.count
        self.buf = (self.buf * n + img) / (n + 1)
        self.count = n + 1

    def image(self):
        return self.buf

    def state(self):
        """The accumulation state to checkpoint: {"buf", "count"}."""
        return {"buf": self.buf, "count": torch.tensor(self.count, dtype=torch.int32)}

    def load_state(self, st):
        """Resume from `state()`'s dict; the buffer moves to the film's
        device."""
        self.buf = torch.as_tensor(st["buf"], dtype=torch.float32).to(self.device)
        self.count = int(st["count"])


def tonemap_gamma(img, gamma=2.2):
    return torch.clamp(img, 0.0, 1.0) ** (1.0 / gamma)


def to_srgb_u8(img):
    x = tonemap_gamma(img).cpu().numpy()
    return (x * 255.0 + 0.5).astype(np.uint8)
