"""Row gathers from small tables.

Counterpart of aten_tpu/ops/gather.py, with the same functions and
arguments.  The reference turns a gather from a table of up to
`max_rows` rows into a one-hot matmul, because the TPU has no gather
hardware and its MXU computes one exactly; a GPU gathers rows directly,
so here both functions are exact index gathers and `max_rows` is
accepted and ignored.
"""
from __future__ import annotations

import torch

MXU_GATHER_MAX_ROWS = 2048


def take_rows(table, idx, *, max_rows=MXU_GATHER_MAX_ROWS):
    """Rows of `table` [K, D] at `idx` [N] (in range) -> [N, D] float32."""
    del max_rows
    return table.to(torch.float32)[idx.long()]


def take_fields(field_dict, idx, *, int_fields=(), max_rows=MXU_GATHER_MAX_ROWS):
    """A dict of per-row fields ([K] or [K, C]) gathered at `idx`: float32
    fields, except those named in int_fields, returned as int32 (a float
    one rounded, as the reference rounds its matmul's result)."""
    del max_rows
    i = idx.long()
    out = {}
    for k, v in field_dict.items():
        f = v[i]
        if k in int_fields:
            f = f if not f.is_floating_point() else torch.round(f)
            out[k] = f.to(torch.int32)
        else:
            out[k] = f.to(torch.float32)
    return out
