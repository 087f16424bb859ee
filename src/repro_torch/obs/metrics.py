"""Sync-free metrics: device-side accumulation, one flush per run.

Twin of ``repro/obs/metrics.py``. Train steps return their metrics as
device tensors; `MetricsBuffer.record` keeps them as they are (a list
append, no device→host sync in the hot loop), and `MetricsBuffer.flush`
moves everything recorded to the host at the end of the run in ONE
transfer: every scalar and vector of every round is stacked on its device
into one f32 tensor, copied with one ``.cpu()``, and split back on the
host. ``counter`` / ``gauge`` / ``histogram`` are the reference's in-step
helpers, on tensors.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def counter(x) -> torch.Tensor:
    """Sum a (possibly batched) quantity into a scalar count."""
    return torch.as_tensor(x, dtype=torch.float32).sum()


def gauge(x) -> torch.Tensor:
    """A point-in-time scalar reading."""
    return torch.as_tensor(x, dtype=torch.float32).reshape(())


def histogram(x, bins: int = 16, lo: float = 0.0,
              hi: float = 1.0) -> torch.Tensor:
    """Fixed-range histogram counts with a static shape.

    Values outside [lo, hi] clamp into the edge buckets so no sample is
    silently dropped (``searchsorted(side="right") - 1``, as the
    reference)."""
    x = torch.as_tensor(x, dtype=torch.float32).reshape(-1)
    edges = torch.linspace(lo, hi, bins + 1, device=x.device)
    idx = (torch.searchsorted(edges, x, right=True) - 1).clamp(0, bins - 1)
    return torch.zeros(bins, device=x.device).index_add_(
        0, idx, torch.ones_like(x))


def _host_value(v: Any) -> Any:
    """A host number or array as the reference flushes it: a float for a
    scalar, nested lists otherwise."""
    a = np.asarray(v)
    return float(a) if a.ndim == 0 else a.tolist()


class MetricsBuffer:
    """Accumulates per-round metric dicts; flushes in one transfer.

    ``record`` keeps device tensors as they are (no sync); ``flush``
    performs the run's single blocking device→host copy over everything
    recorded (the tensors are flattened, upcast to f64, which is exact for
    f32 and int32 values, and concatenated on their device first) and
    returns per-round dicts of host floats (lists for vector metrics such
    as histograms). Host numbers pass through without a transfer."""

    def __init__(self) -> None:
        self._pending: List[Dict[str, Any]] = []

    def __len__(self) -> int:
        return len(self._pending)

    def record(self, metrics: Dict[str, Any]) -> None:
        self._pending.append(metrics)

    def flush(self) -> List[Dict[str, Any]]:
        if not self._pending:
            return []
        pending, self._pending = self._pending, []
        out: List[Dict[str, Any]] = [{} for _ in pending]
        slots, flats = [], []       # where each device value lands
        for i, m in enumerate(pending):
            for k, v in m.items():
                if torch.is_tensor(v):
                    slots.append((i, k, tuple(v.shape), v.numel()))
                    flats.append(v.detach().reshape(-1))
                else:
                    out[i][k] = _host_value(v)
        if flats:
            device = next((f.device for f in flats if f.device.type != "cpu"),
                          flats[0].device)
            flat = torch.cat([f.to(device, torch.float64) for f in flats])
            values = flat.cpu().numpy()   # the run's one blocking transfer
            off = 0
            for i, k, shape, n in slots:
                out[i][k] = _host_value(values[off:off + n].reshape(shape))
                off += n
        return out
