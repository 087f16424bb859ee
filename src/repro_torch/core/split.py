"""Parameter accounting for the client/server split (twin of
``repro/core/split.py``).

A parameter collection is a mapping of names to tensors (or any iterable
of tensors). ``phi_bits=None`` counts each tensor at its dtype's width; an
explicit value applies one accounting width φ to every element, as the
paper's §5 cost model does with φ = 64.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Union

import torch

Params = Union[Mapping[str, torch.Tensor], Iterable[torch.Tensor]]


def _tensors(params: Params):
    return list(params.values()) if isinstance(params, Mapping) \
        else list(params)


def dtype_bits(dtype: torch.dtype) -> int:
    """Bits per element of a dtype (bf16 -> 16, f32 -> 32, ...)."""
    return dtype.itemsize * 8


def tree_size(params: Params) -> int:
    """Total number of parameters."""
    return sum(t.numel() for t in _tensors(params))


def tree_bits(params: Params, phi_bits: Optional[int] = None) -> int:
    """Parameter payload in bits (see module docstring for ``phi_bits``)."""
    tensors = _tensors(params)
    if phi_bits is None:
        return sum(t.numel() * dtype_bits(t.dtype) for t in tensors)
    return tree_size(tensors) * phi_bits
