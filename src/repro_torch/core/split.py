"""Parameter accounting for the client/server split (twin of
``repro/core/split.py``).

A parameter collection is a mapping of names to tensors, nested mappings
and lists of them (a ``TransformerLM``'s params), or any iterable of
tensors. A model's params are split into ``"client"`` and ``"server"``
parts, either as two nested entries or as flat ``client.`` / ``server.``
prefixed names (a module's ``named_parameters()``, as ``FemnistCNN``'s).
``phi_bits=None`` counts each tensor at its dtype's width; an explicit
value applies one accounting width φ to every element, as the paper's §5
cost model does with φ = 64.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

import torch

Params = Union[Mapping[str, Any], Iterable[Any]]


def _tensors(params: Params) -> List[torch.Tensor]:
    """Every tensor of a (possibly nested) parameter collection."""
    if torch.is_tensor(params):
        return [params]
    items = params.values() if isinstance(params, Mapping) else params
    return [t for item in items for t in _tensors(item)]


def split_part(params: Mapping[str, Any], part: str) -> List[torch.Tensor]:
    """The tensors of the ``"client"`` or ``"server"`` part of a model's
    params, nested or with flat prefixed names."""
    if part in params:
        return _tensors(params[part])
    prefix = part + "."
    return [t for k, v in params.items() if k.startswith(prefix)
            for t in _tensors(v)]


def dtype_bits(dtype) -> int:
    """Bits per element of a dtype (bf16 -> 16, f32 -> 32, ...); a torch
    dtype or its name."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
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


def split_summary(params: Mapping[str, Any],
                  phi_bits: Optional[int] = None) -> Dict[str, Any]:
    """Parameter counts and bits of each side of the split."""
    client = split_part(params, "client")
    server = split_part(params, "server")
    n_client = tree_size(client)
    n_server = tree_size(server)
    total = n_client + n_server
    return {
        "client_params": n_client,
        "server_params": n_server,
        "total_params": total,
        "client_fraction": n_client / max(total, 1),
        "client_bits": tree_bits(client, phi_bits),
        "server_bits": tree_bits(server, phi_bits),
    }
