"""Rotary position embeddings: standard RoPE and Qwen2-VL style M-RoPE
(twin of ``repro/models/rope.py``).

M-RoPE (multimodal RoPE, arXiv:2409.12191) splits the head_dim/2 frequency
bands into (temporal, height, width) sections; each section rotates by the
corresponding component of a 3-vector position id. Text tokens carry
(t, t, t), so M-RoPE degenerates to RoPE on text. Angles are computed in
f32; cos and sin are cast to the rotated tensor's dtype, as the reference
does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _angles(positions: torch.Tensor, head_dim: int,
            theta: float) -> torch.Tensor:
    """positions: (..., S) -> angles (..., S, head_dim//2) in f32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    return positions.unsqueeze(-1).float() * freqs


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Optional[Tuple[int, int, int]] = None
                ) -> torch.Tensor:
    """Rotation angles (B, S, head_dim//2).

    positions: (B, S) for RoPE, (3, B, S) for M-RoPE."""
    if mrope_sections is None:
        return _angles(positions, head_dim, theta)
    if positions.dim() != 3 or positions.shape[0] != 3:
        raise ValueError(f"M-RoPE needs (3, B, S) position ids, got "
                         f"{tuple(positions.shape)}")
    ang = _angles(positions, head_dim, theta)          # (3, B, S, half)
    half = ang.shape[-1]
    dev = positions.device
    bounds = torch.cumsum(torch.tensor(mrope_sections, device=dev), 0)
    # frequency band b belongs to the first section whose cumsum exceeds b
    band_section = torch.searchsorted(bounds, torch.arange(half, device=dev),
                                      right=True)                 # (half,)
    onehot = band_section[None, :] == torch.arange(3, device=dev)[:, None]
    return (ang * onehot[:, None, None, :]).sum(0)                # (B, S, half)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate. x: (B, S, H, head_dim); angles: (B, S, head_dim//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
