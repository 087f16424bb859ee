"""Which parameters the port keeps in another layout than the reference.

The paper models keep their conv weights as PyTorch's OIHW, the reference
keeps them HWIO; every other parameter, the LM zoo's included, lies as the
reference's does. ``ref_axes`` is the one statement of that, keyed by a
paper model's state-dict name (``client.conv1_w``): the parameter
conversions (`paper_models.from_jax_params` / `to_jax_params`) and
Adafactor's factored dims read it (Adafactor keeps its factors in the
reference's layout, so a snapshot stores them as they are).
"""

from __future__ import annotations

from typing import Optional, Tuple

OIHW_TO_HWIO = (2, 3, 1, 0)


def ref_axes(key: str) -> Optional[Tuple[int, ...]]:
    """The permutation that takes the tensor of state-dict key ``key``
    (``part.name``) to the reference's layout: OIHW -> HWIO for a paper
    model's conv weight (``conv*_w``), None where the two layouts agree
    (and for keys of other forms, such as an LM's '/'-joined paths)."""
    _, _, name = key.partition(".")
    conv = name.startswith("conv") and name.endswith("_w")
    return OIHW_TO_HWIO if conv else None


def inverse(axes: Tuple[int, ...]) -> Tuple[int, ...]:
    """The permutation that undoes ``axes``."""
    return tuple(sorted(range(len(axes)), key=axes.__getitem__))
