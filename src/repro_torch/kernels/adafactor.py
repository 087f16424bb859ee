"""CUDA kernel: one leaf's Adafactor update in three streaming passes.

Replaces no TPU kernel: the reference's Adafactor is jnp that XLA fuses.
The kernel is ``csrc/adafactor.cu``; its plain version
``ref.adafactor_update_ref``, the optimizer's arithmetic as eager PyTorch.
Both take one leaf's gradient g in the reference's layout (f32 or bf16 on
the card) and its f32 second moment, and return the update −lr·u in g's
dtype and the new second moment as new tensors:

    factored (rank >= 2, v = {"row", "col"}): g seen as matrices (R, C)
      over its leading dims; row and col the means of g² + eps over C and
      over R, each blended with its old value by β;
      u = g / max(sqrt(row_r·col_c / max(mean(row), eps)), eps)
    whole (rank <= 1, v = {"full"}): full = β·full + (1 − β)·(g² + eps);
      u = g / max(sqrt(full), eps)
    then u / max(rms(u) / clip, 1), rms over the whole leaf

Each element goes through the plain version's operations in its order,
each rounded once, with two differences: the order of the f32 sums (a
fixed order: the kernel is bitwise repeatable), and the means, which
divide a sum by its count where torch's mean multiplies by 1/count. The
factored form reads g three times and writes the update once (8 bytes an
element in bf16), with no full-size temporary; its scratch (row and
column partials, per-block sums) is a few floats per row, column and
block.

The kernel runs in stages (``_run``); between them the sums of a block
may be added over the ranks that hold the leaf's other blocks. So a
DTensor's local blocks take the kernel too (``adafactor_update_sharded``):
its row sums are added over the mesh dims that split the leaf's last dim,
its column sums and each matrix's sum of rows over those that split the
second last, and Σ u² over every mesh dim that splits the leaf.

``adafactor_update_kernel`` launches the kernel or raises, a CPU tensor
included (``ops.adafactor_update`` takes the plain version there).
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import _build
from repro_torch.sharding.ctx import like

TILE_ROWS = 256   # rows of a pass's tile (csrc/adafactor.cu's kTileRows)
FULL_TILE = 256 * 16   # values a block of the whole form takes
#                        (kThreads · kFullPer)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# each launcher's arguments (the stream, last, is added by _build.launch)
_SUMS = [_P] * 4 + [_L] + [_I] * 5 + [_F]
_FACTORS = [_P] * 7 + [_I] * 3 + [_F] * 4
_SQUARES = [_P] * 6 + [_L] + [_I] * 5 + [_F] * 2
_APPLY = [_P] * 6 + [_I] * 5 + [_F] * 5
_FULL_SQUARES = [_P] * 5 + [_L, _L, _I] + [_F] * 3
_FULL_APPLY = [_P] * 4 + [_L, _I] + [_F] * 4
_DTYPES = (torch.float32, torch.bfloat16)

# sum_over(over, t) adds t in place over the ranks that hold the leaf's
# other blocks: over "C" those that split its last dim, "R" its second
# last, "N" any dim
SumOver = Callable[[str, torch.Tensor], None]


def vec_values(dtype: torch.dtype) -> int:
    """Values of ``dtype`` in one 16-byte load."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def _tiles(rows: int, cols: int, dtype: torch.dtype) -> Tuple[int, int]:
    """The factored form's row tiles and column tiles of a matrix."""
    return -(-rows // TILE_ROWS), -(-cols // (32 * vec_values(dtype)))


def _no_sum(over: str, t: torch.Tensor) -> None:
    """One device holds the whole leaf: nothing to add."""


def _run(g: torch.Tensor, v: Dict[str, torch.Tensor],
         shape: Tuple[int, ...], sum_over: SumOver, *, beta: float,
         one_minus: float, lr: float, eps: float, clip: float
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The kernel's stages on g, one device's block of a leaf of ``shape``
    (the whole leaf, or a DTensor's local block), and v, its state's block;
    ``sum_over`` adds each stage's sums over the other blocks."""
    out = torch.empty_like(g)
    bf16 = int(g.dtype == torch.bfloat16)
    count = float(math.prod(shape))
    if "full" in v:
        n = g.numel()
        buf = torch.empty(1 + -(-n // FULL_TILE), device=g.device,
                          dtype=torch.float32)
        sumsq, part = buf[:1], buf[1:]
        new = {"full": torch.empty_like(v["full"])}
        _build.launch("adafactor", "adafactor_full_squares_launch",
                      _FULL_SQUARES, g, v["full"], new["full"], sumsq, part,
                      part.numel(), n, bf16, beta, one_minus, eps)
        sum_over("N", sumsq)
        _build.launch("adafactor", "adafactor_full_apply_launch",
                      _FULL_APPLY, g, new["full"], sumsq, out, n, bf16,
                      count, eps, clip, -lr)
    else:
        rows, cols = g.shape[-2:]
        nmat = math.prod(g.shape[:-2])
        big_r, big_c = shape[-2:]
        nrt, nct = _tiles(rows, cols, g.dtype)
        scratch_n = max(nmat * nct * rows + nmat * nrt * cols,
                        nmat * nrt * nct)
        buf = torch.empty(nmat * (rows + cols + 1) + 1 + scratch_n,
                          device=g.device, dtype=torch.float32)
        row_sum, col_sum, total, sumsq, scratch = buf.split(
            [nmat * rows, nmat * cols, nmat, 1, scratch_n])
        new = {"row": torch.empty_like(v["row"]),
               "col": torch.empty_like(v["col"])}
        vec = int(cols % vec_values(g.dtype) == 0)
        shape_args = (nmat, rows, cols, bf16, vec)
        _build.launch("adafactor", "adafactor_sums_launch", _SUMS, g,
                      row_sum, col_sum, scratch, scratch_n, *shape_args, eps)
        sum_over("C", row_sum)
        sum_over("R", col_sum)
        _build.launch("adafactor", "adafactor_factors_launch", _FACTORS,
                      row_sum, col_sum, v["row"], v["col"], new["row"],
                      new["col"], total, nmat, rows, cols, float(big_c),
                      float(big_r), beta, one_minus)
        sum_over("R", total)
        _build.launch("adafactor", "adafactor_squares_launch", _SQUARES, g,
                      new["row"], new["col"], total, sumsq, scratch,
                      scratch_n, *shape_args, float(big_r), eps)
        sum_over("N", sumsq)
        _build.launch("adafactor", "adafactor_apply_launch", _APPLY, g,
                      new["row"], new["col"], total, sumsq, out, *shape_args,
                      float(big_r), count, eps, clip, -lr)
    _build.count("adafactor_update")
    return out, new


def _check(g: torch.Tensor, v: Dict[str, torch.Tensor]) -> None:
    if g.dtype not in _DTYPES or not g.is_contiguous() \
            or g.data_ptr() % 16 != 0:
        raise ValueError(f"adafactor_update: needs a contiguous f32 or bf16 "
                         f"gradient at a 16-byte aligned address, got "
                         f"{g.dtype} {tuple(g.shape)} (contiguous="
                         f"{g.is_contiguous()}, address {g.data_ptr()} mod "
                         f"16 = {g.data_ptr() % 16})")
    if "full" in v:
        want = {"full": g.shape}
    else:
        want = {"row": g.shape[:-1], "col": g.shape[:-2] + g.shape[-1:]}
    if g.dim() < 2 and "full" not in v or set(v) != set(want):
        raise ValueError(f"adafactor_update: a rank-{g.dim()} leaf with "
                         f"state {sorted(v)}")
    for k, t in v.items():
        if t.device != g.device or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.shape != want[k]:
            raise ValueError(f"adafactor_update: state {k!r} must be a "
                             f"contiguous f32 {tuple(want[k])} tensor on "
                             f"{g.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and at a 16-byte aligned address (a copy where it is
    not)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def adafactor_update_kernel(g: torch.Tensor, v: Dict[str, torch.Tensor], *,
                            beta: float, one_minus: float, lr: float,
                            eps: float, clip: float
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """g in the reference's layout: on the card contiguous, 16-byte
    aligned, f32 or bf16; v the leaf's second moment (contiguous f32).
    Returns (the update in g's dtype, the new v)."""
    kw = dict(beta=beta, one_minus=one_minus, lr=lr, eps=eps, clip=clip)
    if g.device.type != "cuda":
        raise ValueError(f"adafactor_update: needs a CUDA tensor, got "
                         f"{g.device}")
    _check(g, v)
    return _run(g, v, tuple(g.shape), _no_sum, **kw)


def _placed(t: DTensor, placements) -> DTensor:
    if tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def adafactor_update_sharded(g: DTensor, v: Dict[str, DTensor], *,
                             beta: float, one_minus: float, lr: float,
                             eps: float, clip: float
                             ) -> Tuple[DTensor, Dict[str, DTensor]]:
    """The kernel on the local blocks of a DTensor gradient placed by Shard
    and Replicate; each factor is taken on the blocks that match g's (a
    row factor replicated over the mesh dims that split g's last dim, a
    column factor over those that split its second last) and returned in
    its own layout. The update is a DTensor laid out as g."""
    mesh, places, nd = g.device_mesh, tuple(g.placements), g.dim()
    split = {}    # mesh dim -> the leaf's dim it splits
    for i, p in enumerate(places):
        if type(p) is Shard:
            split[i] = p.dim % nd
        elif not isinstance(p, Replicate):
            raise ValueError(f"adafactor_update: a gradient placed "
                             f"{places}; the kernel takes Shard and "
                             f"Replicate")
    if "full" in v:
        want = {"full": places}
    else:
        want = {"row": tuple(Replicate() if split.get(i) == nd - 1 else p
                             for i, p in enumerate(places)),
                "col": tuple(Replicate() if split.get(i) == nd - 2
                             else Shard(nd - 2) if split.get(i) == nd - 1
                             else p for i, p in enumerate(places))}
    groups = {"C": [mesh.get_group(i) for i, d in split.items()
                    if d == nd - 1],
              "R": [mesh.get_group(i) for i, d in split.items()
                    if d == nd - 2],
              "N": [mesh.get_group(i) for i in split]}

    def sum_over(over: str, t: torch.Tensor) -> None:
        for group in groups[over]:
            dist.all_reduce(t, group=group)

    g_local = aligned(g.to_local())
    v_local = {k: _placed(t, want[k]).to_local().contiguous()
               for k, t in v.items()}
    _check(g_local, v_local)
    out, new = _run(g_local, v_local, tuple(g.shape), sum_over, beta=beta,
                    one_minus=one_minus, lr=lr, eps=eps, clip=clip)
    out = DTensor.from_local(out, mesh, places, run_check=False,
                             shape=g.shape, stride=g.stride())
    return out, {k: like(DTensor.from_local(
        t, mesh, want[k], run_check=False, shape=v[k].shape,
        stride=v[k].stride()), v[k]) for k, t in new.items()}
