"""CUDA kernel: one Lloyd iteration's statistics (assign + deviation sums).

Twin of ``repro/kernels/lloyd_update.py`` (the Pallas ``_update_kernel``).
The kernel is ``csrc/lloyd_update.cu``; its plain version is
``ref.lloyd_update_ref``. Both compute, for each of P problems,

    codes[i]  = argmax_l (2·x_i·c_l − ‖c_l‖²)    over valid centroids
    dsums[l]  = Σ_i w_i·1[codes_i = l]·(x_i − c_l)
    counts[l] = Σ_i w_i·1[codes_i = l]

x is f32 or bf16 (the kernel upcasts in registers, exactly); the weights
and the centroid mask are optional (None: every weight 1, every centroid
valid), and the kernel then reads neither.

Three routes, picked by ``row_route``: ``d8`` (D = 8, L in ``D8_L``, x
16-byte aligned: persistent blocks stream whole rows into registers, sums
per thread in shared memory, an xor-shuffle tree per warp), ``generic``
(any D, L up to ``generic_max_l``: tiles in shared memory with the whole
codebook, one owner thread per output; above ``D_TILE`` dims a block per
chunk of ``D_TILE`` dims) and ``tiled`` (any D, any larger L: the codes
first, then blocks of a centroid tile by a chunk of dims by a row range
that bucket each row tile by code, one owner per output adding its
bucket's rows). Chunks of dims split the outputs, never a sum, so the
order of every sum is the same at any D. All write per-block partials that a last pass adds in
block order: no atomics, so a run is bitwise the run before it.
``lloyd_layout`` gives a call's route and grid, and
``lloyd_update_in_kernel_order`` sums the plain version's terms in that
route's order, which the kernel meets bit for bit (given the same codes
and 0/1 weights); ``tiled`` sums in ``generic``'s order.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, ref

ROWS_PER_BLOCK = 1024   # generic and tiled routes: 4 tiles of 256 rows
#                         per block
D8_THREADS = 128        # d8 route: consumer threads per block
D8_TILE = 4 * D8_THREADS  # d8 route: rows per tile, 4 per thread
D8_MIN_TILES = 2        # d8 route: tiles a block takes at least, where the
#                         problem has them (measured on an H100, PERF.md)
D8_L = (2, 4, 8, 16)    # the d8 route's compiled codebook sizes
TILE_L = 64             # tiled route: centroids a tile (csrc/assign.cuh's
#                         kLTile)
D_TILE = 64             # generic and tiled routes: dims a chunk
#                         (csrc/assign.cuh's kDTile)
GENERIC_MIN_BLOCKS = 2  # generic route: blocks it keeps resident per SM
#                         at D = D_TILE; above the L where it cannot, tiled

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
ROUTE_IDS = {"generic": 0, "d8": 1, "tiled": 2}   # the launchers' route


class Layout(NamedTuple):
    """A launch's route and grid, which fix its summation order."""
    route: str      # "d8", "generic" or "tiled"
    rows: int       # d8: rows per tile; generic, tiled: rows per block
    blocks: int     # blocks per problem (tiled: row ranges per problem,
    #                 each taken by one block per tile of centroids)
    threads: int = D8_THREADS   # d8: consumer threads per block


def d8_rows(x: torch.Tensor, num_centroids: int) -> bool:
    """Whether the d8 routes take x and L: rows of 8 values, L in ``D8_L``
    and an x whose address is a multiple of 16 bytes (what 16-byte loads
    and bulk copies take)."""
    return x.shape[-1] == 8 and num_centroids in D8_L \
        and x.data_ptr() % 16 == 0


@functools.lru_cache(maxsize=None)
def _generic_max_l(device: int) -> int:
    lib = _build.load("lloyd_update", "lloyd_update_generic_max_l",
                      [ctypes.c_int] * 2)
    with torch.cuda.device(device):
        return lib.lloyd_update_generic_max_l(D_TILE, GENERIC_MIN_BLOCKS)


def generic_max_l(device: torch.device) -> int:
    """The largest L the generic route takes on this card: the largest at
    which a generic block at D = D_TILE still leaves ``GENERIC_MIN_BLOCKS``
    resident per SM, as the library works it out from the block's shared
    memory and the card's (89 on an H100). A block's shared memory is
    largest at D = D_TILE (above it, a block holds one chunk of D_TILE
    dims), so the threshold holds at every D and a call's route depends on
    L alone. Asked once per card, before any
    graph capture."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _generic_max_l(index)


def row_route(x: torch.Tensor, num_centroids: int) -> str:
    """lloyd_update's route: ``"d8"`` where ``d8_rows``; ``"generic"`` for L
    up to one tile of the tiled route (``TILE_L``: there the tiled route
    would add a pass and gain nothing, so the card is not asked) and above
    it up to ``generic_max_l``; ``"tiled"`` for any larger L."""
    if d8_rows(x, num_centroids):
        return "d8"
    if num_centroids <= TILE_L or num_centroids <= generic_max_l(x.device):
        return "generic"
    return "tiled"


def d8_blocks(p: int, n: int, sms: int, per_sm: int, tile: int,
              min_tiles: int) -> int:
    """Blocks per problem of a d8 grid with tiles of ``tile`` rows: the
    card's resident blocks shared among the P problems, but no fewer than
    ``min_tiles`` tiles a block where the problem has them (a block's
    set-up, and the ring's first fill, are paid per block), and at least
    1."""
    tiles = -(-n // tile)
    return max(1, min(-(-tiles // min_tiles), sms * per_sm // max(p, 1)))


@functools.lru_cache(maxsize=None)
def occupancy(lib_name: str, fn: str, device: int, *args: int) -> int:
    """Resident blocks per SM of a persistent kernel's instance, as the
    CUDA runtime reports it (``fn(*args)`` of the library, the instance's
    template arguments as ints); asked once per instance and card, before
    any graph capture."""
    lib = _build.load(lib_name, fn, [ctypes.c_int] * len(args))
    with torch.cuda.device(device):
        per_sm = getattr(lib, fn)(*args)
    if per_sm < 1:
        raise RuntimeError(f"{lib_name}: no instance {fn}{args} fits an SM")
    return per_sm


def device_sms(x: torch.Tensor) -> tuple[int, int]:
    """(device index, SM count) of the card x lies on."""
    dev = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    return dev, torch.cuda.get_device_properties(dev).multi_processor_count


def d8_grid(lib_name: str, fn: str, x: torch.Tensor, num_centroids: int,
            tile: int, min_tiles: int) -> int:
    """Blocks per problem of a d8 launch on x's card. The f32 and the bf16
    instance get the same grid (the fewer resident blocks of the two), so
    that a bf16 x sums in the order of its f32 upcast."""
    p, n, _ = x.shape
    dev, sms = device_sms(x)
    per_sm = min(occupancy(lib_name, fn, dev, num_centroids, bf16)
                 for bf16 in (0, 1))
    return d8_blocks(p, n, sms, per_sm, tile, min_tiles)


def lloyd_layout(x: torch.Tensor, num_centroids: int) -> Layout:
    """The route and grid ``lloyd_update_kernel`` launches for this x (on
    its card) and L."""
    route = row_route(x, num_centroids)
    if route != "d8":
        return Layout(route, ROWS_PER_BLOCK,
                      -(-x.shape[1] // ROWS_PER_BLOCK))
    return Layout("d8", D8_TILE,
                  d8_grid("lloyd_update", "lloyd_update_d8_occupancy", x,
                          num_centroids, D8_TILE, D8_MIN_TILES),
                  D8_THREADS)


def check_cuda_inputs(name: str, x: torch.Tensor, centroids: torch.Tensor,
                      lmask: Optional[torch.Tensor],
                      weights: Optional[torch.Tensor] = None) -> None:
    """What the CUDA kernels take, on one CUDA device, all contiguous: x
    (P, N, D) f32 or bf16, centroids (P, L, D) f32, lmask (L,) f32 or None,
    weights (P, N) f32 or None; any D >= 1, any L >= 1."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {x.device}")
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (P, N, D) f32 or "
                         f"bf16 tensor; got {x.dtype} {tuple(x.shape)} "
                         f"(contiguous={x.is_contiguous()})")
    for t in (centroids, lmask, weights):
        if t is not None and (t.device != x.device
                              or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: centroids, lmask and weights must be "
                             f"contiguous f32 tensors on {x.device}; got "
                             f"{t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    p, n, d = x.shape
    if centroids.dim() != 3 or centroids.shape[0] != p \
            or centroids.shape[2] != d \
            or (lmask is not None and lmask.shape != centroids.shape[1:2]) \
            or (weights is not None and weights.shape != (p, n)):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, centroids "
                         f"{tuple(centroids.shape)}, lmask "
                         f"{None if lmask is None else tuple(lmask.shape)}, "
                         f"weights "
                         f"{None if weights is None else tuple(weights.shape)}"
                         f" do not match")
    if d < 1 or centroids.shape[1] < 1:
        raise ValueError(f"{name}: the kernel takes D >= 1 and L >= 1; got "
                         f"D={d}, L={centroids.shape[1]}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def lloyd_update_kernel(x: torch.Tensor, weights: Optional[torch.Tensor],
                        centroids: torch.Tensor,
                        lmask: Optional[torch.Tensor] = None):
    """x (P, N, D) f32 or bf16, weights (P, N) or None (all 1), centroids
    (P, L, D), lmask (L,) or None (all valid).

    Returns (dsums (P, L, D) f32, counts (P, L) f32)."""
    if x.device.type == "cpu":
        return ref.lloyd_update_ref(x, weights, centroids, lmask)
    check_cuda_inputs("lloyd_update", x, centroids, lmask, weights)
    p, n, d = x.shape
    l = centroids.shape[1]
    lay = lloyd_layout(x, l)
    lib = _build.load("lloyd_update", "lloyd_update_launch", _ARGTYPES)
    partials = torch.empty((p, lay.blocks, l * (d + 1)), device=x.device,
                           dtype=torch.float32)
    codes = torch.empty((p, n), device=x.device, dtype=torch.int32) \
        if lay.route == "tiled" else None
    dsums = torch.empty((p, l, d), device=x.device, dtype=torch.float32)
    counts = torch.empty((p, l), device=x.device, dtype=torch.float32)
    rc = lib.lloyd_update_launch(
        x.data_ptr(), _ptr(weights), centroids.data_ptr(), _ptr(lmask),
        _ptr(codes), partials.data_ptr(), dsums.data_ptr(),
        counts.data_ptr(), p, n, l, d, ROUTE_IDS[lay.route],
        int(x.dtype == torch.bfloat16), lay.rows, lay.blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lloyd_update: launch failed with CUDA error "
                           f"{rc}")
    _build.count("lloyd_update")
    return dsums, counts


def _terms(x, weights, centroids, lmask):
    """Each row's contribution (..., N, L, D+1): w·(x − c_code) and w in
    the row's code slot, exactly 0 elsewhere."""
    codes, _ = ref.kmeans_assign_ref(x, centroids, lmask)
    cf = centroids.float()
    w = torch.ones(codes.shape, device=x.device) if weights is None \
        else weights.float()
    onehot = torch.nn.functional.one_hot(codes, cf.shape[-2]).float()
    delta = w.unsqueeze(-1) * (x.float() - ref._gather_rows(cf, codes))
    row = torch.cat([delta, w.unsqueeze(-1)], -1)            # (.., N, D+1)
    return onehot.unsqueeze(-1) * row.unsqueeze(-2)


def lloyd_update_in_kernel_order(x: torch.Tensor,
                                 weights: Optional[torch.Tensor],
                                 centroids: torch.Tensor,
                                 lmask: Optional[torch.Tensor],
                                 layout: Layout):
    """The plain version, summed in the order of a launch with ``layout``.

    d8: block b takes tiles b, b + blocks, ... of ``rows`` rows, thread t
    of its ``threads`` rows t, t + threads, ... of each tile, and adds them
    in row order; the 32 lanes of a warp add by an xor tree (offsets 16,
    8, 4, 2, 1); the warps' sums are added in warp order, and the blocks'
    in block order. generic and tiled: each block of ``rows`` rows adds
    its rows one at a time in row order, then the blocks in block order;
    a row adds its term to its code's sums only (an exact 0 added to the
    others would change none of them), so no (P, N, L, D+1) tensor of
    terms is made. For 0/1 weights every term is exact, so in f32 this
    gives the kernel's dsums and counts bit for bit, given the same
    codes."""
    p, n, _ = x.shape
    if layout.route != "d8":
        codes, _ = ref.kmeans_assign_ref(x, centroids, lmask)
        w = torch.ones(codes.shape, device=x.device) if weights is None \
            else weights.float()
        delta = w.unsqueeze(-1) * (x.float()
                                   - ref._gather_rows(centroids.float(),
                                                      codes))
        row = torch.cat([delta, w.unsqueeze(-1)], -1)         # (P, N, D+1)
        nb = -(-n // layout.rows)
        pad = nb * layout.rows - n
        row = torch.nn.functional.pad(row, (0, 0, 0, pad)).reshape(
            p, nb, layout.rows, -1)
        codes = torch.nn.functional.pad(codes, (0, pad)).reshape(
            p, nb, layout.rows)
        part = torch.zeros((p, nb, centroids.shape[-2], row.shape[-1]),
                           device=x.device)
        pi = torch.arange(p, device=x.device)[:, None]
        bi = torch.arange(nb, device=x.device)[None, :]
        for r in range(layout.rows):
            c = codes[:, :, r]
            part[pi, bi, c] = part[pi, bi, c] + row[:, :, r]
    else:
        t, nb = layout.threads, layout.blocks
        per = layout.rows // t              # rows of a thread in a tile
        g = layout.rows * nb                # rows one sweep of the grid takes
        lane = torch.arange(32, device=x.device)
        acc = None
        for j0 in range(0, max(n, 1), g):
            j1 = min(j0 + g, n)
            w = None if weights is None else weights[:, j0:j1]
            terms = _terms(x[:, j0:j1], w, centroids, lmask)
            terms = torch.nn.functional.pad(
                terms, (0, 0, 0, 0, 0, g - (j1 - j0))
            ).reshape(p, nb, per, t, *terms.shape[2:])
            for r in range(per):
                acc = terms[:, :, r] if acc is None else acc + terms[:, :, r]
        acc = acc.reshape(p, nb, t // 32, 32, *acc.shape[3:])
        for off in (16, 8, 4, 2, 1):
            acc = acc + acc[:, :, :, lane ^ off]
        warps = acc[:, :, :, 0]                               # (P, nb, W, ..)
        part = warps[:, :, 0]
        for wi in range(1, t // 32):
            part = part + warps[:, :, wi]
    total = torch.zeros_like(part[:, 0])
    for b in range(part.shape[1]):
        total = total + part[:, b]
    return total[..., :-1], total[..., -1]
