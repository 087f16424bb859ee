"""Tensor-tree checkpointing to .npz (twin of
``repro/checkpointing/checkpoint.py``).

A tree is a nested dict whose leaves are tensors (on any device), numpy
arrays or Python scalars. Save copies every tensor leaf to the host and
waits for the card once, flattens the tree with '/'-joined key paths and
stores it in one npz per step. The members are stored, not deflated as
the reference's ``savez_compressed`` deflates them: ``np.load`` reads
both, and deflating a full-width FEMNIST snapshot (27 MB, mostly float
error-feedback memories, which deflate by a third) takes seconds of host
time against rounds of milliseconds on the card (``chip_smoke.py``'s
recovery phase prints both). Restore rebuilds the tree with every leaf a
tensor on the requested device (``"cuda"`` unless the caller asks for
another; without a card and without ``device="cpu"`` it raises, as the
trainer does).

The on-disk format is the reference's, name for name, so each package
restores a step the other wrote: ``ckpt_<step:08d>.npz``; bfloat16,
which numpy cannot hold, stored as its unsigned-int bit view plus a
``__dtype__<path>`` entry naming the dtype; ``meta_<step>.json``
for the caller's host-side extras; ``manifest_<step>.json`` last.

Crash consistency: every file lands via write-to-tmp + ``os.replace``
(POSIX rename is atomic within a filesystem), and each step additionally
writes a ``manifest_<step>.json`` — LAST, after every payload file it
names — carrying the sha256 of each payload. A step is only *visible* (to
`latest_step` / `restore_checkpoint`) once its manifest exists, so a
process killed mid-save leaves at most an orphaned ``.tmp`` or an
unreferenced npz, never a restorable-but-corrupt step. Restore re-hashes
the payload against the manifest and raises `CheckpointError` on any
mismatch, truncation, or unreadable archive. Pre-manifest checkpoints
(bare npz) still restore, with hash verification skipped.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import obs

_SEP = "/"
_DTYPE = "__dtype__"

# tensor dtypes numpy has no dtype for: stored as the unsigned-int view of
# their bits, under the name the reference's ml_dtypes gives them
_BIT_VIEWS = {
    torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
}
_BY_NAME = {name: (dt, signed) for dt, (name, signed, _) in
            _BIT_VIEWS.items()}


class CheckpointError(RuntimeError):
    """A checkpoint failed verification: partial write, corrupt payload,
    or a manifest/payload mismatch."""


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat):
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _to_host(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Every leaf on the host: each card tensor's copy is queued on its
    stream (into pinned memory), then the host waits for the card once."""
    out: Dict[str, Any] = {}
    on_card = False
    for k, v in flat.items():
        if torch.is_tensor(v):
            v = v.detach()
            if v.dtype in _BIT_VIEWS:
                v = v.view(_BIT_VIEWS[v.dtype][1])
            on_card |= v.device.type == "cuda"
            v = v.to("cpu", non_blocking=True)
        out[k] = v
    if on_card:
        torch.cuda.synchronize()
    return out


def _encode(v, dtype: Optional[torch.dtype]):
    """(npz array, dtype name or "") of one host leaf."""
    if dtype in _BIT_VIEWS:
        name, _, unsigned = _BIT_VIEWS[dtype]
        return v.numpy().view(unsigned), name
    return (v.numpy() if torch.is_tensor(v) else np.asarray(v)), ""


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _json_default(o):
    """Meta dicts routinely carry numpy scalars (trace counters, cursor
    times); store them as their Python equivalents."""
    if isinstance(o, np.generic):
        return o.item()
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


def _write_atomic(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _manifest_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"manifest_{step:08d}.json")


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    with obs.span("checkpoint.save", cat="io", step=step):
        os.makedirs(ckpt_dir, exist_ok=True)
        leaves = _flatten(tree)
        dtypes = {k: v.dtype for k, v in leaves.items()
                  if torch.is_tensor(v)}
        flat = {}
        for k, v in _to_host(leaves).items():
            arr, dtname = _encode(v, dtypes.get(k))
            flat[k] = arr
            if dtname:
                flat[f"{_DTYPE}{k}"] = np.asarray(dtname)
        path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
        tmp = path + ".tmp.npz"  # .npz suffix so numpy does not append one
        np.savez(tmp, **flat)
        with open(tmp, "rb") as f:   # flush page cache before the rename
            os.fsync(f.fileno())
        os.replace(tmp, path)
        files = {os.path.basename(path): _sha256(path)}
        if extra is not None:
            meta = os.path.join(ckpt_dir, f"meta_{step:08d}.json")
            _write_atomic(meta,
                          json.dumps(extra, default=_json_default).encode())
            files[os.path.basename(meta)] = _sha256(meta)
        # the commit point: the manifest lands LAST, after every file it
        # names — a step without one is invisible, never half-restored
        manifest = {"step": step, "files": files}
        _write_atomic(_manifest_path(ckpt_dir, step),
                      json.dumps(manifest).encode())
        return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest *committed* step: manifest-backed when any manifest
    exists, falling back to bare npz files (pre-manifest checkpoints)."""
    if not os.path.isdir(ckpt_dir):
        return None
    names = os.listdir(ckpt_dir)
    steps = [int(m.group(1)) for f in names
             if (m := re.match(r"manifest_(\d+)\.json$", f))]
    if steps:
        return max(steps)
    steps = [int(m.group(1)) for f in names
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def verify_checkpoint(ckpt_dir: str, step: int) -> None:
    """Raise `CheckpointError` unless step's manifest matches its payloads
    byte for byte. No-op (nothing to verify against) without a manifest."""
    mpath = _manifest_path(ckpt_dir, step)
    if not os.path.exists(mpath):
        return
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        files = manifest["files"]
    except (json.JSONDecodeError, KeyError, OSError) as e:
        raise CheckpointError(f"unreadable manifest {mpath}: {e}") from e
    for name, digest in files.items():
        path = os.path.join(ckpt_dir, name)
        if not os.path.exists(path):
            raise CheckpointError(f"manifest names missing file {path}")
        actual = _sha256(path)
        if actual != digest:
            raise CheckpointError(
                f"checksum mismatch for {path}: manifest {digest[:12]}…, "
                f"file {actual[:12]}… — partial or corrupt write")


def _decode(a: np.ndarray, dtname: Optional[str]) -> torch.Tensor:
    if dtname is None:
        return torch.from_numpy(a)
    if dtname not in _BY_NAME:
        raise CheckpointError(f"unknown stored dtype {dtname!r}")
    dtype, signed = _BY_NAME[dtname]
    return torch.from_numpy(a).view(signed).view(dtype)


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       device: Any = None) -> Any:
    """The tree saved at ``step`` (default: the newest committed one),
    every leaf a tensor on ``device`` (default ``"cuda"``; the reference's
    ``shardings`` slot)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "restore_checkpoint restores onto the card by default and this "
            "machine has no CUDA device; pass device='cpu'")
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    with obs.span("checkpoint.restore", cat="io", step=step):
        verify_checkpoint(ckpt_dir, step)
        path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
        try:
            with np.load(path) as z:
                dtypes = {k[len(_DTYPE):]: str(z[k]) for k in z.files
                          if k.startswith(_DTYPE)}
                flat = {k: _decode(z[k], dtypes.get(k)) for k in z.files
                        if not k.startswith(_DTYPE)}
        except (zipfile.BadZipFile, ValueError, EOFError, OSError) as e:
            raise CheckpointError(f"corrupt checkpoint {path}: {e}") from e
        return _unflatten({k: v.to(device) for k, v in flat.items()})
