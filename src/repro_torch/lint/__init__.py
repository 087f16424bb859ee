"""fedlint for the port — domain-aware static analysis of the torch and
CUDA code of ``repro_torch`` (the counterpart of ``repro.lint``).

Run it as ``python -m repro_torch.lint [paths...] [--json] [--select
pass,...]`` (default paths: ``src/repro_torch`` and ``chip_smoke.py``).
``tests/test_torch_lint.py`` and ``chip_smoke.py``'s lint phase run it over
the port and fail on ANY finding, so the committed tree carries an empty
baseline. Passes live in a registry mirroring the compressor/executor
registries (``repro_torch.lint.core.register_pass``); ``--select`` picks a
subset by name. The AST and CUDA-source passes are complemented by
dispatch-level helpers (``repro_torch.lint.dispatch``) for what only a run
can show (the host syncs a call makes, the process groups its
collectives use, the gradients a backward gives integer inputs). This
package imports neither jax nor anything of ``repro``.

Rule catalogue
==============

host-sync (``host_sync.py``)
  * ``host-sync-in-step`` — ``.item()``/``.tolist()``/``.cpu()``/
    ``.numpy()``/``torch.cuda.synchronize()``/``float()``/``int()``/
    ``bool()`` of a tensor reachable from an ``nn.Module`` forward, an
    ``autograd.Function`` forward or backward, or ``repro_torch/kernels/``
    (the counterpart of ``host-sync-in-jit``).
  * ``host-sync-in-loop`` — per-iteration sync on a ``make_*step``
    step's output inside a host loop.
  * ``host-sync-in-callback`` — syncs inside per-arrival callbacks (the
    scheduler's ``execute=`` path); serializes every round.
  * ``raw-timing-in-hot-path`` — ``time.perf_counter()``/``print()`` in
    ``repro_torch/federated`` or ``repro_torch/core``.
  The reference's ``jit-closure-rebuild`` and ``jit-static-args`` are
  dropped: the port has no jit cache and no ``torch.compile`` call.

autograd-function (``vjp.py``)
  * ``autograd-staticmethod`` — ``forward``/``backward``/
    ``setup_context`` must be ``@staticmethod``s.
  * ``autograd-missing-backward`` — a Function with no ``backward``.
  * ``autograd-bwd-arity`` — ``backward`` takes ``ctx`` plus one gradient
    per forward output (where forward returns a literal tuple).
  * ``autograd-bwd-return-arity`` — ``backward`` returns one entry per
    forward input after ``ctx``, ``None`` where it takes no gradient.

mesh-axes (``mesh_axes.py``)
  * ``mesh-axis-undeclared`` — dimension names used in ``P(...)``,
    ``shard()``, ``local()``, ``axis_size``/``axis_rank``, ``mesh[...]``
    and ``mesh.get_group(...)`` are cross-checked against every name
    declared anywhere in the linted tree (``mesh_dim_names=``, ``*_AXIS``
    constants, ``axes = (...)``).

cuda (``cuda_checks.py``; reads ``.cu``/``.cuh`` and Python)
  * ``cuda-fp32-atomic`` — no floating-point ``atomicAdd`` or PTX
    ``red``/``atom`` add: kill-and-resume is bitwise.
  * ``cuda-launcher-contract`` — every ``extern "C"`` launcher takes a
    stream and returns an error, every ``<<<…>>>`` passes that stream as
    its fourth argument, every launch is followed by
    ``cudaGetLastError()``.
  * ``cuda-launcher-alloc-sync`` — no ``cudaMalloc``/``cudaFree``/
    synchronous ``cudaMemcpy``/``*Synchronize`` in a CUDA source.
  * ``cuda-int-index`` — a kernel's pointer offset multiplying two
    non-literal ``int``s before a ``size_t``/``int64_t`` cast.
  * ``cuda-vector-alignment`` — a launcher reaching a 16-byte access
    (``float4``/``uint4``/``cp.async`` 16/bulk copy) without an
    alignment test of a pointer.
  * ``cuda-smem-budget`` — literal ``__shared__`` arrays above 48 KiB,
    literal dynamic shared memory above 227 KiB a block.
  * ``kernel-fallback`` — an ``except`` body in ``repro_torch/`` calling
    into ``kernels/ref.py`` (the counterpart of
    ``pallas-interpret-hardcoded``).

fleet-scale (``fleet_loops.py``)
  * ``python-loop-over-fleet`` — a ``for``/comprehension over a
    fleet- or arrival-sized sequence in ``repro_torch/federated/``.

obs-events (``obs_events.py``)
  * ``orphan-obs-event`` — an ``obs.event(...)`` in
    ``repro_torch/federated/`` with a literal name missing from
    ``repro_torch.obs.schema.EVENT_SCHEMAS``.
  * ``dynamic-obs-event`` — a computed (non-literal) event name.

wire-decode (``wire_decode.py``)
  * ``unchecked-wire-decode`` — a ``decode_bytes``/``decode_payload``/
    ``decode_pq_delta`` call in ``repro_torch/federated/`` outside a
    ``try`` catching the `WireError` hierarchy.

wire-format (``wire_checks.py``)
  * ``wire-kind-no-encoder`` / ``wire-kind-no-decoder`` /
    ``wire-unknown-kind-guard`` — as in the reference.
  * ``wire-version-stale`` — the hash of each ``encode_*`` body is pinned
    with its version literal in the port's own ``wire_manifest.json``
    (beside this file); the hash reads the same under Python 3.10-3.13.

Suppressions
============

  * same line:  ``x = float(loss)  # fedlint: disable=host-sync-in-loop``
  * every rule: ``# fedlint: disable=all``
  * whole file: ``# fedlint: disable-file=<rule>[,<rule>...]``
  * in a CUDA source: the same with ``//``.

A suppression is a reviewed decision that lands in the diff; an
unsuppressed finding fails the gate.
"""

from repro_torch.lint.core import (Finding, LintPass, available_passes,
                                   findings_to_json, register_pass,
                                   rule_catalogue, run_lint)

# importing the pass modules registers them
from repro_torch.lint import cuda_checks as _cuda_checks
from repro_torch.lint import fleet_loops as _fleet_loops
from repro_torch.lint import host_sync as _host_sync
from repro_torch.lint import mesh_axes as _mesh_axes
from repro_torch.lint import obs_events as _obs_events
from repro_torch.lint import vjp as _vjp
from repro_torch.lint import wire_checks as _wire_checks
from repro_torch.lint import wire_decode as _wire_decode

register_pass("autograd-function", _vjp.AutogradFunctionPass)
register_pass("cuda", _cuda_checks.CudaPass)
register_pass("fleet-scale", _fleet_loops.FleetLoopPass)
register_pass("host-sync", _host_sync.HostSyncPass)
register_pass("mesh-axes", _mesh_axes.MeshAxesPass)
register_pass("obs-events", _obs_events.ObsEventPass)
register_pass("wire-format", _wire_checks.WirePass)
register_pass("wire-decode", _wire_decode.WireDecodePass)

DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")

__all__ = ["DEFAULT_PATHS", "Finding", "LintPass", "available_passes",
           "findings_to_json", "register_pass", "rule_catalogue", "run_lint"]
