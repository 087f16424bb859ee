"""``moe_device_ms`` on synthetic traces: the device time of the operations
named ``moe_`` over the profiled steps, and nothing where none ran (a
program whose MoE takes the plain route) or on a round's readings."""

from types import SimpleNamespace

import pytest

from fedbench import harness, tracing

GATHER = ("void (anonymous namespace)::moe_slot_gather<__nv_bfloat16, "
          "false>(__nv_bfloat16 const*, int const*, float const*)")
REDUCE = ("void (anonymous namespace)::moe_token_reduce<__nv_bfloat16, "
          "true>(__nv_bfloat16 const*, long long const*)")
PLAIN = ("void at::native::index_elementwise_kernel<128, 4>(long, "
         "at::native::gpu_index_kernel<index_put_kernel_impl>)")


def _readings(ops, kind="train", units=2):
    prof = tracing.Profiled(1.0, [tracing.Op(n, t0, t1) for n, t0, t1 in ops],
                            [])
    return SimpleNamespace(kind=kind, profiled=prof, profiled_units=units)


@pytest.mark.parametrize("ops,kind,want", [
    ([(GATHER, 0.0, 1500.0), ("nvjet_tst_192x192", 1500.0, 9000.0),
      (REDUCE, 9000.0, 11500.0)], "train", 2.0),
    ([(PLAIN, 0.0, 9000.0), ("nvjet_tst_192x192", 9000.0, 9500.0)],
     "train", None),
    ([(GATHER, 0.0, 1500.0)], "round", None),
])
def test_moe_device_ms_reads_the_kernels_only(ops, kind, want):
    got = harness.load_reader("moe_device_ms").read(_readings(ops, kind))
    assert got == (None if want is None else pytest.approx(want))
