"""``ssd_device_ms`` on synthetic traces: the device time of the operations
named ``ssd_`` over the profiled steps, and nothing where none ran (a
program whose scan is the plain chunk loop) or on a round's readings."""

from types import SimpleNamespace

import pytest

from fedbench import harness, tracing

FORWARD = ("void (anonymous namespace)::ssd_output<128>(__nv_bfloat16 "
           "const*, float const*, __nv_bfloat16 const*, float const*)")
BACKWARD = "void (anonymous namespace)::ssd_bwd_chunk<128>(float const*)"
PLAIN = ("void at::native::elementwise_kernel<128, 4>(int, "
         "at::native::gpu_kernel_impl<where_kernel>)")


def _readings(ops, kind="train", units=2):
    prof = tracing.Profiled(1.0, [tracing.Op(n, t0, t1) for n, t0, t1 in ops],
                            [])
    return SimpleNamespace(kind=kind, profiled=prof, profiled_units=units)


@pytest.mark.parametrize("ops,kind,want", [
    ([(FORWARD, 0.0, 1500.0), ("nvjet_tst_192x192", 1500.0, 9000.0),
      (BACKWARD, 9000.0, 11500.0)], "train", 2.0),
    ([(PLAIN, 0.0, 9000.0), ("nvjet_tst_192x192", 9000.0, 9500.0)],
     "train", None),
    ([(FORWARD, 0.0, 1500.0)], "round", None),
])
def test_ssd_device_ms_reads_the_kernels_only(ops, kind, want):
    got = harness.load_reader("ssd_device_ms").read(_readings(ops, kind))
    assert got == (None if want is None else pytest.approx(want))
