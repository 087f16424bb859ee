"""``adafactor_device_ms`` on synthetic traces: the device time of the
operations named ``adafactor_`` over the profiled steps, and nothing where
none ran (a program without the kernel) or on a round's readings."""

from types import SimpleNamespace

import pytest

from fedbench import harness, tracing

KERNEL = ("void (anonymous namespace)::adafactor_factored_u<__nv_bfloat16, "
          "true, true>(__nv_bfloat16 const*, float const*)")


def _readings(ops, kind="train", units=2):
    prof = tracing.Profiled(1.0, [tracing.Op(n, t0, t1) for n, t0, t1 in ops],
                            [])
    return SimpleNamespace(kind=kind, profiled=prof, profiled_units=units)


@pytest.mark.parametrize("ops,kind,want", [
    ([(KERNEL, 0.0, 1500.0), ("nvjet_tst_192x192", 1500.0, 9000.0),
      ("adafactor_factor_sums<float, true>", 9000.0, 9500.0)], "train", 1.0),
    ([("nvjet_tst_192x192", 0.0, 9000.0)], "train", None),
    ([(KERNEL, 0.0, 1500.0)], "round", None),
])
def test_adafactor_device_ms_reads_the_kernel_only(ops, kind, want):
    got = harness.load_reader("adafactor_device_ms").read(
        _readings(ops, kind))
    assert got == (None if want is None else pytest.approx(want))
