"""The quantizer's stage is held to the reference's own k-means: where
the reference follows the program's quantizer decisions, a quantizer that
runs one Lloyd iteration fewer, seeds by kmeans++ instead of
farthest-point, or ships codebooks rounded below the cut's dtype comes out
not correct through ``compare.decide``; the sound program agrees with the
reference's own seeding and Lloyd run row for row on the CPU."""

import pytest

from fedbench import compare
from fedbench.drivers import federated_rounds, lm_train
from fedbench.tests.test_fedbench_reference import (CPU, LM, femnist_cell,
                                                    lm_cell)

PQ_CELLS = ["femnist.fullsync", "femnist.q288_L32", LM]
QUANTIZER_FAULTS = ["kmeans_iters_minus_1", "kmeans_random_seeds",
                    "codebooks_rounded"]
# the number each fault has to fail
FAILS = {"kmeans_iters_minus_1": "codes_differ_share",
         "kmeans_random_seeds": "codes_differ_share",
         "codebooks_rounded": "codebook_cast_off"}


def readings_of(name, seed, fault=None):
    if name == LM:
        cell = lm_cell()
        prog = lm_train.setup(cell, seed, CPU, fault)[2]
        drv = lm_train
    else:
        cell = femnist_cell(name)
        prog = federated_rounds.setup(cell, seed, CPU, fault)[2]
        drv = federated_rounds
    return cell, drv.reference_readings(cell.config, cell.traffic, seed,
                                        CPU, prog)


@pytest.mark.parametrize("name", PQ_CELLS)
def test_the_quantizer_agrees_with_the_reference_own_kmeans(name):
    cell, readings = readings_of(name, 2 ** 31 + 21)
    assert readings["codes_differ_share"] == 0
    assert readings["centroid_gap"] < 1e-6
    assert readings["codebook_cast_off"] == 0
    assert compare.decide(readings, cell.workload["limits"])[0]


@pytest.mark.parametrize("name,fault", [(n, f) for n in PQ_CELLS
                                        for f in QUANTIZER_FAULTS])
def test_a_planted_quantizer_fault_is_not_correct(name, fault):
    cell, readings = readings_of(name, 2 ** 31 + 22, fault)
    ok, checks = compare.decide(readings, cell.workload["limits"])
    assert not ok, checks
    number = FAILS[fault]
    assert checks[number]["value"] > checks[number]["limit"], checks
