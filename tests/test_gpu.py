"""Tests that need an NVIDIA GPU: the DP against the ksw2 oracle and one
golden run, compiled for the card. They skip elsewhere; on a card run

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py

(phase (f) of chip_smoke.py runs them too)."""

import os

import jax
import pytest

from gsalign_tpu.config import AlignConfig
from gsalign_tpu.genome.packing import pack_genome
from gsalign_tpu.index.fmindex import build_fmindex
from gsalign_tpu.ops import dp as dp_ops
from gsalign_tpu.pipeline.align import compare_genomes
from tests.make_testdata import make_pair
from tests.test_dp_oracle import load_cases, run_batch

pytestmark = pytest.mark.gpu

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


def test_gpu_dp_matches_ksw2_oracle(gpu):
    cases, outs = load_cases()
    rows = run_batch(cases, dp_ops.dp_align_batch, 256)
    for i, ((e1, e2), (g1, g2)) in enumerate(zip(outs, rows)):
        assert g1 == e1 and g2 == e2, f"case {i}"


def test_gpu_default_mode_golden(gpu, tmp_path):
    from chip_smoke import golden_diffs
    ref, qry = make_pair(total_len=100_000)
    fm = build_fmindex(pack_genome(ref))
    prefix = str(tmp_path / "d")
    compare_genomes(fm, qry, AlignConfig(), output_prefix=prefix,
                    verbose=False)
    assert golden_diffs(prefix, "g_default", ("maf", "vcf")) == []
