"""Full-scale int64 ("wide") index end-to-end: build a synthetic genome
with 2N > 2^31 (the regime the reference handles via 64-bit bwtint_t,
src/BWT_Index/bwt.h:36-40) and align query slices against it through the
whole pipeline.

Gated behind GSALIGN_BIG=1: the build alone is ~6 min and tens of GB of
RAM. Run manually: GSALIGN_BIG=1 python -m pytest tests/test_wide_e2e.py -s
Its last recorded run is in docs/SCALING_3GB.md (item 4).
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    not os.environ.get("GSALIGN_BIG"),
    reason="multi-GB wide-index run; set GSALIGN_BIG=1")

GENOME_LEN = 1_080_000_000          # 2N = 2.16e9 > 2^31


@pytest.fixture(scope="module")
def wide_fm():
    import time
    from gsalign_tpu.genome.packing import Genome
    from gsalign_tpu.index.fmindex import build_fmindex
    rng = np.random.default_rng(40)
    codes = rng.integers(0, 4, GENOME_LEN, dtype=np.int64).astype(np.uint8)
    g = Genome(names=["big1"], lengths=np.asarray([GENOME_LEN]),
               offsets=np.asarray([0]), holes=[], codes_fwd=codes)
    t0 = time.time()
    fm = build_fmindex(g)
    import resource
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"\n[wide] index build ({2 * GENOME_LEN} rows): "
          f"{time.time() - t0:.0f}s, sa_intv={fm.sa_intv}, "
          f"peak RSS {rss_gb:.1f} GB")
    assert fm.seq_len == 2 * GENOME_LEN > (1 << 31)
    assert fm.rank_dtype == np.int64
    return fm


def _mutate(sl, rng, rate=0.005):
    out = sl.copy()
    subs = rng.random(len(out)) < rate
    out[subs] = (out[subs] + rng.integers(1, 4, subs.sum())) % 4
    return out.astype(np.uint8)


def test_wide_seed_coordinates_beyond_2g(wide_fm):
    """RC-strand seeds resolve to r_pos >= 2^31 (int64 coordinates live).

    The query is the RC of the START of the forward genome: a match of
    RC(fwd[j..]) sits at text position 2N - j - len, so the true loci land
    deterministically in the top ~2 Mb of the fwd+RC text — beyond 2^31
    for this genome size. (A slice from the END of fwd mirrors to
    ~N ≈ 1.08e9 < 2^31 and can never satisfy the assertion.)"""
    from gsalign_tpu.ops.rank import DeviceFMIndex
    from gsalign_tpu.ops.seeding import find_seeds
    dfm = DeviceFMIndex.from_host(wide_fm)
    codes = wide_fm.genome.codes_fwd
    rng = np.random.default_rng(7)
    sl = _mutate(codes[:200_000], rng)
    qry = (3 - sl[::-1]).astype(np.uint8)      # RC -> hits in the RC half
    q_pos, r_pos, length = find_seeds(dfm, qry)
    assert len(q_pos) > 100
    assert (r_pos >= (1 << 31)).any(), "no int64-range coordinates seen"
    # verify a few seeds against the text
    text = wide_fm.genome.codes_fwd_rc()
    for i in np.random.default_rng(1).integers(0, len(q_pos), 20):
        qp, rp, ln = int(q_pos[i]), int(r_pos[i]), int(length[i])
        np.testing.assert_array_equal(qry[qp:qp + ln], text[rp:rp + ln])


def test_wide_end_to_end_alignment(wide_fm):
    """compare_genomes over a mutated 2 Mb slice: alignments + variants."""
    import time
    from gsalign_tpu.config import AlignConfig
    from gsalign_tpu.pipeline.align import compare_genomes
    rng = np.random.default_rng(11)
    codes = wide_fm.genome.codes_fwd
    s = 500_000_000
    sl = _mutate(codes[s:s + 2_000_000], rng)
    DNA = np.frombuffer(b"ACGT", dtype=np.uint8)
    qry_records = [("slice_m", DNA[sl])]
    t0 = time.time()
    stats, collector, blocks = compare_genomes(
        wide_fm, qry_records, AlignConfig(), output_prefix="/tmp/wide_e2e",
        verbose=False)
    print(f"[wide] 2Mb align: {time.time() - t0:.0f}s "
          f"ani={stats.ani:.2f} alns={stats.local_alignment_num} "
          f"snv={collector.n_snv}")
    assert stats.local_alignment_num >= 1
    assert stats.ani > 98.5
    assert collector.n_snv > 5000
    with open("/tmp/wide_e2e.maf") as fh:
        head = fh.read(4000)
    assert "big1" in head
