import jax
import numpy as np
import pytest

from gsalign_tpu.genome.packing import Genome
from gsalign_tpu.index.fmindex import build_fmindex
from gsalign_tpu.ops.rank import DeviceFMIndex
from gsalign_tpu.ops.seeding import find_seeds
from tests.helpers import naive_lmem_seeds, random_genome


def make_fm(codes):
    g = Genome(names=["c"], lengths=np.asarray([len(codes)]),
               offsets=np.asarray([0]), holes=[], codes_fwd=codes)
    return build_fmindex(g, sa_intv=8, prefer_device=False)


def mutate(codes, rng, sub_rate=0.01, n_blocks=0):
    out = codes.copy()
    subs = rng.random(len(out)) < sub_rate
    out[subs] = (out[subs] + rng.integers(1, 4, subs.sum())) % 4
    return out.astype(np.uint8)


def _sorted(seeds):
    return sorted(seeds)


@pytest.mark.parametrize("seed,chunk,sensitive,n_segments", [
    (1, 500, False, 1), (2, 300, False, 1), (3, 500, True, 1),
    (4, 500, False, 8), (5, 400, True, 4), (6, 512, False, 16)])
def test_seeding_matches_naive(seed, chunk, sensitive, n_segments):
    rng = np.random.default_rng(seed)
    ref = random_genome(rng, 2000)
    fm = make_fm(ref)
    dfm = DeviceFMIndex.from_host(fm)
    qry = mutate(ref, rng, sub_rate=0.02)
    # insert some ambiguity
    qry[100:103] = 4

    q_pos, r_pos, length = find_seeds(
        dfm, qry, min_seed_length=12, max_seed_freq=100,
        sensitive=sensitive, chunk=chunk, n_segments=n_segments)
    got = _sorted(zip(q_pos.tolist(), r_pos.tolist(), length.tolist()))

    text = fm.genome.codes_fwd_rc()
    expect = _sorted(naive_lmem_seeds(
        text, qry, min_seed_length=12, max_seed_freq=100, chunk=chunk,
        sensitive=sensitive))
    assert got == expect


def test_seeding_output_sorted_by_posdiff():
    rng = np.random.default_rng(9)
    ref = random_genome(rng, 1500)
    fm = make_fm(ref)
    dfm = DeviceFMIndex.from_host(fm)
    qry = mutate(ref, rng, sub_rate=0.01)
    q_pos, r_pos, length = find_seeds(dfm, qry, min_seed_length=12,
                                      chunk=400)
    pd = r_pos - q_pos
    key = list(zip(pd.tolist(), q_pos.tolist()))
    assert key == sorted(key)


def test_seeding_rc_strand():
    """Seeds on the reverse-complement strand are found (rPos >= N)."""
    rng = np.random.default_rng(11)
    ref = random_genome(rng, 800)
    fm = make_fm(ref)
    dfm = DeviceFMIndex.from_host(fm)
    # query = RC of a forward slice -> matches in the RC half of the text
    sl = ref[100:400]
    qry = (3 - sl[::-1]).astype(np.uint8)
    q_pos, r_pos, length = find_seeds(dfm, qry, min_seed_length=12, chunk=500)
    assert len(q_pos) > 0
    assert (r_pos >= fm.genome.size).any()


@pytest.mark.parametrize("cap,sensitive", [(2, False), (5, False), (3, True)])
def test_seeding_emit_overflow_match_naive(cap, sensitive):
    """A tiny emit-buffer cap forces overflow->poison->host-re-scan rounds;
    the seed set must still match the reference scan exactly."""
    rng = np.random.default_rng(77)
    ref = random_genome(rng, 2500)
    fm = make_fm(ref)
    dfm = DeviceFMIndex.from_host(fm)
    qry = mutate(ref, rng, sub_rate=0.02)
    q_pos, r_pos, length = find_seeds(
        dfm, qry, min_seed_length=12, max_seed_freq=100,
        chunk=600, sensitive=sensitive, max_out_cap=cap)
    got = _sorted(zip(q_pos.tolist(), r_pos.tolist(), length.tolist()))
    text = fm.genome.codes_fwd_rc()
    expect = _sorted(naive_lmem_seeds(
        text, qry, min_seed_length=12, max_seed_freq=100, chunk=600,
        sensitive=sensitive))
    assert got == expect


@pytest.mark.parametrize("slack,n_segments", [(20, 8), (40, 4), (10, 16)])
def test_seeding_poisoned_segments_match_naive(slack, n_segments):
    """Tiny slack + long exact regions force extension clipping at the
    artificial segment bound: the poison/fixup path must still reproduce
    the reference scan exactly."""
    rng = np.random.default_rng(123)
    ref = random_genome(rng, 3000)
    fm = make_fm(ref)
    dfm = DeviceFMIndex.from_host(fm)
    qry = mutate(ref, rng, sub_rate=0.01)
    # an exact 600bp region (no variants): extensions run long there
    qry[800:1400] = ref[800:1400]

    q_pos, r_pos, length = find_seeds(
        dfm, qry, min_seed_length=12, max_seed_freq=100,
        chunk=1000, n_segments=n_segments, slack=slack)
    got = _sorted(zip(q_pos.tolist(), r_pos.tolist(), length.tolist()))
    text = fm.genome.codes_fwd_rc()
    expect = _sorted(naive_lmem_seeds(
        text, qry, min_seed_length=12, max_seed_freq=100, chunk=1000))
    assert got == expect


@pytest.mark.parametrize("gather_k", [8, 64])
@pytest.mark.parametrize("sa_mode", ["xlak"])
def test_seeding_split_sa_pallas_matches_naive(monkeypatch, gather_k,
                                               sa_mode):
    """The non-default direct-mode SA resolution path (K-compacted xlak):
    seed sets must match the naive scan, including when the per-iteration
    slot budget K is tiny so lanes entering direct mode overflow the
    compaction and take the stall-retry path."""
    from gsalign_tpu.ops import seeding as seeding_mod
    monkeypatch.setenv("GSALIGN_SA_MODE", sa_mode)
    monkeypatch.setattr(seeding_mod, "_SA_GATHER_K", gather_k)
    # _SA_GATHER_K is read at trace time inside the jitted scan; clear the
    # jit cache so each parametrization actually compiles with its own K.
    jax.clear_caches()
    rng = np.random.default_rng(77)
    ref = random_genome(rng, 2500)
    g = Genome(names=["c"], lengths=np.asarray([len(ref)]),
               offsets=np.asarray([0]), holes=[], codes_fwd=ref)
    fm = build_fmindex(g, sa_intv=1, prefer_device=False)   # direct mode
    dfm = DeviceFMIndex.from_host(fm)
    assert dfm.direct_ok and not dfm.sa_in_comb
    qry = mutate(ref, rng, sub_rate=0.02)

    q_pos, r_pos, length = find_seeds(
        dfm, qry, min_seed_length=12, max_seed_freq=100, chunk=500)
    got = _sorted(zip(q_pos.tolist(), r_pos.tolist(), length.tolist()))
    text = fm.genome.codes_fwd_rc()
    expect = _sorted(naive_lmem_seeds(
        text, qry, min_seed_length=12, max_seed_freq=100, chunk=500))
    assert got == expect


def test_seeding_compaction_overflow_falls_back(monkeypatch):
    """A tiny compaction budget (1 slot/lane) must trip the full-plane
    fallback fetch and still produce the exact seed set."""
    from gsalign_tpu.ops import seeding as seeding_mod
    monkeypatch.setattr(seeding_mod, "_COMPACT_SLOTS", 1)
    jax.clear_caches()   # _COMPACT_SLOTS is read at trace time
    rng = np.random.default_rng(5)
    ref = random_genome(rng, 3000)
    fm = make_fm(ref)
    dfm = DeviceFMIndex.from_host(fm)
    qry = mutate(ref, rng, sub_rate=0.01)
    q_pos, r_pos, length = find_seeds(
        dfm, qry, min_seed_length=12, max_seed_freq=100, chunk=1000)
    got = _sorted(zip(q_pos.tolist(), r_pos.tolist(), length.tolist()))
    text = fm.genome.codes_fwd_rc()
    expect = _sorted(naive_lmem_seeds(
        text, qry, min_seed_length=12, max_seed_freq=100, chunk=1000))
    assert got == expect
    jax.clear_caches()
