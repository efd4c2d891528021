"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import pytest

from gsalign_tpu.genome.packing import Genome
from gsalign_tpu.index.fmindex import build_fmindex
from gsalign_tpu.ops.rank import DeviceFMIndex
from gsalign_tpu.ops.seeding import find_seeds
from gsalign_tpu.parallel import mesh as mesh_lib
from tests.helpers import random_genome


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    ref = random_genome(rng, 3000)
    g = Genome(names=["c"], lengths=np.asarray([len(ref)]),
               offsets=np.asarray([0]), holes=[], codes_fwd=ref)
    fm = build_fmindex(g, sa_intv=8, prefer_device=False)
    qry = ref.copy()
    subs = rng.random(len(qry)) < 0.02
    qry[subs] = (qry[subs] + 1) % 4
    return fm, qry.astype(np.uint8)


def test_sharded_seeding_matches_unsharded(setup):
    fm, qry = setup
    dfm = DeviceFMIndex.from_host(fm)
    base = find_seeds(dfm, qry, min_seed_length=12, chunk=500)
    mesh = mesh_lib.make_mesh(jax.devices()[:8])
    sharded = find_seeds(dfm, qry, min_seed_length=12, chunk=500, mesh=mesh)
    for a, b in zip(base, sharded):
        np.testing.assert_array_equal(a, b)


def test_sharded_seeding_direct_sa_parity(monkeypatch):
    """Direct-mode indexes resolve occurrences from the standalone SA plane
    with a plain per-lane gather ("xla", the default mode); mesh runs shard
    the lanes per device and must produce the identical seed set."""
    from gsalign_tpu.ops import seeding as seeding_mod
    jax.clear_caches()
    rng = np.random.default_rng(21)
    ref = random_genome(rng, 2500)
    g = Genome(names=["c"], lengths=np.asarray([len(ref)]),
               offsets=np.asarray([0]), holes=[], codes_fwd=ref)
    fm = build_fmindex(g, sa_intv=1, prefer_device=False)   # direct mode
    dfm = DeviceFMIndex.from_host(fm)
    assert dfm.direct_ok and not dfm.sa_in_comb
    mesh = mesh_lib.make_mesh(jax.devices()[:8])
    assert seeding_mod._pick_sa_mode(dfm, mesh) == "xla"
    qry = ref.copy()
    subs = rng.random(len(qry)) < 0.02
    qry[subs] = (qry[subs] + 1) % 4
    qry = qry.astype(np.uint8)
    base = find_seeds(dfm, qry, min_seed_length=12, chunk=500)
    sharded = find_seeds(dfm, qry, min_seed_length=12, chunk=500, mesh=mesh)
    for a, b in zip(base, sharded):
        np.testing.assert_array_equal(a, b)
    jax.clear_caches()


def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as ge
    ge.dryrun_multichip(min(8, len(jax.devices())))


def test_pipeline_mesh_byte_identical(tmp_path):
    """compare_genomes on the 8-device mesh produces byte-identical MAF/VCF
    to the single-device run (deterministic merge order regardless of
    topology)."""
    from gsalign_tpu.config import AlignConfig
    from gsalign_tpu.pipeline.align import compare_genomes
    from tests.make_testdata import make_pair
    ref, qry = make_pair(total_len=120_000, n_chr=2, seed=77)
    from gsalign_tpu.genome.packing import pack_genome
    fm = build_fmindex(pack_genome(ref))
    cfg = AlignConfig()
    p1 = str(tmp_path / "one")
    p8 = str(tmp_path / "eight")
    compare_genomes(fm, qry, cfg, output_prefix=p1, verbose=False)
    mesh = mesh_lib.make_mesh(jax.devices()[:8])
    compare_genomes(fm, qry, cfg, output_prefix=p8, verbose=False, mesh=mesh)
    def _strip_ref_line(b):
        return b"\n".join(ln for ln in b.split(b"\n")
                          if not ln.startswith(b"##reference"))

    for ext in (".maf", ".vcf"):
        with open(p1 + ext, "rb") as fh:
            one = _strip_ref_line(fh.read())
        with open(p8 + ext, "rb") as fh:
            eight = _strip_ref_line(fh.read())
        assert one == eight, f"{ext} differs between 1-dev and 8-dev"
