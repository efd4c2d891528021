"""Beyond-HBM index sharding (docs/SCALING_3GB.md item 1): the big
table rows (t3 + sampled SA) sharded across the 8-device CPU mesh, lanes
replicated — seeds and full pipeline outputs must be byte-identical to the
single-device run. This is the device story for the 3 Gb config, whose
wide tables come to ~19.4 GB t3 + ~6.2 GB SA at 6.2 G rows; sharding
their rows is the path for indexes beyond one card's memory."""

import dataclasses

import numpy as np
import jax
import pytest

from gsalign_tpu.config import AlignConfig
from gsalign_tpu.genome.packing import Genome
from gsalign_tpu.index.fmindex import build_fmindex
from gsalign_tpu.ops.rank import DeviceFMIndex
from gsalign_tpu.ops.seeding import find_seeds
from gsalign_tpu.parallel import mesh as mesh_lib
from tests.helpers import random_genome


@pytest.fixture(scope="module", params=[False, True],
                ids=["narrow", "wide"])
def setup(request):
    rng = np.random.default_rng(11)
    ref = random_genome(rng, 4000)
    g = Genome(names=["c"], lengths=np.asarray([len(ref)]),
               offsets=np.asarray([0]), holes=[], codes_fwd=ref)
    fm = build_fmindex(g, sa_intv=8, prefer_device=False,
                       force_wide=request.param)
    qry = ref.copy()
    subs = rng.random(len(qry)) < 0.02
    qry[subs] = (qry[subs] + 1) % 4
    return fm, qry.astype(np.uint8)


def test_row_sharded_seeds_match_single_device(setup):
    fm, qry = setup
    dfm = DeviceFMIndex.from_host(fm)
    base = find_seeds(dfm, qry, min_seed_length=12, chunk=500)
    mesh = mesh_lib.make_mesh(jax.devices()[:8])
    sharded_dfm = mesh_lib.shard_index_rows(dfm, mesh)
    assert "t3" in sharded_dfm._row_shard_fields
    # the shards really are distributed: each device holds ~1/8 of rows
    t3_shard_rows = {s.data.shape[0]
                     for s in sharded_dfm.t3.addressable_shards}
    assert t3_shard_rows == {sharded_dfm.t3.shape[0] // 8}
    got = find_seeds(sharded_dfm, qry, min_seed_length=12, chunk=500,
                     mesh=mesh)
    for a, b in zip(base, got):
        np.testing.assert_array_equal(a, b)


def test_row_sharded_pipeline_byte_identical(setup, tmp_path):
    from gsalign_tpu.pipeline.align import compare_genomes
    fm, qry = setup
    DNA = np.frombuffer(b"ACGTN", dtype=np.uint8)
    qry_records = [("q", DNA[qry])]
    cfg = dataclasses.replace(AlignConfig(), min_aln_block_score=50,
                              min_seed_length=12, thread_num=1)

    outs = {}
    for mode in ("single", "rowshard"):
        prefix = str(tmp_path / mode)
        kw = {}
        if mode == "rowshard":
            mesh = mesh_lib.make_mesh(jax.devices()[:8])
            kw = dict(mesh=mesh, shard_index_rows=True)
        compare_genomes(fm, qry_records, cfg, output_prefix=prefix,
                        verbose=False, **kw)
        with open(prefix + ".maf", "rb") as fh:
            maf = fh.read()
        with open(prefix + ".vcf", "rb") as fh:
            vcf = b"".join(ln for ln in fh.read().splitlines(keepends=True)
                           if not ln.startswith(b"##reference"))
        outs[mode] = (maf, vcf)
    assert outs["rowshard"][0] == outs["single"][0]
    assert outs["rowshard"][1] == outs["single"][1]
