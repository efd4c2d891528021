"""Smoke-guard for tools/run_3gb.py — the driver that executed the 3 Gb
config (BASELINE.json config 5) at full scale. The full run (6.2 G-row
wide build + row-sharded mesh align, recorded in docs/SCALING_3GB.md) is
hours; this exercises the SAME script end-to-end at 2 Mb so refactors of
build_fmindex/save_index/shard_index_rows/compare_genomes can't silently
break the at-scale entry point."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_run3gb_driver_smoke(tmp_path):
    out = tmp_path / "run3gb_smoke"
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "run_3gb.py"),
         "--len", "2000000", "--slice-len", "100000", "--out", str(out)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-2000:]
    with open(out / "result.json") as fh:
        res = json.load(fh)
    assert res["mesh_devices"] == 8
    assert res["alignments"] == 3          # one per query slice
    assert res["aligned_bp"] == res["query_bp"] == 300000
    assert res["ani_pct"] > 99.0
    assert res["snv"] > 1000               # 0.5% mutated slices
    # outputs written through the normal pipeline writers
    assert (out / "out.maf").stat().st_size > 100_000
    assert (out / "out.vcf").stat().st_size > 10_000
    # small scale stays narrow; the >2^31 run asserts wide internally
    assert res["wide"] is False
