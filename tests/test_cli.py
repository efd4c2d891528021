"""CLI end-to-end smoke tests (subprocess, CPU platform)."""

import os
import subprocess
import sys

import pytest

from tests.make_testdata import make_pair, write_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, cwd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "gsalign_tpu.cli"] + args,
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    ref, qry = make_pair(total_len=60_000, n_chr=1, seed=31, inversion=False)
    write_fasta(str(d / "ref.fa"), ref)
    write_fasta(str(d / "qry.fa"), qry)
    return d


def test_cli_index_subcommand(data_dir):
    r = run_cli(["index", "ref.fa", "refidx"], cwd=data_dir)
    assert r.returncode == 0, r.stderr
    assert (data_dir / "refidx.npz").exists()


def test_cli_align_with_index(data_dir):
    r = run_cli(["-i", "refidx", "-q", "qry.fa", "-o", "out", "-t", "2"],
                cwd=data_dir)
    assert r.returncode == 0, r.stderr
    assert "Alignment#=" in r.stderr
    assert (data_dir / "out.maf").exists()
    assert (data_dir / "out.vcf").exists()
    with open(data_dir / "out.maf") as fh:
        assert fh.readline() == "##maf version=1\n"


def test_cli_align_builds_index_from_ref(data_dir, tmp_path):
    import shutil
    d = tmp_path
    shutil.copy(data_dir / "ref.fa", d / "r2.fa")
    shutil.copy(data_dir / "qry.fa", d / "q2.fa")
    r = run_cli(["-r", "r2.fa", "-q", "q2.fa", "-o", "o2", "-fmt", "2",
                 "-no_vcf"], cwd=d)
    assert r.returncode == 0, r.stderr
    assert (d / "o2.aln").exists()
    assert not (d / "o2.vcf").exists()


def test_cli_usage_and_bad_args(data_dir):
    r = run_cli(["-h"], cwd=data_dir)
    assert "Usage:" in r.stderr
    r = run_cli(["-slen", "5", "-i", "refidx", "-q", "qry.fa"], cwd=data_dir)
    assert r.returncode == 1


def test_cli_debug_dump(data_dir):
    # -d dumps chained block boundaries (live equivalent of the
    # reference's parsed-but-dead -d/-obr, src/main.cpp:288-289)
    r = run_cli(["-i", "refidx", "-q", "qry.fa", "-o", "outd", "-d"],
                cwd=data_dir)
    assert r.returncode == 0, r.stderr
    assert "AlnBlockBoundary Q[" in r.stdout
    # -obr filters the dump to blocks covering a reference position; a
    # position past the genome matches nothing
    r = run_cli(["-i", "refidx", "-q", "qry.fa", "-o", "outd",
                 "-obr", "999999999"], cwd=data_dir)
    assert r.returncode == 0, r.stderr
    assert "AlnBlockBoundary" not in r.stdout
    r = run_cli(["-i", "refidx", "-q", "qry.fa", "-o", "outd",
                 "-obr", "30000"], cwd=data_dir)
    assert r.returncode == 0, r.stderr
    assert "AlnBlockBoundary" in r.stdout
