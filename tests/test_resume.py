"""Per-fragment resumability: kill -9 mid-run, restart with -resume,
outputs must be byte-identical to an uninterrupted run (the reference's
appended outputs are corrupt after a crash, src/tools.cpp:158-163)."""

import os
import signal
import subprocess
import sys
import time

import pytest

from tests.make_testdata import make_pair, write_fasta


def _strip_ref_line(b: bytes) -> bytes:
    return b"\n".join(ln for ln in b.split(b"\n")
                      if not ln.startswith(b"##reference"))


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env.pop("XLA_FLAGS", None)
    return env


def _run_cli(args, cwd):
    env = _env()
    return subprocess.run([sys.executable, "-m", "gsalign_tpu.cli"] + args,
                          cwd=cwd, env=env, capture_output=True, timeout=300)


def test_kill9_then_resume_byte_identical(tmp_path):
    ref, qry = make_pair(total_len=160_000, n_chr=4, seed=91,
                         inversion=False)
    write_fasta(str(tmp_path / "ref.fa"), ref)
    write_fasta(str(tmp_path / "qry.fa"), qry)
    r = _run_cli(["index", "ref.fa", "idx"], str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()

    # uninterrupted reference run (no -resume)
    r = _run_cli(["-i", "idx", "-q", "qry.fa", "-o", "full"], str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()

    # start a -resume run and SIGKILL it once the first shard committed
    env = _env()
    p = subprocess.Popen(
        [sys.executable, "-m", "gsalign_tpu.cli", "-i", "idx", "-q",
         "qry.fa", "-o", "part", "-resume"],
        cwd=str(tmp_path), env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.time() + 240
    first_marker = tmp_path / "part.part0.pkl"
    while time.time() < deadline and p.poll() is None:
        if first_marker.exists():
            break
        time.sleep(0.05)
    if p.poll() is None:
        os.kill(p.pid, signal.SIGKILL)
        p.wait()
    killed_early = first_marker.exists() and not (tmp_path / "part.vcf").exists()
    assert killed_early or (tmp_path / "part.vcf").exists()

    # restart: must complete, recomputing only uncommitted chromosomes
    r = _run_cli(["-i", "idx", "-q", "qry.fa", "-o", "part", "-resume"],
                 str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()

    for ext in (".maf", ".vcf"):
        with open(tmp_path / ("full" + ext), "rb") as fh:
            full = _strip_ref_line(fh.read())
        with open(tmp_path / ("part" + ext), "rb") as fh:
            part = _strip_ref_line(fh.read())
        assert full == part, f"{ext} differs after kill+resume"
    # shards were cleaned up by the merge
    assert not list(tmp_path.glob("part.part*"))
