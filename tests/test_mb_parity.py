"""Mb-scale golden parity against a freshly-built C reference binary.

Opt-in (GSALIGN_BIG=1): builds hsinnan75/GSAlign from /root/reference into
/tmp/refbuild (cached), generates the same 4.6 Mb pair bench.py uses, runs
both aligners, and byte-compares MAF + VCF. This machine-checks the
flagship "byte-identical at Mb scale" claim that the always-on
tests/test_e2e.py goldens only cover at 100 kb (VERDICT r3 weak #6).
Reference analogue: run_test.sh:13 (the E. coli smoke pair).
"""

import os
import shutil
import subprocess
import sys

import pytest

from tests.make_testdata import make_pair, write_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SRC = "/root/reference"
REF_BUILD = "/tmp/refbuild"

pytestmark = pytest.mark.skipif(
    not os.environ.get("GSALIGN_BIG"),
    reason="Mb-scale parity is opt-in (GSALIGN_BIG=1): builds the C "
           "reference and aligns a 4.6 Mb pair (~2 min)")


def _ref_binaries():
    """Build (or reuse) the C reference; returns (gsalign, bwt_index)."""
    gsalign = os.path.join(REF_BUILD, "bin", "GSAlign")
    bwt_index = os.path.join(REF_BUILD, "bin", "bwt_index")
    if not (os.path.exists(gsalign) and os.path.exists(bwt_index)):
        if os.path.exists(REF_BUILD):
            shutil.rmtree(REF_BUILD)
        shutil.copytree(REF_SRC, REF_BUILD)
        subprocess.run(["make", "-j4"], cwd=REF_BUILD, check=True,
                       capture_output=True)
    return gsalign, bwt_index


def _strip_headers(text: bytes) -> bytes:
    # ##reference= carries the output prefix (differs by construction)
    return b"\n".join(ln for ln in text.split(b"\n")
                      if not ln.startswith(b"##reference="))


def test_mb_scale_byte_parity(tmp_path):
    gsalign, bwt_index = _ref_binaries()
    d = str(tmp_path)
    ref_fa = os.path.join(d, "ref.fa")
    qry_fa = os.path.join(d, "qry.fa")
    ref_records, qry_records = make_pair(total_len=4_600_000)
    write_fasta(ref_fa, ref_records)
    write_fasta(qry_fa, qry_records)

    # C reference: index + align (-t 4 matches run_test.sh; its outputs
    # are thread-count-independent)
    idx = os.path.join(d, "c_idx")
    subprocess.run([bwt_index, ref_fa, idx], check=True,
                   capture_output=True)
    c_out = os.path.join(d, "c_out")
    subprocess.run([gsalign, "-t", "4", "-i", idx, "-q", qry_fa,
                    "-o", c_out], check=True, capture_output=True)

    # ours, via the CLI like a user would (CPU platform)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    my_out = os.path.join(d, "my_out")
    r = subprocess.run(
        [sys.executable, "-m", "gsalign_tpu.cli", "-i", idx, "-q", qry_fa,
         "-o", my_out, "-t", "4"],
        env=env, capture_output=True, text=True, timeout=1800)
    assert r.returncode == 0, r.stderr

    with open(c_out + ".maf", "rb") as fh:
        c_maf = fh.read()
    with open(my_out + ".maf", "rb") as fh:
        my_maf = fh.read()
    assert my_maf == c_maf, "MAF bytes diverge at 4.6 Mb"

    with open(c_out + ".vcf", "rb") as fh:
        c_vcf = _strip_headers(fh.read())
    with open(my_out + ".vcf", "rb") as fh:
        my_vcf = _strip_headers(fh.read())
    assert my_vcf == c_vcf, "VCF bytes diverge at 4.6 Mb"
