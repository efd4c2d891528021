"""CPU checks of the start-up path and of chip_smoke.py's own helpers."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child_env(**overrides):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(overrides)
    return env


@pytest.mark.parametrize("cache_env", [None, "set"])
def test_compile_cache_placement(cache_env, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits at
    a fixed path inside the checkout."""
    extra = {}
    want = os.path.join(REPO, ".jax_cache")
    if cache_env:
        want = str(tmp_path / "cc")
        extra["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run(
        [sys.executable, "-c",
         "import gsalign_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=_child_env(**extra), cwd=str(tmp_path), capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == want


def test_chip_smoke_refuses_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"),
         "--work", str(tmp_path)],
        env=_child_env(), capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_golden_helper_on_100kb_pair(tmp_path):
    """The CLI on the golden pair, compared by chip_smoke.golden_diffs: equal
    outputs pass, a changed byte is named."""
    from chip_smoke import golden_diffs, output_diffs, run_cli, write_pair
    d, ref_fa, qry_fa = write_pair(str(tmp_path), 100_000)
    idx = os.path.join(d, "idx")
    run_cli("index", ref_fa, idx)
    prefix = os.path.join(d, "g")
    err = run_cli("-i", idx, "-q", qry_fa, "-o", prefix, "-t", "1")
    assert "[stages]" in err
    assert golden_diffs(prefix, "g_default", ("maf", "vcf")) == []
    assert output_diffs(prefix, prefix) == []
    with open(prefix + ".maf", "r+b") as fh:
        fh.seek(200)
        b = fh.read(1)
        fh.seek(200)
        fh.write(b"A" if b != b"A" else b"C")
    assert golden_diffs(prefix, "g_default", ("maf", "vcf")) == [
        f"{prefix}.maf != g_default.maf"]
