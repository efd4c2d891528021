"""gsalign_tpu — a JAX whole-genome pairwise alignment framework.

A from-scratch JAX/XLA re-design of the capabilities of GSAlign
(hsinnan75/GSAlign; reference layout surveyed in SURVEY.md):

- FM-index construction on device (prefix-doubling suffix array; replaces the
  incremental BWT-SW builder, reference src/BWT_Index/bwt_gen.c).
- Batched LMEM seeding: thousands of query chunks extend in lock-step through
  vectorized rank/occ queries (replaces the per-thread sequential walk in
  reference src/GSAlign.cpp:51-124 / src/bwt_search.cpp:141-185).
- Diagonal chaining and block repair as vectorized segmented array ops
  (replaces pthread work queues, reference src/GSAlign.cpp:126-471).
- A batched anti-diagonal affine-gap DP (one lax.scan step per
  anti-diagonal) with on-device traceback (replaces ksw2 extz2_sse,
  reference src/ksw2_alignment.cpp).
- MAF/ALN/VCF emission with byte parity against the reference formats
  (reference src/tools.cpp, src/SeqVariant.cpp).
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Genome coordinates over fwd+RC text exceed 2^31 for >1 Gbp genomes and the
# prefix-doubling sort uses int64 composite keys; 64-bit must be on globally.
_jax.config.update("jax_enable_x64", True)

# Compiled programs persist across processes. JAX_COMPILATION_CACHE_DIR,
# when set, is honoured by JAX itself; otherwise the cache lives at a fixed
# path inside the checkout (the path is part of the cache key).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from gsalign_tpu.config import AlignConfig  # noqa: F401,E402
