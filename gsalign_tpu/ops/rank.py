"""Batched FM-index rank/occ queries on device.

The reference answers one rank query at a time with popcount over an
interleaved BWT (src/bwt_search.cpp:45-119). Here a query is a lane of a
[B]-vector: checkpoint gather + vectorized 2-bit-field equality + popcount
over the 8 words of one 128-base block, so thousands of FM extensions step
together through the index — that is the whole design point of the port.

Rank-space integers are int32 below seq_len 2^31 and int64 above (the
"wide" layout: u32 low checkpoints + 2-bit carries, matching the
reference's 64-bit bwtint_t regime, src/BWT_Index/bwt.h:36-40).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gsalign_tpu.index.fmindex import FMIndex, WORDS_PER_BLOCK


UNION_ROW = 16   # uint32 words per row of the single-char rank table
T3_ROW_WIDE = 100  # wide fused rows: 64 cp-low + 4 carry words + 32 syms
# comb_pairs layout offsets (see the field's docstring)
INIT_OFF = 65536 + 136                 # narrow packed: INIT starts-pair rows
INIT_OFF_WIDE = 2 * (65536 + 136)      # wide flattened: INIT starts plane
# SA placement: direct-mode lanes resolve their occurrence with ONE plain
# XLA gather on the standalone sa_rows plane, so the O(n) SA plane never
# rides the per-iteration comb gather.
# INIT jump order is scale-dependent: order 10 (4 MB plane) below this
# seq_len, order 12 (67 MB plane) above. Every scan iteration sweeps the
# whole plane (XLA gather cost model), so small genomes want the small
# plane; large genomes want the longer jump — at 200 Mb a 10-mer averages
# ~200 occurrences vs ~12 for a 12-mer, and the extra triple steps to
# uniqueness cost more iterations than the 63 MB/iteration sweep saves.
# The crossover on the GPU is not measured.
INIT12_MIN_SEQLEN = 64 * 2 ** 20


def comb_rows(order: int) -> int:
    """Total comb_pairs rows for an INIT order."""
    return INIT_OFF + 4 ** order


@partial(jax.tree_util.register_dataclass,
         data_fields=["union", "t3", "t3_major", "l2",
                      "sa_samples", "c64", "t3_exc_pos", "t3_exc_chr",
                      "comb_pairs", "init_corr", "text_rows", "sa_rows"],
         meta_fields=["seq_len", "primary", "sa_intv", "wide", "direct_ok",
                      "sa_in_comb", "init_order", "row_shard"])
@dataclasses.dataclass(frozen=True)
class DeviceFMIndex:
    # Rank tables, the device analogue of the reference's interleaved .bwt
    # layout (src/BWT_Index/bwtindex.c:53-75):
    #  union: single-char blocks of 128 bases
    #        [cp0..cp3 | 8 packed words (2b/base) | 0...]
    #  narrow order-3 layout (seq_len < 2^31): ONE fused 256 B row per
    #    query, [32 words of u16-packed MINOR checkpoints (class j in word
    #    j>>1, half j&1) | 32 packed symbol words], plus a small MAJOR
    #    table every 256 rows (32768 bases, so minors fit u16). Every XLA
    #    gather re-reads its whole table per call, so row bytes are the
    #    t3 cost; the major table is ~n/128 bytes and sweeps for free.
    #  wide (seq_len >= 2^31, the reference's 64-bit bwtint_t regime,
    #  src/BWT_Index/bwt.h:36-40) widens the fused row: [cp-low0..63 |
    #  4 carry words (2 bits/class: cp bits 32-33) | 32 packed words].
    union: jnp.ndarray        # uint32 [n_rows, 16] (narrow only; [1,16] wide)
    t3: jnp.ndarray           # uint32 [n3_rows, 64] narrow | [n3, 100] wide
    t3_major: jnp.ndarray     # int32 [ceil(n3/256), 64] narrow | [1, 64] wide
    l2: jnp.ndarray           # rdtype [5]
    sa_samples: jnp.ndarray   # rdtype [n_samples]
    c64: jnp.ndarray          # rdtype [65]
    t3_exc_pos: jnp.ndarray   # rdtype [3]
    t3_exc_chr: jnp.ndarray   # int32 [3]
    # The seeding scan's per-iteration class lookup. NARROW layout
    # (round 4): int64 1-D plane of PACKED (lo | sz << 32) per class row —
    # ONE gather with ONE per-lane index serves every scan class (the
    # previous flattened layout needed 2B indices/iteration for the lo
    # and sz planes, and gather cost is per-index latency-bound at large
    # B; a [M, 2] table would pad its minor dim in the device layout):
    #  rows      0..65535   INIT-8   (c8lo[g], c8sz[g])
    #  rows  65536..65599   triple INIT  (C64[g], C64[g+1]-C64[g])
    #  rows  65600..65603   single INIT by base c (L2[3-c]+1, L2[c+1]-L2[c])
    #  rows  65604..65667   triple EXT base (C64[g], 0)
    #  rows  65668..65671   single EXT base by class c (L2[c]+1, 0)
    #  rows  INIT_OFF + g   INIT-order (starts[g], starts[g+1]) — the size
    #    is starts[g+1] - starts[g] minus the <= order short-suffix +1
    #    steps recorded in init_corr (keys g where a step lands at g+1).
    #    ORDER 10 is derived at load time from the stored order-12 counts
    #    for small genomes (4 ** 10 packed rows = 8 MB vs 134 MB at 12).
    # WIDE layout (values exceed 32 bits; wide is never direct): the old
    # flattened int64 planes [c8 lo | lut lo | c8 sz | lut sz | starts
    # (+ sentinel)] with TWO selected indices per lane (INIT_OFF_WIDE).
    # The suffix array NEVER rides this table (round 4): direct-mode
    # occurrence resolution gathers K compacted entry lanes from the
    # standalone sa_rows plane instead (seeding sa_mode "xlak").
    comb_pairs: jnp.ndarray   # int64 [comb_rows(order)] | wide flattened
    # INIT-order-mer keys g whose block size needs a -1 vs
    # starts[g+1]-starts[g] (short-suffix steps at g+1; duplicates legal),
    # padded with -1; room for the up-to-11 step keys at order 12
    init_corr: jnp.ndarray    # int64 [12]
    # Overlapping 512-base windows of the packed fwd+RC text at stride 256:
    # row r = words [16r, 16r+32). Direct-extension seeding (unique-interval
    # lanes compare text to query 256 bases per gather) reads these; a [1,1]
    # dummy when direct mode is off (sampled SA / wide). Aligned row
    # gathers from this duplicated-row layout replace slice gathers at
    # arbitrary word offsets from a flat array.
    text_rows: jnp.ndarray    # uint32 [ceil(2N/1024), 128] | [1, 1]
    # Large direct indexes move the full SA OUT of comb_pairs (sa_in_comb
    # False) into this standalone int32 table: riding along in comb made
    # EVERY scan iteration gather from the whole SA plane (~800 MB at
    # 100 Mb scale), while only the handful of lanes entering direct mode
    # need a row. [1] dummy when direct mode is off.
    sa_rows: jnp.ndarray      # int32 [seq_len+1] | [1]
    seq_len: int
    primary: int
    sa_intv: int
    wide: bool
    direct_ok: bool
    sa_in_comb: bool
    init_order: int           # INIT jump k-mer order (10 or 12)
    # Beyond-HBM index sharding (docs/SCALING_3GB.md item 1): when set to
    # (axis_name, (field, ...)) INSIDE a shard_map, the named table fields
    # (subset of {"t3", "sa_samples"}) hold only this device's ROW SHARD;
    # their fetch sites become local-masked-gather + psum over the axis —
    # each device answers the rows it owns. The reference reaches 3 Gb
    # through 64-bit bwtint_t on host RAM (src/BWT_Index/bwt.h:36-40);
    # this is the device analogue for tables exceeding one chip's HBM.
    row_shard: tuple = None

    @property
    def rdtype(self):
        return jnp.int64 if self.wide else jnp.int32

    @staticmethod
    def from_host(fm: FMIndex) -> "DeviceFMIndex":
        cached = getattr(fm, "_device_cache", None)
        if cached is not None:
            return cached
        wide = fm.rank_dtype == np.int64
        n3 = fm.t3_cp.shape[0]
        major3 = np.zeros((1, 64), dtype=np.int32)
        if wide:
            union = np.zeros((1, UNION_ROW), dtype=np.uint32)
            rows3 = np.empty((n3, T3_ROW_WIDE), dtype=np.uint32)
            # slab-wise: whole-table temporaries here (u32 carries + the
            # shifted [n3, 4, 16] reduce input) are ~25 GB at 6.2 G rows,
            # on top of the 19.4 GB output and the host t3_cp — enough to
            # OOM the 3 Gb config's align phase (measured)
            shifts = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]
            SLAB = 1 << 22
            t3p = fm.t3_packed.reshape(n3, 32)
            for s in range(0, n3, SLAB):
                e = min(s + SLAB, n3)
                cp = fm.t3_cp[s:e]
                rows3[s:e, :64] = (cp & 0xFFFFFFFF).astype(np.uint32)
                carry = ((cp >> 32) & 3).astype(np.uint32)   # [m, 64]
                cw = carry.reshape(e - s, 4, 16)
                rows3[s:e, 64:68] = np.bitwise_or.reduce(cw << shifts,
                                                         axis=2)
                rows3[s:e, 68:] = t3p[s:e]
        else:
            n1 = fm.occ_cp.shape[0]
            union = np.zeros((n1, UNION_ROW), dtype=np.uint32)
            union[:, :4] = fm.occ_cp.astype(np.int32).view(
                np.uint32).reshape(n1, 4)
            union[:, 4:12] = fm.bwt_packed.reshape(n1, WORDS_PER_BLOCK)
            cp3 = fm.t3_cp.astype(np.int32)                  # [n3, 64]
            major3 = np.ascontiguousarray(cp3[::256])        # [n3/256, 64]
            minor = (cp3 - major3[np.arange(n3) >> 8]).astype(np.uint32)
            rows3 = np.empty((n3, 64), dtype=np.uint32)
            rows3[:, :32] = minor[:, 0::2] | (minor[:, 1::2] << 16)
            rows3[:, 32:] = fm.t3_packed.reshape(n3, 32)
        lut = np.zeros((136, 2), dtype=np.int64)
        c64 = np.asarray(fm.c64, dtype=np.int64)
        l2 = np.asarray(fm.l2, dtype=np.int64)
        lut[0:64, 0] = c64[:64]
        lut[0:64, 1] = c64[1:65] - c64[:64]
        for c in range(4):
            lut[64 + c] = (l2[3 - c] + 1, l2[c + 1] - l2[c])
            lut[132 + c, 0] = l2[c] + 1
        lut[68:132, 0] = c64[:64]
        rdt = jnp.int64 if wide else jnp.int32
        direct_ok = (fm.sa_intv == 1) and not wide and fm.genome is not None
        if direct_ok:
            from gsalign_tpu.index.fmindex import pack_bwt_codes
            text = fm.genome.codes_fwd_rc()
            n_rows_t = -(-fm.seq_len // 256)
            # four 512-base windows (own 16 words + 256-base lookahead)
            # per table row: the scan's per-row gather then reads ONE
            # contiguous 512 B line of a row-major table
            n4 = -(-n_rows_t // 4)
            padded = np.zeros((n4 * 4 + 1) * 256, dtype=np.uint8)
            padded[:fm.seq_len] = text
            pk = pack_bwt_codes(padded).reshape(n4 * 4 + 1, 16)
            text_rows = np.concatenate([pk[:-1], pk[1:]],
                                       axis=1).reshape(n4, 128)
        else:
            text_rows = np.zeros((1, 1), dtype=np.uint32)
        c8 = fm.c8
        if c8 is None:                     # pre-v4 in-memory index
            from gsalign_tpu.index.fmindex import _build_c8
            c8 = _build_c8(fm.genome.codes_fwd_rc(), fm.seq_len)
        import os
        init_order = 12 if fm.seq_len > INIT12_MIN_SEQLEN else 10
        env_o = os.environ.get("GSALIGN_INIT_ORDER")
        if env_o in ("10", "12"):          # A/B override
            init_order = int(env_o)
        if init_order == 12:
            c12 = fm.c12
            if c12 is None:                # small index: c12 never built
                from gsalign_tpu.index.fmindex import _build_c12
                c12 = _build_c12(fm.genome.codes_fwd_rc(), fm.seq_len)
            starts_init = c12[:, 0]
            from gsalign_tpu.index.fmindex import c12_step_keys
            steps = c12_step_keys(c12)     # lb values of the +1 steps
        elif fm.c12 is not None:           # big index carries c12: reuse
            starts_init, steps = _derive_c10(
                fm.c12[:, 1], fm.genome.codes_fwd_rc(), fm.seq_len)
        else:                              # small index: direct histogram
            starts_init, steps = _build_c10(
                fm.genome.codes_fwd_rc(), fm.seq_len)
        corr = np.full(12, -1, dtype=np.int64)
        # a step at lb bumps starts[lb:], i.e. block lb-1's naive size;
        # lb == 0 only shifts the whole table (no block affected)
        keys = steps[steps > 0] - 1
        corr[:keys.shape[0]] = keys
        if wide:
            # values exceed 32 bits: flattened lo/sz planes, two indices
            comb = np.concatenate(
                [c8[:, 0], lut[:, 0], c8[:, 1], lut[:, 1],
                 starts_init, np.asarray([fm.seq_len + 1], np.int64)])
        else:
            # packed (lo | sz << 32) rows, ONE index per lane per iteration
            starts_ext = np.concatenate(
                [starts_init, np.asarray([fm.seq_len + 1], np.int64)])
            lo = np.concatenate([c8[:, 0], lut[:, 0], starts_ext[:-1]])
            sz = np.concatenate([c8[:, 1], lut[:, 1], starts_ext[1:]])
            comb = (lo.astype(np.uint64)
                    | (sz.astype(np.uint64) << np.uint64(32))).view(np.int64)
        # The SA never rides the comb gather (round 4): direct-mode lanes
        # resolve their occurrence from the standalone sa_rows plane via
        # the K-compacted gather (seeding sa_mode "xlak"), so the scan's
        # per-iteration gather never touches the O(n) SA plane at all.
        sa_in_comb = False
        if direct_ok:
            sa_field = np.zeros(1, dtype=np.int32)
            sa_rows = np.ascontiguousarray(fm.sa_samples, dtype=np.int32)
        else:
            sa_field = fm.sa_samples
            sa_rows = np.zeros(1, dtype=np.int32)
        dfm = DeviceFMIndex(
            union=jnp.asarray(union),
            t3=jnp.asarray(rows3),
            t3_major=jnp.asarray(major3),
            l2=jnp.asarray(fm.l2, dtype=rdt),
            sa_samples=jnp.asarray(sa_field, dtype=rdt),
            c64=jnp.asarray(fm.c64, dtype=rdt),
            t3_exc_pos=jnp.asarray(fm.t3_exc_pos, dtype=rdt),
            t3_exc_chr=jnp.asarray(fm.t3_exc_chr, dtype=jnp.int32),
            comb_pairs=jnp.asarray(comb, dtype=jnp.int64),
            init_corr=jnp.asarray(corr, dtype=jnp.int32),
            text_rows=jnp.asarray(text_rows),
            sa_rows=jnp.asarray(sa_rows),
            seq_len=int(fm.seq_len),
            primary=int(fm.primary),
            sa_intv=int(fm.sa_intv),
            wide=wide,
            direct_ok=direct_ok,
            sa_in_comb=sa_in_comb,
            init_order=init_order,
        )
        if fm.sa_intv == 1:
            # full-SA index: keep a HOST view of the SA so hit expansion
            # resolves ranks with a numpy gather instead of a device round
            # trip (seeding._expand_hits). Not a dataclass/pytree field —
            # jit tracing and sharding must not see it.
            object.__setattr__(dfm, "_host_sa", np.asarray(fm.sa_samples))
        fm._device_cache = dfm
        return dfm


def _derive_c10(counts12: np.ndarray, text: np.ndarray, n: int):
    """ORDER-10 INIT jump starts from the stored order-12 counts.

    12-mer keys put the FIRST char in the high bits (fmindex._build_c12),
    so the low 20 bits of key12(p) are the 10-mer at p+2: summing the
    counts over the 16 high-bit values counts every 10-mer except the two
    at p in {0, 1}, added back from the text. Starts are the exclusive
    cumsum plus one +1 step per suffix SHORTER than 10 chars (incl. the
    sentinel row), exactly the _build_c12 short-suffix argument at order
    10. Returns (starts[4^10] int64, step lbs int64[<=10])."""
    nk = 4 ** 10
    counts10 = np.ascontiguousarray(counts12.reshape(16, nk)).sum(
        axis=0, dtype=np.int64)
    for p in (0, 1):
        if n - 10 >= p:
            key = 0
            for j in range(10):
                key = (key << 2) | int(text[p + j])
            counts10[key] += 1
    return _c10_from_counts(counts10, text, n)


def _build_c10(text: np.ndarray, n: int):
    """ORDER-10 INIT jump starts straight from the text — used for small
    indexes that never built (or persisted) a c12 table. Same short-suffix
    step semantics as _derive_c10; the 4^10 histogram costs one vectorized
    sweep over the text (~10 shifted adds + a bincount)."""
    nk = 4 ** 10
    if n >= 10:
        t = text.astype(np.int64)
        key = np.zeros(n - 9, dtype=np.int64)
        for j in range(10):
            key += t[j: n - 9 + j] << (2 * (9 - j))
        counts10 = np.bincount(key, minlength=nk)
    else:
        counts10 = np.zeros(nk, dtype=np.int64)
    return _c10_from_counts(counts10, text, n)


def _c10_from_counts(counts10: np.ndarray, text: np.ndarray, n: int):
    nk = 4 ** 10
    starts10 = np.zeros(nk, dtype=np.int64)
    np.cumsum(counts10[:-1], out=starts10[1:])
    steps = []
    for k in range(0, min(10, n + 1)):     # suffix of length k at n - k
        lb = 0
        for j in range(k):
            lb += int(text[n - k + j]) << (2 * (9 - j))
        starts10[lb:] += 1
        steps.append(lb)
    return starts10, np.asarray(steps, dtype=np.int64)


_LOW = jnp.uint32(0x55555555)


def _field_match_bits(words: jnp.ndarray, c: int) -> jnp.ndarray:
    """Per 2-bit field: low bit set iff field == c. words uint32 [...]."""
    x = words ^ jnp.uint32(c * 0x55555555)
    return (~x) & ((~x) >> jnp.uint32(1)) & _LOW


_CHAR_PATTERNS = np.asarray(
    [0x00000000, 0x55555555, 0xAAAAAAAA, 0xFFFFFFFF], dtype=np.uint32)

# base-selection masks per in-block offset (ka & 127): one gather replaces
# the limit/shift arithmetic in the hot loop. _MASK_TABLE[o, j] keeps the
# first-`limit` bases of word j for a query ending at offset o.
_mt = np.zeros((128, WORDS_PER_BLOCK), dtype=np.uint32)
for _o in range(128):
    _widx, _m = _o >> 4, (_o & 15) + 1
    for _j in range(WORDS_PER_BLOCK):
        _limit = 16 if _j < _widx else (_m if _j == _widx else 0)
        _mt[_o, _j] = 0 if _limit == 0 else \
            (0xFFFFFFFF << (32 - 2 * _limit)) & 0xFFFFFFFF
_MASK_TABLE = _mt
del _mt


def occ4(dfm: DeviceFMIndex, k: jnp.ndarray) -> jnp.ndarray:
    """Counts of each base in B'[0..k_adj], batched. k int32 [B] (-1 -> 0).

    Mirrors bwt_occ4 (src/bwt_search.cpp:69-86) with two changes that shrink
    the op count for the hot seeding loop: the base-selection mask is applied
    to the match-bit vector (no count-of-A correction needed), and all four
    characters are counted in one broadcasted pass over a [B, 8, 4] tensor
    instead of an unrolled per-char loop.
    """
    valid = k >= 0
    ka = k - (k >= dfm.primary).astype(k.dtype)
    ka_safe = jnp.maximum(ka, 0)
    row = dfm.union[ka_safe >> 7]                            # [B, 32] uint32
    cp = row[:, :4].astype(jnp.int32)                        # [B, 4]
    words = row[:, 4:12]                                     # [B, 8]
    base_mask = jnp.asarray(_MASK_TABLE)[ka_safe & 127]      # [B, 8]
    # per-2-bit-field class selectors on [B, 8] (cheaper than broadcasting a
    # [B, 8, 4] char comparison): field == c <=> (hi-bit, lo-bit) pattern
    hi = (words >> jnp.uint32(1)) & _LOW
    lo = words & _LOW
    mask_lo = base_mask & _LOW
    pc = jax.lax.population_count
    c3 = pc(hi & lo & mask_lo)
    c2 = pc(hi & (lo ^ _LOW) & mask_lo)
    c1 = pc((hi ^ _LOW) & lo & mask_lo)
    c0 = pc(mask_lo) - c1 - c2 - c3
    counts = jnp.stack(
        [jnp.sum(c0, axis=1), jnp.sum(c1, axis=1),
         jnp.sum(c2, axis=1), jnp.sum(c3, axis=1)], axis=1)   # [B, 4]
    cnt = cp + counts.astype(jnp.int32)
    return jnp.where(valid[:, None], cnt, 0)


def bwt_code_at(dfm: DeviceFMIndex, x: jnp.ndarray) -> jnp.ndarray:
    """BWT base code at $-removed position x, batched."""
    w = dfm.union[x >> 7, 4 + ((x >> 4) & 7)]
    sh = (((~x) & 15) << 1).astype(jnp.uint32)
    return ((w >> sh) & jnp.uint32(3)).astype(jnp.int32)


def extend_forward(dfm: DeviceFMIndex, ik0, ik1, ik2, nt):
    """One forward-extension step of the bi-interval (pattern, RC-pattern).

    Batched equivalent of the loop body in BWT_Search
    (src/bwt_search.cpp:159-171): occ4 at the RC interval's two ends (fused
    into one [2B] query), derive all four child intervals, pick child 3-nt.
    Returns (ok0, ok1, ok2) for the chosen child (ok2 == 0 => dead end).

    Kept for parity tests; the seeding scan uses extend_rc (the fwd+RC index
    text is its own reverse complement, so the forward interval start ik0 is
    redundant — occurrences of P mirror occurrences of RC(P)).
    """
    B = ik0.shape[0]
    both = occ4(dfm, jnp.concatenate([ik1 - 1, ik1 - 1 + ik2]))
    tk = both[:B]                                # [B,4]
    tl = both[B:]
    x1_all = dfm.l2[None, :4] + 1 + tk           # [B,4]
    s_all = tl - tk
    has_primary = ((ik1 <= dfm.primary) &
                   (ik1 + ik2 - 1 >= dfm.primary)).astype(ik0.dtype)
    x0_3 = ik0 + has_primary
    x0_2 = x0_3 + s_all[:, 3]
    x0_1 = x0_2 + s_all[:, 2]
    x0_0 = x0_1 + s_all[:, 1]
    x0_all = jnp.stack([x0_0, x0_1, x0_2, x0_3], axis=1)
    i = 3 - nt
    rows = jnp.arange(ik0.shape[0])
    return x0_all[rows, i], x1_all[rows, i], s_all[rows, i]


DFM_DATA_FIELDS = ("union", "t3", "t3_major", "l2", "sa_samples", "c64",
                   "t3_exc_pos", "t3_exc_chr", "comb_pairs", "init_corr",
                   "text_rows", "sa_rows")
DFM_META_FIELDS = ("seq_len", "primary", "sa_intv", "wide", "direct_ok",
                   "sa_in_comb", "init_order")


def split_dfm(dfm: DeviceFMIndex):
    """(arrays, meta) tuples in canonical field order — used by shard_map
    wrappers that need per-array PartitionSpecs and hashable meta."""
    return (tuple(getattr(dfm, f) for f in DFM_DATA_FIELDS),
            tuple(getattr(dfm, f) for f in DFM_META_FIELDS))


def join_dfm(arrays, meta, row_shard=None) -> DeviceFMIndex:
    kw = dict(zip(DFM_DATA_FIELDS, arrays))
    kw.update(zip(DFM_META_FIELDS, meta))
    return DeviceFMIndex(row_shard=row_shard, **kw)


def _sharded(dfm: DeviceFMIndex, field: str) -> bool:
    return dfm.row_shard is not None and field in dfm.row_shard[1]


def _t3_row_fetch(dfm: DeviceFMIndex, idx: jnp.ndarray) -> jnp.ndarray:
    """dfm.t3[idx] ([B, row_width]), row-shard-aware: under a sharded t3
    each device gathers the rows it owns (masked local gather) and a psum
    over the shard axis assembles the full rows on every device."""
    if not _sharded(dfm, "t3"):
        return dfm.t3[idx]
    axis = dfm.row_shard[0]
    nloc = dfm.t3.shape[0]                       # LOCAL rows in shard_map
    off = (jax.lax.axis_index(axis) * nloc).astype(idx.dtype)
    loc = idx - off
    ok = (loc >= 0) & (loc < nloc)
    row = jnp.where(ok[:, None],
                    dfm.t3[jnp.clip(loc, 0, nloc - 1).astype(jnp.int32)],
                    jnp.uint32(0))
    return jax.lax.psum(row, axis)


def _plane_fetch(dfm: DeviceFMIndex, field: str,
                 idx: jnp.ndarray) -> jnp.ndarray:
    """arr[idx] for a 1-D table plane, row-shard-aware (same scheme)."""
    arr = getattr(dfm, field)
    if not _sharded(dfm, field):
        return arr[idx]
    axis = dfm.row_shard[0]
    nloc = arr.shape[0]
    off = (jax.lax.axis_index(axis) * nloc).astype(idx.dtype)
    loc = idx - off
    ok = (loc >= 0) & (loc < nloc)
    v = jnp.where(ok, arr[jnp.clip(loc, 0, nloc - 1).astype(jnp.int32)],
                  jnp.zeros((), arr.dtype))
    return jax.lax.psum(v, axis)


def occ_t3(dfm: DeviceFMIndex, k: jnp.ndarray,
           is_triple: jnp.ndarray, cls: jnp.ndarray) -> jnp.ndarray:
    """Per-lane single-class STRICT rank over the order-3 table, one gather.

    triple mode (is_triple True): # of 8-bit symbols == cls in T3[0, k)
      (cls in [0, 64)), with the SA<3 exception rows subtracted from class 0.
    single mode: # of rows in [0, k) whose true preceding char is cls
      (cls in [0, 4)) — sym & 3 plus exception corrections; equals the
      bwt_occ4-based count (src/bwt_search.cpp:69-86) of rows below k.
    """
    rdt = dfm.rdtype
    cls = cls.astype(jnp.int32)
    if dfm.wide:
        row = _t3_row_fetch(dfm, k >> 7)                     # [B, 100] uint32
        iota = jnp.arange(64, dtype=jnp.int32)[None, :]
        want = jnp.where(is_triple[:, None], iota == cls[:, None],
                         (iota & 3) == cls[:, None])
        lo = row[:, :64].astype(jnp.int64)                   # u32 -> exact
        cw = row[:, 64:68]
        carr = (cw[:, :, None] >> (jnp.arange(16, dtype=jnp.uint32) * 2)
                [None, None, :]) & jnp.uint32(3)
        cp = lo + (carr.reshape(lo.shape[0], 64).astype(jnp.int64)
                   << jnp.int64(32))
        cp_sel = jnp.sum(jnp.where(want, cp, 0), axis=1, dtype=jnp.int64)
        words = row[:, 68:]                                  # [B, 32] uint32
    else:
        # fused narrow rows: ONE 256 B gather per query (u16 minor cps) +
        # one 256 B major-table row (the major table is tiny, so its
        # whole-table re-read per gather call costs nothing)
        row = _t3_row_fetch(dfm, k >> 7)                     # [B, 64] uint32
        mrow = dfm.t3_major[k >> 15]                         # [B, 64] int32
        iota = jnp.arange(64, dtype=jnp.int32)[None, :]
        want = jnp.where(is_triple[:, None], iota == cls[:, None],
                         (iota & 3) == cls[:, None])
        packed = row[:, :32]
        cp16 = jnp.stack([packed & jnp.uint32(0xFFFF),
                          packed >> jnp.uint32(16)],
                         axis=2).reshape(packed.shape[0], 64)
        cp = mrow + cp16.astype(jnp.int32)
        cp_sel = jnp.sum(jnp.where(want, cp, 0), axis=1, dtype=jnp.int32)
        words = row[:, 32:]
    j32 = jnp.arange(32, dtype=jnp.int32)[None, :]
    m = (k & 127).astype(jnp.int32)[:, None]
    keep = jnp.clip(m - 4 * j32, 0, 4)
    mask = jnp.where(keep == 0, jnp.uint32(0),
                     jnp.uint32(0xFFFFFFFF)
                     << jnp.clip(32 - 8 * keep, 0, 31).astype(jnp.uint32))
    pat = cls.astype(jnp.uint32)[:, None] * jnp.uint32(0x01010101)
    x = words ^ pat
    # per-byte zero detect (all sym values < 0x40, so bits 6..7 are clean)
    s = x | (x >> jnp.uint32(4))
    s = s | (s >> jnp.uint32(2))
    s = s | (s >> jnp.uint32(1))
    eq_t = ~s & jnp.uint32(0x01010101)
    x2 = x & jnp.uint32(0x03030303)
    s2 = x2 | (x2 >> jnp.uint32(1))
    eq_s = ~s2 & jnp.uint32(0x01010101)
    eq = jnp.where(is_triple[:, None], eq_t, eq_s)
    cnt = jnp.sum(jax.lax.population_count(eq & mask),
                  axis=1).astype(jnp.int32)

    below = dfm.t3_exc_pos[None, :] < k[:, None]             # [B, 3]
    nbelow = jnp.sum(below, axis=1, dtype=jnp.int32)
    chr_match = jnp.sum(below & (dfm.t3_exc_chr[None, :] == cls[:, None]),
                        axis=1, dtype=jnp.int32)
    zero_cls = (cls == 0).astype(jnp.int32)
    corr = jnp.where(is_triple, -zero_cls * nbelow,
                     -zero_cls * nbelow + chr_match)
    return cp_sel + (cnt + corr).astype(rdt)


def extend_rc(dfm: DeviceFMIndex, ik1, ik2, nt):
    """Forward extension tracking ONLY the RC interval (ik1, size ik2):
    appending base nt to P = backward-extending RC(P) with comp(nt).
    Returns (nik1, nik2)."""
    B = ik1.shape[0]
    both = occ4(dfm, jnp.concatenate([ik1 - 1, ik1 - 1 + ik2]))
    c = 3 - nt
    rows = jnp.arange(B)
    tk = both[:B][rows, c]
    tl = both[B:][rows, c]
    return dfm.l2[c] + 1 + tk, tl - tk


def init_interval(dfm: DeviceFMIndex, p: jnp.ndarray):
    """Initial bi-interval for a single base p (src/bwt_search.cpp:149-152)."""
    ik0 = dfm.l2[p] + 1
    ik1 = dfm.l2[3 - p] + 1
    ik2 = dfm.l2[p + 1] - dfm.l2[p]
    return ik0, ik1, ik2


def inv_psi(dfm: DeviceFMIndex, k: jnp.ndarray) -> jnp.ndarray:
    """Batched bwt_invPsi (src/bwt_search.cpp:121-127)."""
    x = k - (k > dfm.primary).astype(k.dtype)
    c = bwt_code_at(dfm, x)
    occ_c = occ4(dfm, k)[jnp.arange(k.shape[0]), c]
    xr = dfm.l2[c] + occ_c
    return jnp.where(k == dfm.primary, 0, xr)


def lf_t3(dfm: DeviceFMIndex, k: jnp.ndarray) -> jnp.ndarray:
    """Batched LF mapping over SA_full rank space via the T3 table: the
    rank whose suffix is one position to the LEFT (bwt_invPsi semantics,
    src/bwt_search.cpp:121-127, without the $-removed-BWT index shuffling).
    LF(k) = L2[c] + 1 + strict_rank1(c, k) for c = the char preceding row
    k's suffix; the SA==0 row maps to the sentinel row 0."""
    B = k.shape[0]
    full = _t3_row_fetch(dfm, k >> 7)
    row_syms = full[:, 68:] if dfm.wide else full[:, 32:]
    inb = (k & 127).astype(jnp.int32)
    w = jnp.take_along_axis(row_syms, (inb >> 2)[:, None], axis=1)[:, 0]
    sym = (w >> (((3 - (inb & 3)) * 8).astype(jnp.uint32))) & jnp.uint32(0xFF)
    c = sym.astype(jnp.int32) & 3
    for i in range(3):           # rows with SA < 3 store sym 0; fix the char
        c = jnp.where((k == dfm.t3_exc_pos[i]) & (dfm.t3_exc_chr[i] >= 0),
                      dfm.t3_exc_chr[i], c)
    rank = occ_t3(dfm, k, jnp.zeros(B, jnp.bool_), c)
    out = dfm.l2[c] + 1 + rank
    return jnp.where(k == jnp.asarray(dfm.primary, k.dtype),
                     jnp.zeros_like(out), out)


@partial(jax.jit, static_argnums=())
def resolve_sa(dfm: DeviceFMIndex, k: jnp.ndarray) -> jnp.ndarray:
    """Batched bwt_sa (src/bwt_search.cpp:129-139): LF-walk each rank to the
    nearest sampled one, then add the stored SA value (mod seq_len+1).
    With a full SA (sa_intv == 1) this is a single gather."""
    if dfm.sa_intv == 1:
        if dfm.direct_ok:
            return dfm.sa_rows[k].astype(dfm.rdtype)
        return _plane_fetch(dfm, "sa_samples", k)
    k = k.astype(dfm.rdtype)
    mask = jnp.asarray(dfm.sa_intv - 1, dfm.rdtype)
    log2_intv = int(np.log2(dfm.sa_intv))

    def cond(state):
        k, steps = state
        return jnp.any((k & mask) != 0)

    def body(state):
        k, steps = state
        active = (k & mask) != 0
        k_new = lf_t3(dfm, k)
        return (jnp.where(active, k_new, k),
                steps + active.astype(dfm.rdtype))

    k, steps = jax.lax.while_loop(cond, body, (k, jnp.zeros_like(k)))
    base = _plane_fetch(dfm, "sa_samples", k >> log2_intv)
    return (steps + base) % jnp.asarray(dfm.seq_len + 1, dfm.rdtype)
