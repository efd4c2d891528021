"""Multi-chip data parallelism.

The reference has no distributed code (pthreads + one mutex,
src/GSAlign.cpp:8,492-526); this module supplies that dimension on the device:
one mesh axis "frag" shards the two batched device stages — the seeding
lane axis (query chunks) and the DP problem axis — while the FM-index arrays
stay replicated (a 2-bit fwd+RC human genome is ~1.5 GB, well under per-chip
HBM). Merges are host gathers of per-device seed buffers; deterministic
output order is restored by the global (PosDiff, qPos) sort, so results are
bit-stable for any device count.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gsalign_tpu.ops.rank import DeviceFMIndex

FRAG_AXIS = "frag"


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    devices = jax.devices() if devices is None else list(devices)
    return Mesh(np.asarray(devices), (FRAG_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def frag_sharded(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(FRAG_AXIS))


def shard_index(dfm: DeviceFMIndex, mesh: Mesh) -> DeviceFMIndex:
    """Replicate the FM-index arrays across the mesh."""
    rep = replicated(mesh)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, rep), dfm)


# fields row-sharded by shard_index_rows (docs/SCALING_3GB.md item 1):
# the big per-row tables — order-3 fused rows and the sampled SA. The
# small planes (comb_pairs INIT tables, l2, c64, text windows) replicate.
ROW_SHARD_FIELDS = ("t3", "sa_samples")


def shard_index_rows(dfm: DeviceFMIndex, mesh: Mesh) -> DeviceFMIndex:
    """Beyond-HBM mode: shard the big table ROWS over the "frag" axis
    (each device holds 1/n of t3 + sampled SA) and replicate the rest.

    The seed scan and resolve_sa then run with lanes REPLICATED and every
    table fetch as local-masked-gather + psum (rank._t3_row_fetch): this
    trades lane-parallel speedup for CAPACITY, which is the point — the
    6.2 G-row (3 Gb pair) wide tables are ~19.4 GB t3 + ~6.2 GB SA
    (~4.9 + 1.6 GB per device at 4, plus the ~1.6 GB replicated planes);
    an index beyond one card's memory needs this mode.
    Use seeding.find_seeds_all(..., mesh=mesh, index_sharded=True).
    """
    import dataclasses
    n_dev = mesh.devices.size
    repl = replicated(mesh)
    shard = frag_sharded(mesh)
    updates = {}
    fields = []
    for f in rank_fields():
        a = getattr(dfm, f)
        if f in ROW_SHARD_FIELDS and a.ndim >= 1 and a.shape[0] > 1:
            n = a.shape[0]
            want = pad_to_multiple(n, n_dev)
            if want != n:
                pad = jnp.zeros((want - n,) + a.shape[1:], a.dtype)
                a = jnp.concatenate([a, pad], axis=0)
            updates[f] = jax.device_put(a, shard)
            fields.append(f)
        else:
            updates[f] = jax.device_put(a, repl)
    out = dataclasses.replace(dfm, **updates)
    # plain attrs (not pytree fields): which planes are sharded + the mesh
    object.__setattr__(out, "_row_shard_fields", tuple(fields))
    object.__setattr__(out, "_row_shard_mesh", mesh)
    host_sa = getattr(dfm, "_host_sa", None)
    if host_sa is not None:
        object.__setattr__(out, "_host_sa", host_sa)
    return out


def rank_fields():
    from gsalign_tpu.ops.rank import DFM_DATA_FIELDS
    return DFM_DATA_FIELDS


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def shard_lanes(arr: np.ndarray, mesh: Mesh, pad_value) -> jnp.ndarray:
    """Pad axis 0 to a device-count multiple and shard it over "frag"."""
    n_dev = mesh.devices.size
    n = arr.shape[0]
    want = pad_to_multiple(max(n, 1), n_dev)
    if want != n:
        pad = np.full((want - n,) + arr.shape[1:], pad_value, dtype=arr.dtype)
        arr = np.concatenate([arr, pad], axis=0)
    return jax.device_put(arr, frag_sharded(mesh))
