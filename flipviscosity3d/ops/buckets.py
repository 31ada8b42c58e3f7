"""Cell-bucketed particle layout — the table particle engine core.

Instead of the reference's particle-loop scatter/gather
(/root/reference/src/fluidsimulation.cpp:391-420, particlelevelset.cpp:98-125)
the engine sorts particles by home cell once per pass and materializes a
fixed-capacity dense table of shape (capacity, n_cells) per field. Every
particle<->grid transfer then becomes a *dense* reduction/broadcast over the
table combined with static shifted slices of the grids (ops/grids.py) — zero
gathers in the inner loops.

One lax.sort + one scatter builds the table; one gather maps per-slot results
back to the flat particle arrays. Those three are the only irregular ops per
bucketing pass.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
from jax import lax


class BucketTable(NamedTuple):
    """Dense per-cell particle table.

    fields: tuple of (capacity, n_cells) float32 arrays, in the order the
        payload was passed (positions first by convention).
    sorted: tuple of the flat (N,) payload arrays in sorted order — the new
        canonical particle order after this pass (also the fallback data for
        capacity-overflow particles).
    slot: (N,) int32 — flat table slot of each particle in *sorted* order;
        capacity*n_cells (out of range) for particles dropped by overflow.
    cell: (N,) int32 — home cell of each sorted particle.
    n_overflow: () int32 — number of particles that did not fit.
    """

    fields: tuple
    sorted: tuple
    slot: jnp.ndarray
    cell: jnp.ndarray
    n_overflow: jnp.ndarray


def cell_of_position(pos, dx, grid_shape):
    """Clamped home cell (i,j,k) -> flat index, matching
    Grid3d::positionToGridIndex floor semantics (grid3d.h:37-43) with a clamp
    into the grid for out-of-domain positions (callers mask those)."""
    idx = jnp.floor(pos / dx).astype(jnp.int32)
    dims = jnp.array(grid_shape, jnp.int32)
    idx = jnp.clip(idx, 0, dims - 1)
    return (idx[..., 0] * grid_shape[1] + idx[..., 1]) * grid_shape[2] + idx[..., 2]


def build_buckets(
    key_pos,
    payload: Sequence[jnp.ndarray],
    dx: float,
    grid_shape,
    capacity: int,
    default_far: float = 1.0e8,
    n_table_fields: int | None = None,
) -> BucketTable:
    """Sort particles by the cell containing `key_pos` and build dense tables.

    payload: sequence of (N,) float32 arrays; by convention the first three
    are the particle positions used by the dense kernels. Empty slots hold
    `default_far` in the first three fields (so distances are huge and kernel
    weights vanish without an explicit mask) and 0 elsewhere.

    Only the first `n_table_fields` payload entries are scattered into dense
    tables (scatters are the expensive part); the rest ride along in the sort
    and are available via `.sorted` (pass-through data for later passes).
    """
    n = key_pos.shape[0]
    n_cells = grid_shape[0] * grid_shape[1] * grid_shape[2]
    key = cell_of_position(key_pos, dx, grid_shape)

    sorted_ops = lax.sort((key,) + tuple(payload), num_keys=1, is_stable=True)
    key_s = sorted_ops[0]
    payload_s = sorted_ops[1:]

    # rank within each cell run
    idx = jnp.arange(n, dtype=jnp.int32)
    new_run = jnp.concatenate(
        [jnp.ones((1,), bool), key_s[1:] != key_s[:-1]]
    )
    # lax.cummax (one HLO op), NOT lax.associative_scan: the generic scan's
    # log-depth slice/concat program makes this round's XLA hang in compile
    # (>5 min at 4.1M, measured round 4) where cummax compiles in seconds.
    run_start = lax.cummax(jnp.where(new_run, idx, 0))
    rank = idx - run_start

    ok = rank < capacity
    n_overflow = jnp.sum(~ok)
    slot = jnp.where(ok, rank * n_cells + key_s, capacity * n_cells)

    # One scatter per field, each into its own (capacity, n_cells) column.
    n_fields = len(payload_s) if n_table_fields is None else n_table_fields
    fields = []
    for f in range(n_fields):
        default = default_far if f < 3 else 0.0
        col = jnp.full((capacity * n_cells,), default, jnp.float32)
        # slot is rank-major ((rank, cell) layout) so not monotone; unique
        # still holds.
        col = col.at[slot].set(payload_s[f], mode="drop", unique_indices=True)
        fields.append(col.reshape(capacity, n_cells))
    return BucketTable(tuple(fields), payload_s, slot, key_s, n_overflow)


def gather_results(
    table: BucketTable,
    results: Sequence[jnp.ndarray],
    fallbacks: Sequence[jnp.ndarray] | None = None,
):
    """Map per-slot results (capacity, n_cells) back to flat (N,) arrays in
    the sorted particle order. Capacity-overflow particles (whose data never
    entered the table) take the corresponding per-particle `fallbacks[i]`
    value instead (0 if no fallbacks given).

    The fields are stacked into (slots, F) rows and fetched with ONE row
    gather (one index read serves all F fields)."""
    size = results[0].size
    ok = table.slot < size
    stacked = jnp.stack([r.reshape(-1) for r in results], axis=-1)  # (M, F)
    rows = jnp.take(stacked, table.slot, axis=0, mode="fill", fill_value=0.0)
    out = []
    for i in range(len(results)):
        g = rows[:, i]
        if fallbacks is not None:
            g = jnp.where(ok, g, fallbacks[i])
        out.append(g)
    return out


def cell_coords(grid_shape, dtype=jnp.int32):
    """(3, n_cells) integer coordinates of every flat cell index."""
    i = jnp.arange(grid_shape[0], dtype=dtype)
    j = jnp.arange(grid_shape[1], dtype=dtype)
    k = jnp.arange(grid_shape[2], dtype=dtype)
    ii = jnp.broadcast_to(i[:, None, None], grid_shape).reshape(-1)
    jj = jnp.broadcast_to(j[None, :, None], grid_shape).reshape(-1)
    kk = jnp.broadcast_to(k[None, None, :], grid_shape).reshape(-1)
    return jnp.stack([ii, jj, kk])
