"""Sorted-stream particle engine core: segment reductions without tables.

The table engine scatters every field into fixed-capacity
(capacity, n_cells) tables each bucketing pass (ops/buckets.py). The tables
move mostly empty slots (capacity 16 vs ~2 particles/cell average in a
partly filled domain), grow memory with capacity, and drop overflow
particles to a ballistic fallback.

This module replaces the tables with reductions over the cell-sorted
particle stream itself:

- ONE lax.sort per substep (pass A); every later pass keys per-particle
  cell indices directly, no re-sort, no scatter.
- Per-cell reductions (P2G weight/velocity sums, SDF mins — the reference's
  per-particle scatter loops, /root/reference/src/fluidsimulation.cpp:364-438
  and particlelevelset.cpp:98-125) become SEGMENTED SCANS over the sorted
  stream (sum or min with a reset flag at run starts, an associative
  operator), evaluated at each cell's run end with one row-gather. All
  quantities share one scan and one row-gather.
- Per-particle sampling (G2P, RK2 stage 2, solid pushback) gathers ROWS of
  per-cell stacked columns (shifted grids) indexed by each particle's cell,
  then combines with per-particle trilinear/kernel weights.
- The only scatter left is one int32 run-start table build per sort.

Every particle participates in every transfer: the capacity/overflow
concept of the table engine does not exist here (matching the reference,
which has no such limit either).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from .buckets import cell_of_position


class ParticleStream(NamedTuple):
    """Cell-sorted particle arrays plus the cell-run index.

    key: (N,) int32 sorted flat home cell of each particle.
    sorted: tuple of (N,) float32 payload arrays in sorted order (the new
        canonical particle order after the pass-A sort).
    new_run: (N,) bool, True at the first particle of each cell run.
    starts: (n_cells+1,) int32, first sorted index of each cell's run
        (searchsorted-left semantics; starts[n_cells] == N).
    counts: (n_cells,) int32 particles per cell.
    """

    key: jnp.ndarray
    sorted: tuple
    new_run: jnp.ndarray
    starts: jnp.ndarray
    counts: jnp.ndarray


def cell_runs(key_s, n_cells: int):
    """Run index of a sorted key array: starts (one int32 scatter + a
    reverse cummin fill) and per-cell counts."""
    n = key_s.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    new_run = jnp.concatenate(
        [jnp.ones((1,), bool), key_s[1:] != key_s[:-1]]
    )
    starts = jnp.full((n_cells + 1,), n, jnp.int32)
    starts = starts.at[jnp.where(new_run, key_s, n_cells + 1)].min(
        idx, mode="drop", unique_indices=True
    )
    # fill empty cells: start[c] = min over c' >= c with a run
    # (cummin, not associative_scan — see ops/buckets.py compile-hang note)
    starts = lax.cummin(starts, reverse=True)
    counts = starts[1:] - starts[:-1]
    return new_run, starts, counts


def stream_sort(
    key_pos, payload: Sequence[jnp.ndarray], dx: float, grid_shape
) -> ParticleStream:
    """Sort particles by home cell and index the runs."""
    key = cell_of_position(key_pos, dx, grid_shape)
    return stream_sort_keys(key, payload, grid_shape)


def stream_sort_keys(
    key, payload: Sequence[jnp.ndarray], grid_shape
) -> ParticleStream:
    """stream_sort from precomputed flat cell keys. Keys may equal n_cells
    to mark dead/padding particles: they sort to the end, belong to no cell
    run, and never contribute to segment reductions (the shard_map pipeline
    uses this for its fixed-capacity per-shard particle arrays)."""
    n_cells = grid_shape[0] * grid_shape[1] * grid_shape[2]
    sorted_ops = lax.sort((key,) + tuple(payload), num_keys=1, is_stable=True)
    key_s = sorted_ops[0]
    new_run, starts, counts = cell_runs(key_s, n_cells)
    return ParticleStream(key_s, tuple(sorted_ops[1:]), new_run, starts,
                          counts)


def segment_reduce(
    stream: ParticleStream,
    sums: Sequence[jnp.ndarray],
    mins: Sequence[jnp.ndarray],
    min_default: float,
):
    """Per-cell reductions of per-particle quantities over the sorted stream.

    sums/mins: lists of (N,) float32 arrays. Returns (sum_cells, min_cells):
    lists of (n_cells,) arrays; empty cells reduce to 0 / min_default.

    One (N, S) scatter-add and one (N, M) scatter-min over the sorted keys.
    Earlier rounds used a keyed segmented associative_scan here; this round's
    XLA hangs in compile on associative_scan at 4M elements (see
    ops/buckets.py), and a cumsum-difference rewrite of the sums would lose
    ~4M*eps to prefix cancellation, so plain scatters it is — same
    accumulation semantics as the table engine. Dead/padding particles carry
    key == n_cells, landing in the dropped guard row.
    """
    n_cells = stream.counts.shape[0]
    key = stream.key
    sum_cells = []
    min_cells = []
    if sums:
        stacked = jnp.stack(sums, axis=-1)  # (N, S)
        out = jnp.zeros((n_cells, len(sums)), jnp.float32)
        out = out.at[key].add(stacked, mode="drop")
        sum_cells = [out[:, i] for i in range(len(sums))]
    if mins:
        stacked = jnp.stack(mins, axis=-1)
        out = jnp.full((n_cells, len(mins)), min_default, jnp.float32)
        out = out.at[key].min(stacked, mode="drop")
        min_cells = [out[:, i] for i in range(len(mins))]
    return sum_cells, min_cells


def rows_at_cells(columns: Sequence[jnp.ndarray], keys):
    """Per-particle rows of stacked per-cell columns: ONE (N, C) row-gather.

    columns: (n_cells,) float32 arrays (e.g. shifted grid reads).
    keys: (N,) int32 cell index per particle (any order, need not be sorted).
    Returns a list of (N,) arrays, one per column.
    """
    stacked = jnp.stack(columns, axis=-1)  # (n_cells, C)
    rows = jnp.take(stacked, keys, axis=0)  # (N, C)
    return [rows[:, i] for i in range(len(columns))]


def decode_cells(keys, grid_shape):
    """Flat cell index -> (i, j, k) int32 coordinates."""
    jk = grid_shape[1] * grid_shape[2]
    i = keys // jk
    rem = keys - i * jk
    j = rem // grid_shape[2]
    k = rem - j * grid_shape[2]
    return i, j, k
