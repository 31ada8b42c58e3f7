"""Halo-exchange primitives: shard_map slabs vs direct global computation."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from flipviscosity3d.parallel import halo

NDEV = 8
I, J, K = 32, 8, 8
B = I // NDEV


def _mesh():
    return Mesh(np.array(jax.devices()[:NDEV]), ("x",))


def _shard_map(fn, mesh, in_specs, out_specs):
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)


def test_slab_exchange_roundtrip():
    rng = np.random.default_rng(0)
    g = jnp.asarray(rng.normal(size=(I, J, K)).astype(np.float32))
    mesh = _mesh()
    h = 2

    def f(g):
        s = halo.slab(g, "x", NDEV, h, fill=7.0)
        # slab fills halos from the replicated global directly; zero them
        # out and re-fill via exchange to test the collective path
        z = jnp.concatenate([
            jnp.zeros_like(s[:h]), s[h:-h], jnp.zeros_like(s[:h])
        ], axis=0)
        s2 = halo.halo_exchange(z, "x", h, fill=7.0)
        return (jnp.abs(s2 - s).max())[None]

    err = _shard_map(f, mesh, (P(),), P("x"))(g)
    assert float(jnp.max(err)) == 0.0


def test_halo_reduce_sum_matches_global_stencil():
    """A 1-cell i-shift accumulation computed on slabs + halo_reduce equals
    the global computation."""
    rng = np.random.default_rng(1)
    g = jnp.asarray(rng.normal(size=(I, J, K)).astype(np.float32))
    mesh = _mesh()
    h = 1

    def global_ref(g):
        # out[i] = g[i] + g[i-1] + g[i+1], zero beyond the domain
        out = g.copy()
        out = out.at[1:].add(g[:-1])
        out = out.at[:-1].add(g[1:])
        return out

    def f(g):
        s = halo.slab(g, "x", NDEV, h, fill=0.0)
        # accumulate into a halo'd output: each owned row writes to i-1,i,i+1
        acc = jnp.zeros_like(s)
        owned = s[h:-h]
        acc = acc.at[h:-h].add(owned)
        acc = acc.at[0:-2 * h].add(owned)       # contribution to i-1
        acc = acc.at[2 * h:].add(owned)         # contribution to i+1
        acc = halo.halo_reduce(acc, "x", h, op="sum")
        return halo.unslab(acc, "x", h)

    got = _shard_map(f, mesh, (P(),), P("x"))(g)
    np.testing.assert_allclose(np.asarray(got), np.asarray(global_ref(g)),
                               atol=1e-6)


def test_halo_reduce_sum_wide_halo():
    """halo > B/2: incoming windows overlap and must still combine."""
    rng = np.random.default_rng(3)
    g = jnp.asarray(rng.normal(size=(I, J, K)).astype(np.float32))
    mesh = _mesh()
    h = 3  # B = 4 -> windows [3,6) and [4,7) overlap

    def global_ref(g):
        out = g.copy()
        for o in (1, 2, 3):
            out = out.at[o:].add(g[:-o])
            out = out.at[:-o].add(g[o:])
        return out

    def f(g):
        s = halo.slab(g, "x", NDEV, h, fill=0.0)
        acc = jnp.zeros_like(s)
        owned = s[h:-h]
        acc = acc.at[h:-h].add(owned)
        for o in (1, 2, 3):
            acc = acc.at[h - o : s.shape[0] - h - o].add(owned)
            acc = acc.at[h + o : s.shape[0] - h + o].add(owned)
        acc = halo.halo_reduce(acc, "x", h, op="sum")
        return halo.unslab(acc, "x", h)

    got = _shard_map(f, mesh, (P(),), P("x"))(g)
    np.testing.assert_allclose(np.asarray(got), np.asarray(global_ref(g)),
                               atol=1e-5)


def test_halo_reduce_min():
    rng = np.random.default_rng(2)
    g = jnp.asarray(rng.normal(size=(I, J, K)).astype(np.float32))
    big = 99.0
    mesh = _mesh()
    h = 1

    def global_ref(g):
        out = jnp.full_like(g, big)
        out = jnp.minimum(out, g)
        out = out.at[:-1].min(g[1:])
        out = out.at[1:].min(g[:-1])
        return out

    def f(g):
        s = halo.slab(g, "x", NDEV, h, fill=big)
        acc = jnp.full_like(s, big)
        owned = s[h:-h]
        acc = acc.at[h:-h].min(owned)
        acc = acc.at[0:-2 * h].min(owned)
        acc = acc.at[2 * h:].min(owned)
        acc = halo.halo_reduce(acc, "x", h, op="min", reset=big)
        return halo.unslab(acc, "x", h)

    got = _shard_map(f, mesh, (P(),), P("x"))(g)
    np.testing.assert_allclose(np.asarray(got), np.asarray(global_ref(g)),
                               atol=1e-6)
