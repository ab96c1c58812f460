"""
Host transport: fetch a whole pytree of device arrays in ONE device->host
copy.

Every `np.asarray(jax_array)` is a full round-trip on the device link,
and result-object assembly in the analyses layer
naturally touches many small leaves — the decay module alone made 33 such
fetches per file before this existed. Packing concatenates every leaf into
one float32 vector ON DEVICE, fetches once, and unpacks by static
shape/dtype — the same trick as the engine's flat metric transport
(engine/batch.py fetch_packed), generalised to any pytree.

float32 packing is lossless for f32/bool and for integers |v| < 2^24
(indices/lengths here are < 2^21); an assert guards the contract.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _pack_f32(leaves):
    """Concatenate a list of device arrays into one flat f32 vector ON
    DEVICE as a single compiled program (eager per-leaf astype/ravel +
    concatenate dispatched ~3 programs per distinct leaf-set — each a
    separate compile)."""
    return jnp.concatenate([leaf.astype(jnp.float32).ravel() for leaf in leaves])


def fetch_packed_tree(tree):
    """Return `tree` with every jax array replaced by host numpy, using one
    packed device->host transfer; non-array leaves pass through."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    idx = [i for i, leaf in enumerate(leaves) if isinstance(leaf, jax.Array)]
    if len(idx) <= 1:
        out = list(leaves)
        for i in idx:
            out[i] = np.asarray(leaves[i])
        return jax.tree_util.tree_unflatten(treedef, out)

    dev = [leaves[i] for i in idx]
    for leaf in dev:
        assert not jnp.issubdtype(leaf.dtype, jnp.complexfloating), (
            "complex leaves not supported by f32 packing (fetch parts instead)"
        )
    packed = np.asarray(_pack_f32(dev))

    out = list(leaves)
    offset = 0
    for i, leaf in zip(idx, dev):
        size = int(np.prod(leaf.shape)) if leaf.ndim else 1
        chunk = packed[offset : offset + size].reshape(leaf.shape)
        offset += size
        if jnp.issubdtype(leaf.dtype, jnp.bool_):
            chunk = chunk > 0.5
        elif jnp.issubdtype(leaf.dtype, jnp.integer):
            assert np.all(np.abs(chunk) < 2**24), "int leaf exceeds exact-f32 range"
            chunk = chunk.astype(np.dtype(leaf.dtype.name))
        out[i] = chunk
    return jax.tree_util.tree_unflatten(treedef, out)
