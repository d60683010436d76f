"""Host-side bookkeeping of the port tests' JAX train-step references.

Outside `jax.jit`, JAX runs each array op eagerly and compiles a small
program for every op and shape it meets: building the flat weight-decay
mask with a `jnp.full_like` per leaf, or splitting a flat parameter vector
back into its few hundred leaves with `ravel_pytree`'s unravel, costs
seconds of such compiles and no arithmetic. These helpers do the same in
numpy, in `ravel_pytree`'s leaf order: the values are JAX's to the bit."""

import jax
import jax.numpy as jnp
import numpy as np


def flat_decay_mask(params, mask) -> jnp.ndarray:
    """The mask tree `mask` (a bool a leaf of `params`) raveled as
    `ravel_pytree` ravels `params`: 1.0 where a leaf decays, else 0.0."""
    return jnp.asarray(np.concatenate([
        np.full(np.size(p), 1.0 if mb else 0.0, np.float32)
        for p, mb in zip(jax.tree.leaves(params), jax.tree.leaves(mask))]))


def unravel_host(params, flat):
    """`ravel_pytree(params)[1](flat)` as a tree of numpy arrays: `flat`
    split into the leaves of `params`, in order, each to its shape."""
    leaves, treedef = jax.tree.flatten(params)
    flat = np.asarray(flat)
    ends = np.cumsum([np.size(p) for p in leaves])
    assert ends[-1] == flat.size, (ends[-1], flat.size)
    return jax.tree.unflatten(treedef, [a.reshape(np.shape(p)) for a, p in
                                        zip(np.split(flat, ends[:-1]), leaves)])
