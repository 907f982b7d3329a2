"""tpu_restir.struct: frozen pytree dataclasses with static fields."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from tpu_restir import struct


class _Node(struct.PyTreeNode):
    a: jnp.ndarray
    b: jnp.ndarray
    size: int = struct.field(pytree_node=False, default=4)


def test_static_fields_are_not_leaves():
    n = _Node(a=jnp.ones(2), b=jnp.zeros(3), size=7)
    leaves, treedef = jax.tree.flatten(n)
    assert len(leaves) == 2
    assert all(isinstance(x, jax.Array) for x in leaves)
    back = jax.tree.unflatten(treedef, leaves)
    assert back.size == 7
    # the static value is part of the structure
    assert treedef != jax.tree.structure(_Node(a=jnp.ones(2), b=jnp.zeros(3)))
    assert jax.tree.map(lambda x: x + 1, n).size == 7


def test_replace_and_frozen():
    n = _Node(a=jnp.ones(2), b=jnp.zeros(3))
    m = n.replace(b=jnp.ones(3), size=5)
    assert m.size == 5 and float(m.b.sum()) == 3.0
    assert n.size == 4 and float(n.b.sum()) == 0.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        n.a = jnp.zeros(2)


def test_jit_retraces_only_on_static_change():
    traces = []

    @jax.jit
    def f(node):
        traces.append(node.size)
        return node.a * node.size + node.b[:2]

    n = _Node(a=jnp.ones(2), b=jnp.zeros(3))
    f(n)
    f(n.replace(a=3.0 * jnp.ones(2)))     # same structure: cached
    assert traces == [4]
    out = f(n.replace(size=2))            # static field: in the cache key
    assert traces == [4, 2]
    assert out.tolist() == [2.0, 2.0]
