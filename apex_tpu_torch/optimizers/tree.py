"""Trees of tensors: the port's counterpart of ``jax.tree_util`` for the
optimizers.

A tree is nested dicts (walked in sorted key order, as JAX walks them),
lists, tuples and NamedTuples with anything else as a leaf; ``None`` is
an empty subtree, as in JAX.  A class registered with
:func:`register_node` (``bucketing.Buckets``) is a node whose children
its own functions give, as ``jax.tree_util.register_pytree_node`` makes
it.  A dict subclass that sets ``tree_leaf = True`` (``base.HyperLeaf``)
is a leaf, as an unregistered dict subclass is in JAX.
"""

from typing import Any, Callable, List, NamedTuple, Tuple

Tree = Any

#: class -> (children(node) -> tuple, rebuild(node, children) -> node)
_NODES = {}


def register_node(cls, children: Callable, rebuild: Callable) -> None:
    """Make ``cls`` a tree node: ``children(node)`` gives its subtrees,
    ``rebuild(node, children)`` a node of the same kind holding new
    ones."""
    _NODES[cls] = (children, rebuild)


def _is_dict(x) -> bool:
    return isinstance(x, dict) and not getattr(x, "tree_leaf", False)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x):
    """``(kind, keys, children)`` of a node, or None for a leaf."""
    if x is None:
        return ("none", (), ())
    if _is_dict(x):
        keys = tuple(sorted(x))
        return ("dict", keys, tuple(x[k] for k in keys))
    if _is_namedtuple(x):
        return ("namedtuple", type(x), tuple(x))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, len(x), tuple(x))
    entry = _NODES.get(type(x))
    if entry is not None:
        return ("registered", x, tuple(entry[0](x)))
    return None


def _rebuild(kind, keys, node, children):
    if kind == "none":
        return None
    if kind == "dict":
        return dict(zip(keys, children))
    if kind == "namedtuple":
        return keys(*children)
    if kind in ("list", "tuple"):
        return type(node)(children)
    return _NODES[type(node)][1](node, children)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, keeping ``tree``'s structure; raises if the trees differ
    in their keys or lengths."""
    node = _children(tree)
    if node is None:
        return fn(tree, *rest)
    kind, keys, kids = node
    rest_kids = []
    for r in rest:
        rn = _children(r)
        if rn is None or rn[0] != kind or len(rn[2]) != len(kids):
            raise ValueError(f"trees differ in their structure: {kind} against "
                             f"{type(r).__name__}")
        if kind == "dict" and rn[1] != keys:
            raise ValueError("trees differ in their keys")
        rest_kids.append(rn[2])
    return _rebuild(kind, keys, tree,
                    tuple(tree_map(fn, k, *rk) for k, *rk in zip(kids, *rest_kids)))


def tree_leaves(tree) -> List:
    """The leaves of ``tree`` in :func:`tree_map` order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


class TreeDef(NamedTuple):
    """A tree's structure alone, hashable: what a bucket plan keeps so
    it can rebuild the tree from its leaves (``jax.tree.structure``)."""

    kind: str
    keys: Any
    children: Tuple

    def unflatten(self, leaves):
        it = iter(leaves)
        out = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError("more leaves than the structure holds")
        return out

    def _build(self, it):
        if self.kind == "leaf":
            return next(it)
        kids = [c._build(it) for c in self.children]
        if self.kind == "none":
            return None
        if self.kind == "dict":
            return dict(zip(self.keys, kids))
        if self.kind == "namedtuple":
            return self.keys(*kids)
        if self.kind == "list":
            return list(kids)
        return tuple(kids)

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)


_END = object()


def tree_structure(tree) -> TreeDef:
    """The :class:`TreeDef` of ``tree`` (dicts, lists, tuples,
    NamedTuples and None; a registered node is taken as a leaf here, as
    plans are built over param trees)."""
    if tree is None:
        return TreeDef("none", None, ())
    if _is_dict(tree):
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys, tuple(tree_structure(tree[k]) for k in keys))
    if _is_namedtuple(tree):
        return TreeDef("namedtuple", type(tree), tuple(map(tree_structure, tree)))
    if isinstance(tree, (list, tuple)):
        return TreeDef("list" if isinstance(tree, list) else "tuple", None,
                       tuple(map(tree_structure, tree)))
    return TreeDef("leaf", None, ())


def _key_entry(kind, key):
    if kind == "dict":
        return f"[{key!r}]"
    if kind == "namedtuple":
        return f".{key}"
    return f"[{key}]"


def leaves_with_path(tree, prefix="") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in :func:`tree_map` order; ``path`` is the
    string ``jax.tree_util.keystr`` gives the same position
    (``"['b']['c']"``, ``"[0]"``, ``".field"``), so one
    ``param_group_fn`` serves both packages."""
    node = _children(tree)
    if node is None:
        return [(prefix, tree)]
    kind, keys, kids = node
    if kind == "dict":
        names = keys
    elif kind == "namedtuple":
        names = keys._fields
    else:
        names = range(len(kids))
    out = []
    for name, kid in zip(names, kids):
        out.extend(leaves_with_path(kid, prefix + _key_entry(kind, name)))
    return out
