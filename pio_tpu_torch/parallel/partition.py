"""Partition rules and the per-device placement budget.

The port of ``pio_tpu/parallel/partition.py``: an ordered list of
``(path_regex, PartitionSpec)`` pairs matched first-hit against the
``/``-joined path of every leaf of a parameter tree (nested dicts, lists
and tuples of tensors or arrays), scalars always replicated. The rule
sets of the three templates (``als``, ``two_tower``, ``seqrec``) are the
reference's, as data. A :class:`PartitionSpec` is a tuple with one entry
a dim: an axis name, a tuple of axis names, or None (replicated on that
dim).

Placement (:func:`shard_params`) gives each rank of a process group its
row slices (``ComputeContext`` with a group), or each device of a device
tuple its piece. Trainers check their parameters against
``PIO_TPU_DEVICE_BUDGET_BYTES`` before anything lands on a device.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from pio_tpu_torch.utils import knobs

#: Per-device parameter budget (bytes); 0 = unlimited.
DEVICE_BUDGET_ENV = "PIO_TPU_DEVICE_BUDGET_BYTES"


class DeviceBudgetExceeded(RuntimeError):
    """A placement would exceed ``PIO_TPU_DEVICE_BUDGET_BYTES`` per device."""


class PartitionSpec(tuple):
    """Per-dim placement: an axis name, a tuple of names, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


# -- trees ----------------------------------------------------------------------
def _is_node(x: Any) -> bool:
    return isinstance(x, (dict, list)) or (
        isinstance(x, tuple) and not isinstance(x, PartitionSpec))


def tree_flatten_with_path(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf)]`` in the reference's order: dict keys sorted (as
    ``jax.tree_util`` flattens dicts), sequences by index."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_flatten_with_path(tree[k], prefix + (k,))
        return out
    if _is_node(tree):
        out = []
        for i, v in enumerate(tree):
            out += tree_flatten_with_path(v, prefix + (i,))
        return out
    return [(prefix, tree)]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over every leaf (a :class:`PartitionSpec` is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if _is_node(tree):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_map2(fn: Callable, tree: Any, other: Any) -> Any:
    """``fn(leaf, other_leaf)`` over two trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, other[k]) for k, v in tree.items()}
    if _is_node(tree):
        return type(tree)(tree_map2(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def tree_path_name(path: Sequence[Any]) -> str:
    """``/``-joined name of a path: ``("blocks", "wq")`` → ``blocks/wq``,
    ``(0, "mu")`` → ``0/mu``."""
    return "/".join(str(k) for k in path)


def _ndim(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.dim()
    return np.ndim(leaf)


def _nbytes(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    nbytes = getattr(leaf, "nbytes", None)
    if nbytes is None and hasattr(leaf, "size"):
        nbytes = leaf.size * np.dtype(getattr(leaf, "dtype", np.float32)).itemsize
    return int(nbytes or 0)


def match_partition_rules(
    rules: Iterable[Tuple[str, Any]],
    tree: Any,
    *,
    on_unmatched: str = "replicate",
):
    """Spec tree for ``tree``: the first rule whose regex ``search``es the
    leaf's ``/``-joined path wins; scalars are always replicated.

    ``on_unmatched``: ``"replicate"`` (unmatched leaves get ``P()``) or
    ``"error"`` (raise ``ValueError`` naming the leaf)."""
    rules = list(rules)

    def spec_of(path, leaf):
        if _ndim(leaf) == 0:
            return P()
        name = tree_path_name(path)
        for pat, spec in rules:
            if re.search(pat, name):
                return spec if isinstance(spec, PartitionSpec) else P(*spec)
        if on_unmatched == "error":
            raise ValueError(
                f"no partition rule matches leaf {name!r} "
                f"(shape {tuple(np.shape(leaf))})")
        return P()

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if _is_node(node):
            return type(node)(walk(v, path + (i,)) for i, v in enumerate(node))
        return spec_of(path, node)

    return walk(tree, ())


def _axis_sizes(mesh) -> Dict[str, int]:
    """Axis name → size of a ``DeviceMesh``, a mapping, or nothing."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    names = mesh.mesh_dim_names or ()
    return {n: int(mesh.size(i)) for i, n in enumerate(names)}


def spec_for_mesh(mesh, spec) -> PartitionSpec:
    """Project a spec onto ``mesh``: axis names the mesh doesn't carry
    become None (replicated on that dim), so one rule set serves the full
    training mesh and a 1-D serving mesh."""
    axes = set(_axis_sizes(mesh))

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, str):
            return entry if entry in axes else None
        kept = tuple(a for a in entry if a in axes)
        return kept if kept else None

    return P(*[keep(e) for e in spec])


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# -- per-template rule registry ---------------------------------------------
_TEMPLATE_RULES: Dict[str, Callable[[], List[Tuple[str, Any]]]] = {}


def register_partition_rules(
    template: str, rules: Callable[[], List[Tuple[str, Any]]]
) -> None:
    """Register (or override) the rule list of a template name."""
    _TEMPLATE_RULES[template] = rules


def rules_for(template: str) -> List[Tuple[str, Any]]:
    """The registered rule list of ``template`` (raises KeyError)."""
    try:
        factory = _TEMPLATE_RULES[template]
    except KeyError:
        raise KeyError(
            f"no partition rules registered for template {template!r}; "
            f"known: {sorted(_TEMPLATE_RULES)}"
        ) from None
    return list(factory())


def _als_rules():
    # factor matrices row-sharded over the entity (data) axis; indexes and
    # everything else replicated
    return [
        (r"(user_factors|item_factors)$", P("data", None)),
    ]


def _two_tower_rules():
    # vocab-parallel embedding (ep), Megatron column/row MLP splits (tp);
    # the trained serving vectors row-shard over entities like ALS factors
    return [
        (r"(user_vectors|item_vectors)$", P("data", None)),
        (r"emb$", P("model", None)),
        (r"w1$", P(None, "model")),
        (r"b1$", P("model")),
        (r"w2$", P("model", None)),
        (r"b2$", P()),
    ]


def _seqrec_rules():
    # layer-stacked blocks ride pipe on the leading (layer) dim; heads and
    # ffn hidden are tp column/row splits; embedding is vocab-sharded
    return [
        (r"blocks/(wq|wk|wv|w1)$", P("pipe", None, "model")),
        (r"blocks/(wo|w2)$", P("pipe", "model", None)),
        (r"blocks/b1$", P("pipe", "model")),
        (r"blocks/", P("pipe", None)),
        (r"emb$", P("model", None)),
        (r"(pos|lnf_g|lnf_b)$", P()),
    ]


register_partition_rules("als", _als_rules)
register_partition_rules("two_tower", _two_tower_rules)
register_partition_rules("seqrec", _seqrec_rules)


# -- placement budget --------------------------------------------------------
def device_budget_bytes() -> int:
    """Per-device parameter budget from the env; 0 = unlimited."""
    return knobs.knob_int(DEVICE_BUDGET_ENV)


def tree_nbytes(tree: Any) -> int:
    """Total bytes across the tree's array leaves (host or device)."""
    return sum(_nbytes(leaf) for _, leaf in tree_flatten_with_path(tree))


def assert_device_budget(
    nbytes: int, n_devices: int, what: str = "placement"
) -> None:
    """Raise :class:`DeviceBudgetExceeded` when ``nbytes`` spread over
    ``n_devices`` devices exceeds the per-device budget (no-op when the
    budget env is unset)."""
    budget = device_budget_bytes()
    if budget <= 0:
        return
    per_device = -(-nbytes // max(1, n_devices))
    if per_device > budget:
        raise DeviceBudgetExceeded(
            f"{what}: {per_device} B/device over {n_devices} device(s) "
            f"exceeds {DEVICE_BUDGET_ENV}={budget}"
        )


def per_device_nbytes(mesh, params: Any, specs: Any) -> int:
    """Bytes each device holds after placing ``params`` under ``specs``:
    sharded dims divide a leaf's footprint by the product of their axis
    sizes; replicated leaves cost their full size per device. ``mesh`` is
    a ``DeviceMesh`` or a mapping of axis name → size."""
    sizes = _axis_sizes(mesh)
    spec_leaves = [s for _, s in tree_flatten_with_path(specs)]
    total = 0
    for (_, leaf), spec in zip(tree_flatten_with_path(params), spec_leaves):
        factor = 1
        for entry in spec_for_mesh(sizes, spec):
            for axis in _entry_axes(entry):
                factor *= sizes[axis]
        total += -(-_nbytes(leaf) // max(1, factor))
    return total


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _pad_dim(t: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """``t`` zero-padded along ``dim`` to a multiple of ``parts``."""
    n = t.shape[dim]
    extra = -n % parts
    if not extra:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def shard_rows(x, parts: int, dim: int = 0) -> List[torch.Tensor]:
    """``x`` zero-padded along ``dim`` to a multiple of ``parts`` and split
    into ``parts`` equal pieces, in order."""
    return list(torch.chunk(_pad_dim(_as_tensor(x), dim, parts), parts, dim))


def _rank_slice(t: torch.Tensor, spec, sizes: Dict[str, int],
                coord: Dict[str, int]) -> torch.Tensor:
    """This rank's piece of ``t`` under ``spec``: on each sharded dim, the
    slice at the rank's (mixed-radix) coordinate over the dim's axes."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        parts = math.prod(sizes[a] for a in axes)
        if parts <= 1:
            continue
        index = 0
        for a in axes:
            index = index * sizes[a] + coord[a]
        t = shard_rows(t, parts, dim)[index]
    return t


def local_shards(mesh, params: Any, specs: Any) -> Any:
    """This rank's piece of every leaf of ``params`` under ``specs``
    (its slices on the sharded dims, zero-padded to a multiple of the axis
    sizes); the leaves as they are without a mesh."""
    if mesh is None:
        return params
    sizes = _axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return tree_map2(
        lambda leaf, spec: _rank_slice(
            _as_tensor(leaf), spec_for_mesh(sizes, spec), sizes,
            coord).contiguous(),
        params, specs)


def gather_shards(mesh, params: Any, specs: Any, shapes: Any) -> Any:
    """The inverse of :func:`local_shards` on every rank: each leaf's
    pieces gathered over the axes of its sharded dims (innermost axis
    first, so the mixed-radix order comes back) and cut to ``shapes``
    (a tree of the whole leaves' shapes). The leaves as they are without
    a mesh."""
    if mesh is None:
        return params
    from pio_tpu_torch.parallel.collectives import all_gather

    sizes = _axis_sizes(mesh)

    def whole(leaf, spec_shape):
        spec, shape = spec_shape
        for dim, entry in enumerate(spec_for_mesh(sizes, spec)):
            for axis in reversed(_entry_axes(entry)):
                if sizes[axis] > 1:
                    leaf = all_gather(leaf.detach(), mesh.get_group(axis),
                                      dim)
        return leaf[tuple(slice(0, n) for n in shape)].contiguous()

    return tree_map2(whole, params, tree_map2(
        lambda spec, shape: (spec, shape), specs, shapes))


def shard_params(
    where,
    params: Any,
    rules: Iterable[Tuple[str, Any]],
    *,
    on_unmatched: str = "replicate",
    enforce_budget: bool = True,
) -> Tuple[Any, Any]:
    """Match ``rules`` over ``params`` and place every leaf. Returns
    ``(placed, specs)``.

    ``where`` is a ``ComputeContext`` or a tuple of devices:

    - a context with a group: each leaf becomes this rank's piece (its
      slices on the sharded dims, zero-padded to a multiple of the axis
      sizes), on the rank's device;
    - a context without one: each leaf whole on its device;
    - a device tuple (a serving mesh of one ``data`` axis): each leaf a
      list with one piece a device, row pieces where the spec names
      ``data`` on dim 0 and whole copies otherwise.

    The per-device footprint is checked against the budget and booked on
    the device ledger's ``shard`` category.
    """
    specs = match_partition_rules(rules, params, on_unmatched=on_unmatched)
    if isinstance(where, (tuple, list)):
        devices = [torch.device(d) for d in where]
        sizes = {"data": len(devices)}

        def place(leaf, spec):
            spec = spec_for_mesh(sizes, spec)
            if spec and spec[0] == "data":
                return [p.to(d) for p, d in
                        zip(shard_rows(leaf, len(devices)), devices)]
            return [_as_tensor(leaf).to(d) for d in devices]
    else:
        ctx = where
        if ctx.group is None:
            return tree_map(lambda x: _as_tensor(x).to(ctx.device),
                            params), specs
        sizes = _axis_sizes(ctx.mesh)
        names = ctx.mesh.mesh_dim_names
        coord = dict(zip(names, ctx.mesh.get_coordinate()))

        def place(leaf, spec):
            spec = spec_for_mesh(sizes, spec)
            return _rank_slice(_as_tensor(leaf), spec, sizes,
                               coord).contiguous().to(ctx.device)
    per_dev = per_device_nbytes(sizes, params, specs)
    if enforce_budget:
        assert_device_budget(per_dev, 1, "shard_params")
    placed = tree_map2(place, params, specs)
    from pio_tpu_torch.obs import devicewatch

    # the latest sharded placement's per-device footprint, replaced on
    # each call (the params it books are superseded by the next one)
    devicewatch.ledger_place("shard", "shard_params", per_dev,
                             name="shard_params per-device")
    return placed, specs
