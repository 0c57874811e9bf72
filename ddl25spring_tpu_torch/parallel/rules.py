"""The partition-rule engine, a parallelism strategy as data: the counterpart of
the JAX package's ``parallel/rules.py``.

A strategy is a mesh axis, an ordered table of rules and an issue
discipline.  Each :class:`PartitionRule` maps a regex over ``/``-joined leaf
paths to a layout atom (``"replicated"``: a full replica with DP gradients;
``"rows"``: ZeRO's padded ``[n, k]`` rows, :func:`~ddl25spring_tpu_torch.
parallel.zero.zero_shard_params`; ``"layers"``: the per-layer rows of
ZeRO's LLaMA step); the first rule whose ``re.search`` matches wins.
:class:`RulePartitioner` reads a table and builds the step of its layout
through the port's own builders: all-``replicated`` through
:func:`~ddl25spring_tpu_torch.parallel.dp.make_dp_train_step`, all-``rows``
through :func:`~ddl25spring_tpu_torch.parallel.zero.make_zero_dp_train_step`.
A mixed or ``layers`` table raises ``NotImplementedError``, as in JAX.

Leaf paths are the JAX package's names for the same model (:func:`leaf_paths`),
so one table matches the same leaves in both packages: a model with
``param_tree()`` (LLaMA, ResNet, :class:`~ddl25spring_tpu_torch.parallel.dp.
TinyMlp`) names its leaves by that tree (``blocks/wq``, one leaf for the
stacked layers, not ``blocks/0/wq``), any other by flax's names
(:func:`~ddl25spring_tpu_torch.models.flax_bridge.flax_path`: ``Conv_0/kernel``),
in the JAX pytree's flatten order (sorted keys).  A nested dict of tensors or
arrays names its leaves by its keys.  Where JAX returns a pytree of atoms,
:func:`match_partition_rules` returns a dict from path to atom, in flatten
order.

The HLO ``describe()`` hook is not ported (ROADMAP A12).
"""

from __future__ import annotations

import abc
import re
from dataclasses import dataclass, field
from typing import Any, Callable

from torch import nn

# the layout atoms a rule may assign: a closed set, so a table naming
# anything else fails before a step is built
LAYOUT_ATOMS = ("replicated", "rows", "layers")


@dataclass(frozen=True)
class PartitionRule:
    """One ordered entry of a rule table: leaves whose path matches
    ``pattern`` (``re.search``) take layout ``spec``, unless an earlier rule
    matched first."""

    pattern: str
    spec: str

    def __post_init__(self):
        if self.spec not in LAYOUT_ATOMS:
            raise ValueError(f"partition rule {self.pattern!r} names unknown layout "
                             f"{self.spec!r}; known atoms: {LAYOUT_ATOMS}")
        re.compile(self.pattern)  # a table with a broken regex fails loudly


@dataclass(frozen=True)
class RuleTable:
    """A strategy, as data: mesh axes, ordered rules, issue discipline
    (``sync`` or ``overlap``)."""

    name: str
    axes: tuple[str, ...]
    rules: tuple[PartitionRule, ...]
    discipline: str = "sync"

    def __post_init__(self):
        if self.discipline not in ("sync", "overlap"):
            raise ValueError(f"rule table {self.name!r} names unknown issue discipline "
                             f"{self.discipline!r}; known: sync, overlap")

    def to_meta(self) -> dict[str, Any]:
        """The JSON-serializable form of the table (JAX ``to_meta``)."""
        return {"name": self.name, "axes": list(self.axes), "discipline": self.discipline,
                "rules": [[r.pattern, r.spec] for r in self.rules]}


def _dict_paths(tree: dict, prefix: str = "") -> list[str]:
    out = []
    for key in sorted(tree):
        value, path = tree[key], f"{prefix}{key}"
        out.extend(_dict_paths(value, path + "/") if isinstance(value, dict) else [path])
    return out


def leaf_paths(tree) -> list[str]:
    """``/``-joined leaf paths in the JAX pytree's flatten order: of a model
    (by its ``param_tree()``, else by flax's names for its parameters), of a
    nested dict, or a list of paths as given."""
    from ddl25spring_tpu_torch.models.flax_bridge import flax_path

    if isinstance(tree, nn.Module):
        if hasattr(tree, "param_tree"):
            return _dict_paths(tree.param_tree())
        return ["/".join(p) for p in sorted(flax_path(n) for n, _ in tree.named_parameters())]
    if isinstance(tree, dict):
        return _dict_paths(tree)
    return list(tree)


def _rule_list(rules) -> list[PartitionRule]:
    if isinstance(rules, RuleTable):
        return list(rules.rules)
    return [r if isinstance(r, PartitionRule) else PartitionRule(*r) for r in rules]


def match_partition_rules(rules, tree) -> dict[str, str]:
    """``{path: atom}`` over :func:`leaf_paths` of ``tree``, from an ordered
    rule list (a :class:`RuleTable`, or :class:`PartitionRule` s or
    ``(pattern, spec)`` pairs): the first ``re.search`` match wins, and a
    leaf no rule matches raises ``ValueError``."""
    rules = _rule_list(rules)
    atoms = {}
    for name in leaf_paths(tree):
        for r in rules:
            if re.search(r.pattern, name):
                atoms[name] = r.spec
                break
        else:
            raise ValueError(f"no partition rule matches param leaf {name!r}: add a rule")
    return atoms


def rule_coverage(rules, tree_or_paths) -> dict[str, Any]:
    """For every leaf, all rule indices whose pattern matches (the first one
    fires), and for every rule, how many leaves it fires for and matches:
    ``{"leaves": [{"path", "matches", "spec"}], "rules": [{"pattern", "spec",
    "first_matches", "matches"}]}`` (JAX ``rule_coverage``)."""
    rules = _rule_list(rules)
    fires, matches, leaves = [0] * len(rules), [0] * len(rules), []
    for name in leaf_paths(tree_or_paths):
        hit = [i for i, r in enumerate(rules) if re.search(r.pattern, name)]
        if hit:
            fires[hit[0]] += 1
        for i in hit:
            matches[i] += 1
        leaves.append({"path": name, "matches": hit, "spec": rules[hit[0]].spec if hit else None})
    return {"leaves": leaves,
            "rules": [{"pattern": r.pattern, "spec": r.spec, "first_matches": fires[i],
                       "matches": matches[i]} for i, r in enumerate(rules)]}


class Partitioner(abc.ABC):
    """How state lands on ranks, how a batch shards and how a train step is
    built, for a workload on a mesh."""

    @abc.abstractmethod
    def shard_params(self, model):
        """This rank's part of ``model``'s parameters under the layout."""

    @abc.abstractmethod
    def shard_batch(self, batch):
        """This rank's rows of one global batch."""

    @abc.abstractmethod
    def make_train_step(self, model, loss_fn, optimizer, rows=None, **kw) -> Callable:
        """The train step of this layout."""

    @property
    @abc.abstractmethod
    def mesh(self):
        """The mesh the partitioner builds on."""


@dataclass
class RulePartitioner(Partitioner):
    """A rule table on a mesh (a :class:`~ddl25spring_tpu_torch.utils.mesh.Mesh`
    of one rank).  The table's one layout picks the builder; the step is the
    bespoke builder's own, so both train alike to the bit."""

    _mesh: Any
    table: RuleTable
    axis: str = field(init=False)

    def __post_init__(self):
        unknown = [a for a in self.table.axes if a not in self._mesh.grid.names]
        if unknown:
            raise ValueError(f"rule table {self.table.name!r} names mesh axes {unknown} "
                             f"absent from the mesh {self._mesh.grid.names}")
        self.axis = self.table.axes[0]

    @property
    def mesh(self):
        return self._mesh

    def with_mesh(self, mesh) -> "RulePartitioner":
        """The same table on another mesh (the elastic re-lower seam)."""
        return RulePartitioner(mesh, self.table)

    def layout_of(self, model) -> str:
        """The table's one layout for ``model``'s leaves; an unmatched leaf
        raises ``ValueError``, a mixed or ``layers`` table
        ``NotImplementedError``."""
        atoms = set(match_partition_rules(self.table, model).values())
        if len(atoms) != 1:
            raise NotImplementedError(
                f"rule table {self.table.name!r} mixes layouts {sorted(atoms)}; the generic "
                "mixed-layout lowering is not built (ROADMAP A, after A8e)")
        (atom,) = atoms
        if atom == "layers":
            raise NotImplementedError(
                "the per-layer 'layers' atom lowers through zero.make_zero3_llama_train_step; "
                "its rule-table form is not built (ROADMAP A, after A8e)")
        return atom

    def shard_params(self, model):
        """``rows``: this rank's :func:`~ddl25spring_tpu_torch.parallel.zero.
        zero_shard_params`; ``replicated``: ``model`` itself, untouched."""
        from ddl25spring_tpu_torch.parallel.zero import zero_shard_params

        if self.layout_of(model) == "rows":
            return zero_shard_params(model, self._mesh, self.axis)
        return model

    def shard_batch(self, batch):
        from ddl25spring_tpu_torch.parallel.dp import shard_rows

        ax = self._mesh.axis(self.axis)
        return shard_rows(batch, ax.index, ax.size, self._mesh.device)

    def make_train_step(self, model, loss_fn, optimizer, rows=None, **kw):
        """``rows``: :func:`~ddl25spring_tpu_torch.parallel.zero.
        make_zero_dp_train_step` over ``rows`` (from :meth:`shard_params`,
        the optimizer built over them); ``replicated``:
        :func:`~ddl25spring_tpu_torch.parallel.dp.make_dp_train_step`.
        ``kw`` goes to the builder."""
        from ddl25spring_tpu_torch.parallel import dp, zero

        if self.layout_of(model) == "rows":
            if rows is None:
                raise ValueError(f"rule table {self.table.name!r} shards rows: pass the "
                                 "rows of shard_params, the optimizer built over them")
            return zero.make_zero_dp_train_step(model, loss_fn, optimizer, self._mesh, rows,
                                                axis=self.axis, **kw)
        if self.axis != "data":
            raise ValueError(f"replicated DP reduces over 'data', not {self.axis!r}")
        return dp.make_dp_train_step(model, loss_fn, optimizer, self._mesh, **kw)


# the proof-of-concept strategies, as data (JAX ``TABLES``, ``rules.py:340``):
# two rules each, weights and biases, for the tiny MLP's w1, b1, w2
TABLES: dict[str, RuleTable] = {
    "dp": RuleTable(name="dp-rules", axes=("data",),
                    rules=(PartitionRule(r"(^|/)w\d+$", "replicated"),
                           PartitionRule(r"(^|/)b\d+$", "replicated"))),
    "zero3": RuleTable(name="zero3-rules", axes=("data",),
                       rules=(PartitionRule(r"(^|/)w\d+$", "rows"),
                              PartitionRule(r"(^|/)b\d+$", "rows"))),
}
