"""The port's partition-rule engine against the JAX package's, on the CPU:
the counterparts of ``tests/test_shard_flow.py``'s rule-engine cases and of
``tests/test_elastic.py::test_rules_relower_with_mesh_and_lint_clean``, the
parts that read no HLO.

The rules themselves need no world: atoms and regexes are validated, the
first match wins and an unmatched leaf raises, the coverage matrix and
``to_meta`` equal JAX's on the same tables, :func:`leaf_paths` of the port's
LLaMA (dense and switch-MoE), MnistCnn, ResNet-18 and tiny MLP equal JAX's
over the same models' pytrees (``jax.eval_shape``: nothing compiles), mixed
and ``layers`` tables raise, ``shard_params`` gives the ZeRO rows and
``with_mesh`` re-lowers.  One spawned gloo world of 2 ranks trains the tiny
MLP 10 Adam steps through each table's step and through the bespoke builder
from the same weights: losses and parameters bitwise equal, the loss
falling.  The ranks import this module, so it imports jax only inside the
tests.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ddl25spring_tpu_torch.models import llama, mnist_cnn, resnet  # noqa: E402
from ddl25spring_tpu_torch.parallel import dp, rules, zero  # noqa: E402
from ddl25spring_tpu_torch.parallel.comm import Comm  # noqa: E402
from ddl25spring_tpu_torch.parallel.launch import spawn  # noqa: E402
from ddl25spring_tpu_torch.utils.config import LlamaConfig  # noqa: E402
from ddl25spring_tpu_torch.utils.mesh import Mesh, RankGrid, init_mesh  # noqa: E402

TINY = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=2, ctx_size=16, dtype="float32")
MOE = dict(TINY, n_experts=4)
X = np.random.default_rng(8).normal(size=(16, 16)).astype(np.float32)
Y = np.random.default_rng(9).normal(size=(16, 4)).astype(np.float32)
STEPS = 10


def _mesh(n, axis="stage"):
    """One rank's view of a ``data = n`` grid; no world is joined."""
    grid = RankGrid(n, 1, axis)
    return Mesh(grid, 0, torch.device("cpu"), "gloo", Comm("gloo", torch.device("cpu")),
                {name: None for name in grid.names})


def _mlp():
    model = dp.TinyMlp()
    g = np.random.default_rng(7)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(0.1 * g.normal(size=tuple(p.shape)).astype(np.float32)))
    return model


def test_partition_rule_validates_atom_and_regex():
    import re

    with pytest.raises(ValueError, match="unknown layout"):
        rules.PartitionRule("^w", "diagonal")
    with pytest.raises(re.error):
        rules.PartitionRule("[", "rows")
    with pytest.raises(ValueError, match="discipline"):
        rules.RuleTable(name="t", axes=("data",), rules=(rules.PartitionRule(".*", "rows"),),
                        discipline="overlpa")


def test_match_partition_rules_first_match_wins_and_raises_unmatched():
    tree = {"w1": torch.zeros(2, 2), "b1": torch.zeros(2)}
    assert rules.match_partition_rules(rules.TABLES["zero3"], tree) == {"w1": "rows",
                                                                       "b1": "rows"}
    assert rules.match_partition_rules([("^w1$", "rows"), (".*", "replicated")], tree) == {
        "w1": "rows", "b1": "replicated"}
    with pytest.raises(ValueError, match="no partition rule matches"):
        rules.match_partition_rules([("^w", "rows")], tree)
    # a module's leaves by their JAX names
    assert rules.match_partition_rules(rules.TABLES["dp"], dp.TinyMlp()) == {
        "b1": "replicated", "w1": "replicated", "w2": "replicated"}


def test_coverage_and_meta_equal_jax():
    from ddl25spring_tpu.parallel import rules as jrules

    cases = [([("^w", "rows"), ("^w1$", "rows"), ("^b", "rows")], ["w1", "w2", "b1"]),
             (jrules.TABLES["dp"], ["w1", "b1", "w2", "c"]),
             ([("blocks/w", "rows"), (".*", "replicated")],
              ["blocks/wq", "blocks/ln1", "embed", "blocks/moe/router"])]
    for table, paths in cases:
        port_table = (rules.RuleTable(table.name, table.axes,
                                      tuple(rules.PartitionRule(r.pattern, r.spec)
                                            for r in table.rules), table.discipline)
                      if isinstance(table, jrules.RuleTable) else table)
        assert rules.rule_coverage(port_table, paths) == jrules.rule_coverage(table, paths)
    cov = rules.rule_coverage(cases[0][0], cases[0][1])
    by_path = {r["path"]: r for r in cov["leaves"]}
    assert by_path["w1"]["matches"] == [0, 1] and cov["rules"][1]["first_matches"] == 0
    for name in ("dp", "zero3"):
        meta = rules.TABLES[name].to_meta()
        assert meta == jrules.TABLES[name].to_meta()
        assert json.loads(json.dumps(meta)) == meta


def test_leaf_paths_equal_jax():
    """One table matches the same leaves in both packages: the port's models
    name their leaves as the JAX package's pytrees of the same models."""
    import jax

    from ddl25spring_tpu.models import llama as jllama
    from ddl25spring_tpu.models import resnet as jresnet
    from ddl25spring_tpu.models.mnist_cnn import MnistCnn as JMnistCnn
    from ddl25spring_tpu.parallel import rules as jrules
    from ddl25spring_tpu.parallel.dp import _tiny_mlp_workload
    from ddl25spring_tpu.utils import config as jconfig

    key = jax.random.PRNGKey(0)
    for cfg in (TINY, MOE):
        jtree = jax.eval_shape(lambda: jllama.init_llama_params(key, jconfig.LlamaConfig(**cfg)))
        port = llama.Llama(LlamaConfig(**cfg), device="cpu",
                           generator=torch.Generator().manual_seed(0))
        assert rules.leaf_paths(port) == jrules.leaf_paths(jtree)
        assert "blocks/wq" in rules.leaf_paths(port)
    jtree = jax.eval_shape(JMnistCnn().init, key, jax.ShapeDtypeStruct((1, 28, 28, 1),
                                                                       np.float32))["params"]
    port = mnist_cnn.MnistCnn(generator=torch.Generator().manual_seed(0))
    assert rules.leaf_paths(port) == jrules.leaf_paths(jtree)
    jtree = jax.eval_shape(jresnet.ResNet18(norm="group").init, key,
                           jax.ShapeDtypeStruct((1, 32, 32, 3), np.float32))["params"]
    port = resnet.ResNet18(norm="group", generator=torch.Generator().manual_seed(0))
    assert rules.leaf_paths(port) == jrules.leaf_paths(jtree)
    assert rules.leaf_paths(dp.TinyMlp()) == jrules.leaf_paths(_tiny_mlp_workload(2)[0])


def test_rule_partitioner_rejects_mixed_and_layers_tables():
    mesh = _mesh(4)
    mixed = rules.RuleTable(name="mixed", axes=("data",),
                            rules=(rules.PartitionRule("^w", "rows"),
                                   rules.PartitionRule("^b", "replicated")))
    with pytest.raises(NotImplementedError, match="mixes layouts"):
        rules.RulePartitioner(mesh, mixed).layout_of(dp.TinyMlp())
    layered = rules.RuleTable(name="layered", axes=("data",),
                              rules=(rules.PartitionRule(".*", "layers"),))
    with pytest.raises(NotImplementedError, match="layers"):
        rules.RulePartitioner(mesh, layered).layout_of(dp.TinyMlp())
    wrong_axis = rules.RuleTable(name="w", axes=("model",),
                                 rules=(rules.PartitionRule(".*", "rows"),))
    with pytest.raises(ValueError, match="mesh axes"):
        rules.RulePartitioner(mesh, wrong_axis)
    part = rules.RulePartitioner(mesh, rules.TABLES["zero3"])
    with pytest.raises(ValueError, match="pass the rows"):
        part.make_train_step(dp.TinyMlp(), dp.tiny_mlp_loss, None)


def test_rule_partitioner_shard_params_matches_zero_rows():
    mesh = _mesh(4)
    model = _mlp()
    a = rules.RulePartitioner(mesh, rules.TABLES["zero3"]).shard_params(model)
    b = zero.zero_shard_params(model, mesh)
    assert all(torch.equal(x, y) and x.shape == y.shape for x, y in zip(a, b, strict=True))
    assert rules.RulePartitioner(mesh, rules.TABLES["dp"]).shard_params(model) is model
    batch = rules.RulePartitioner(mesh, rules.TABLES["dp"]).shard_batch(torch.arange(8.0))
    assert torch.equal(batch, torch.arange(2.0))


def test_with_mesh_relowers():
    mesh8, mesh4 = _mesh(8), _mesh(4)
    part8 = rules.RulePartitioner(mesh8, rules.TABLES["zero3"])
    part4 = part8.with_mesh(mesh4)
    assert part4.table is part8.table and part4.mesh is mesh4 and part4.axis == part8.axis
    model = _mlp()
    rows = part4.shard_params(model)
    assert [tuple(r.shape) for r in rows] == [(1, 8), (1, 128), (1, 32)]
    step = part4.make_train_step(model, dp.tiny_mlp_loss, torch.optim.SGD(rows, lr=0.1),
                                 rows=rows)
    assert callable(step)


def rules_rank(rdv):
    """Each table's step and its bespoke builder from the same weights:
    losses and final parameters (the rows unsharded for ``zero3``)."""
    batch = (torch.from_numpy(X), torch.from_numpy(Y))
    out = {}
    with init_mesh(rdv, 2, stages=1, device="cpu") as mesh:
        for name in ("dp", "zero3"):
            for how in ("table", "bespoke"):
                model = _mlp()
                part = rules.RulePartitioner(mesh, rules.TABLES[name])
                if name == "dp":
                    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
                    step = (part.make_train_step(model, dp.tiny_mlp_loss, opt) if how == "table"
                            else dp.make_dp_train_step(model, dp.tiny_mlp_loss, opt, mesh))
                else:
                    rows = (part.shard_params(model) if how == "table"
                            else zero.zero_shard_params(model, mesh))
                    opt = torch.optim.Adam(rows, lr=1e-2)
                    step = (part.make_train_step(model, dp.tiny_mlp_loss, opt, rows=rows)
                            if how == "table"
                            else zero.make_zero_dp_train_step(model, dp.tiny_mlp_loss, opt,
                                                              mesh, rows))
                losses = [float(step(batch)) for _ in range(STEPS)]
                params = rows if name == "zero3" else dp.param_leaves(model)
                out[name, how] = (losses, [p.detach().numpy().copy() for p in params])
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn(rules_rank, 2, timeout=120, tmpdir=str(tmp_path_factory.mktemp("rdv")))


@pytest.mark.parametrize("name", ["dp", "zero3"])
def test_table_steps_equal_bespoke_bitwise(world, name):
    for r in world:
        (la, pa), (lb, pb) = r[name, "table"], r[name, "bespoke"]
        assert la == lb
        assert la[-1] < 0.5 * la[0], la
        for x, y in zip(pa, pb, strict=True):
            assert np.array_equal(x, y)
