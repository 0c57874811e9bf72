"""The port's gradient bucketing against the JAX package's, in one process: the
same bucket boundaries from the same parameter tree, pack/unpack round trips,
dtype-homogeneous buckets and the ``DDL25_BUCKET_BYTES`` knob."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from ddl25spring_tpu.models import llama as jllama  # noqa: E402
from ddl25spring_tpu.parallel import bucketing as jbucketing  # noqa: E402
from ddl25spring_tpu.utils import config as jconfig  # noqa: E402
from ddl25spring_tpu_torch.models import llama  # noqa: E402
from ddl25spring_tpu_torch.parallel import bucketing  # noqa: E402
from ddl25spring_tpu_torch.parallel.dp import param_leaves  # noqa: E402
from ddl25spring_tpu_torch.utils import config  # noqa: E402

TINY = dict(vocab_size=64, dmodel=32, num_heads=2, n_layers=6, ctx_size=16, dtype="float32")


@pytest.fixture(scope="module")
def trees():
    """The JAX parameter pytree and the port's model loaded from it."""
    params = jax.tree.map(
        np.asarray, jllama.init_llama_params(jax.random.PRNGKey(0), jconfig.LlamaConfig(**TINY)))
    model = llama.load_jax_params(
        llama.Llama(config.LlamaConfig(**TINY), device="cpu",
                    generator=torch.Generator().manual_seed(0)), params)
    return params, model


def test_leaves_follow_the_jax_flatten_order(trees):
    params, model = trees
    want = [jax.tree_util.keystr(path, simple=True, separator=".")
            for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    got = [path for path, _ in bucketing.flatten(model.param_tree())]
    assert got == want
    # a stacked leaf has the shape of the JAX [L, ...] leaf
    for leaf, ref in zip(param_leaves(model), jax.tree.leaves(params)):
        assert bucketing.plan_buckets([leaf]).shapes[0] == ref.shape


# 4 KiB is below most leaves (embed is 8 KiB), 64 KiB between the block
# stacks (24 KiB attention, 96 KiB FFN), 4 MiB the default: one bucket
@pytest.mark.parametrize("bucket_bytes", [4096, 65536, bucketing.DEFAULT_BUCKET_BYTES])
def test_plan_matches_jax(trees, bucket_bytes):
    params, model = trees
    want = jbucketing.plan_buckets(params, bucket_bytes)
    got = bucketing.plan_buckets(param_leaves(model), bucket_bytes)
    assert got.buckets == want.buckets
    assert got.sizes == want.sizes
    assert got.shapes == want.shapes
    assert got.n_buckets == want.n_buckets > 0
    if bucket_bytes == bucketing.DEFAULT_BUCKET_BYTES:
        assert got.n_buckets == 1


@pytest.mark.parametrize("bucket_bytes", [4096, 65536])
def test_pack_unpack_round_trip_is_bitwise(trees, bucket_bytes):
    _, model = trees
    leaves = param_leaves(model)
    plan = bucketing.plan_buckets(leaves, bucket_bytes)
    bufs = plan.pack(leaves)
    assert [b.numel() for b in bufs] == [plan.bucket_size(b) for b in range(plan.n_buckets)]
    for leaf, back in zip(leaves, plan.unpack(bufs)):
        ref = leaf if isinstance(leaf, torch.Tensor) else torch.stack(list(leaf))
        assert torch.equal(back, ref.detach())
    # unpack_into writes every tensor of every leaf back in place
    blank = [torch.zeros_like(leaf) if isinstance(leaf, torch.Tensor)
             else [torch.zeros_like(t) for t in leaf] for leaf in leaves]
    plan.unpack_into(bufs, blank)
    for leaf, got in zip(leaves, blank):
        for a, b in zip(bucketing.parts(leaf), bucketing.parts(got)):
            assert torch.equal(a.detach(), b)


def test_no_bucket_mixes_dtypes(trees):
    params, _ = trees
    # every other leaf in bf16: the planners keep one open bucket per dtype
    flat, treedef = jax.tree.flatten(params)
    mixed = [x.astype(jnp.bfloat16) if i % 2 else x for i, x in enumerate(flat)]
    leaves = [torch.from_numpy(np.array(x, np.float32)).to(
        torch.bfloat16 if i % 2 else torch.float32) for i, x in enumerate(mixed)]
    for bb in (4096, 65536, bucketing.DEFAULT_BUCKET_BYTES):
        got = bucketing.plan_buckets(leaves, bb)
        assert got.buckets == jbucketing.plan_buckets(treedef.unflatten(mixed), bb).buckets
        for b, idxs in enumerate(got.buckets):
            assert {got.dtypes[i] for i in idxs} == {got.bucket_dtype(b)}
        assert sorted(i for idxs in got.buckets for i in idxs) == list(range(len(leaves)))
        bufs = got.pack(leaves)
        assert [buf.dtype for buf in bufs] == [got.bucket_dtype(b) for b in range(got.n_buckets)]
    with pytest.raises(ValueError, match="mixes dtypes"):
        bucketing.plan_buckets([[torch.zeros(2), torch.zeros(2, dtype=torch.bfloat16)]])


@pytest.mark.parametrize("env,want", [(None, 4 * 1024 * 1024), ("0", None), ("12345", 12345)])
def test_bucket_bytes_knob_matches_jax(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("DDL25_BUCKET_BYTES", raising=False)
    else:
        monkeypatch.setenv("DDL25_BUCKET_BYTES", env)
    assert bucketing.resolve_bucket_bytes(bucketing.AUTO) == want
    assert jbucketing.resolve_bucket_bytes(jbucketing.AUTO) == want
    for explicit in (None, 0, 777):
        assert (bucketing.resolve_bucket_bytes(explicit)
                == jbucketing.resolve_bucket_bytes(explicit))
