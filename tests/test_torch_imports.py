"""Import hygiene of the PyTorch port: importing every module of
``ddl25spring_tpu_torch`` loads neither jax nor any module of the JAX package
(``ddl25spring_tpu`` itself or ``ddl25spring_tpu.*`` -- matched exactly, since
the port's name shares the prefix)."""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

_PROBE = """
import importlib, json, pkgutil, sys
import ddl25spring_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m in ("jax", "ddl25spring_tpu") or m.startswith(("jax.", "ddl25spring_tpu.")))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_imports_no_jax_and_no_reference_package():
    import json

    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=root, capture_output=True,
                         text=True, timeout=120, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    for mod in ("primer", "models.llama", "ops.flash_attention", "ops._build",
                "parallel.dp", "data.tinystories", "data.tokenizer", "utils.device",
                "utils.mesh", "parallel.comm", "parallel.bucketing", "parallel.pipeline",
                "parallel.launch", "lab.microbatches", "lab.dp_pp", "data.cifar10",
                "models.resnet", "parallel.het_pipeline", "utils.flops", "benchmarks",
                "data.mnist", "data.splitter", "data.heart", "utils.metrics", "utils.prng",
                "models.flax_bridge", "models.layers", "models.mnist_cnn",
                "models.heart_mlp", "fl", "fl.horizontal", "fl.vertical", "fl.generative",
                "bench", "examples.homework1_a1_equivalence",
                "examples.vfl_and_generative_fl", "parallel.schedule",
                "examples.homework1_a2_a3_sweeps", "examples.tutorial_1b.intro_dp_ga",
                "examples.tutorial_1b.intro_dp_wa", "examples.tutorial_1b.intro_pp_1f1b",
                "parallel.sp", "parallel.tp", "parallel.ep", "parallel.zero",
                "parallel.rules", "obs", "obs.state", "obs.recorder", "obs.counters",
                "obs.spans", "obs.logger", "obs.watchdog", "obs.timeline", "obs.sentinels",
                "analysis", "analysis.host_sanitizer", "utils.tracing", "utils.pytree",
                "utils.checkpoint", "ft", "ft.manifest", "ft.chaos", "ft.reshard",
                "ft.autosave", "ft.elastic", "ft.demo", "lab.ckpt_overhead",
                "models.decode", "serve", "serve.traffic", "serve.kv_pages", "serve.prefix",
                "serve.engine", "serve.spec", "serve.driver", "obs.memscope", "obs.goodput",
                "obs.perfscope", "obs.report", "data.native_loader", "data.sp_model",
                "analysis.rules", "analysis.waivers", "analysis.source_lint",
                "analysis.host_safety", "analysis.__main__", "obs.comm_analytics",
                "examples.golden_tables"):
        assert f"ddl25spring_tpu_torch.{mod}" in report["modules"]
