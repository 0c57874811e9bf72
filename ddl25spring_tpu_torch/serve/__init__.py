"""``ddl25spring_tpu_torch.serve`` — the continuous-batching LLaMA decode
engine, the counterpart of the JAX package's ``serve/``: paged KV cache
(:mod:`.kv_pages`), the radix prefix cache (:mod:`.prefix`),
prefill/decode-disaggregated scheduler with admission control
(:mod:`.engine`), speculative decoding (:mod:`.spec`), and the seeded
synthetic open-loop workload (:mod:`.traffic`).  Drive it via ``python -m ddl25spring_tpu_torch.bench
--serve``; report with ``tools/serve_report.py``.

PEP-562 lazy exports: importing the package must not drag torch in —
:mod:`.traffic` and :mod:`.prefix` are numpy/stdlib only.
"""

from __future__ import annotations

_LAZY = {
    "ServeEngine": ("ddl25spring_tpu_torch.serve.engine", "ServeEngine"),
    "Request": ("ddl25spring_tpu_torch.serve.engine", "Request"),
    "make_decode_tick": ("ddl25spring_tpu_torch.serve.engine", "make_decode_tick"),
    "make_prefill": ("ddl25spring_tpu_torch.serve.engine", "make_prefill"),
    "init_page_pool": ("ddl25spring_tpu_torch.serve.kv_pages", "init_page_pool"),
    "early_exit_drafter": ("ddl25spring_tpu_torch.serve.spec", "early_exit_drafter"),
    "TrafficSpec": ("ddl25spring_tpu_torch.serve.traffic", "TrafficSpec"),
    "synth_trace": ("ddl25spring_tpu_torch.serve.traffic", "synth_trace"),
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)
