"""Fault tolerance: survive preemption instead of only diagnosing it (the
counterpart of the JAX package's ``ft/``).

The observability core makes deaths diagnosable (sentinels, flight recorder,
watchdog); this package makes them survivable:

- :mod:`~ddl25spring_tpu_torch.ft.chaos` -- deterministic fault injection
  (``DDL25_CHAOS=sigterm@12`` / ``kill@7`` / ``nan_grad@5`` /
  ``device_loss@9``), which makes every recovery claim checkable;
- :mod:`~ddl25spring_tpu_torch.ft.autosave` -- sentinel-gated async
  checkpointing of the FULL resume state (parameters, optimizer state, step,
  data and rng cursors) with an atomic manifest and a crash-path barrier
  (the manifest I/O itself lives in the stdlib-only
  :mod:`~ddl25spring_tpu_torch.ft.manifest`);
- :mod:`~ddl25spring_tpu_torch.ft.reshard` -- cross-mesh restore: ZeRO rows
  saved on ``n`` ranks re-land exactly on ``m``, from a checkpoint or live;
- :mod:`~ddl25spring_tpu_torch.ft.elastic` -- in-run reshaping: on
  ``device_loss`` / ``capacity_change`` the running ranks re-land their
  state on the new layout and re-lower the strategy instead of dying into a
  relaunch.

:mod:`~ddl25spring_tpu_torch.ft.demo` is the minimal deterministic train loop
the kill-and-resume tests drive; ``lab.dp_pp --workload llama --ckpt-dir``
checkpoints the main path.

Attribute access is lazy (PEP 562): a retry driver's parent and a
post-mortem report read :mod:`ft.manifest` between relaunches, and that read
must not load ``torch.distributed.checkpoint`` (through ``autosave``) into
processes that only touch JSON.
"""

_EXPORTS = {
    "AutoSaver": "autosave",
    "resume_bundle": "autosave",
    "ChaosInjector": "chaos",
    "DeviceLossError": "chaos",
    "Fault": "chaos",
    "parse_chaos": "chaos",
    "SIGNAL_KINDS": "chaos",
    "record_reshape": "elastic",
    "relower": "elastic",
    "reshape_state": "elastic",
    "surviving_devices": "elastic",
    "MANIFEST_BASENAME": "manifest",
    "latest_durable_step": "manifest",
    "read_manifest": "manifest",
    "write_manifest": "manifest",
    "Rows": "reshard",
    "reshard_leaf": "reshard",
    "reshard_state": "reshard",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    submodule = _EXPORTS.get(name)
    if submodule is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    import importlib

    return getattr(
        importlib.import_module(f"{__name__}.{submodule}"), name
    )


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
