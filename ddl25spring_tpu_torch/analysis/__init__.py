"""Analysis of the PyTorch port's own code: the source rules S101 and S103
(:mod:`~ddl25spring_tpu_torch.analysis.source_lint`), the host-safety rules
S201-S205 (:mod:`~ddl25spring_tpu_torch.analysis.host_safety`) and their
runtime twin, the lock-order sanitizer
(:mod:`~ddl25spring_tpu_torch.analysis.host_sanitizer`), all reporting the
:class:`~ddl25spring_tpu_torch.analysis.rules.Finding` record against one
waiver file (:mod:`~ddl25spring_tpu_torch.analysis.waivers`,
``analysis/waivers.toml``).  Run the gate with ``python -m
ddl25spring_tpu_torch.analysis --check --host-safety``; ``--strategy train``
adds the training strategies' collective signatures
(:mod:`~ddl25spring_tpu_torch.obs.comm_analytics`)."""
