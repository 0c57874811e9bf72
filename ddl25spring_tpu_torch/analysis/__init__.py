"""Host-side analysis of the PyTorch port: the runtime lock-order sanitizer
(:mod:`~ddl25spring_tpu_torch.analysis.host_sanitizer`)."""
