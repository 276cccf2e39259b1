"""Multi-process data parallelism: the job's mesh (``mesh``) and the
model wrapping over its ``data`` and ``fsdp`` axes (``data_parallel``)."""
