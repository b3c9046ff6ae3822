"""The parallel paths on ``torch.distributed`` (``svdd_tpu/parallel``):
the process grid and its collectives (``mesh``), FSDP of a module's
parameters (``fsdp``), and the global rows of the noise (``rows``)."""
