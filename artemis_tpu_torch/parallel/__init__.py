"""Multi-device runs (port of ``artemis_tpu/parallel``): ``mesh`` decomposes
a single-level run over an explicit list of torch devices."""

from .mesh import ShardedDriver, make_device_mesh  # noqa: F401
