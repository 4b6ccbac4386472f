"""The benchmark of ``artemis_tpu_torch`` on one NVIDIA H100 (``run.py``;
README.md says how to run a cell and how to add one)."""
