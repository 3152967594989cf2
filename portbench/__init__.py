"""The benchmark of ``egtr_tpu_torch`` on NVIDIA H100 cards (``run.py``)."""
