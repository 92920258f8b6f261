"""The benchmark of ptyrad_tpu_torch on one NVIDIA H100 (run.py runs a cell)."""
