"""The benchmark of tpu_lanczos_torch on one NVIDIA H100 (see README.md)."""
