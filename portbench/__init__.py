"""The benchmark of kiwi_tpu_torch (see portbench/harness.py)."""
