"""Attention across sequence positions (port of `mmlspark_tpu/parallel`,
so far only the single-device dense path of `ring_attention.py`)."""
