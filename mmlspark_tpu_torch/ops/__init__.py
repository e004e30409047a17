"""Device ops of the port: binning, the GBDT histogram (with its CUDA
kernel in `histogram_cuda.py` / `csrc/histogram.cu`) and flash attention
with its backward (`flash_attention.py`: `flash_attention`,
`flash_backward`; kernels in `csrc/flash_attention.cu` and
`csrc/flash_attention_bwd.cu`). The submodules are the interface: a
re-export of `flash_attention` here would shadow its module."""
