"""Device ops of the port: binning, the GBDT histogram (with its CUDA
kernel in `histogram_cuda.py` / `csrc/histogram.cu`) and the flash-attention
forward (`flash_attention.py` / `csrc/flash_attention.cu`)."""
