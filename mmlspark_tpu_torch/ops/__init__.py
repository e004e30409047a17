"""Device ops of the port: binning and the GBDT histogram (with its CUDA
kernel in `histogram_cuda.py` / `csrc/histogram.cu`)."""
