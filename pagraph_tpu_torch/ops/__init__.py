"""Device ops: the CUDA gather kernels and the block aggregations built on
them."""
