"""Device kernels for the hot DP paths (CUDA, called through jax.ffi)."""
