"""Support counting: packed-popcount and int8 tensor-core kernels."""
