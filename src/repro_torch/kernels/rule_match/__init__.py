"""Rule matching for serving: packed-popcount and int8 tensor-core kernels."""
